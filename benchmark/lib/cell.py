"""One run of one cell: set-up, the measured window (or, with trace, the
phase-timed and profiled proves), the per-layer readers, and the
comparison with the reference that decides `correct`.

Set-up is everything from process start to the first timed proof: the
kernel build (first run in a checkout only), the key made on the device
from the seed's toxic waste, the PROVE synthesis with to_matrices, the
prover's upload of the key, the pool of assignments, and a warm-up of
the traffic's own path.  The window then runs the traffic mix for
`seconds`; nothing is built or compiled inside it.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import os
import sys
import time

import torch

from benchmark.lib import check, program, trace
from benchmark.lib.draw import FixedT, config_waste, domain_size, draw_job, job_assignment, stream
from benchmark.lib.spec import BENCH_DIR
from benchmark.reference.groth16 import CurveSpec


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def circuit_module(cfg):
    return importlib.import_module(f"benchmark.circuits.{cfg['circuit']['module']}")


def metric_reader(name: str):
    """benchmark/metrics/<name>.py's `read(ctx)`."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def draw_pool(cfg, circuit, seed: int, r: int, device, size: int, span=None):
    """The seed's pool of `size` assignments, the first by the program's
    PROVE synthesis, which also gives the circuit's matrices.  span(name):
    a context that times the synthesis and the rest of the pool.  ->
    (matrices, pool)."""
    span = span or (lambda name: contextlib.nullcontext())
    rng = stream(seed, "pool")
    with span("synthesis"):
        values = circuit.draw_values(cfg, rng, r, device)
        cs = program.constraint_system(r, prove=True)
        circuit.synthesize(cfg, cs, values)
        matrices = cs.to_matrices()
        pool = [cs.full_assignment()]
        del cs
    with span("pool"):
        direct = circuit.assignment(cfg, values, r)
        if direct is not None and direct != pool[0]:
            raise AssertionError("the circuit's direct assignment differs from its synthesis")
        for _ in range(1, size):
            values = circuit.draw_values(cfg, rng, r, device)
            z = circuit.assignment(cfg, values, r)
            if z is None:
                cs = program.constraint_system(r, prove=True)
                circuit.synthesize(cfg, cs, values)
                z = cs.full_assignment()
            pool.append(z)
    return matrices, pool


class Run:
    """State of one run; `go()` -> the result line (a dict)."""

    def __init__(self, cell, seed: int, seconds: float, trace_on: bool, device="cuda",
                 entry_factory=None, t_start=None):
        self.cell, self.seed, self.seconds, self.trace_on = cell, int(seed), float(seconds), bool(trace_on)
        self.dev = torch.device(device)
        self.entry_factory = entry_factory or (lambda run: program.Entry(run.prover, run.traffic))
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.cfg, self.traffic = cell.config, cell.traffic
        self.spec = CurveSpec.from_json(self.cfg["curve"])
        self.circuit = circuit_module(self.cfg)
        self.spans = {}
        self.jobs, self.proofs = [], []

    @contextlib.contextmanager
    def span(self, name):
        t0 = time.perf_counter()
        yield
        program.sync(self.dev)
        self.spans[name] = time.perf_counter() - t0
        log(f"[bench] {name}: {self.spans[name]:.3f} s")

    # -- set-up -----------------------------------------------------------

    def setup(self):
        cfg, r, dev = self.cfg, self.spec.r, self.dev
        if dev.type == "cuda":
            with self.span("build"):
                program.build_kernels(cfg["kernel_curves"])
            torch.cuda.reset_peak_memory_stats()
        self.waste = config_waste(cfg, self.seed, r)
        g1, g2 = self.spec.groups()
        p1 = g1.mul(self.spec.g1_base, self.waste.k1)
        p2 = g2.mul(self.spec.g2_base, self.waste.k2)
        with self.span("keygen"):
            self.pk = program.keygen(lambda cs: self.circuit.synthesize(cfg, cs), cfg["curve"]["name"],
                                     self.waste, p1, p2, FixedT(self.waste.t), dev)
        self.matrices, self.pool = draw_pool(cfg, self.circuit, self.seed, r, dev, int(self.traffic["pool"]),
                                             self.span)
        with self.span("upload"):
            self.prover = program.prover(self.pk, self.matrices, dev)
        self.entry = self.entry_factory(self)
        self.job_rng = stream(self.seed, "jobs")
        with self.span("warmup"):
            self.drive(int(self.traffic["warmup_jobs"]))
        # the pool's millions of list slots out of the collector's reach,
        # so that no full collection lands inside the window
        gc.collect()
        gc.freeze()
        self.setup_s = time.perf_counter() - self.t_start
        log(f"[bench] setup_s: {self.setup_s:.3f} s")

    def next_job(self):
        """-> (the job's assignment, r, s)."""
        job = draw_job(self.cfg, self.circuit, self.job_rng, len(self.jobs), len(self.pool), self.spec.r)
        self.jobs.append(job)
        return job_assignment(self.pool, job), job[1], job[2]

    def drive(self, count=None, deadline=None, timer=None, on_proof=None):
        """Run the traffic's entry for `count` jobs or until `deadline`
        (jobs are drawn until then; those in flight finish).  -> the
        perf_counter time of the last completion."""
        def more(k):
            return k < count if count is not None else time.perf_counter() < deadline

        t_last, k = None, 0
        if self.traffic["entry"] == "single":
            while more(k):
                z, r, s = self.next_job()
                self.proofs.append(self.entry.single(z, r, s, timer=timer))
                t_last, k = time.perf_counter(), k + 1
                if on_proof:
                    on_proof(k)
        elif self.traffic["entry"] == "stream":
            def jobs():
                nonlocal k
                while more(k):
                    job = self.next_job()
                    k += 1
                    yield job

            done = 0
            for proof in self.entry.stream(jobs()):
                self.proofs.append(proof)
                t_last, done = time.perf_counter(), done + 1
                if on_proof:
                    on_proof(done)
        else:
            raise ValueError(f"unknown entry {self.traffic['entry']!r}")
        return t_last

    # -- the window -------------------------------------------------------

    def window(self) -> dict:
        n0 = len(self.proofs)
        t0 = time.perf_counter()
        t_last = self.drive(deadline=t0 + self.seconds)
        done = len(self.proofs) - n0
        span = t_last - t0
        log(f"[bench] window: {done} proofs in {span:.3f} s")
        return {"prove_s": span / done, "proofs_per_s": done / span, "setup_s": self.setup_s}

    def traced(self) -> dict:
        """Phase-timed proves (single entries) with the profiler off, for
        the phases' host times; as many again under the profiler, for the
        device's time inside each phase; then a stretch of consecutive
        proves, profiled.  -> the readers' context."""
        from torch.profiler import ProfilerActivity, profile

        n = int(self.traffic.get("phase_timed_proofs", 0))
        timers = [self.phase_timed() for _ in range(n)]
        prof = profile(activities=[ProfilerActivity.CUDA]) if self.dev.type == "cuda" else None
        if prof is not None and n:
            prof.start()
        stamped = [self.phase_timed() for _ in range(n)] if prof is not None else []
        count = int(self.traffic["profiled_proofs"])
        t0, t1, spans = self.stretch(count, prof if prof is not None and not n else None)
        ctx = {"phases": [t.as_dict() for t in timers], "phase_device": [], "trace": None}
        if prof is None:
            return ctx
        prof.stop()
        events = trace.device_events(prof)
        ctx["phase_device"] = [{name: trace.busy_s(events, a, b) for name, a, b in t.stamps} for t in stamped]
        single = self.traffic["entry"] == "single"
        default = "prove: dispatch" if single else "next(): fetch and decode"
        ctx["trace"] = trace.summarize(events, t0, t1, count, spans, default)
        return ctx

    def phase_timed(self):
        """One prove with the program's phases fenced; -> its timer."""
        timer = program.phase_timer(self.dev)
        self.drive(count=1, timer=timer)
        return timer

    def stretch(self, count: int, prof=None):
        """`count` consecutive proves with the harness's host spans around
        the program's steps; a stream's from once its pipeline is full, and
        kept full to the end.  prof: a profiler to start at the stretch's
        first prove.  -> (start_ns, end_ns, spans) on the wall clock."""
        spans = trace.Spans()
        p = self.prover
        single = self.traffic["entry"] == "single"
        if isinstance(self.entry, program.Entry):
            p.encode_assignment = spans.wrap("encode", p.encode_assignment)
            if single:
                p._assemble = spans.wrap("fetch and host assembly", p._assemble)
            else:
                p.prove_encoded = spans.wrap("dispatch", p.prove_encoded)
        depth = 0 if single else int(self.traffic["depth"])
        lead = 0 if single else depth + 1
        marks = {}

        def on_proof(k):
            if k == lead:
                if prof is not None:
                    program.sync(self.dev)
                    prof.start()
                marks["t0"] = time.time_ns()
            if k == lead + count:
                marks["t1"] = time.time_ns()

        if lead == 0:
            on_proof(0)
        self.drive(count=lead + count + depth, on_proof=on_proof)
        for name in ("encode_assignment", "_assemble", "prove_encoded"):
            p.__dict__.pop(name, None)
        return marks["t0"], marks["t1"], spans

    # -- after the window -------------------------------------------------

    def work(self, circuit) -> dict:
        """Sizes the roofline readers count from: the reference's circuit
        and the first assignment (a key point at infinity or a zero scalar
        needs no addition)."""
        ninp = circuit.num_instance
        cols = [set(), set(), set()]
        nnz = 0
        for s, e, *terms in circuit.runs:
            for k, t in enumerate(terms):
                cols[k].update(col for _, col in t)
                nnz += (e - s) * len(t)
        cols[0].update(range(ninp))  # the input-consistency rows
        z = job_assignment(self.pool, self.jobs[0])
        live = [sum(1 for i in c if i >= lo and z[i] % self.spec.r) for c, lo in
                ((cols[0], 1), (cols[1], 1), (cols[0] | cols[1] | cols[2], ninp))]
        n = domain_size(circuit.num_constraints, ninp)
        return {"domain": n, "nnz": nnz, "num_variables": ninp + circuit.num_witness,
                "msm_g1_points": [live[0], live[1], n - 1, live[2]], "msm_g2_points": live[1],
                "r": self.spec.r, "p": self.spec.p, "g2_deg": self.spec.g2_deg, "products": self.cfg["work"]}

    def go(self) -> dict:
        self.setup()
        if self.trace_on:
            ctx = self.traced()
            e2e = {}
        else:
            ctx, e2e = {}, self.window()
        memory_peak = torch.cuda.max_memory_allocated() if self.dev.type == "cuda" else 0
        vk = self.pk.vk
        del self.entry, self.prover, self.pk
        gc.unfreeze()
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        circuit, digest = self.circuit.reference_circuit(self.cfg, self.matrices)
        t0 = time.perf_counter()
        checks = check.compare(self.cfg, self.spec, self.waste, circuit, digest, self.pool,
                               self.jobs, self.proofs, vk, rng=stream(self.seed, "sample"))
        log(f"[bench] reference: {time.perf_counter() - t0:.3f} s for {len(self.jobs)} proofs")
        metrics = {}
        if self.trace_on:
            ctx.update(spans=self.spans, work=self.work(circuit), entry=self.traffic["entry"])
            for m in self.cell.per_layer:
                v = metric_reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            for m in self.cell.end_to_end:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
        device = {"platform": "gpu" if self.dev.type == "cuda" else self.dev.type,
                  "kind": torch.cuda.get_device_name(self.dev) if self.dev.type == "cuda" else "cpu",
                  "count": 1, "memory_peak_bytes": int(memory_peak)}
        line = {"correct": check.is_correct(checks), "attempted": len(self.jobs),
                "failed": checks["proofs_differing"]["value"] + checks["proofs_missing"]["value"],
                "metrics": metrics, "device": device}
        summary = ctx.get("trace")
        if summary:
            device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
            line["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
        line["checks"] = checks
        return line

