"""The card's time by the program's own phases and layers.

The program marks its layers with spans (groth16_tpu_torch/utils/
profiling: `encode`, `witness_map` with its `matvec` and `ntt`,
`msm_g1_x4`, `msm_g2`, `assembly`, `fetch`), recorded inside
`profiling.tracing()` on time.time_ns(), each with its parent and its
job's id, and counts the bytes it uploads (`h2d_bytes`).  A CUDA-only
profile holds, besides the device's kernels and copies, the CUDA API
calls that launched them (cudaLaunchKernel, cudaMemcpyAsync, ...),
stamped on the same clock and tied to them by correlation id.  Each device
event goes to the innermost program span open when its launch call was
made, and counts to that span and to every span around it.

`PhaseRun` is cell.Run with one more profiled stretch after its traced
proves: `profiled_proofs` consecutive proves, a stream's once its pipeline
is full, with the recorder on and nothing of the program wrapped.  The
readings before it are left as they were.  `summarize` reads the stretch,
and `READERS` turn the summary into the per-layer metrics of `METRICS`
(entries in BENCHMARK.json's form).  benchmark/phase_trace.py runs a cell
so; a program without the recorder gives no summary, and every reader
then returns None.
"""

from __future__ import annotations

import bisect
import statistics
import time

from benchmark.lib import program
from benchmark.lib.cell import Run, log
from benchmark.lib.trace import is_launch, union

STREAM, SINGLE = "bls12_381.bench_2p20.stream", "mnt6_298.recursion.single"
WITNESS = "witness map: qap/device, ntt/ntt"
MSM = "MSM: msm/pippenger, msm/cuda_scan, curves/cuda_point"
DISPATCH = "host dispatch: protocol/prover_torch, par/batch_pp"
ENCODE = "host encode: fields/spec.encode via TorchProver.encode_assignment"


def _metric(name, unit, source, layer, cell):
    moves = "proofs_per_s" if cell == STREAM else "prove_s"
    return {"name": name, "unit": unit, "better": "lower", "source": source, "layer": layer,
            "moves": moves, "workloads": [cell]}


METRICS = [
    _metric("encode_ms.stream", "ms/proof", "program_span", ENCODE, STREAM),
    _metric("idle_in_encode.stream", "%", "device_trace", ENCODE, STREAM),
    _metric("fetch_wait_ms.stream", "ms/proof", "program_span", DISPATCH, STREAM),
    _metric("h2d_mb_per_proof.stream", "MB/proof", "program_counter", DISPATCH, STREAM),
    _metric("witness_map_device_ms.stream", "ms/proof", "device_trace", WITNESS, STREAM),
    _metric("msm_device_ms.stream", "ms/proof", "device_trace", MSM, STREAM),
    _metric("assembly_device_ms.stream", "ms/proof", "device_trace",
            "assembly: protocol/prover_torch, protocol/prover", STREAM),
    _metric("matvec_device_ms.single", "ms/proof", "device_trace", WITNESS, SINGLE),
    _metric("ntt_device_ms.single", "ms/proof", "device_trace", WITNESS, SINGLE),
]


# -- the trace ---------------------------------------------------------------


def kineto_events(prof):
    """-> (device, launches): each device event as (name, start_ns,
    end_ns, correlation id), and each CUDA API call's host start by
    correlation id."""
    from torch.autograd import DeviceType

    device, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            s = e.start_ns()
            device.append((e.name(), s, s + e.duration_ns(), e.correlation_id()))
        elif e.name().startswith("cu"):
            launches[e.correlation_id()] = e.start_ns()
    return device, launches


def innermost(spans):
    """-> (bounds, owner): the spans' ends in order and, for each stretch
    [bounds[k], bounds[k + 1]), the index of the innermost span open there
    (the latest started; -1 where none is)."""
    closed = [(i, a, b) for i, (_, a, b, *_) in enumerate(spans) if b is not None]
    bounds = sorted({t for _, a, b in closed for t in (a, b)})
    owner = []
    for t in bounds:
        best, start = -1, None
        for i, a, b in closed:
            if a <= t < b and (start is None or a >= start):
                best, start = i, a
        owner.append(best)
    return bounds, owner


def owner_at(bounds, owner, t: int) -> int:
    k = bisect.bisect_right(bounds, t) - 1
    return owner[k] if k >= 0 else -1


def _clip(intervals, t0, t1):
    return [(max(s, t0), min(e, t1)) for s, e in intervals if e > t0 and s < t1]


def _length(merged) -> int:
    return sum(e - s for s, e in merged)


def _overlap(a, b) -> int:
    """ns in both of two merged, sorted interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def summarize(spans, counts: dict, device, launches: dict, t0: int, t1: int, proofs: int,
              traced: bool) -> dict:
    """The stretch [t0, t1] of `proofs` proves: each span name's device
    busy ms (its own events and those of the spans inside it, the union
    of their intervals), kernels launched and host ms (its spans,
    clipped), the idle seconds each name's spans cover, the share of the
    busy time that some span holds, the largest unattributed events, and
    the bytes uploaded a job.  traced: whether the device was profiled."""
    bounds, owner = innermost(spans)
    chain = []
    for name, _, _, parent, _ in spans:
        chain.append({name} | (chain[parent] if parent is not None else set()))
    by_name, launched, held, free, stray = {}, {}, [], [], {}
    for name, s, e, corr in device:
        if e <= t0 or s >= t1:
            continue
        s, e = max(s, t0), min(e, t1)
        t = launches.get(corr)
        i = -1 if t is None else owner_at(bounds, owner, t)
        if i < 0:
            free.append((s, e))
            stray[name] = stray.get(name, 0) + e - s
            continue
        held.append((s, e))
        for n in chain[i]:
            by_name.setdefault(n, []).append((s, e))
            launched[n] = launched.get(n, 0) + is_launch(name)
    busy = union(held + free)
    busy_ns = _length(busy)
    idle, prev = [], t0
    for s, e in busy:
        if s > prev:
            idle.append((prev, s))
        prev = max(prev, e)
    if prev < t1:
        idle.append((prev, t1))
    host = {}
    for name, a, b, *_ in spans:
        if b is not None:
            host.setdefault(name, []).append((a, b))
    host = {n: union(_clip(v, t0, t1)) for n, v in host.items()}
    jobs = {proof for *_, proof in spans if proof is not None}
    top = sorted(stray.items(), key=lambda kv: -kv[1])[:5]
    return {
        "traced": traced,
        "window_s": (t1 - t0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "proofs": proofs,
        "device_ms": {n: _length(union(v)) / 1e6 for n, v in by_name.items()},
        "launches": launched,
        "host_ms": {n: _length(v) / 1e6 for n, v in host.items()},
        "idle_s": {n: _overlap(v, idle) / 1e9 for n, v in host.items()},
        "attributed_share": _length(union(held)) / busy_ns if busy_ns else None,
        "unattributed_ops": [[n[:120], v / 1e9] for n, v in top],
        "h2d_bytes_per_job": counts.get("h2d_bytes", 0) / len(jobs) if jobs else None,
    }


# -- the readers -------------------------------------------------------------


def _summary(ctx, entry, device=False):
    t = ctx.get("program_trace")
    if ctx.get("entry") != entry or not t or not t["proofs"]:
        return None
    if device and not (t["traced"] and t["busy_s"] > 0):
        return None
    return t


def _device_ms(entry, *names):
    def read(ctx):
        t = _summary(ctx, entry, device=True)
        return None if t is None else sum(t["device_ms"].get(n, 0.0) for n in names) / t["proofs"]
    return read


def _host_ms(entry, name):
    def read(ctx):
        t = _summary(ctx, entry)
        return None if t is None else t["host_ms"].get(name, 0.0) / t["proofs"]
    return read


def _idle_in_encode(ctx):
    t = _summary(ctx, "stream", device=True)
    return None if t is None else 100.0 * t["idle_s"].get("encode", 0.0) / t["window_s"]


def _h2d_mb(ctx):
    t = _summary(ctx, "stream")
    return None if t is None or t["h2d_bytes_per_job"] is None else t["h2d_bytes_per_job"] / 1e6


READERS = {
    "encode_ms.stream": _host_ms("stream", "encode"),
    "idle_in_encode.stream": _idle_in_encode,
    "fetch_wait_ms.stream": _host_ms("stream", "fetch"),
    "h2d_mb_per_proof.stream": _h2d_mb,
    "witness_map_device_ms.stream": _device_ms("stream", "witness_map"),
    "msm_device_ms.stream": _device_ms("stream", "msm_g1_x4", "msm_g2"),
    "assembly_device_ms.stream": _device_ms("stream", "assembly"),
    "matvec_device_ms.single": _device_ms("single", "matvec"),
    "ntt_device_ms.single": _device_ms("single", "ntt"),
}


def read_all(ctx, cell_name: str) -> dict:
    """The metrics of METRICS listed for the cell that have a reading."""
    out = {}
    for m in METRICS:
        v = READERS[m["name"]](ctx) if cell_name in m["workloads"] else None
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


# -- the run -----------------------------------------------------------------


class PhaseRun(Run):
    """cell.Run whose traced run ends with the program-span stretch;
    `phase_ctx` then holds its summary under "program_trace" (None on a
    program without the recorder).  cost_proofs: as many single proves
    again with the recorder off and on, in turns (`recorder_cost`)."""

    cost_proofs = 0

    def traced(self) -> dict:
        ctx = super().traced()
        summary = self.program_stretch(int(self.traffic["profiled_proofs"]))
        self.phase_ctx = {"program_trace": summary, "entry": self.traffic["entry"]}
        if summary is not None:
            log(f"[bench] program spans: {summary['attributed_share']} of the busy time attributed; "
                f"unattributed {summary['unattributed_ops']}")
        if self.cost_proofs:
            self.phase_ctx["recorder_cost"] = self.recorder_cost(self.cost_proofs)
        return ctx

    def program_stretch(self, count: int):
        try:
            from groth16_tpu_torch.utils.profiling import tracing
        except ImportError:
            log("[bench] program spans: the program has no recorder")
            return None
        prof = None
        if self.dev.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA])
        single = self.traffic["entry"] == "single"
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

        with tracing() as rec:
            if lead == 0:
                on_proof(0)
            self.drive(count=lead + count + depth, on_proof=on_proof)
        device, launches = [], {}
        if prof is not None:
            prof.stop()
            t = time.perf_counter()
            device, launches = kineto_events(prof)
            log(f"[bench] program spans: {len(device)} device events read in {time.perf_counter() - t:.1f} s")
        return summarize(rec.spans, rec.counts, device, launches, marks["t0"], marks["t1"], count,
                         prof is not None)

    def recorder_cost(self, n: int) -> dict:
        """n single proves with the recorder off and n with it on, in
        turns (off, on, on, off, ...): -> each side's seconds, median and
        quartiles."""
        from groth16_tpu_torch.utils.profiling import tracing

        times = {"off": [], "on": []}
        for k in range(2 * n):
            side = "on" if k % 4 in (1, 2) else "off"
            program.sync(self.dev)
            t = time.perf_counter()
            if side == "on":
                with tracing():
                    self.drive(count=1)
            else:
                self.drive(count=1)
            program.sync(self.dev)
            times[side].append(time.perf_counter() - t)
        out = {}
        for side, v in times.items():
            q1, q2, q3 = statistics.quantiles(v, n=4)
            out[side] = {"median_s": q2, "q1_s": q1, "q3_s": q3, "runs_s": v}
        return out
