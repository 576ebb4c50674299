"""The port's span recorder and counters (utils/profiling) on the CPU.

MySillyCircuit on bn254, the smallest circuit a CPU prove test runs:
with the recorder off nothing is recorded and the proof is the traced
one; with it on, one prove records its layers under one proof id with
the right parents; a ProofStream gives each job's spans its own id; the
profiler stamps a torch op inside the time.time_ns() span around it; and
`upload` counts the bytes it is handed.  The stream case reuses the first
prove's MSM accumulators (its jobs share one assignment), since the MSMs
take nearly all of a CPU prove and hold no span.
"""

import functools

import pytest
import torch

from groth16_tpu_torch.curves.params import get_curve
from groth16_tpu_torch.par import dryrun
from groth16_tpu_torch.par.batch_pp import ProofStream
from groth16_tpu_torch.protocol import prover_torch
from groth16_tpu_torch.protocol.generator import setup
from groth16_tpu_torch.protocol.prover_torch import TorchProver
from groth16_tpu_torch.r1cs.circuits import MySillyCircuit
from groth16_tpu_torch.r1cs.system import ConstraintSystem, SynthesisMode
from groth16_tpu_torch.utils import profiling
from groth16_tpu_torch.utils.rng import Rng

torch.set_num_threads(1)

R, S = 12345, 6789
PROVE_SPANS = {"encode": 1, "witness_map": 1, "matvec": 3, "ntt": 7, "msm_g1_x4": 1, "msm_g2": 1,
               "assembly": 1, "fetch": 1}


@functools.lru_cache(maxsize=None)
def _prover():
    c = get_curve("bn254")
    pk, _ = setup(MySillyCircuit(), "bn254", Rng(3))
    cs = ConstraintSystem(c.r, mode=SynthesisMode.PROVE)
    MySillyCircuit(a=3, b=5)(cs)
    return TorchProver(pk, cs.to_matrices(), device="cpu"), cs.full_assignment()


MSM_ACCS = {}


def _kept(fn):
    def kept(*args):
        MSM_ACCS[fn.__name__] = fn(*args)
        return MSM_ACCS[fn.__name__]
    return kept


@functools.lru_cache(maxsize=None)
def _proves():
    """The same prove with the recorder off, then on: -> (off, on, spans).
    The first keeps its MSM accumulators in MSM_ACCS."""
    prover, z = _prover()
    assert profiling.span("encode") is profiling.NULL_SPAN and profiling.job() is profiling.NULL_SPAN
    with pytest.MonkeyPatch.context() as mp:
        for name in ("msm_g1_phase", "msm_g2_phase"):
            mp.setattr(prover_torch, name, _kept(getattr(prover_torch, name)))
        off = prover.prove(z, R, S)
    with profiling.tracing() as rec:
        on = prover.prove(z, R, S)
    return off, on, rec.spans


def _counted(spans) -> dict:
    out = {}
    for name, *_ in spans:
        out[name] = out.get(name, 0) + 1
    return out


@pytest.mark.parametrize("case", ["off", "on"])
def test_prove_spans(case):
    off, on, spans = _proves()
    assert (on.a, on.b, on.c) == (off.a, off.b, off.c)
    if case == "off":
        with profiling.tracing() as rec:
            pass
        assert rec.spans == [] and rec.counts["h2d_bytes"] == 0
        return
    assert _counted(spans) == PROVE_SPANS
    assert {proof for *_, proof in spans} == {0}
    index = {name: i for i, (name, *_) in reversed(list(enumerate(spans)))}
    for name, t0, t1, parent, _ in spans:
        want = {"matvec": "witness_map", "ntt": "witness_map", "fetch": "assembly"}.get(name)
        assert parent == (None if want is None else index[want]), name
        assert t0 <= t1
        if parent is not None:
            assert spans[parent][1] <= t0 and t1 <= spans[parent][2]


def test_stream_jobs_carry_their_own_ids(monkeypatch):
    prover, z = _prover()
    _proves()
    for name, acc in MSM_ACCS.items():
        monkeypatch.setattr(prover_torch, name, lambda *args, acc=acc: acc)
    with profiling.tracing() as rec:
        proofs = list(ProofStream(prover, depth=2).prove_all([(z, 3 + i, 5 + i) for i in range(3)]))
    assert len(proofs) == 3
    by_job = {}
    for name, _, _, _, proof in rec.spans:
        by_job.setdefault(proof, []).append(name)
    assert sorted(by_job) == [0, 1, 2]
    for names in by_job.values():
        assert _counted([(n,) for n in names]) == PROVE_SPANS
    # job 0's fetch comes after job 2's encode, and keeps job 0's id
    order = [(name, proof) for name, _, _, _, proof in rec.spans if name in ("encode", "fetch")]
    assert order.index(("fetch", 0)) > order.index(("encode", 2))


def test_profiler_stamps_on_the_span_clock():
    from torch.profiler import ProfilerActivity, profile

    a = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof, profiling.tracing() as rec:
        with profiling.span("mm"):
            torch.mm(a, a)
    (_, t0, t1, _, _), = rec.spans
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert starts and all(t0 <= s <= t1 for s in starts)


@pytest.mark.parametrize("shape,dtype", [((18, 5), torch.int32), ((3,), torch.int64), ((2, 7), torch.bool)])
def test_upload_counts_its_bytes(shape, dtype):
    host = torch.zeros(shape, dtype=dtype)
    dryrun.zero_counts()
    with profiling.tracing() as rec:
        prover_torch.upload(host, torch.device("cpu"))
    want = host.numel() * host.element_size()
    assert rec.counts["h2d_bytes"] == want == profiling.snapshot()["h2d_bytes"]
    assert set(dryrun.read_counts()) == {"launches", "plain"}
