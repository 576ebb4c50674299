"""Benchmark entry point of the port: the end-to-end Groth16 prove on one
NVIDIA GPU, printed as `bench.py`'s ONE JSON line.

    python3 -m groth16_tpu_torch.bench        # on a machine with the card

Prints {"metric", "value", "unit", "vs_baseline", "extras"} with
`metric` = prove_2p{LOG_N}_{CURVE}_wall: the least of the steady
`prove_encoded_host` walls (witness map, five MSMs and the host assembly;
the key resident on the card, the assignment encoded and uploaded
beforehand), and in `extras` every key `bench.py` can emit, under its
names and units:

  curve, log_n, baseline_kind, setup_s (a fresh setup only), pk_upload_s,
  first_prove_compile_s (here: the first prove's wall, including the nvcc
  build of any kernel library that is not built yet),
  assignment_encode_upload_s, phases_s, msm_window_bits, msm_g1_groups,
  msm_g1_points_per_s, msm_g2_points_per_s, msm_g1_adds_total,
  msm_g1_adds_per_s, msm_g1_sol_frac, msm_g2_adds_per_s, msm_g2_sol_frac,
  ntt_butterflies_per_s, ntt_sol_frac, verify_latency_s (the mean of
  `verify_reps` verifies), verify_engine, evaluate_constraint_ms,
  evaluate_constraint_note, batch_prove (LOG_N <= 16), baseline_model_s;

and three keys of its own:

  card                     the card's name and power limit as
                           `nvidia-smi --query-gpu=name,power.limit
                           --format=csv,noheader` gives them (None on the CPU);
  int32_mad_per_s          the 32-bit multiply rate the *_sol_frac fields
                           divide by (None on the CPU, where they are None);
  int32_mad_per_s_source   where that rate comes from.

The speed-of-light fractions divide the achieved point additions (or
butterflies) a second by the card's measured 32-bit multiply rate (kernel
V, `utils/ubench.mul_rate`) over the multiply-adds of one addition
(`utils/profiling.point_add_u32_ops`, the mixed formula; for MNT4-298
and MNT6-298, `point_add_general_u32_ops`, the generic-a full addition
of their capture scan) or of one butterfly (one Montgomery product,
`mont_mul_u32_ops`): 1.0 would be a card that multiplies and does
nothing else.  On a mixed-radix domain (MNT6-298's Fr past 2^17) the
butterfly count does not hold, so ntt_butterflies_per_s and ntt_sol_frac
are null there and `ntt_note` says why.

Settings, as `bench.py`: G16_BENCH_CURVE (bn254), G16_BENCH_LOGN (16),
G16_BENCH_FRESH_SETUP (set: set the key up anew and time it).  The same
DummyCircuit (2^(LOG_N-1) variables, 2^LOG_N - 2 constraints, a = 3,
b = 5), Rng(0xBE7C) and three steady proves, the last one phase-timed.
The proving key is cached (the port's serde, uncompressed) in
$XDG_CACHE_HOME or ~/.cache as g16_torch_bench_pk_{CURVE}_{LOG_N}.bin.
On the card the verifier must run the native C++ engine: the run fails
where `native_pairing(curve)` is None.

`run(...)` takes the sizes as arguments (tests run it on the CPU, where
every kernel runs its plain version and every number is a CPU time, for
checking the line only; `chip_smoke.py` calls it in-process).

## Baseline (vs_baseline)

As `bench.py`: a MODEL of arkworks' rayon prover on a 96-core x86 host
(~900 ns a constraint at 2^20, ~1300 at 2^16, ~2000 at 2^12; BASELINE.md),
labeled `baseline_kind: "model"`, never a measurement; vs_baseline =
model_s / wall.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np
import torch

from groth16_tpu_torch.config import CONFIG, resolve_device

# modeled arkworks 96-core ns/constraint (bench.py's model, BASELINE.md)
_MODEL_NS_PER_CONSTRAINT = {12: 2000.0, 16: 1300.0, 20: 900.0, 24: 800.0}
NNZ = (100, 1000, 10000, 100000)
RATE_SOURCE = "utils/ubench.py kernel V: the larger of the u32 and i32 multiply rates at N = 2^20, R = 2048 and 8R"


def model_prove_seconds(log_n: int) -> float:
    ks = sorted(_MODEL_NS_PER_CONSTRAINT)
    if log_n <= ks[0]:
        npc = _MODEL_NS_PER_CONSTRAINT[ks[0]]
    elif log_n >= ks[-1]:
        npc = _MODEL_NS_PER_CONSTRAINT[ks[-1]]
    else:
        for lo, hi in zip(ks, ks[1:]):
            if lo <= log_n <= hi:
                f = (log_n - lo) / (hi - lo)
                npc = (1 - f) * _MODEL_NS_PER_CONSTRAINT[lo] + f * _MODEL_NS_PER_CONSTRAINT[hi]
                break
    return npc * (1 << log_n) * 1e-9


def default_cache(curve: str, log_n: int) -> str:
    base = os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    return os.path.join(base, f"g16_torch_bench_pk_{curve}_{log_n}.bin")


def card_line():
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _marginal_s(fn, device, reps=2):
    """bench.py's marginal time of one call: the least wall of 16 chained
    calls per sync times 16, minus that of one call per sync, over 15
    (the sync's own floor drops out)."""
    def per_call(inner):
        fn()
        _sync(device)
        best = None
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(inner):
                fn()
            _sync(device)
            dt = (time.perf_counter() - t0) / inner
            best = dt if best is None else min(best, dt)
        return best

    t1, t16 = per_call(1), per_call(16)
    return max(0.0, (16 * t16 - t1) / 15)


def run(curve: str = "bn254", log_n: int = 16, device="cuda", steady: int = 3, batch: int = 4,
        verify_reps: int = 50, nnz=NNZ, cache=None, fresh_setup: bool = False, keep=None) -> dict:
    """One bench line (the dict `main` prints).  cache: the key file (None:
    no cache, the key is set up every run); fresh_setup: drop the cached
    key first; keep: a dict that receives the key (pk, vk), the setup's
    record of scalars and its phase times (a fresh setup only:
    generator_torch's synthesis, scalars, tables, batch_mul and decode;
    scalars is the exact host instance map on a mixed-radix domain), the
    prover and the assignment z, for a caller that checks them further
    (chip_smoke.py)."""
    from groth16_tpu_torch.curves.params import get_curve
    from groth16_tpu_torch.fields.spec import encode, make_spec
    from groth16_tpu_torch.curves import codec
    from groth16_tpu_torch.msm.pippenger import msm_plan
    from groth16_tpu_torch.native import native_pairing
    from groth16_tpu_torch.protocol.generator_torch import setup_device
    from groth16_tpu_torch.protocol.prover_torch import TorchProver
    from groth16_tpu_torch.protocol.verifier import prepare_verifying_key, verify_proof
    from groth16_tpu_torch.qap.device import device_matrix_from_numpy, sparse_matvec
    from groth16_tpu_torch.r1cs.circuits import DummyCircuit
    from groth16_tpu_torch.r1cs.system import ConstraintSystem, SynthesisMode
    from groth16_tpu_torch.serde import deserialize_proving_key, serialize_proving_key
    from groth16_tpu_torch.utils import ubench
    from groth16_tpu_torch.utils.profiling import (
        PhaseTimer,
        mont_mul_u32_ops,
        msm_work_point_adds,
        ntt_butterflies,
        point_add_general_u32_ops,
        point_add_u32_ops,
    )
    from groth16_tpu_torch.utils.rng import Rng

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    nat = native_pairing(curve)
    if on_card and nat is None:
        raise RuntimeError(f"the native verifier engine is unavailable for {curve} (g++ build failed?)")
    c = get_curve(curve)
    n_constraints = (1 << log_n) - 2  # domain = 2^log_n with 2 instance vars
    n_vars = 1 << (log_n - 1)
    rng = Rng(0xBE7C)
    extras = {"curve": curve, "log_n": log_n, "baseline_kind": "model"}

    if cache and fresh_setup and os.path.exists(cache):
        os.remove(cache)
    t0 = time.perf_counter()
    if cache and os.path.exists(cache):
        with open(cache, "rb") as f:
            pk = deserialize_proving_key(f.read(), curve, compress=False, validate=False)
        vk = pk.vk
    else:
        record = {} if keep is not None else None
        setup_timer = PhaseTimer(verbose=False, device=str(dev))
        pk, vk = setup_device(
            DummyCircuit(n_vars, n_constraints), curve, rng, device=dev, timer=setup_timer, record=record
        )
        _sync(dev)
        if keep is not None:
            keep.update(record=record, setup_phases_s=setup_timer.as_dict())
        extras["setup_s"] = time.perf_counter() - t0
        if cache:
            os.makedirs(os.path.dirname(cache) or ".", exist_ok=True)
            with open(cache, "wb") as f:
                f.write(serialize_proving_key(pk, compress=False))

    a, b = 3, 5
    public = [a * b % c.r]
    cs = ConstraintSystem(c.r, mode=SynthesisMode.PROVE)
    DummyCircuit(n_vars, n_constraints, a=a, b=b)(cs)
    matrices = cs.to_matrices()
    z = cs.full_assignment()

    t0 = time.perf_counter()
    prover = TorchProver(pk, matrices, device=dev)
    _sync(dev)
    extras["pk_upload_s"] = time.perf_counter() - t0
    if keep is not None:
        keep.update(pk=pk, vk=vk, prover=prover, z=z)

    r, s = rng.field_element(c.r), rng.field_element(c.r)
    t0 = time.perf_counter()
    proof = prover.prove(z, r, s)
    extras["first_prove_compile_s"] = time.perf_counter() - t0

    pvk = prepare_verifying_key(vk)
    if not verify_proof(pvk, proof, public):
        raise AssertionError("the first proof does not verify")

    t0 = time.perf_counter()
    z_enc = prover.encode_assignment(z)
    _sync(dev)
    extras["assignment_encode_upload_s"] = time.perf_counter() - t0

    times = []
    timer = PhaseTimer(verbose=False, device=str(dev))
    for i in range(steady):
        r, s = rng.field_element(c.r), rng.field_element(c.r)
        t0 = time.perf_counter()
        proof = prover.prove_encoded_host(z_enc, r, s, timer=timer if i == steady - 1 else None)
        times.append(time.perf_counter() - t0)
    wall = min(times)
    if not verify_proof(pvk, proof, public):
        raise AssertionError("the steady proof does not verify")
    phases = timer.as_dict()
    extras["phases_s"] = phases

    # throughput and speed-of-light fractions of the MSMs and the NTTs
    dpk = prover.dpk
    sbits = c.r.bit_length()
    L = make_spec(c.p).n_limbs
    g1, g2 = codec.g1_ops(c), codec.g2_ops(c)
    d2 = g2.k.tower_deg
    rate = ubench.mul_rate(device=dev) if on_card else None
    g1_adds = g1_points = 0
    for npad_g, lane_ids in dpk.g1_group_info:
        cb_g = msm_plan(g1, npad_g, len(lane_ids), sbits).c
        g1_adds += len(lane_ids) * msm_work_point_adds(npad_g, sbits, cb_g, CONFIG.msm_signed_digits)
        g1_points += len(lane_ids) * npad_g
    n_g2 = len(pk.b_g2_query) - 1
    g2_adds = msm_work_point_adds(
        n_g2, sbits, msm_plan(g2, n_g2, 1, sbits).c, CONFIG.msm_signed_digits
    )
    extras["msm_window_bits"] = msm_plan(g1, dpk.n_pad, 1, sbits).c
    # operations of one addition of each MSM's scan: the a = 0 mixed one,
    # or (a != 0, MNT) the generic-a full addition of the capture scan
    if g1.a_is_zero:
        ops1, ops2 = point_add_u32_ops(L), point_add_u32_ops(L, fp2=d2 == 2)
    else:
        ops1, ops2 = point_add_general_u32_ops(g1), point_add_general_u32_ops(g2)
    extras["msm_g1_groups"] = [{"n_pad": npad_g, "lanes": len(lane_ids)} for npad_g, lane_ids in dpk.g1_group_info]
    extras["msm_g1_points_per_s"] = g1_points / phases["msm_g1_x4"]
    extras["msm_g2_points_per_s"] = n_g2 / phases["msm_g2"]
    extras["msm_g1_adds_total"] = g1_adds
    extras["msm_g1_adds_per_s"] = g1_adds / phases["msm_g1_x4"]
    extras["msm_g1_sol_frac"] = extras["msm_g1_adds_per_s"] * ops1 / rate if rate else None
    extras["msm_g2_adds_per_s"] = g2_adds / phases["msm_g2"]
    extras["msm_g2_sol_frac"] = extras["msm_g2_adds_per_s"] * ops2 / rate if rate else None
    fr_limbs = z_enc.shape[0]
    if dpk.domain.radixes:
        # a mixed-radix domain (MNT6-298's Fr): radix-2 butterflies do not
        # count its odd stages' work, so neither figure is given
        extras["ntt_butterflies_per_s"] = extras["ntt_sol_frac"] = None
        extras["ntt_note"] = f"mixed-radix domain of {dpk.domain.size} (radixes {dpk.domain.radixes}): not counted"
    else:
        bflies = 7 * ntt_butterflies(dpk.domain.size)
        extras["ntt_butterflies_per_s"] = bflies / phases["witness_map"]
        extras["ntt_sol_frac"] = (
            extras["ntt_butterflies_per_s"] * mont_mul_u32_ops(fr_limbs) / rate if rate else None
        )

    # verify latency (the reference's 50 reps, benches/bench.rs:97-124)
    t0 = time.perf_counter()
    for _ in range(verify_reps):
        verify_proof(pvk, proof, public)
    extras["verify_latency_s"] = (time.perf_counter() - t0) / verify_reps
    extras["verify_engine"] = "native" if nat is not None else "python"

    # evaluate_constraint microbench (benches/bench.rs:126-150): one row
    # of nnz entries through the device sparse matvec
    fr = prover.fr
    rnd = np.random.RandomState(7)
    nv = max(1024, min(65536, len(z)))
    z_dev = torch.from_numpy(encode(list(z[:nv]) + [0] * max(0, nv - len(z)), fr).astype(np.int32)).to(dev)
    ec = {}
    for k in nnz:
        seg = np.zeros(k, bool)
        seg[0] = True
        dm = device_matrix_from_numpy(
            encode([3] * k, fr), rnd.randint(0, nv, size=k), seg, np.array([k - 1]), np.array([True]), 1, dev
        )
        ec[str(k)] = _marginal_s(lambda dm=dm: sparse_matvec(fr, dm, z_dev), dev) * 1e3
    extras["evaluate_constraint_ms"] = ec
    extras["evaluate_constraint_note"] = (
        "marginal time of one call (16 chained calls per sync against one); "
        "dominated by dispatch and launches below nnz~10^5"
    )

    # batch proving: B proofs of the same circuit, pipelined dispatch
    if log_n <= 16:
        def draw():
            return [rng.field_element(c.r) for _ in range(batch)]

        t0 = time.perf_counter()
        prover.prove_batch([z] * batch, draw(), draw())
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        proofs = prover.prove_batch([z] * batch, draw(), draw())
        t_batch = time.perf_counter() - t0
        if not all(verify_proof(pvk, pf, public) for pf in proofs):
            raise AssertionError("a batch proof does not verify")
        extras["batch_prove"] = {
            "batch": batch,
            "proofs_per_s": batch / t_batch,
            "batch_wall_s": t_batch,
            "per_proof_vs_single": t_batch / batch / wall,
            "first_call_compile_s": t_first,
        }

    model_s = model_prove_seconds(log_n)
    extras["baseline_model_s"] = model_s
    extras["card"] = card_line() if on_card else None
    extras["int32_mad_per_s"] = rate
    extras["int32_mad_per_s_source"] = RATE_SOURCE if on_card else "not measured: ran on the cpu"
    return {
        "metric": f"prove_2p{log_n}_{curve}_wall",
        "value": wall,
        "unit": "s",
        "vs_baseline": model_s / wall,
        "extras": extras,
    }


def main() -> int:
    curve = os.environ.get("G16_BENCH_CURVE", "bn254")
    log_n = int(os.environ.get("G16_BENCH_LOGN", "16"))
    line = run(curve, log_n, cache=default_cache(curve, log_n),
               fresh_setup=bool(os.environ.get("G16_BENCH_FRESH_SETUP")))
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
