"""The sharded path end to end, and the rank programs that drive it.

`dryrun_multichip(n, device, backend)` is the counterpart of the JAX
package's `__graft_entry__.dryrun_multichip`: one sharded prove + verify
of a tiny DummyCircuit (2 S^2 - 2 constraints, so that the four-step
NTT's n1 and n2 are multiples of S) over `n` ranks, on the card unless
the caller asks for the CPU.

The `rank_*` functions are rank programs for `par.mesh.run_ranks`: each
runs on every rank of a launch with the same arguments (its first, the
rank's device, comes from run_ranks) and returns a picklable result.
They live in the package because a spawned rank imports the module of
the function it runs (a test module would bring the JAX package along).
The CPU tests (tests/test_torch_sharded*.py, test_torch_elastic.py,
test_torch_batch_sharded.py) and chip_smoke.py's multi_device phase
hold their results against the exact prover and the single-device
path; `rank_calls` runs several of them in one launch.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from groth16_tpu_torch.curves import codec
from groth16_tpu_torch.curves.params import get_curve
from groth16_tpu_torch.fields import fp
from groth16_tpu_torch.fields.spec import decode, encode, make_spec
from groth16_tpu_torch.msm.pippenger import msm_device_lanes
from groth16_tpu_torch.ntt.ntt import NttDomain
from groth16_tpu_torch.par import collectives
from groth16_tpu_torch.par.mesh import DATA_AXIS, make_mesh, make_mesh_2d, run_ranks, shard_elements
from groth16_tpu_torch.utils import profiling
from groth16_tpu_torch.utils.profiling import PhaseTimer

CURVE = "bn254"


def zero_counts() -> None:
    """Set this process's counters to 0 (utils/profiling.reset_counts)."""
    profiling.reset_counts()


def read_counts() -> dict:
    """{"launches": kernel -> count, "plain": kernel -> plain-version
    calls} since zero_counts(), copies of this process's counters."""
    snap = profiling.snapshot()
    return {"launches": snap["launches"], "plain": snap["plain"]}


def _key_shard(dpk) -> dict:
    """A sharded key's query points on this rank (the G1 stack and the G2
    tail) and their bytes."""
    g1, g2 = dpk.g1_msm_points, dpk.b_g2_tail
    return {
        "g1_points": int(g1[2].shape[-1] * g1[2].shape[-2]),
        "g2_points": int(g2[2].shape[-1]),
        "bytes": int(sum(x.numel() * x.element_size() for x in (*g1, *g2))),
    }


def rank_calls(device, calls) -> list:
    """Run several rank programs in turn in one launch: calls is a list
    of (fn, args); -> their results."""
    return [fn(device, *args) for fn, args in calls]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rank_mesh_axes(device, shape) -> dict:
    """A make_mesh_2d(*shape) mesh's axes on this rank: -> the sizes
    (axis_size) and, for each axis, this rank's line (global ranks) and
    its index in it."""
    from groth16_tpu_torch.par.mesh import axis_size

    mesh = make_mesh_2d(*shape, device=device)
    keys = (*mesh.axis_names, mesh.axis_names)
    return {
        "sizes": {k: axis_size(mesh, k) for k in keys},
        "lines": {k: (list(mesh.axis(k).ranks), mesh.axis(k).index) for k in keys},
    }


def rank_prove(device, pk, matrices, z, r, s, mesh_shape=None, axis=DATA_AXIS, steady=False) -> dict:
    """One ShardedProver prove (mesh: 1D over every rank, or
    make_mesh_2d(*mesh_shape)); -> the proof and this rank's figures: its
    key shard, the launches and collective traffic of the prove, and on
    the card its peak memory.  steady: prove once more, timed by phase."""
    from groth16_tpu_torch.par.prover_dp import ShardedProver

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    mesh = make_mesh(device=device) if mesh_shape is None else make_mesh_2d(*mesh_shape, device=device)
    t0 = time.perf_counter()
    prover = ShardedProver(pk, matrices, mesh=mesh, axis=axis)
    upload_s = time.perf_counter() - t0
    zero_counts()
    t0 = time.perf_counter()
    proof = prover.prove(z, r, s)
    first_s = time.perf_counter() - t0
    out = {
        "rank": mesh.rank, "index": prover.ax.index, "size": prover.ax.size, "proof": proof,
        "key_shard": _key_shard(prover.dpk), "upload_s": upload_s, "first_prove_s": first_s,
        **read_counts(), "traffic": mesh.traffic_summary(),
    }
    if steady:
        timer = PhaseTimer(verbose=False, device=str(device))
        t0 = time.perf_counter()
        again = prover.prove(z, r, s, timer=timer)
        out.update(steady_prove_s=time.perf_counter() - t0, phases_s=timer.as_dict(), steady_equal=again == proof)
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    return out


def rank_ntt(device, curve, coeffs, reps=0) -> dict:
    """ShardedNtt's four transforms of `coeffs` (ints; n = len) over every
    rank; -> this rank's slices (canonical digits, numpy) and whether each
    equals its slice of NttDomain's transform on this rank.  reps > 0:
    also the milliseconds of a sharded and a single-device fft (host
    clock to a sync, the least of reps)."""
    from groth16_tpu_torch.par.ntt_cp import ShardedNtt

    c = get_curve(curve)
    mesh = make_mesh(device=device)
    domain = NttDomain(c.fr, len(coeffs), device)
    sntt = ShardedNtt(domain, mesh)
    spec = domain.spec
    a = torch.from_numpy(encode(list(coeffs), spec).astype(np.int32)).to(device)
    mine = shard_elements(mesh, a)
    out = {"local": {}, "equal_single": {}}
    for name in ("fft", "ifft", "coset_fft", "coset_ifft"):
        got = fp.normalize(spec, getattr(sntt, name)(mine), bound_k=2)
        want = shard_elements(mesh, fp.normalize(spec, getattr(domain, name)(a), bound_k=2))
        out["local"][name] = got.cpu().numpy()
        out["equal_single"][name] = bool(torch.equal(got, want))
    if reps:
        for key, fn, x in (("sharded_fft_ms", sntt.fft, mine), ("single_fft_ms", domain.fft, a)):
            best = None
            for _ in range(reps):
                _sync(device)
                t0 = time.perf_counter()
                fn(x)
                _sync(device)
                dt = (time.perf_counter() - t0) * 1e3
                best = dt if best is None else min(best, dt)
            out[key] = best
    return out


def rank_msm(device, curve, points, scalars, lanes=2) -> list:
    """msm_sharded_lanes of `lanes` copies of one G1 MSM (affine points,
    int scalars) over every rank; -> the lanes' affine sums."""
    from groth16_tpu_torch.par.prover_dp import msm_sharded_lanes

    c = get_curve(curve)
    g = codec.g1_ops(c)
    mesh = make_mesh(device=device)
    pts = tuple(torch.stack([x] * lanes, dim=-2) for x in codec.g1_to_device(c, points, device))
    sc = codec.scalars_to_device(scalars, make_spec(c.r), device)
    sc = torch.stack([sc] * lanes, dim=0)
    acc = msm_sharded_lanes(g, shard_elements(mesh, pts), shard_elements(mesh, sc), c.r.bit_length(), mesh)
    return codec.g1_from_device(c, g, acc)


def rank_key_msm(device, pk, matrices, z) -> dict:
    """The sharded prove's 4-lane G1 MSM (msm_sharded_lanes on this
    rank's slice of the stacked key, the prove's scalars) against
    msm_device_lanes of the whole stack on this rank, as affine points."""
    from groth16_tpu_torch.par.prover_dp import ShardedProver, _g1_scalar_stack, msm_sharded_lanes
    from groth16_tpu_torch.par.collectives import all_gather_leaves
    from groth16_tpu_torch.protocol.device_keys import upload_proving_key

    prover = ShardedProver(pk, matrices, mesh=make_mesh(device=device))
    c, dpk = prover.c, prover.dpk
    g = codec.g1_ops(c)
    z_mont = prover.encode_assignment(z)
    mine, _ = _g1_scalar_stack(prover.fr, prover.sntt, prover.mesh, prover.axis, dpk, z_mont, dpk.num_inputs)
    sharded = msm_sharded_lanes(g, dpk.g1_msm_points, mine, c.r.bit_length(), prover.mesh)
    (every,) = all_gather_leaves([mine], prover.ax)  # [S, 4, Ls, n_pad/S]
    whole_sc = every.movedim(0, -2).reshape(every.shape[1], every.shape[2], -1).contiguous()
    whole = upload_proving_key(pk, matrices, device, pad_multiple=prover.ax.size, layout="stacked")
    single = msm_device_lanes(g, whole.g1_msm_points, whole_sc, c.r.bit_length())
    got, want = codec.g1_from_device(c, g, sharded), codec.g1_from_device(c, g, single)
    return {"lanes": len(got), "points_per_rank": int(mine.shape[-1]), "equal_affine": got == want}


@dataclasses.dataclass
class InjectedFault:
    """ElasticProver.fault_hook of the tests: at the attempts `at` (None:
    every one), "sdc" returns the proof with A's x moved by one, "loss"
    raises as a lost device would."""

    kind: str
    at: tuple = (0,)

    def __call__(self, attempt, proof):
        if self.at is not None and attempt not in self.at:
            return proof
        if self.kind == "loss":
            raise RuntimeError("CUDA error: device lost (injected)")
        ax, ay = proof.a
        return dataclasses.replace(proof, a=((ax + 1) % get_curve(proof.curve).p, ay))


def rank_elastic(device, pk, matrices, z, r, s, scenarios) -> list:
    """ElasticProver.prove_checked once a scenario: (fault, max_attempts,
    localize) with fault None or an InjectedFault; -> for each, the proof
    (None where it raised), the report, the error, the ranks proving at
    the end, and localize_faults' shards where asked (on the final mesh)."""
    from groth16_tpu_torch.par.elastic import ElasticProver, ProverFaultError, localize_faults

    out = []
    for fault, max_attempts, localize in scenarios:
        ep = ElasticProver(pk, matrices, max_attempts=max_attempts, fault_hook=fault, device=device)
        res = {"proof": None, "report": None, "error": None}
        try:
            res["proof"], res["report"] = ep.prove_checked(z, r, s)
        except ProverFaultError as e:
            res["error"] = str(e)
        res["n_devices"] = ep.n_devices
        if localize and ep._prover is not None:
            res["faults"] = localize_faults(ep._prover, z, passes=3)
        out.append(res)
    return out


def rank_batch(device, pk, matrices, zs, rs, ss) -> list:
    """prove_batch_sharded of the batch over every rank (the key whole on
    each, grouped layout); -> the B proofs."""
    from groth16_tpu_torch.par.batch_pp import prove_batch_sharded
    from groth16_tpu_torch.protocol.prover_torch import TorchProver

    mesh = make_mesh(device=device)
    return prove_batch_sharded(TorchProver(pk, matrices, device=mesh.device), zs, rs, ss, mesh)


def rank_collectives(device, seed: int, L: int = 3, rows: int = 2, cols: int = 4) -> dict:
    """The four collectives over every rank on inputs made from `seed`
    (the same global arrays on every rank, each rank its part); -> this
    rank's results, for holding against their definitions:
      transpose_a2a   of X[L, rows S, cols S] int32, rows sharded
      gather_tree_reduce under integer addition of int32[5] (rank i's
                      part: V[i])
      psum_field      of bn254 Fr Montgomery digits (rank i's: F[i], 7
                      elements)
      ring_shift      of int32[4] (rank i's: V[i, :4]), offset 1."""
    mesh = make_mesh(device=device)
    ax = mesh.axis(DATA_AXIS)
    S, i = ax.size, ax.index
    rng = np.random.default_rng(seed)
    X = rng.integers(0, 1 << 30, size=(L, rows * S, cols * S), dtype=np.int64).astype(np.int32)
    V = rng.integers(0, 1 << 20, size=(S, 5), dtype=np.int64).astype(np.int32)
    spec = make_spec(get_curve(CURVE).r)
    F = [[int(v) for v in rng.integers(0, 1 << 62, size=7)] for _ in range(S)]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731

    (tsum,) = collectives.gather_tree_reduce(lambda a, b: (a[0] + b[0],), (t(V[i]),), ax)
    psum = collectives.psum_field(spec, t(encode(F[i], spec).astype(np.int32)), ax, S)
    tr = collectives.transpose_a2a(t(X[:, rows * i : rows * (i + 1)]), ax)
    return {
        "X": X, "V": V, "F": F,
        "transpose": tr.cpu().numpy(), "transpose_contiguous": tr.is_contiguous(),
        "tree_sum": tsum.cpu().numpy(),
        "psum": decode(psum.cpu().numpy(), spec),
        "ring": collectives.ring_shift(t(V[i, :4]), ax, S, 1).cpu().numpy(),
        "traffic": mesh.traffic_summary(),
    }


def _dryrun_rank(device, pk, matrices, z, r, s) -> dict:
    from groth16_tpu_torch.par.prover_dp import ShardedProver
    from groth16_tpu_torch.protocol.verifier import prepare_verifying_key, verify_proof

    proof = ShardedProver(pk, matrices, mesh=make_mesh(device=device)).prove(z, r, s)
    return {"proof": proof, "verified": verify_proof(prepare_verifying_key(pk.vk), proof, [15])}


def dryrun_multichip(n_devices: int, device="cuda", backend="nccl"):
    """Full sharded prove step over `n_devices` ranks, tiny shapes: the
    exact setup of a DummyCircuit with 2 S^2 - 2 constraints (public
    input 3 * 5 = 15) here, then one ShardedProver prove and a verify on
    every rank; every rank's proof must verify and be the same.  ->
    the proof.  By default one card a rank over NCCL; ranks sharing a
    card take backend="gloo", and device="cpu", backend="gloo" runs them
    on the CPU (as the JAX one runs on virtual CPU devices)."""
    from groth16_tpu_torch.protocol.generator import setup
    from groth16_tpu_torch.r1cs.circuits import DummyCircuit
    from groth16_tpu_torch.r1cs.system import ConstraintSystem, SynthesisMode
    from groth16_tpu_torch.utils.rng import Rng

    c = get_curve(CURVE)
    S = n_devices
    n_constraints = 2 * S * S - 2
    num_vars = max(3, n_constraints // 2)
    pk, _ = setup(DummyCircuit(num_vars, n_constraints), CURVE, Rng(0xE17))
    cs = ConstraintSystem(c.r, mode=SynthesisMode.PROVE)
    DummyCircuit(num_vars, n_constraints, a=3, b=5)(cs)
    if not cs.is_satisfied():
        raise AssertionError("dryrun_multichip: the DummyCircuit is not satisfied")
    got = run_ranks(_dryrun_rank, S, backend, device, pk, cs.to_matrices(), cs.full_assignment(), 777, 888)
    if not all(g["verified"] for g in got):
        raise AssertionError("dryrun_multichip: a rank's sharded proof failed verification")
    if any(g["proof"] != got[0]["proof"] for g in got):
        raise AssertionError("dryrun_multichip: the ranks' proofs differ")
    print(f"dryrun_multichip({n_devices}): sharded prove + verify OK", flush=True)
    return got[0]["proof"]
