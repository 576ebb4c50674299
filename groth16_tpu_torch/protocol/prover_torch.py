"""Device prover (PyTorch): witness map and MSMs on the device, O(1)
assembly on the host or on the device.

Port of `groth16_tpu/protocol/prover_tpu.py:TpuProver` (prove,
prove_encoded_host, prove_encoded, prove_batch, encode_assignment) and
of its device assembly (`_assembly_jit`) and `decode_proof_arrays`.  A
prove runs four phases, with the JAX package's names:

  witness_map  sparse matvecs + 7 NTTs -> h, then standard-form MSM
               scalars (qap/device.py; K1 for every Fr product)
  msm_g1_x4    the four G1 MSMs, lane-batched per size class
               (msm/pippenger.py; K2 for the bucket scans, K4 in the
               tails; K6 per scan step with msm_fused_scan=False)
  msm_g2       the G2 MSM (K3, K5; K7 on the capture path)
  assembly     the O(1) group-op tail of prover.rs:54-132: on the host's
               exact engine (protocol/prover.py) from the five MSM
               accumulators fetched in one copy (`prove`,
               `prove_encoded_host`, `prove_batch`), or on the device
               (`assembly_phase`: the r, s and rs multiples in three
               launches of the scalar-multiplication kernel, the sums by
               K4/K5, to_affine by K1), whose six tensors stay there
               until `decode_proof_arrays` fetches them in one copy
               (`prove(host_assembly=False)`, `prove_encoded`,
               par/batch_pp.ProofStream)

`prove_batch` enqueues the witness map and MSMs of every proof before
the first fetch: nothing on that stretch waits for the card (the
assignments go up from pinned buffers), so the host encodes proof i + 1
while the card works on proof i.  The prover runs on the card unless the
caller passes device="cpu" (where every kernel runs its plain version).

Spans (utils/profiling.span; recorded only inside `profiling.tracing`):
`encode` (encode_assignment), the four phases above, `fetch` (the one
blocking device-to-host copy), and below them `matvec`
(qap/device.sparse_matvec) and `ntt` (ntt/ntt.NttDomain.fft, .ifft).
`upload` counts the bytes it sends in TRANSFERS["h2d_bytes"].
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from groth16_tpu_torch.config import resolve_device
from groth16_tpu_torch.curves import codec
from groth16_tpu_torch.curves.params import get_curve
from groth16_tpu_torch.fields import fp
from groth16_tpu_torch.fields.spec import decode, encode, make_spec
from groth16_tpu_torch.msm.pippenger import msm_device, msm_device_lanes
from groth16_tpu_torch.protocol.data_structures import Proof, ProvingKey
from groth16_tpu_torch.protocol.device_keys import DeviceProvingKey, upload_proving_key
from groth16_tpu_torch.qap.device import witness_map_device
from groth16_tpu_torch.r1cs.matrices import ConstraintMatrices
from groth16_tpu_torch.utils import profiling

# bytes handed to `upload`, on every device (utils/profiling.snapshot)
TRANSFERS = {"h2d_bytes": 0}


def upload(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on `device` without waiting for the card: on CUDA the
    copy runs from a pinned buffer, queued on the current stream behind
    the work already there.  PyTorch's caching host allocator records an
    event on the stream for each such copy and keeps the pinned block
    from reuse until it has passed, so the buffer outlives its copy."""
    TRANSFERS["h2d_bytes"] += host.numel() * host.element_size()
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def scalar_bits(values: Sequence[int], device) -> torch.Tensor:
    """Host ints -> int32 [len(values), nbits] little-endian bits on
    `device` (the JAX package's `scalar_bits_array`, one row a scalar).
    nbits is the longest value's bit length: the scalar multiplication
    starts each lane at its top non-zero window digit, and zero bits above
    every value's top only add zero digits above it (the windows are cut
    from bit 0 up), so the digits equal those of the curve order's full
    width."""
    nbits = max(1, max(v.bit_length() for v in values))
    bits = np.array([[(v >> i) & 1 for i in range(nbits)] for v in values], dtype=np.int32)
    return upload(torch.from_numpy(bits), torch.device(device))


def fetch(tensors) -> list:
    """numpy copies of device tensors in ONE device-to-host copy (bool
    tensors come back as bool)."""
    tensors = list(tensors)
    with profiling.span("fetch"):
        flat = torch.cat([x.reshape(-1).to(torch.int32) for x in tensors]).cpu().numpy()
    out, off = [], 0
    for x in tensors:
        part = flat[off : off + x.numel()].reshape(tuple(x.shape))
        out.append(part.astype(bool) if x.dtype == torch.bool else part)
        off += x.numel()
    return out


def _pad_scalars(s: torch.Tensor, n_pad: int) -> torch.Tensor:
    n = s.shape[-1]
    if n == n_pad:
        return s
    return torch.nn.functional.pad(s, (0, n_pad - n))


def _group_scalars(dpk: DeviceProvingKey, rho_std, h_std, aux_std):
    """Per-size-class scalar stacks matching dpk.g1_groups."""
    srcs = [
        rho_std[:, : dpk.nv_tail],
        rho_std[:, : dpk.nv_tail],
        h_std[:, : dpk.n_h],
        aux_std[:, : dpk.n_aux],
    ]
    return tuple(
        torch.stack([_pad_scalars(srcs[i], npad_g) for i in lane_ids], dim=0)
        for npad_g, lane_ids in dpk.g1_group_info
    )


def witness_phase(dpk: DeviceProvingKey, z_mont: torch.Tensor):
    """Phase 1: witness map + standard-form scalar prep."""
    fr = dpk.fr_spec
    h_mont = witness_map_device(
        fr, dpk.domain, dpk.mats, z_mont, dpk.num_inputs, dpk.num_constraints
    )
    h_std = fp.from_mont(fr, h_mont)
    z_std = fp.from_mont(fr, z_mont)
    rho_std = z_std[:, 1:]
    aux_std = z_std[:, dpk.num_inputs :]
    return _group_scalars(dpk, rho_std, h_std, aux_std), rho_std


def msm_g1_phase(dpk: DeviceProvingKey, scalars_g):
    """Phase 2a: the 4 G1 query MSMs — a_query[1:], b_g1_query[1:],
    h_query (zip-truncated to n-1), l_query — one lane-batched MSM per
    size class.  Returns the accumulators stacked in canonical lane
    order ([..., 4])."""
    c = dpk.params
    g1 = codec.g1_ops(c)
    sbits = c.r.bit_length()
    by_lane = [None] * 4
    for (_, lane_ids), pts, sc in zip(dpk.g1_group_info, dpk.g1_groups, scalars_g):
        acc = msm_device_lanes(g1, pts, sc, sbits)
        for j, lane in enumerate(lane_ids):
            by_lane[lane] = tuple(x[..., j] for x in acc)
    return tuple(torch.stack([by_lane[i][k] for i in range(4)], dim=-1) for k in range(3))


def msm_g2_phase(dpk: DeviceProvingKey, rho_std: torch.Tensor):
    """Phase 2b: the G2 MSM (b_g2_query tail)."""
    c = dpk.params
    return msm_device(codec.g2_ops(c), dpk.b_g2_tail, rho_std, c.r.bit_length())


def assembly_phase(dpk: DeviceProvingKey, acc4, b2_acc, bits: torch.Tensor):
    """Phase 3 on the device (`_assembly_jit`, prover.rs:54-132) and
    to_affine; bits: int32 [3, nbits] rows r, s, rs (`scalar_bits`).
    Returns (ax, ay, ainf, bx, by, binf): A and C as the two lanes of one
    G1 batch, B as a one-lane G2 batch, x and y < 2p in Montgomery form."""
    c = dpk.params
    g1 = codec.g1_ops(c)
    g2 = codec.g2_ops(c)
    a_acc, b1_acc, h_acc, l_aux_acc = (g1.index(acc4, i) for i in range(4))

    # batched O(1) scalar muls: [r, s, rs] * delta_g1, one launch
    delta3 = tuple(torch.stack([x, x, x], dim=-1) for x in dpk.delta_g1)
    rsd = g1.scalar_mul_bits(delta3, bits)
    r_delta, s_delta, rs_delta = (g1.index(rsd, i) for i in range(3))

    # calculate_coeff (prover.rs:252-270) for A, B1; B2 in G2
    def finish(initial, q0, acc, vk_param):
        res = g1.add(initial, q0)
        res = g1.add(res, acc)
        return g1.add(res, vk_param)

    g_a = finish(r_delta, dpk.a0, a_acc, dpk.alpha_g1)
    g1_b = finish(s_delta, dpk.b10, b1_acc, dpk.beta_g1)

    s_delta_g2 = g2.scalar_mul_bits(dpk.delta_g2, bits[1])
    g2_b = g2.add(g2.add(g2.add(s_delta_g2, dpk.b20), b2_acc), dpk.beta_g2)

    # s*A and r*B1, batched; r == 0 makes r*B1 infinity (prover.rs:98-108)
    ab = tuple(torch.stack([x, y], dim=-1) for x, y in zip(g_a, g1_b))
    sab = g1.scalar_mul_bits(ab, torch.stack([bits[1], bits[0]]))
    s_g_a, r_g1_b = g1.index(sab, 0), g1.index(sab, 1)

    g_c = g1.add(s_g_a, r_g1_b)
    g_c = g1.add(g_c, g1.neg(rs_delta))
    g_c = g1.add(g_c, l_aux_acc)
    g_c = g1.add(g_c, h_acc)

    # A and C share one G1 batch inversion
    ac = tuple(torch.stack([x, y], dim=-1) for x, y in zip(g_a, g_c))
    ax, ay, ainf = g1.to_affine(ac)
    bx, by, binf = g2.to_affine(tuple(x[..., None] for x in g2_b))
    return (ax, ay, ainf, bx, by, binf)


def msm_phases(dpk: DeviceProvingKey, z_mont: torch.Tensor, timer=None):
    """Phases 1-2 (witness map | MSMs) -> the G1 accumulators ([..., 4])
    and the G2 one, left on the device.  timer: optional
    utils.profiling.PhaseTimer; each phase is then fenced and timed."""
    with profiling.span("witness_map", timer):
        scalars_g, rho_std = witness_phase(dpk, z_mont)
    with profiling.span("msm_g1_x4", timer):
        acc4 = msm_g1_phase(dpk, scalars_g)
    with profiling.span("msm_g2", timer):
        b2_acc = msm_g2_phase(dpk, rho_std)
    return acc4, b2_acc


def prove_phases(dpk: DeviceProvingKey, z_mont: torch.Tensor, bits: torch.Tensor, timer=None):
    """The full prove on the device, every intermediate left there; ->
    assembly_phase's six tensors (timer as for msm_phases)."""
    acc4, b2_acc = msm_phases(dpk, z_mont, timer)
    with profiling.span("assembly", timer):
        return assembly_phase(dpk, acc4, b2_acc, bits)


def decode_proof_arrays(curve: str, out) -> Proof:
    """(ax, ay, ainf, bx, by, binf) of assembly_phase -> host Proof, the
    six tensors fetched in one copy."""
    c = get_curve(curve)
    ax, ay, ainf, bx, by, binf = fetch(out)
    spec = make_spec(c.p, name=f"{curve}.Fq")
    xs, ys = decode(ax, spec), decode(ay, spec)
    a_pt = None if ainf[0] else (xs[0], ys[0])
    c_pt = None if ainf[1] else (xs[1], ys[1])
    # bx/by: [L, d, 1] (G2 over Fq2 or Fq3) or [L, 1] (G2 over Fq)
    bx_v, by_v = decode(bx, spec), decode(by, spec)
    if binf[0]:
        b_pt = None
    elif c.g2_over_base:
        b_pt = (bx_v[0], by_v[0])
    else:
        b_pt = (tuple(bx_v), tuple(by_v))
    return Proof(curve=curve, a=a_pt, b=b_pt, c=c_pt)


def _decode_proj_host(curve: str, ops, coords, idx=None):
    """Host homogeneous-projective (X, Y, Z) limb coords (numpy) -> host
    affine point (or None for infinity)."""
    c = get_curve(curve)
    spec = make_spec(c.p, name=f"{curve}.Fq")
    vals = []
    for coord in coords:
        arr = np.asarray(coord if idx is None else coord[..., idx])
        v = decode(arr, spec)
        vals.append(tuple(v) if len(v) > 1 else v[0])
    X, Y, Z = vals
    k = ops.k
    if k.is_zero(Z):
        return None
    zi = k.inv(Z)
    return (k.mul(X, zi), k.mul(Y, zi))


def _host_assembly_np(pk: ProvingKey, acc4_np, b2_np, r: int, s: int) -> Proof:
    """Phase 3 on the host: the O(1) group-op tail of prover.rs:54-132 on
    the exact engine, from the fetched MSM accumulators."""
    from groth16_tpu_torch.protocol.prover import _ops

    curve = pk.vk.curve
    c = get_curve(curve)
    g1, g2 = _ops(curve)
    a_acc, b1_acc, h_acc, l_acc = (
        _decode_proj_host(curve, g1, acc4_np, i) for i in range(4)
    )
    b2_aff = _decode_proj_host(curve, g2, b2_np)

    delta = g1.from_affine(pk.delta_g1)

    def finish(initial, q0, acc_aff, vk_param):
        res = g1.add(initial, g1.from_affine(q0))
        res = g1.add(res, g1.from_affine(acc_aff))
        return g1.add(res, g1.from_affine(vk_param))

    g_a = finish(g1.scalar_mul(delta, r), pk.a_query[0], a_acc, pk.vk.alpha_g1)
    g1_b = finish(g1.scalar_mul(delta, s), pk.b_g1_query[0], b1_acc, pk.beta_g1)
    s_d2 = g2.scalar_mul(g2.from_affine(pk.vk.delta_g2), s)
    g2_b = g2.add(s_d2, g2.from_affine(pk.b_g2_query[0]))
    g2_b = g2.add(g2_b, g2.from_affine(b2_aff))
    g2_b = g2.add(g2_b, g2.from_affine(pk.vk.beta_g2))

    g_c = g1.add(g1.scalar_mul(g_a, s), g1.scalar_mul(g1_b, r))
    g_c = g1.add(g_c, g1.neg(g1.scalar_mul(delta, (r * s) % c.r)))
    g_c = g1.add(g_c, g1.from_affine(l_acc))
    g_c = g1.add(g_c, g1.from_affine(h_acc))
    return Proof(curve=curve, a=g1.to_affine(g_a), b=g2.to_affine(g2_b), c=g1.to_affine(g_c))


def encode_assignment(fr, full_assignment: List[int], device: torch.device) -> torch.Tensor:
    """The full assignment as int32[L, nv] Montgomery on `device`: host
    limbs in STANDARD form, Montgomery conversion on the device (one wide
    K1 multiply); on the card the upload is queued from a pinned buffer,
    so it does not wait for the work ahead of it."""
    std = encode(list(full_assignment), fr, mont=False).astype(np.int32)
    return fp.to_mont(fr, upload(torch.from_numpy(std), device))


class TorchProver:
    """Per-(pk, circuit-shape) prover; holds the device key mirror."""

    def __init__(self, pk: ProvingKey, matrices: ConstraintMatrices, device="cuda"):
        self.device = resolve_device(device)
        self.pk = pk
        self.curve = pk.vk.curve
        self.c = get_curve(self.curve)
        self.fr = make_spec(self.c.r, name=f"{self.curve}.Fr")
        self.dpk = upload_proving_key(pk, matrices, self.device)

    def encode_assignment(self, full_assignment: List[int]) -> torch.Tensor:
        with profiling.span("encode"):
            return encode_assignment(self.fr, full_assignment, self.device)

    def prove(self, full_assignment: List[int], r: int, s: int, timer=None,
              host_assembly: bool = True) -> Proof:
        with profiling.job():
            z = self.encode_assignment(full_assignment)
            if host_assembly:
                return self.prove_encoded_host(z, r, s, timer=timer)
            return decode_proof_arrays(self.curve, self.prove_encoded(z, r, s, timer=timer))

    def prove_encoded_host(self, z_mont: torch.Tensor, r: int, s: int, timer=None) -> Proof:
        """Device witness map + MSMs, host O(1) assembly: the single-proof
        path, whose accumulator fetch is its only wait for the card.
        timer: optional utils.profiling.PhaseTimer; each phase is then
        fenced and timed."""
        rr = self.c.r
        acc4, b2_acc = msm_phases(self.dpk, z_mont, timer)
        with profiling.span("assembly", timer):
            return self._assemble(acc4, b2_acc, r % rr, s % rr)

    def prove_encoded(self, z_mont: torch.Tensor, r: int, s: int, timer=None):
        """The whole prove on the device, assembly included: returns
        assembly_phase's six tensors without waiting for the card (for
        pipelined callers, par/batch_pp.ProofStream)."""
        rr = self.c.r
        r %= rr
        s %= rr
        bits = scalar_bits([r, s, r * s % rr], self.device)
        return prove_phases(self.dpk, z_mont, bits, timer=timer)

    def dispatch_batch(self, assignments) -> list:
        """Encode, witness map and MSMs of every assignment, all enqueued
        before any result is fetched: -> per proof (acc4, b2_acc) on the
        device.  Nothing here waits for the card."""
        return [msm_phases(self.dpk, self.encode_assignment(z)) for z in assignments]

    def prove_batch(self, assignments, rs, ss) -> List[Proof]:
        """B proofs by pipelined dispatch of the single-prove phases
        (`dispatch_batch`), then ONE copy of all 5B accumulators and the
        host assembly of each proof (_host_assembly_np).  As in the JAX
        package, the device assembly is not used here: the batch's one
        fetch is its only wait for the card anyway, and the host's exact
        arithmetic takes no longer than the device assembly's ~750
        launches (PERF.md)."""
        rr = self.c.r
        B = len(assignments)
        if not len(rs) == len(ss) == B:
            raise ValueError(f"prove_batch: {B} assignments, {len(rs)} r and {len(ss)} s")
        accs = self.dispatch_batch(assignments)
        parts = fetch([x for acc4, b2 in accs for x in acc4 + b2])
        return [
            _host_assembly_np(self.pk, tuple(parts[6 * i : 6 * i + 3]), tuple(parts[6 * i + 3 : 6 * i + 6]),
                              rs[i] % rr, ss[i] % rr)
            for i in range(B)
        ]

    def _assemble(self, acc4, b2_acc, r, s) -> Proof:
        # one device->host copy for all five accumulators
        parts = fetch(acc4 + b2_acc)
        return _host_assembly_np(self.pk, tuple(parts[:3]), tuple(parts[3:]), r, s)
