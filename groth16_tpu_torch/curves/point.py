"""Complete projective point arithmetic on limb tensors (PyTorch).

Port of `groth16_tpu/curves/point.py:CurveDevice`.  One class serves G1
(coords = FpOps) and G2 (coords = Fp2Ops, or Fp3Ops for MNT6-298).
Additions use the Renes-Costello-Batina complete laws (eprint
2015/1060): one straight-line formula covers generic addition, doubling,
inverses and infinity (0 : 1 : 0) for every point of the prime-order
subgroup; algorithm 7 for a = 0 (BN, BLS12, BW6), algorithm 1 for the
MNT families' a != 0.

Data model: a batch of points is (X, Y, Z) limb tensors with a shared
batch shape; coordinate (limb/tower) axes LEAD and batch axes TRAIL;
coordinates hold values in [0, 2p) with exact digits.

`add` and `add_affine` flatten the broadcast batch and go through the
wrappers of curves/cuda_point.py, which dispatch by device: the CUDA
kernels K4/K5 and K6/K7 on the card, their plain versions on the CPU;
`horner` runs an MSM's Horner chain in one launch.
The TPU size gates of the JAX package have no counterpart here: the
kernels mask their own ragged edge.  `to_affine` inverts every Z of a
batch with one Fermat inverse (fields/fp.py batch_inv, K1 products).
`scalar_mul_bits` runs each lane's scalar multiplication in one launch
of the scalar-multiplication kernel (fixed windows on Horner's doubling
and addition programs; its plain version on the CPU).  Where a != 0,
`add` runs the generic-a group kernel, `horner` and `scalar_mul_bits`
the generic-a programs, and `add_affine` and
`capture_step` the group kernel's capture step: the full addition of the
projective point it rebuilds from the affine row in registers, as the
JAX package adds the rebuilt point (it has no mixed generic-a formula).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from groth16_tpu_torch.curves import cuda_point
from groth16_tpu_torch.fields.fp import broadcast_shapes
from groth16_tpu_torch.fields.ops import _bbc

Point = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (X, Y, Z)


class CurveDevice:
    def __init__(self, k, b3, a=0):
        """k: FpOps | Fp2Ops | Fp3Ops; b3: 3*b curve constant (int or tower
        tuple); a: curve coefficient (int or tower tuple; != 0 for MNT)."""
        self.k = k
        self.b3_val = b3
        self.a_val = a
        self.a_is_zero = cuda_point.a_is_zero(a)

    # -- constructors --------------------------------------------------------

    def infinity(self, shape=(), device="cpu") -> Point:
        k = self.k
        return (
            k.zero(shape, device=device),
            k.one(shape, device=device).contiguous(),
            k.zero(shape, device=device),
        )

    def from_affine(self, x, y, inf_mask=None) -> Point:
        """(x, y) limb tensors (+ optional bool infinity mask) -> projective."""
        k = self.k
        shape = x.shape[k.coord_ndim :]
        z = k.one(shape, device=x.device)
        if inf_mask is not None:
            zero = k.zero(shape, device=x.device)
            x = k.select(inf_mask, zero, x)
            y = k.select(inf_mask, k.one(shape, device=x.device), y)
            z = k.select(inf_mask, zero, z)
        return (x, y, z.contiguous())

    def batch_shape(self, pt: Point):
        return tuple(pt[2].shape[self.k.coord_ndim :])

    # -- predicates / selects ------------------------------------------------

    def is_infinity(self, pt: Point):
        return self.k.is_zero(pt[2], bound_k=2)

    def select(self, mask, a: Point, b: Point) -> Point:
        k = self.k
        return tuple(k.select(mask, x, y) for x, y in zip(a, b))

    def index(self, pt: Point, idx) -> Point:
        """Select along the trailing batch axis (`c[..., idx]`)."""
        return tuple(c[..., idx] for c in pt)

    # -- group law -----------------------------------------------------------

    def neg(self, pt: Point) -> Point:
        return (pt[0], self.k.neg(pt[1], k=2), pt[2])

    def _flat(self, coords):
        """Broadcast coordinates to one batch shape and flatten it:
        -> (contiguous [*coords, n] tensors, batch shape)."""
        cd = self.k.coord_ndim
        shape = broadcast_shapes(*[tuple(x.shape[cd:]) for x in coords])
        n = math.prod(shape)
        out = [
            _bbc(x, cd, shape).reshape(tuple(x.shape[:cd]) + (n,)).contiguous()
            for x in coords
        ]
        return out, tuple(shape)

    def _unflat(self, out, shape) -> Point:
        cd = self.k.coord_ndim
        return tuple(x.reshape(tuple(x.shape[:cd]) + shape) for x in out)

    def add(self, p1: Point, p2: Point) -> Point:
        """Complete addition (RCB a = 0, or the generic-a law).
        Inputs/outputs: coords < 2p exact.  K4 (G1) / K5 (G2) on CUDA
        tensors."""
        k = self.k
        flat, shape = self._flat(list(p1) + list(p2))
        if k.tower_deg == 1:
            out = cuda_point.add_g1(k.spec, self.b3_val, flat[:3], flat[3:], self.a_val)
        else:
            out = cuda_point.add_g2(
                k.spec, k.nr_int, self.b3_val, flat[:3], flat[3:], self.a_val, k.tower_deg
            )
        return self._unflat(out, shape)

    def horner(self, sums: Point, c: int) -> Point:
        """sum_w 2^(c w) sums[.., w] for each lane of window sums with
        batch (lanes, W), window 0 first: one Horner kernel launch on CUDA
        tensors (c doublings and one add a window, from the top), its
        plain loop of additions on CPU tensors."""
        sums = tuple(x.contiguous() for x in sums)
        k = self.k
        if k.tower_deg == 1:
            return cuda_point.horner_g1(k.spec, self.b3_val, sums, c, self.a_val)
        return cuda_point.horner_g2(k.spec, k.nr_int, self.b3_val, sums, c, self.a_val, k.tower_deg)

    def add_affine(self, p1: Point, xy2) -> Point:
        """p1 + affine (x2, y2) with infinity encoded (0, 0) — the MSM
        suffix-scan hot op.  K6 (G1) / K7 (G2) on CUDA tensors; on CPU
        tensors their plain version (the same 13-product mixed formula;
        equal mod p to the complete add of the reconstructed projective
        point, representatives may differ within < 2p).  Where a != 0:
        the capture step without a capture (the full addition of the
        projective point rebuilt in registers, the JAX package's path)."""
        k = self.k
        flat, shape = self._flat(list(p1) + list(xy2))
        if not self.a_is_zero:
            out, _ = self.capture_step(tuple(flat[:3]), tuple(flat[3:]))
            return self._unflat(out, shape)
        if k.tower_deg == 1:
            out = cuda_point.add_mixed_g1(k.spec, self.b3_val, flat[:3], flat[3:])
        else:
            out = cuda_point.add_mixed_g2(
                k.spec, k.nr_int, self.b3_val, flat[:3], flat[3:]
            )
        return self._unflat(out, shape)

    def capture_step(self, acc: Point, xy, cap=None, jk=None, src=None, k_prev: int = -1, add: bool = True):
        """One step of the capture scan where a != 0, on flat [*coords, n]
        points: acc + the affine row xy (infinity (0, 0)) where `add`, and
        cap[t] = acc[src[t]] for the targets with jk[t] == k_prev (the
        step before's captures, read from this step's input), in one
        launch of the generic-a group kernel on CUDA tensors (cap written
        in place).  Returns (acc', cap')."""
        k = self.k
        if k.tower_deg == 1:
            return cuda_point.capture_step_g1(k.spec, self.b3_val, self.a_val, acc, xy, cap, jk, src, k_prev, add)
        return cuda_point.capture_step_g2(
            k.spec, k.nr_int, self.b3_val, self.a_val, acc, xy, cap, jk, src, k_prev, add, k.tower_deg
        )

    def scalar_mul_bits(self, pt: Point, bits: torch.Tensor) -> Point:
        """Per-lane variable scalar multiplication: bits int32 [*batch,
        nbits] little-endian.  Fixed windows of c bits, most significant
        first (cuda_point.scalar_mul_g1/g2: a table of j P, the top
        non-zero digit's entry, then c doublings and an addition of the
        digit's entry where it is not zero, a window) in one kernel launch
        on CUDA tensors, its plain version on CPU tensors; the same digits
        either way, and the same points mod p as the JAX package's select
        loop (other representatives)."""
        k = self.k
        flat, shape = self._flat(list(pt))
        n = flat[0].shape[-1]
        bits = bits.reshape(n, bits.shape[-1]).to(torch.int32).contiguous()
        if k.tower_deg == 1:
            out = cuda_point.scalar_mul_g1(k.spec, self.b3_val, flat, bits, self.a_val)
        else:
            out = cuda_point.scalar_mul_g2(
                k.spec, k.nr_int, self.b3_val, flat, bits, self.a_val, k.tower_deg
            )
        return self._unflat(out, shape)

    # -- conversions -------------------------------------------------------------

    def to_affine(self, pt: Point):
        """Batch projective -> affine: (x, y, inf_mask), x and y < 2p in
        Montgomery form, (0, 0) at infinity.  One batched Fermat inverse
        of the Z's (the analog of arkworks' `into_affine` batch
        normalization, prover.rs:127-130)."""
        k = self.k
        X, Y, Z = pt
        shape = self.batch_shape(pt)
        dev = Z.device
        inf = self.is_infinity(pt)
        zsafe = k.select(inf, k.one(shape, device=dev), Z)
        zinv = k.batch_inv(zsafe) if shape else k.inv(zsafe)
        x, y = k.mul_many([(X, zinv), (Y, zinv)])
        zero = k.zero(shape, device=dev)
        return k.select(inf, zero, x), k.select(inf, zero, y), inf

    # -- reductions ------------------------------------------------------------

    def tree_reduce(self, pt: Point) -> Point:
        """Sum an [N]-batch of points down to a single point: log2(N)
        rounds of halving adds (N padded to a power of two with
        infinities)."""
        n = pt[2].shape[-1]
        m = 1
        while m < n:
            m <<= 1
        if m != n:
            pad = self.infinity(self.batch_shape(pt)[:-1] + (m - n,), device=pt[0].device)
            pt = tuple(torch.cat([c, p], dim=-1) for c, p in zip(pt, pad))
        while m > 1:
            h = m // 2
            pt = self.add(self.index(pt, slice(0, h)), self.index(pt, slice(h, m)))
            m = h
        return self.index(pt, 0)
