"""Fixed-base batch scalar multiplication on the device (the setup hot loop).

Port of `groth16_tpu/msm/fixed_base.py`, the counterpart of
`ark-ec::scalar_mul::BatchMulPreprocessing` (generator.rs:129-183): a
shared window table of the base point, then per-scalar table lookups.

Table build: row w is the inclusive prefix scan of B = 2^c copies of
base_w = 2^{cw} * base (msm/scans.py scan_points).  The JAX package scans
one row at a time, taking the next row's base from the scan's last element
(B * base_w); here the caller gives every base_w (a few host doublings) and
ONE scan runs all rows as a batch, so the build costs the launches of one
scan instead of one scan per window.

batch_mul: one step per window, each an [N]-wide gather from the table row
and one N-wide point addition -- one K4 (G1) or K5 (G2) launch over the
whole batch on the card.  Digit 0 gathers the infinity slot, so there are
no special cases.
"""

from __future__ import annotations

import torch

from groth16_tpu_torch.curves.point import CurveDevice, Point
from groth16_tpu_torch.msm.pippenger import all_window_digits
from groth16_tpu_torch.msm.scans import scan_points


def window_bases(add, base, c: int, num_windows: int) -> list:
    """[2^{cw} * base for w < num_windows] with an exact group addition
    `add` (e.g. RefGroups.g1_add): c doublings per window."""
    out = [base]
    for _ in range(num_windows - 1):
        b = out[-1]
        for _ in range(c):
            b = add(b, b)
        out.append(b)
    return out


def build_window_table(g: CurveDevice, bases: Point, c: int) -> Point:
    """Table[w, d] = d * bases[w], coordinates [*coords, num_windows, 2^c].

    bases: a [num_windows] batch of projective points, bases[w] =
    2^{cw} * base (window_bases)."""
    B = 1 << c
    reps = tuple(x[..., None].expand(x.shape + (B,)).contiguous() for x in bases)
    scan = scan_points(g, reps)  # [W, B]: 1*b_w .. B*b_w
    inf = g.infinity(g.batch_shape(bases) + (1,), device=bases[0].device)
    return tuple(torch.cat([z, s[..., :-1]], dim=-1) for z, s in zip(inf, scan))


def batch_mul_device(g: CurveDevice, table: Point, scalars: torch.Tensor, c: int, scalar_bits: int) -> Point:
    """[s * base for s in scalars] from a prebuilt window table.

    scalars: int32[Ls, N] standard-form 15-bit digits.  Returns [N]
    projective points (g.to_affine converts them)."""
    num_windows = table[2].shape[-2]
    digits = all_window_digits(scalars, c, scalar_bits).long()
    if digits.shape[0] != num_windows:
        raise ValueError(f"table has {num_windows} windows, the scalars need {digits.shape[0]}")
    acc = g.infinity((scalars.shape[-1],), device=scalars.device)
    for w in range(num_windows):
        row = tuple(x[..., w, :] for x in table)
        acc = g.add(acc, g.index(row, digits[w]))
    return acc
