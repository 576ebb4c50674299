"""Host <-> device codecs for points and scalars.

Port of `groth16_tpu/curves/codec.py`: bridges the exact engine's
representation (ints / (c0, c1) tuples, None for infinity) and the
device structure-of-arrays limb tensors.  Each encoder takes the device
explicitly; decoders convert to affine where the points lie (on the card:
`CurveDevice.to_affine`, one batched inverse through K1) and bring back
standard-form digits.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from groth16_tpu_torch.curves.params import CurveParams
from groth16_tpu_torch.curves.point import CurveDevice, Point
from groth16_tpu_torch.fields import fp
from groth16_tpu_torch.fields.ops import Fp2Ops, Fp3Ops, FpOps
from groth16_tpu_torch.fields.spec import FpSpec, decode, encode, make_spec


def _t(arr: np.ndarray, device) -> torch.Tensor:
    """uint32 digits (< 2^15) -> int32 tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(arr).astype(np.int32)).to(device)


def g1_ops(c: CurveParams) -> CurveDevice:
    return CurveDevice(FpOps(make_spec(c.p, name=f"{c.name}.Fq")), b3=3 * c.b % c.p, a=c.a % c.p)


def g2_ops(c: CurveParams) -> CurveDevice:
    spec = make_spec(c.p, name=f"{c.name}.Fq")
    if c.g2_over_base:
        # bw6-family: G2 over Fq itself — the same Fp point kernels as G1
        return CurveDevice(FpOps(spec), b3=3 * c.b2 % c.p)
    if c.g2_field_degree == 3:
        # MNT6: G2 over Fq3 = Fq[v]/(v^3 - nr), a = (0, 0, a)
        return CurveDevice(
            Fp3Ops(spec, c.fp2_nonresidue),
            b3=tuple(3 * x % c.p for x in c.b2),
            a=getattr(c, "a2", (0, 0, 0)),
        )
    b2_0, b2_1 = c.b2
    return CurveDevice(
        Fp2Ops(spec, c.fp2_nonresidue),
        b3=(3 * b2_0 % c.p, 3 * b2_1 % c.p),
        a=getattr(c, "a2", (0, 0)),
    )


def scalars_to_device(values: Sequence[int], fr_spec: FpSpec, device="cuda") -> torch.Tensor:
    """Standard-form (non-Montgomery) scalar limbs for MSM digit slicing."""
    return _t(encode(list(values), fr_spec, mont=False), device)


def g1_to_device(c: CurveParams, pts: Sequence[Optional[Tuple[int, int]]], device="cuda") -> Point:
    """Affine G1 points -> projective device batch [L, N] (Z = 1; None ->
    (0, 1, 0))."""
    spec = make_spec(c.p, name=f"{c.name}.Fq")
    xs = [p[0] if p is not None else 0 for p in pts]
    ys = [p[1] if p is not None else 1 for p in pts]
    inf = np.array([p is None for p in pts], dtype=bool)
    one = encode([1], spec)  # [L, 1]
    z = np.where(inf[None, :], np.zeros_like(one), one)
    return (_t(encode(xs, spec), device), _t(encode(ys, spec), device), _t(z, device))


def g2_to_device(c: CurveParams, pts, device="cuda") -> Point:
    """Affine G2 points (tower tuples) -> projective device batch [L, d, N]
    for the extension degree d (2; 3 for MNT6)."""
    if c.g2_over_base:
        return g1_to_device(c, pts, device)
    spec = make_spec(c.p, name=f"{c.name}.Fq")
    d = c.g2_field_degree

    def encd(vals):  # list of d-tuples -> [L, d, N]
        flat = [x for v in vals for x in v]
        arr = encode(flat, spec)  # [L, d*N]; column d*i+j = cj_i
        return arr.reshape(spec.n_limbs, len(vals), d).transpose(0, 2, 1)

    zero_t = (0,) * d
    one_t = (1,) + (0,) * (d - 1)
    xs = [p[0] if p is not None else zero_t for p in pts]
    ys = [p[1] if p is not None else one_t for p in pts]
    inf = np.array([p is None for p in pts], dtype=bool)
    one = encode(list(one_t), spec).reshape(spec.n_limbs, d, 1)
    z = np.where(inf[None, None, :], np.zeros_like(one), one)
    return (_t(encd(xs), device), _t(encd(ys), device), _t(z, device))


def _affine_std(g: CurveDevice, pt: Point):
    """Device projective batch -> (x, y) in standard form on the host
    (numpy digits) and the infinity mask: the affine conversion and the
    Montgomery -> standard conversion run on the device (K1 products), so
    the host only unpacks digits."""
    x, y, inf = g.to_affine(pt)
    spec = g.k.spec
    xy = fp.from_mont(spec, torch.stack([x, y], dim=1)).cpu().numpy()
    return xy[:, 0], xy[:, 1], inf.cpu().numpy()


def g1_from_device(c: CurveParams, g: CurveDevice, pt: Point):
    """Device projective batch (or single point) -> list of exact affine
    points (None for infinity)."""
    single = pt[2].dim() == g.k.coord_ndim
    if single:
        pt = tuple(a[..., None] for a in pt)
    x, y, inf = _affine_std(g, pt)
    xs = decode(x.reshape(x.shape[0], -1), g.k.spec, mont=False)
    ys = decode(y.reshape(y.shape[0], -1), g.k.spec, mont=False)
    out = [None if i else (xv, yv) for xv, yv, i in zip(xs, ys, inf.reshape(-1))]
    return out[0] if single else out


def g2_from_device(c: CurveParams, g: CurveDevice, pt: Point):
    if c.g2_over_base:
        return g1_from_device(c, g, pt)
    single = pt[2].dim() == g.k.coord_ndim
    if single:
        pt = tuple(a[..., None] for a in pt)
    x, y, inf = _affine_std(g, pt)  # [L, d, *batch]
    d = g.k.tower_deg

    def dec(a):  # -> per-point coefficient tuples
        a = a.reshape(a.shape[0], d, -1)
        v = decode(np.moveaxis(a, 1, 2), g.k.spec, mont=False)
        return list(zip(*(v[i::d] for i in range(d))))

    out = [None if i else (xv, yv) for xv, yv, i in zip(dec(x), dec(y), inf.reshape(-1))]
    return out[0] if single else out
