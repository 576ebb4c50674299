"""The port's Horner entry and K4/K5 launch bookkeeping on the CPU.

`CurveDevice.horner` (curves/cuda_point.py horner_g1/horner_g2: one
kernel launch on the card, its plain loop of additions on CPU tensors)
against the JAX package's exact engine (groth16_tpu.ref) on a few window
sums at c = 4 and 5, bn254 G1 (two lanes) and G2: sum_w 2^(c w) S_w.
Tolerance: the same points, compared projectively (X = x Z, Y = y Z mod
p; Z = 0 exactly at infinity), as after conversion to affine.  Then the
size classes of the launch histogram and the wrappers' dispatch of CPU
tensors to their plain versions."""

import random

import pytest
import torch

from groth16_tpu.curves.params import get_curve
from groth16_tpu.ref.curve import RefGroups
from groth16_tpu_torch.curves import codec, cuda_point
from groth16_tpu_torch.fields.spec import decode, make_spec

torch.set_num_threads(1)

CURVE = "bn254"


def _same_points(g, pt, want):
    """Device projective points [*coords, n] equal the exact affine points
    `want` (None at infinity)."""
    k = g.k
    spec, D = k.spec, k.tower_deg
    p = spec.modulus

    def ints(t):  # [L, (D,) n] -> one D-tuple per point
        t = t.reshape(spec.n_limbs, D, -1).numpy()
        return list(zip(*[decode(t[:, d], spec, mont=False) for d in range(D)]))

    def mul(a, b):
        if D == 1:
            return (a[0] * b[0] % p,)
        return ((a[0] * b[0] + k.nonresidue * a[1] * b[1]) % p, (a[0] * b[1] + a[1] * b[0]) % p)

    def tup(v):
        return v if isinstance(v, tuple) else (v,)

    X, Y, Z = (ints(x) for x in pt)
    assert [not any(v % p for v in z) for z in Z] == [w is None for w in want]
    for x, y, z, w in zip(X, Y, Z, want):
        if w is not None:
            assert tuple(v % p for v in x) == mul(tup(w[0]), z)
            assert tuple(v % p for v in y) == mul(tup(w[1]), z)


@pytest.mark.parametrize("group,lanes,windows,c", [("g1", 2, 3, 4), ("g2", 1, 2, 5)])
def test_horner_plain_matches_exact(group, lanes, windows, c):
    """Window sums [lanes, W] (one of them infinity) -> sum_w 2^(c w) S_w
    for each lane, through CurveDevice.horner on CPU tensors."""
    curve = get_curve(CURVE)
    ref = RefGroups(CURVE)
    g2 = group == "g2"
    r = random.Random(41)
    if g2:
        base, mul, add = ref.g2_sample(1), ref.g2_mul, ref.g2_add
        g, to_dev = codec.g2_ops(curve), codec.g2_to_device
    else:
        base, mul, add = ref.g1_sample(5), ref.g1_mul, ref.g1_add
        g, to_dev = codec.g1_ops(curve), codec.g1_to_device
    sums = [[mul(base, r.randrange(1, ref.c.r)) for _ in range(windows)] for _ in range(lanes)]
    sums[0][windows - 1] = None  # an infinity window sum (the padded top windows)
    flat = to_dev(curve, [s for lane in sums for s in lane], "cpu")
    dev = tuple(x.reshape(x.shape[:-1] + (lanes, windows)) for x in flat)
    got = g.horner(dev, c)
    want = []
    for lane in sums:
        acc = None
        for w, s in enumerate(lane):
            acc = add(acc, mul(s, 1 << (c * w)) if s is not None else None)
        want.append(acc)
    _same_points(g, got, want)


def test_launch_sizes_and_cpu_dispatch():
    """The size classes of the K4/K5 launch histogram; on CPU tensors K4
    and Horner run their plain versions (sums of infinity are infinity)
    and count no kernel launch and no plain call on the card."""
    assert [cuda_point.size_class(n) for n in (1, 4, 5, 4096, 4097)] == [
        "1-4", "1-4", "5-4096", "5-4096", ">4096"
    ]
    spec = make_spec(get_curve(CURVE).p)
    g = codec.g1_ops(get_curve(CURVE))
    pt = g.infinity((2,))
    counts = (dict(cuda_point.LAUNCHES), dict(cuda_point.PLAIN_CALLS), dict(cuda_point.LARGEST_LAUNCH))
    assert bool(g.is_infinity(cuda_point.add_g1(spec, g.b3_val, pt, pt)).all())
    sums = tuple(x.reshape(x.shape[:-1] + (1, 2)) for x in pt)
    assert bool(g.is_infinity(g.horner(sums, 3)).all())
    assert (dict(cuda_point.LAUNCHES), dict(cuda_point.PLAIN_CALLS), dict(cuda_point.LARGEST_LAUNCH)) == counts
