"""The generic-a point additions (MNT4-298's a = 2, MNT6-298's a = 11;
RCB algorithm 1) of the port, on the CPU (every kernel's plain version):
`add`, `add_affine`, `horner` and `scalar_mul_bits` on G1 (Fq), MNT4's
G2 (Fq2, nonresidue 17) and MNT6's G2 (Fq3) against the exact engine
`groth16_tpu.ref` (RefGroups), with infinity, P + P and P + (-P) lanes,
compared after conversion to affine (tolerance: equal points mod p); and
one batch of `add` against the JAX package's `CurveDevice._add_general`,
coordinate for coordinate mod p (the port's plain version runs the
generic-a group kernel's order of the same formula, curves/formulas.py,
so each coordinate is the same field element in another representative
below 2p).  Three cases, so pytest-xdist's --dist loadfile hands the file
out after tests/test_gadget.py."""

import random

import numpy as np
import pytest
import torch

from groth16_tpu.curves import codec as jcodec
from groth16_tpu.curves.params import get_curve as jget_curve
from groth16_tpu.ref.curve import RefGroups
from groth16_tpu_torch.curves import codec
from groth16_tpu_torch.curves.params import get_curve
from groth16_tpu_torch.fields import fp

torch.set_num_threads(1)


def _cases(ref, group, seed):
    """(lhs, rhs): random subgroup points, P + P, P + (-P), P + inf,
    inf + P, inf + inf."""
    r = random.Random(seed)
    base = getattr(ref, f"{group}_sample")(3)
    mul, neg = getattr(ref, f"{group}_mul"), getattr(ref, f"{group}_neg")
    pts = [mul(base, r.randrange(1, ref.c.r)) for _ in range(3)]
    lhs = pts + [pts[0], pts[1], pts[2], None, None]
    rhs = pts[::-1] + [pts[0], neg(pts[1]), None, pts[2], None]
    return lhs, rhs


@pytest.mark.parametrize("curve", ["mnt4_298", "mnt6_298"])
def test_generic_a_group_law_matches_ref(curve):
    c, ref = get_curve(curve), RefGroups(curve)
    for group in ("g1", "g2"):
        g = (codec.g2_ops if group == "g2" else codec.g1_ops)(c)
        to = codec.g2_to_device if group == "g2" else codec.g1_to_device
        back = codec.g2_from_device if group == "g2" else codec.g1_from_device
        add, mul = getattr(ref, f"{group}_add"), getattr(ref, f"{group}_mul")
        assert not g.a_is_zero and g.k.tower_deg == (1 if group == "g1" else c.g2_field_degree)
        lhs, rhs = _cases(ref, group, 7)
        want = [add(a, b) for a, b in zip(lhs, rhs)]
        # a projective left operand (Z != 1): 2 * (lhs / 2) through the kernel's law
        half = (c.r + 1) // 2
        p1 = g.add(*(to(c, [None if p is None else mul(p, half) for p in lhs], "cpu"),) * 2)
        assert back(c, g, p1) == lhs
        p2 = to(c, rhs, "cpu")
        assert back(c, g, g.add(p1, p2)) == want
        x2, y2, inf2 = g.to_affine(p2)
        assert back(c, g, g.add_affine(p1, (x2, y2))) == want
        assert inf2.tolist() == [p is None for p in rhs]
        # Horner over 2 lanes of 4 windows, c = 3: sum_w 8^w S_w
        sums = tuple(x.reshape(x.shape[:-1] + (2, 4)).contiguous() for x in g.add(p1, p2))
        flat = want
        hw = []
        for lane in range(2):
            acc = None
            for w in reversed(range(4)):
                acc = add(None if acc is None else mul(acc, 8), flat[4 * lane + w])
            hw.append(acc)
        assert back(c, g, g.horner(sums, 3)) == hw
        # the scalar multiplication: lanes of 5 bits, one of zeros
        bits = torch.tensor([[1, 0, 1, 1, 0], [0] * 5, [1] * 5], dtype=torch.int32)
        pts = tuple(x[..., :3] for x in p1)
        assert back(c, g, g.scalar_mul_bits(pts, bits)) == [mul(lhs[0], 13), None, mul(lhs[2], 31)]


def test_generic_a_add_matches_jax_add_general():
    """One batch of the port's generic-a `add` against the JAX package's
    `CurveDevice._add_general` on MNT4-298's G1 and G2 (Fq2 with the
    nonresidue 17, whose c0 takes a product by the nonresidue) and
    MNT6-298's G2 (Fq3), coordinate for coordinate mod p (both < 2p,
    reduced to [0, p) and compared digit for digit)."""
    for curve, group in (("mnt4_298", "g1"), ("mnt4_298", "g2"), ("mnt6_298", "g2")):
        c, jc, ref = get_curve(curve), jget_curve(curve), RefGroups(curve)
        g = (codec.g2_ops if group == "g2" else codec.g1_ops)(c)
        jg = (jcodec.g2_ops if group == "g2" else jcodec.g1_ops)(jc)
        to = codec.g2_to_device if group == "g2" else codec.g1_to_device
        lhs, rhs = _cases(ref, group, 9)
        p1 = g.add(to(c, lhs, "cpu"), to(c, rhs, "cpu"))
        p2 = to(c, rhs, "cpu")
        got = g.add(p1, p2)
        want = jg._add_general(*(tuple(np.asarray(x).astype(np.uint32) for x in pt) for pt in (p1, p2)))
        for x, y in zip(got, want):
            y = torch.from_numpy(np.asarray(y).astype(np.int32))
            np.testing.assert_array_equal(fp.normalize(g.k.spec, x, bound_k=2).numpy(),
                                          fp.normalize(g.k.spec, y, bound_k=2).numpy())
