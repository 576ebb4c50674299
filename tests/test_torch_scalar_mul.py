"""The proof assembly's scalar multiplication on the CPU: the plain
version of the fixed-window kernel (curves/cuda_point.py:
scalar_mul_plain, reached through `CurveDevice.scalar_mul_bits` on CPU
tensors) against the exact engine `groth16_tpu.ref` (RefGroups), on the
a = 0 law (bn254 G1 and G2 over Fq2) and the generic-a law (MNT4-298 G1
and G2 over Fq2 with nonresidue 17, MNT6-298 G2 over Fq3).

Lanes: the scalars 0, 1, 2^c - 1, 2^c, one whose middle windows are
zero, at a bit count that c does not divide (a short top window), a lane
whose point is infinity, and r - 1 on a lane of its own at the curve
order's width.  Both engines of `formulas.run_plain` (Python ints and
stacked digit tensors) must give the same digits.  Inputs from a numpy
seed; tolerance: the same points mod p after conversion to affine (the
window order gives other representatives than the JAX package's select
loop).  Three cases, so pytest-xdist's --dist loadfile hands the file out
after tests/test_gadget.py."""

import numpy as np
import pytest
import torch

from groth16_tpu.ref.curve import RefGroups
from groth16_tpu_torch.curves import codec, cuda_point, formulas
from groth16_tpu_torch.curves.params import get_curve

torch.set_num_threads(1)

NBITS = 13  # not a multiple of the window bits


def _bits(scalars, nbits):
    return torch.from_numpy(np.array([[(k >> i) & 1 for i in range(nbits)] for k in scalars], np.int32))


@pytest.mark.parametrize("curve,groups", [("bn254", ("g1", "g2")), ("mnt4_298", ("g1", "g2")),
                                          ("mnt6_298", ("g2",))])
def test_scalar_mul_plain_matches_ref(curve, groups, monkeypatch):
    c, ref = get_curve(curve), RefGroups(curve)
    rng = np.random.default_rng(0x5CA1)
    for group in groups:
        g = (codec.g2_ops if group == "g2" else codec.g1_ops)(c)
        to = codec.g2_to_device if group == "g2" else codec.g1_to_device
        back = codec.g2_from_device if group == "g2" else codec.g1_from_device
        mul, neg = getattr(ref, f"{group}_mul"), getattr(ref, f"{group}_neg")
        w = cuda_point.SCALAR_MUL_WINDOW
        assert NBITS % w
        base = getattr(ref, f"{group}_sample")(3)
        pts = [mul(base, int(rng.integers(1, 1 << 62))) for _ in range(7)]
        pts[6] = None  # P = infinity
        middle_zero = 1 | 1 << (NBITS - 1)  # its windows between the first and the top are zero
        scalars = [0, 1, (1 << w) - 1, 1 << w, middle_zero, int(rng.integers(1 << (NBITS - 1), 1 << NBITS)),
                   int(rng.integers(1, 1 << NBITS))]
        bits = _bits(scalars, NBITS)
        before = dict(cuda_point.LAUNCHES)
        got = g.scalar_mul_bits(to(c, pts, "cpu"), bits)
        assert cuda_point.LAUNCHES == before  # the plain version on CPU tensors
        want = [mul(p, k) if p is not None and k else None for p, k in zip(pts, scalars)]
        assert back(c, g, got) == want
        # the digit-tensor engine gives the ints engine's digits
        monkeypatch.setattr(formulas, "PLAIN_INT_MAX_N", 0)
        tens = g.scalar_mul_bits(to(c, pts, "cpu"), bits)
        monkeypatch.undo()
        assert all(torch.equal(x, y) for x, y in zip(got, tens))
        # r - 1 at the curve order's width: -P
        one = g.scalar_mul_bits(to(c, pts[:1], "cpu"), _bits([c.r - 1], c.r.bit_length()))
        assert back(c, g, one) == [neg(pts[0])]
