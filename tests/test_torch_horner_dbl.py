"""The Horner kernel's doublings and chain on the CPU (plain versions:
curves/formulas.py's programs, curves/cuda_point.py:horner_plain)
against the exact engine of the JAX package (groth16_tpu.ref, Python
ints).

- the a = 0 doubling (RCB algorithm 9) on bn254's G1 and G2, and the
  generic-a doubling (algorithm 3) on MNT4-298's G1 and G2 over Fq2
  (nonresidue 17), equal the exact 2P, infinity included, on the plain
  version's two engines (digit tensors and Python ints, the same
  digits); the Horner kernel's launch data (slots, threads) fit a block;
- horner_plain, c doublings and one addition a window, equals the exact
  sum_w 2^(c w) S_w on MNT6-298's G2 over Fq3 and bls12_381's G1.

Tolerance: the same points after conversion to affine (equal mod p).
Three cases, so pytest-xdist's --dist loadfile hands the file out after
tests/test_gadget.py."""

import random

import pytest
import torch

from groth16_tpu.ref.curve import RefGroups
from groth16_tpu_torch.curves import codec, cuda_point, formulas
from groth16_tpu_torch.curves.params import get_curve
from groth16_tpu_torch.fields import cuda_fp

torch.set_num_threads(1)


def _group(curve, group):
    c, ref = get_curve(curve), RefGroups(curve)
    g = (codec.g2_ops if group == "g2" else codec.g1_ops)(c)
    to = codec.g2_to_device if group == "g2" else codec.g1_to_device
    back = codec.g2_from_device if group == "g2" else codec.g1_from_device
    add, mul, neg = (getattr(ref, f"{group}_{op}") for op in ("add", "mul", "neg"))
    return c, ref, g, to, back, add, mul, neg


@pytest.mark.parametrize("curve", ["bn254", "mnt4_298"])
def test_doubling_matches_exact(curve):
    """The doubling program of the curve's law on projective points (Z !=
    1) and infinity, on both plain engines, against the exact 2P."""
    for group in ("g1", "g2"):
        c, ref, g, to, back, add, mul, neg = _group(curve, group)
        k = g.k
        dbl, _ = formulas.programs(k.spec, k.tower_deg, getattr(k, "nr_int", 0), g.a_val, g.b3_val)
        assert dbl.name == ("a0_dbl" if g.a_is_zero else "general_dbl")
        r = random.Random(13)
        base = getattr(ref, f"{group}_sample")(2)
        pts = [mul(base, r.randrange(1, c.r)) for _ in range(5)] + [None]
        half = (c.r + 1) // 2
        p = g.add(*(to(c, [None if x is None else mul(x, half) for x in pts], "cpu"),) * 2)  # Z != 1
        want = [None if x is None else add(x, x) for x in pts]
        got = [formulas.run_plain(dbl, (p,), ints=ints) for ints in (True, False)]
        assert all(torch.equal(x, y) for x, y in zip(*got))
        assert back(c, g, got[0]) == want
        hp = cuda_point.horner_programs(k.spec, k.tower_deg, getattr(k, "nr_int", None), g.a_val, g.b3_val)
        assert hp["threads"] % 32 == 0 and hp["threads"] <= 1024
        assert hp["slots"] * cuda_fp.KERNEL_WORDS[k.spec.n_limbs] * 4 <= 48 * 1024


def test_horner_plain_matches_exact_sums():
    """horner_plain on 2 lanes of 3 windows at c = 4 (one window sum at
    infinity): sum_w 2^(c w) S_w for each lane."""
    for curve, group in (("mnt6_298", "g2"), ("bls12_381", "g1")):
        c, ref, g, to, back, add, mul, neg = _group(curve, group)
        r = random.Random(17)
        base = getattr(ref, f"{group}_sample")(5)
        lanes, windows, cw = 2, 3, 4
        sums = [[mul(base, r.randrange(1, c.r)) for _ in range(windows)] for _ in range(lanes)]
        sums[1][2] = None
        sums[0][1] = neg(sums[0][0])
        flat = to(c, [s for lane in sums for s in lane], "cpu")
        dev = tuple(x.reshape(x.shape[:-1] + (lanes, windows)).contiguous() for x in flat)
        got = g.horner(dev, cw)
        want = []
        for lane in sums:
            acc = None
            for w in reversed(range(windows)):
                acc = add(None if acc is None else mul(acc, 1 << cw), lane[w])
            want.append(acc)
        assert back(c, g, got) == want
