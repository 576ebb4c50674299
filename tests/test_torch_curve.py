"""Port point additions (plain versions of K4-K7) against the JAX
package's CurveDevice on the CPU, G1 and G2, bn254 and bls12_381; and the
G2 additions at bls12_377's Fq2 nonresidue -5 against the exact engine
`groth16_tpu.ref` (equal points after conversion to affine).

Tolerances: `add` is compared digit-for-digit (both run the stacked RCB
path); `add_affine` is compared mod p after conversion to affine (the
port runs K6/K7's 13-product mixed formula, the JAX package on the CPU
its complete-add fallback; representatives may differ within < 2p)."""

import random

import jax
import numpy as np
import pytest
import torch

from groth16_tpu.curves import codec as jcodec
from groth16_tpu.curves.params import get_curve
from groth16_tpu.ref.curve import RefGroups
from groth16_tpu_torch.curves import codec

torch.set_num_threads(1)

CURVES = ["bn254", "bls12_381"]


def _cases(ref, g2: bool, seed: int):
    """(lhs, rhs) lists: random subgroup points, P+P, P+(-P), P+inf,
    inf+P, inf+inf."""
    r = random.Random(seed)
    if g2:
        base, mul, neg = ref.g2_sample(1), ref.g2_mul, ref.g2_neg
    else:
        base, mul, neg = ref.g1_sample(5), ref.g1_mul, ref.g1_neg
    pts = [mul(base, r.randrange(1, ref.c.r)) for _ in range(4)]
    lhs = pts + [pts[0], pts[1], pts[2], None, None]
    rhs = pts[::-1] + [pts[0], neg(pts[1]), None, pts[3], None]
    return lhs, rhs


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int32))


def _affine_rows(pts, to_device, c):
    """Affine (x, y) device rows with infinity encoded (0, 0)."""
    X, Y, _ = to_device(c, pts)
    inf = np.array([p is None for p in pts])
    return tuple(np.where(inf, 0, np.asarray(a)) for a in (X, Y))


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_add_matches_jax(curve, group):
    c = get_curve(curve)
    ref = RefGroups(curve)
    is_g2 = group == "g2"
    lhs, rhs = _cases(ref, is_g2, seed=11)
    jops = (jcodec.g2_ops if is_g2 else jcodec.g1_ops)(c)
    to_dev = jcodec.g2_to_device if is_g2 else jcodec.g1_to_device
    A, B = to_dev(c, lhs), to_dev(c, rhs)

    g = (codec.g2_ops if is_g2 else codec.g1_ops)(c)
    got = g.add(tuple(_t(x) for x in A), tuple(_t(x) for x in B))
    want = jax.jit(jops.add)(A, B)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy().astype(np.uint32), np.asarray(y))
    add = ref.g2_add if is_g2 else ref.g1_add
    dec = codec.g2_from_device if is_g2 else codec.g1_from_device
    assert dec(c, g, got) == [add(x, y) for x, y in zip(lhs, rhs)]


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_add_affine_matches_jax(curve, group):
    c = get_curve(curve)
    ref = RefGroups(curve)
    is_g2 = group == "g2"
    lhs, rhs = _cases(ref, is_g2, seed=12)
    jops = (jcodec.g2_ops if is_g2 else jcodec.g1_ops)(c)
    to_dev = jcodec.g2_to_device if is_g2 else jcodec.g1_to_device
    A = to_dev(c, lhs)
    xy = _affine_rows(rhs, to_dev, c)  # None -> (0, 0)

    g = (codec.g2_ops if is_g2 else codec.g1_ops)(c)
    got = g.add_affine(tuple(_t(x) for x in A), tuple(_t(x) for x in xy))
    want = tuple(_t(x) for x in jax.jit(jops.add_affine)(A, xy))
    dec = codec.g2_from_device if is_g2 else codec.g1_from_device
    add = ref.g2_add if is_g2 else ref.g1_add
    # one decode of both batches side by side
    both = dec(c, g, tuple(torch.cat([x, y], dim=-1) for x, y in zip(got, want)))
    n = len(lhs)
    assert both[:n] == both[n:] == [add(x, y) for x, y in zip(lhs, rhs)]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_tree_reduce_sums_the_batch(group):
    """from_affine with an infinity mask, then tree_reduce (5 points
    padded to 8, halved three times): the sum equals the exact engine's."""
    c = get_curve("bn254")
    ref = RefGroups("bn254")
    is_g2 = group == "g2"
    lhs, _ = _cases(ref, is_g2, seed=13)
    pts = lhs[:4] + [None]
    add = ref.g2_add if is_g2 else ref.g1_add
    want = None
    for p in pts:
        want = add(want, p)
    g = (codec.g2_ops if is_g2 else codec.g1_ops)(c)
    to_dev = codec.g2_to_device if is_g2 else codec.g1_to_device
    dec = codec.g2_from_device if is_g2 else codec.g1_from_device
    x, y, _ = to_dev(c, pts, "cpu")
    batch = g.from_affine(x, y, torch.tensor([p is None for p in pts]))
    assert dec(c, g, g.tree_reduce(batch)) == want


@pytest.mark.parametrize("mixed", [False, True], ids=["full", "mixed"])
def test_g2_add_at_nonresidue_minus5_matches_ref(mixed):
    """bls12_377's G2 (Fq2 = Fq[u]/(u^2 + 5)): the plain versions of K5
    (full) and K7 (mixed) give the exact engine's sums, P+P, P+(-P) and
    infinity lanes included."""
    c = get_curve("bls12_377")
    assert c.fp2_nonresidue == -5
    ref = RefGroups("bls12_377")
    lhs, rhs = _cases(ref, True, seed=14)
    g = codec.g2_ops(c)
    A = codec.g2_to_device(c, lhs, "cpu")
    if mixed:
        X, Y, _ = codec.g2_to_device(c, rhs, "cpu")
        inf = torch.tensor([p is None for p in rhs])
        got = g.add_affine(A, tuple(torch.where(inf, torch.zeros_like(v), v) for v in (X, Y)))
    else:
        got = g.add(A, codec.g2_to_device(c, rhs, "cpu"))
    assert codec.g2_from_device(c, g, got) == [ref.g2_add(x, y) for x, y in zip(lhs, rhs)]
