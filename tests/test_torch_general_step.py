"""The capture step of the generic-a law (MNT4-298's a = 2, MNT6-298's
a = 11) on the CPU: its plain version (curves/cuda_point.py:
capture_step_plain, the generic-a group kernel's order of operations)
against the exact engine of the JAX package (groth16_tpu.ref, Python
ints), and the capture scan built on it (msm/scans.py) against exact
prefix sums.

Each case runs a few steps over C = 8 chunks from an infinite
accumulator: the rows hold affine infinity (0, 0), a point equal to the
accumulator's (P + P) and its negative (P + (-P)); the captures take
the accumulator of a step before.  Tolerance: the same points after
conversion to affine (equal mod p).  Three cases, so pytest-xdist's
--dist loadfile hands the file out after tests/test_gadget.py."""

import random

import pytest
import torch

from groth16_tpu.ref.curve import RefGroups
from groth16_tpu_torch.curves import codec, cuda_point
from groth16_tpu_torch.curves.params import get_curve
from groth16_tpu_torch.msm.scans import scan_storage_mixed_capture

torch.set_num_threads(1)

C, STEPS = 8, 3


def _setup(curve, group, seed):
    c, ref = get_curve(curve), RefGroups(curve)
    g = (codec.g2_ops if group == "g2" else codec.g1_ops)(c)
    to = codec.g2_to_device if group == "g2" else codec.g1_to_device
    back = codec.g2_from_device if group == "g2" else codec.g1_from_device
    add, mul, neg = (getattr(ref, f"{group}_{op}") for op in ("add", "mul", "neg"))
    r = random.Random(seed)
    base = getattr(ref, f"{group}_sample")(3)
    return c, g, to, back, add, mul, neg, [mul(base, r.randrange(1, c.r)) for _ in range(C)]


def _rows(pts, add, neg):
    """STEPS rows of C affine points: chunk 0 takes P then P (P + P),
    chunk 1 P then -P (back to infinity), chunk 2 infinity rows, the
    others distinct points."""
    rows = [[pts[(c + 3 * k) % C] for c in range(C)] for k in range(STEPS)]
    rows[1][0] = rows[0][0]
    rows[1][1] = neg(rows[0][1])
    for k in range(STEPS):
        rows[k][2] = None
    rows[2][5] = None
    return rows


def _affine(c, g, to, xs):
    pt = to(c, xs, "cpu")
    x, y, _ = g.to_affine(pt)
    return x, y


@pytest.mark.parametrize("curve,group", [("mnt4_298", "g1"), ("mnt6_298", "g2")])
def test_capture_step_plain_matches_exact(curve, group):
    """STEPS plain capture steps: acc = acc + row (from_affine, the
    generic-a law), and the targets of the step before captured from the
    step's input; MNT4-298's G1 and MNT6-298's G2 over Fq3."""
    c, g, to, back, add, _, neg, pts = _setup(curve, group, 5)
    ops = cuda_point.plain_ops(g.k)
    rows = _rows(pts, add, neg)
    jk = torch.tensor([0, 1, 1, 2, 0, 1], dtype=torch.int32)
    src = torch.tensor([0, 1, 2, 3, 7, 0], dtype=torch.int32)
    acc = g.infinity((C,))
    cap = g.infinity((jk.numel(),))
    want_acc = [None] * C
    want_cap = [None] * jk.numel()
    history = []
    for k in range(STEPS + 1):
        if k:  # capture the step before, from this step's input
            for t in range(jk.numel()):
                if int(jk[t]) == k - 1:
                    want_cap[t] = want_acc[int(src[t])]
        if k == STEPS:
            acc, cap = cuda_point.capture_step_plain(ops, g.b3_val, g.a_val, acc, None, cap, jk, src, k - 1, add=False)
            break
        acc, cap = cuda_point.capture_step_plain(ops, g.b3_val, g.a_val, acc, _affine(c, g, to, rows[k]), cap, jk,
                                                 src, k - 1)
        want_acc = [add(a, b) for a, b in zip(want_acc, rows[k])]
        history.append(list(want_acc))
    assert back(c, g, acc) == want_acc
    assert back(c, g, cap) == want_cap
    assert history[1][1] is None and history[1][0] == add(pts[0], pts[0])  # P + (-P), P + P
    # add_affine where a != 0 is the step without a capture
    x2, y2 = _affine(c, g, to, rows[0])
    assert back(c, g, g.add_affine(g.infinity((C,)), (x2, y2))) == rows[0]


def test_capture_scan_matches_exact_prefix_sums():
    """msm/scans.py:scan_storage_mixed_capture where a != 0 (one capture
    step a step, the captures of each step read in the next, one capture
    after the last) on MNT4-298's G1 over 2 lead entries, forward and in
    reverse: every captured value is the exact within-chunk prefix sum."""
    c, g, to, back, add, _, neg, pts = _setup("mnt4_298", "g1", 9)
    K = STEPS
    rows = [_rows(pts[::-1] if lead else pts, add, neg) for lead in range(2)]  # [lead][k][chunk]
    flat = [rows[lead][k][ch] for lead in range(2) for k in range(K) for ch in range(C)]
    x, y = _affine(c, g, to, flat)
    xy = tuple(v.reshape(v.shape[:-1] + (2, K * C)) for v in (x, y))
    jk = torch.tensor([[0, 1, 2, 2, 1], [2, 0, 1, 1, 0]])
    jc = torch.tensor([[0, 1, 2, 7, 5], [3, 0, 1, 1, 6]])
    for reverse in (False, True):
        cap, totals = scan_storage_mixed_capture(g, xy, K, C, jk, jc, reverse=reverse)
        order = list(reversed(range(K))) if reverse else list(range(K))
        for lead in range(2):
            want_tot, prefix = [None] * C, {}
            for k in order:
                want_tot = [add(a, b) for a, b in zip(want_tot, rows[lead][k])]
                prefix[k] = list(want_tot)
            got_cap = back(c, g, tuple(v[..., lead, :] for v in cap))
            assert got_cap == [prefix[int(k)][int(ch)] for k, ch in zip(jk[lead], jc[lead])]
            assert back(c, g, tuple(v[..., lead, :] for v in totals)) == want_tot
