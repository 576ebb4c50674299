"""Port MSM (Pippenger with signed digits) on the CPU against exact sums
from the JAX package's exact engine (groth16_tpu.ref), bn254:
msm_device_lanes for G1 (4 lanes) and msm_device for G2, on the fused-scan
path (the default: the plain version of K2/K3) and on the capture-scan
path.  Tolerance: equal as affine points.  The G1 MSM of size 1 uses full-width
(254-bit) scalars; the rest use 64-bit scalars (scalar_bits = 64): the
code path is the same, and Horner's chain of single-point additions,
which dominates a small MSM on the CPU, is a quarter as long.  The
prover tests run full-width G1 and G2 MSMs."""

import random

import pytest
import torch

from groth16_tpu.curves.params import get_curve
from groth16_tpu.ref.curve import RefGroups
from groth16_tpu.ref.group import g1_jacobian, g2_jacobian
from groth16_tpu_torch.config import CONFIG, configure
from groth16_tpu_torch.curves import codec
from groth16_tpu_torch.fields.spec import decode, make_spec
from groth16_tpu_torch.msm import cuda_scan
from groth16_tpu_torch.msm.cuda_scan import (
    SIGN_BIT,
    choose_segments,
    segment_steps,
    suffix_scan_g1_rows,
    suffix_scan_g2_rows,
)
from groth16_tpu_torch.msm.pippenger import (
    CAPTURE_BUCKET_COST,
    FUSED_BUCKET_COST,
    choose_window_bits,
    first_ge_histogram,
    msm_device,
    msm_device_lanes,
    signed_num_windows,
)

torch.set_num_threads(1)

CURVE = "bn254"


def _points(ref, n, g2, seed):
    """n distinct subgroup points (a walk P_{i+1} = P_i + Q) with one
    infinity entry."""
    r = random.Random(seed)
    if g2:
        base, mul, add = ref.g2_sample(1), ref.g2_mul, ref.g2_add
    else:
        base, mul, add = ref.g1_sample(5), ref.g1_mul, ref.g1_add
    p, q = mul(base, r.randrange(1, ref.c.r)), mul(base, r.randrange(1, ref.c.r))
    out = []
    for _ in range(n):
        out.append(p)
        p = add(p, q)
    if n > 2:
        out[n // 2] = None
    return out


def _scalars(n, bits, seed, modulus):
    r = random.Random(seed)
    vals = [r.randrange(min(modulus, 1 << bits)) for _ in range(n)]
    special = [0, 1, min(modulus, 1 << bits) - 1]
    return (special + vals)[:n] if n >= 3 else vals


def _exact(ops, pts, scalars):
    return ops.to_affine(ops.msm(pts, scalars))


def _assert_points(g, pt, want):
    """Device projective points (Montgomery digits; one point or a batch)
    equal the exact affine points `want` (one, or a list in the batch's
    row-major order; None at infinity): Z = 0 exactly at infinity, and
    X = x Z, Y = y Z mod p elsewhere (Montgomery form scales X, Y and Z
    alike).  The same equality as after conversion to affine, with no
    inversion."""
    k = g.k
    spec, D = k.spec, k.tower_deg
    p = spec.modulus
    if pt[2].dim() == k.coord_ndim:
        pt, want = tuple(x[..., None] for x in pt), [want]

    def ints(t):  # [L, (D,) *batch] -> one D-tuple per point
        t = t.reshape(spec.n_limbs, D, -1).cpu().numpy()
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


@pytest.mark.parametrize("n,bits", [(7, 64), (64, 64), (300, 64)])  # (1, 254): test_torch_late.py
def test_msm_g1_lanes(n, bits):
    c = get_curve(CURVE)
    ref = RefGroups(CURVE)
    fr = make_spec(c.r)
    lanes = [_points(ref, n, False, seed=10 * n + i) for i in range(4)]
    scal = [_scalars(n, bits, seed=n + i, modulus=c.r) for i in range(4)]
    dev = [codec.g1_to_device(c, pts, "cpu") for pts in lanes]
    points = tuple(torch.stack([d[k] for d in dev], dim=-2) for k in range(3))
    scalars = torch.stack([codec.scalars_to_device(s, fr, "cpu") for s in scal])
    g = codec.g1_ops(c)
    acc = msm_device_lanes(g, points, scalars, min(bits, c.r.bit_length()))
    ops = g1_jacobian(c)
    _assert_points(g, acc, [_exact(ops, p, s) for p, s in zip(lanes, scal)])


@pytest.mark.parametrize("n,bits", [(1, 64), (7, 64), (64, 64), (300, 64)])
def test_msm_g2(n, bits):
    c = get_curve(CURVE)
    ref = RefGroups(CURVE)
    fr = make_spec(c.r)
    pts = _points(ref, n, True, seed=n)
    scal = _scalars(n, bits, seed=7 * n, modulus=c.r)
    g = codec.g2_ops(c)
    acc = msm_device(g, codec.g2_to_device(c, pts, "cpu"), codec.scalars_to_device(scal, fr, "cpu"),
                     min(bits, c.r.bit_length()))
    _assert_points(g, acc, _exact(g2_jacobian(c), pts, scal))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_msm_real_carry_window(group):
    """c = 8 divides the 24 scalar bits, so the signed recode's extra top
    window is real: scalars >= 0xC00000 carry out of the top window."""
    c = get_curve(CURVE)
    ref = RefGroups(CURVE)
    fr = make_spec(c.r)
    bits, cbits = 24, 8
    assert signed_num_windows(bits, cbits) == bits // cbits + 1
    r = random.Random(3)
    n = 40
    g2 = group == "g2"
    pts = _points(ref, n, g2, seed=5)
    scal = [r.randrange(0xC00000, 1 << bits) for _ in range(n)]
    g = (codec.g2_ops if g2 else codec.g1_ops)(c)
    to_dev = codec.g2_to_device if g2 else codec.g1_to_device
    acc = msm_device(g, to_dev(c, pts, "cpu"), codec.scalars_to_device(scal, fr, "cpu"), bits,
                     window_bits=cbits)
    ops = (g2_jacobian if g2 else g1_jacobian)(c)
    _assert_points(g, acc, _exact(ops, pts, scal))


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
def test_msm_window_groups(monkeypatch, signed):
    """The MSM knobs off their defaults: unsigned digits, and a memory
    budget of two windows' gathered rows, so the 5 windows of c = 5 over
    24 bits run as 3 groups of 2 with one zero-digit padding window."""
    c = get_curve(CURVE)
    ref = RefGroups(CURVE)
    fr = make_spec(c.r)
    n, bits, cbits = 40, 24, 5
    monkeypatch.setattr(CONFIG, "msm_signed_digits", signed)
    # one window's gathered rows and prefix: lanes * npad * 5 coordinates
    # of 4-byte digits
    monkeypatch.setattr(CONFIG, "msm_group_bytes", 2 * (64 * fr.n_limbs * 5 * 4))
    pts = _points(ref, n, False, seed=9)
    scal = _scalars(n, bits, seed=4, modulus=c.r)
    g = codec.g1_ops(c)
    acc = msm_device(g, codec.g1_to_device(c, pts, "cpu"), codec.scalars_to_device(scal, fr, "cpu"),
                     bits, window_bits=cbits)
    _assert_points(g, acc, _exact(g1_jacobian(c), pts, scal))


def test_window_chooser_matches_jax_capture_path():
    """The port's chooser picks the JAX package's window on its capture
    path (bucket weight 50) for every size class of the prove."""
    from groth16_tpu.msm.pippenger import choose_window_bits as jchoose

    for n in (8, 300, 4096, 1 << 15, 1 << 16, 1 << 20):
        for signed in (False, True):
            got = choose_window_bits(n, 254, signed, CAPTURE_BUCKET_COST)
            assert got == jchoose(n, 254, signed, bucket_cost=50)


def test_window_chooser_matches_jax_fused_path():
    """On the fused path both packages weigh a bucket by the JAX
    package's msm_bucket_cost."""
    from groth16_tpu.config import CONFIG as JCONFIG
    from groth16_tpu.msm.pippenger import choose_window_bits as jchoose

    assert FUSED_BUCKET_COST == JCONFIG.msm_bucket_cost
    for n in (8, 300, 4096, 1 << 15, 1 << 16, 1 << 20):
        for signed in (False, True):
            assert choose_window_bits(n, 254, signed) == jchoose(n, 254, signed)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_msm_capture_path(group):
    """msm_fused_scan=False: the capture scan (K6/K7 steps) gives the same
    sums."""
    c = get_curve(CURVE)
    ref = RefGroups(CURVE)
    fr = make_spec(c.r)
    n, bits = 64, 64
    g2 = group == "g2"
    pts = _points(ref, n, g2, seed=21)
    scal = _scalars(n, bits, seed=22, modulus=c.r)
    g = (codec.g2_ops if g2 else codec.g1_ops)(c)
    to_dev = codec.g2_to_device if g2 else codec.g1_to_device
    with configure(msm_fused_scan=False):
        acc = msm_device(g, to_dev(c, pts, "cpu"), codec.scalars_to_device(scal, fr, "cpu"), bits)
    _assert_points(g, acc, _exact((g2_jacobian if g2 else g1_jacobian)(c), pts, scal))


def test_first_ge_histogram_matches_jax():
    """The port's histogram (scatter_add_) against the JAX package's
    (one-hot contraction) on the CPU, and against searchsorted: exact."""
    import jax.numpy as jnp
    import numpy as np

    from groth16_tpu.msm.pippenger import first_ge_histogram as jhist

    rng = np.random.default_rng(5)
    B = 257
    digits = rng.integers(0, B, size=(2, 3, 512))
    got = first_ge_histogram(torch.from_numpy(digits.astype(np.int32)), B)
    assert np.array_equal(got.numpy(), np.asarray(jhist(jnp.asarray(digits, jnp.uint32), B)))
    srt = np.sort(digits, axis=-1)
    want = np.stack([np.searchsorted(row, np.arange(1, B)) for row in srt.reshape(6, 512)])
    assert np.array_equal(got.numpy().reshape(6, B - 1), want)


@pytest.mark.parametrize("segments", [1, 2, 3])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_suffix_scan_plain_matches_exact(group, segments):
    """The plain version of K2/K3, its K = 3 steps cut into 1, 2 (of 2 and
    1 steps) or 3 segments, on rows with negated, infinite, doubled and
    cancelling steps: every prefix value and chunk total equals the exact
    suffix sum of its chunk."""
    c = get_curve(CURVE)
    ref = RefGroups(CURVE)
    g2 = group == "g2"
    g = (codec.g2_ops if g2 else codec.g1_ops)(c)
    add, neg = (ref.g2_add, ref.g2_neg) if g2 else (ref.g1_add, ref.g1_neg)
    R, K, C = 2, 3, 4
    n = R * K * C
    pts = _points(ref, n, g2, seed=31)  # storage order: [r, k, c]
    rng = random.Random(32)
    signs = [rng.randrange(2) for _ in range(n)]
    pts[C + 2] = pts[2]  # steps 0 and 1 of chunk 2: P + P
    signs[C + 2] = signs[2]
    pts[C + 3] = pts[3]  # steps 0 and 1 of chunk 3: P + (-P)
    signs[C + 3] = 1 - signs[3]
    x, y, _ = (codec.g2_to_device if g2 else codec.g1_to_device)(c, pts, "cpu")
    inf = torch.tensor([p is None for p in pts])
    x, y = (torch.where(inf, torch.zeros_like(t), t) for t in (x, y))

    def rows_of(t):  # [L, (2,) n] -> [n, ce], tower-major
        if g2:
            t = t.movedim(1, 0)
        return t.reshape(-1, n).T

    rows = torch.cat([rows_of(x), rows_of(y)], dim=-1).contiguous()
    rows[:, 0] |= torch.tensor(signs, dtype=torch.int32) * SIGN_BIT
    rows = rows.reshape(R, K * C, -1)
    if g2:
        prefix, totals = suffix_scan_g2_rows(g.k.spec, g.k.nr_int, g.b3_val, rows, K, C, segments)
    else:
        prefix, totals = suffix_scan_g1_rows(g.k.spec, g.b3_val, rows, K, C, segments)
    L = g.k.spec.n_limbs
    ce = prefix.shape[-1] // 3
    flat = prefix.reshape(n, 3 * ce).T
    coords = tuple(flat[i * ce : (i + 1) * ce] for i in range(3))
    if g2:
        coords = tuple(t.reshape(2, L, n).movedim(0, 1) for t in coords)
    signed = [neg(p) if s and p is not None else p for p, s in zip(pts, signs)]
    want = [None] * n
    for r in range(R):
        for cc in range(C):
            acc = None
            for k in reversed(range(K)):
                e = (r * K + k) * C + cc
                acc = signed[e] if acc is None else (acc if signed[e] is None else add(acc, signed[e]))
                want[e] = acc
    _assert_points(g, coords, want)
    _assert_points(g, totals, [want[r * K * C + cc] for r in range(R) for cc in range(C)])


def test_segment_chooser():
    """S on a card of 132 SMs (blocks of 64 threads): 1 once the columns
    give every SM a block, else as many segments as keep 64 steps each;
    1 on the CPU (no SMs)."""
    assert choose_segments(4 * 512, 1024, 132) == 16  # the 2^20 G2 scan
    assert choose_segments(9 * 512, 1024, 132) == 16  # the 2^20 G1 scan
    assert choose_segments(22 * 512, 64, 132) == 1  # the 2^16 G2 scan
    assert choose_segments(66 * 512, 64, 132) == 1  # the 2^16 G1 scan
    assert choose_segments(132 * 64 - 1, 128, 132) == 2
    assert choose_segments(12, 127, 132) == 1  # too few steps for two segments
    assert choose_segments(4 * 512, 1024, 0) == 1
    assert [segment_steps(7, s) for s in (1, 2, 3, 4, 9)] == [(1, 7), (2, 4), (3, 3), (4, 2), (7, 1)]
    assert segment_steps(4, 3) == (2, 2)  # no empty segment


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_msm_fused_segmented_scan(monkeypatch, group):
    """The fused path with every scan cut into 2 and then 3 segments (the
    chooser patched: on the CPU it picks 1), n = 64 (K = 8 steps): the
    exact engine's MSM."""
    c = get_curve(CURVE)
    ref = RefGroups(CURVE)
    fr = make_spec(c.r)
    n, bits = 64, 32
    g2 = group == "g2"
    pts = _points(ref, n, g2, seed=41)
    scal = _scalars(n, bits, seed=42, modulus=c.r)
    g = (codec.g2_ops if g2 else codec.g1_ops)(c)
    to_dev = codec.g2_to_device if g2 else codec.g1_to_device
    want = _exact((g2_jacobian if g2 else g1_jacobian)(c), pts, scal)
    for segments in (2, 3):
        monkeypatch.setattr(cuda_scan, "choose_segments", lambda *card: segments)
        acc = msm_device(g, to_dev(c, pts, "cpu"), codec.scalars_to_device(scal, fr, "cpu"), bits)
        _assert_points(g, acc, want)
