"""The CUDA kernels of the port against their plain PyTorch versions, on
the card: K1 (mont_mul), K4-K7 (point additions), the Horner kernel,
K2/K3 (the MSM suffix scans), V (the op-rate microbenchmark) and the
scalar multiplication, then batch inversion and to_affine, a small prove
through every kernel, on each MSM scan path, against the exact prover, a
small device setup against the exact setup, and a small batch and device
assembly against the exact prover.

CUDA kernels have no CPU mode, so every test here needs an NVIDIA GPU and
`nvcc` (the kernels build at first use) and skips elsewhere.  The machine
with the card has no JAX, which the suite's conftest imports, so run this
file there without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance: digit-for-digit equality with the plain versions (they run the
same operations in the same order), and equal points after conversion to
affine against the exact engine."""

import random

import numpy as np
import pytest
import torch

from groth16_tpu_torch.curves import codec, cuda_point
from groth16_tpu_torch.curves.params import get_curve
from groth16_tpu_torch.fields import cuda_fp, fp
from groth16_tpu_torch.fields.spec import decode, encode, int_to_limbs, make_spec
from groth16_tpu_torch.msm import cuda_scan
from groth16_tpu_torch.ref.curve import RefGroups
from groth16_tpu_torch.utils import cuda_build, ubench

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    # build every library this file loads up front, one nvcc each, all at
    # once (a library built at first use would build alone)
    names = {"ubench_ops"}
    for curve in ("bn254", "bls12_381", "bls12_377", "bw6_761"):
        c = get_curve(curve)
        names.update(cuda_build.curve_variants(c))
    cuda_build.build(sorted(names))
    return torch.device("cuda")


def _lazy_digits(values, L, rng):
    """int32[L, N] digits of `values` with random borrows moved down one
    digit (lazy digit class, digits < 2^27)."""
    d = np.array([[(v >> (15 * i)) & 0x7FFF for v in values] for i in range(L)], np.int64)
    for i in range(L - 1):
        r = np.minimum(rng.integers(0, 1 << 11, size=d.shape[1]), d[i + 1])
        d[i] += r << 15
        d[i + 1] -= r
    return torch.from_numpy(d.astype(np.int32))


def _at_limit_digits(values, L):
    """int32[L, N] digits of `values` with the most each digit can take
    moved down from the next (digits near 2^27)."""
    d = np.array([[(v >> (15 * i)) & 0x7FFF for v in values] for i in range(L)], np.int64)
    for i in range(L - 1):
        r = np.minimum((1 << 12) - 1, d[i + 1])
        d[i] += r << 15
        d[i + 1] -= r
    return torch.from_numpy(d.astype(np.int32))


@pytest.mark.parametrize(
    "n,periods", [(1, [1]), (3, [1]), (4097, [1, 17]), (3 << 14, [1, 3, 1 << 14]), ((1 << 16) + 3, [1])]
)
@pytest.mark.parametrize(
    "curve,field", [("bn254", "p"), ("bn254", "r"), ("bls12_381", "p"), ("bls12_377", "p"), ("bw6_761", "p")]
)
def test_mont_mul_kernel_matches_plain(dev, curve, field, n, periods, monkeypatch):
    """K1 (32-bit words) at n elements, L = 18, 26 and 52, at one and two
    elements a thread (one at L = 52; an odd n runs one): lazy and
    at-limit (just below
    8p, digits near 2^27) inputs; full operands and [L, h] period
    operands on either side (h = 3 splits a pair), each digit-equal to
    the plain version and counted once."""
    modulus = getattr(get_curve(curve), field)
    spec = make_spec(modulus)
    L = spec.n_limbs
    r = random.Random(n)
    rng = np.random.default_rng(2)
    vals_a = ([0, 1, modulus - 1, 8 * modulus - 1] + [r.randrange(8 * modulus) for _ in range(n)])[:n]
    vals_b = ([8 * modulus - 1] * 4 + [r.randrange(8 * modulus) for _ in range(n)])[:n]
    a = _lazy_digits(vals_a, L, rng).to(dev)
    b = _at_limit_digits(vals_b, L).to(dev)
    cases = [(a, b)]
    for h in periods:
        cases += [(a, b[:, :h].contiguous()), (b[:, :h].contiguous(), a)]
    for vec in cuda_fp.KERNEL_VECTORS[L]:
        monkeypatch.setattr(cuda_fp, "elements_per_thread", lambda L_, n_: vec)
        for x, y in cases:
            before = cuda_fp.LAUNCHES["mont_mul"]
            got = cuda_fp.mont_mul(spec, x, y, n)
            torch.cuda.synchronize()
            assert cuda_fp.LAUNCHES["mont_mul"] == before + 1
            assert torch.equal(got, cuda_fp.mont_mul_plain(spec, x, y, n))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    spec = make_spec(get_curve("bn254").p)
    a = torch.zeros((18, 64), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        cuda_fp.mont_mul(spec, a.long(), a.long())
    with pytest.raises(ValueError):
        cuda_fp.mont_mul(spec, a[:, ::2], a[:, ::2])
    with pytest.raises(ValueError):
        cuda_fp.mont_mul(spec, a, a.cpu())
    with pytest.raises(ValueError):
        cuda_fp.mont_mul(make_spec(get_curve("bls12_377").r), a[:17], a[:17])
    with pytest.raises(ValueError):  # a period that does not divide n
        cuda_fp.mont_mul(spec, a, a[:, :5].contiguous())


def _batches(curve, g2, n, seed):
    """Two batches of n subgroup points (a walk) with the special lanes
    P + P, P + (-P), P + inf, inf + P and inf + inf."""
    ref = RefGroups(curve)
    r = random.Random(seed)
    if g2:
        base, mul, add, neg = ref.g2_sample(1), ref.g2_mul, ref.g2_add, ref.g2_neg
    else:
        base, mul, add, neg = ref.g1_sample(5), ref.g1_mul, ref.g1_add, ref.g1_neg
    p, q = mul(base, r.randrange(1, ref.c.r)), mul(base, r.randrange(1, ref.c.r))
    walk = []
    for _ in range(n):
        walk.append(p)
        p = add(p, q)
    lhs = walk[: n - 5] + [walk[0], walk[1], walk[2], None, None]
    rhs = walk[::-1][: n - 5] + [walk[0], neg(walk[1]), None, walk[3], None]
    return lhs, rhs, add


@pytest.mark.parametrize("curve", ["bn254", "bls12_381", "bls12_377", "bw6_761"])
@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("mixed", [False, True], ids=["full", "mixed"])
def test_point_add_kernels_match_plain(dev, curve, group, mixed):
    c = get_curve(curve)
    g2 = group == "g2"
    lhs, rhs, add = _batches(curve, g2, 300, seed=3)
    g = (codec.g2_ops if g2 else codec.g1_ops)(c)
    to_dev = codec.g2_to_device if g2 else codec.g1_to_device
    dec = codec.g2_from_device if g2 else codec.g1_from_device
    # a projective left operand with Z != 1: P + inf on the plain path
    p1 = to_dev(c, lhs, "cpu")
    p1 = g.add(p1, g.infinity(g.batch_shape(p1)))
    p1 = tuple(x.to(dev) for x in p1)
    p2 = tuple(x.to(dev) for x in to_dev(c, rhs, "cpu"))
    k = g.k
    # bw6_761's G2 lies over Fq: G1's kernels (K4, K6) with G2's b3
    name = ("add_mixed_g" if mixed else "add_g") + str(k.tower_deg)
    nr = getattr(k, "nr_int", None)
    ops = cuda_point._plain_ops(k.spec, nr)
    if mixed:
        inf = torch.tensor([q is None for q in rhs], device=dev)
        p2 = tuple(torch.where(inf, torch.zeros_like(x), x) for x in p2[:2])
        plain = cuda_point.mixed_add_plain(ops, g.b3_val, p1, p2)
    else:
        plain = cuda_point.add_plain(ops, g.b3_val, p1, p2)
    before = cuda_point.LAUNCHES[name]
    got = (g.add_affine if mixed else g.add)(p1, p2)
    torch.cuda.synchronize()
    assert cuda_point.LAUNCHES[name] == before + 1
    for x, y in zip(got, plain):
        assert torch.equal(x, y)
    assert dec(c, g, got) == [add(x, y) for x, y in zip(lhs, rhs)]


@pytest.mark.parametrize("n", [1, 3, 33, 4096 + 5])
@pytest.mark.parametrize("curve", ["bn254", "bls12_381", "bls12_377", "bw6_761"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_point_add_sizes_match_plain(dev, curve, group, n):
    """K4/K5 (a lane group a point) at n points, digit-equal to the plain
    version, with the special lanes P + P, P + (-P), P + inf, inf + P and
    inf + inf (the first n of them where n < 5); the launch counted on its
    counter and size class."""
    c = get_curve(curve)
    g2 = group == "g2"
    lhs, rhs, add = _batches(curve, g2, max(n, 5), seed=5)
    if n < 5:
        lhs, rhs = lhs[-5:][:n], rhs[-5:][:n]
    g = (codec.g2_ops if g2 else codec.g1_ops)(c)
    to_dev = codec.g2_to_device if g2 else codec.g1_to_device
    p1 = to_dev(c, lhs, "cpu")
    p1 = tuple(x.to(dev) for x in g.add(p1, g.infinity(g.batch_shape(p1))))  # Z != 1
    p2 = tuple(x.to(dev) for x in to_dev(c, rhs, "cpu"))
    k = g.k
    nr = getattr(k, "nr_int", None)
    plain = cuda_point.add_plain(cuda_point._plain_ops(k.spec, nr), g.b3_val, p1, p2)
    name, size = f"add_g{k.tower_deg}", cuda_point.size_class(n)
    before = (cuda_point.LAUNCHES[name], cuda_point.LAUNCH_SIZES[name][size])
    got = g.add(p1, p2)
    torch.cuda.synchronize()
    assert (cuda_point.LAUNCHES[name], cuda_point.LAUNCH_SIZES[name][size]) == (before[0] + 1, before[1] + 1)
    for x, y in zip(got, plain):
        assert torch.equal(x, y)


@pytest.mark.parametrize("n", [1, 3, 33, 4096 + 5])
@pytest.mark.parametrize("curve", ["bn254", "bls12_381", "bls12_377"])
def test_mixed_add_g2_group_form_matches_plain(dev, curve, n):
    """K7 (a lane group a point) at n points: a projective left operand
    (Z != 1) plus an affine one with infinity rows ((0, 0), every fifth
    and the last) mixed in, and P + P, P + (-P) and inf + P; digit-equal
    to the plain version, the exact sums, counted on the launch counter
    and the size class."""
    c = get_curve(curve)
    lhs, rhs, add = _batches(curve, True, max(n, 5), seed=7)
    rhs = [None if i % 5 == 4 else q for i, q in enumerate(rhs)]
    if n < 5:
        lhs, rhs = lhs[-5:][:n], rhs[-5:][:n]
    lhs, rhs = lhs[:n], rhs[:n]
    g = codec.g2_ops(c)
    p1 = codec.g2_to_device(c, lhs, "cpu")
    p1 = tuple(x.to(dev) for x in g.add(p1, g.infinity(g.batch_shape(p1))))  # Z != 1
    inf = torch.tensor([q is None for q in rhs], device=dev)
    xy2 = tuple(torch.where(inf, torch.zeros_like(x), x) for x in codec.g2_to_device(c, rhs, dev)[:2])
    plain = cuda_point.mixed_add_plain(cuda_point._plain_ops(g.k.spec, g.k.nr_int), g.b3_val, p1, xy2)
    size = cuda_point.size_class(n)
    before = (cuda_point.LAUNCHES["add_mixed_g2"], cuda_point.LAUNCH_SIZES["add_mixed_g2"][size])
    got = g.add_affine(p1, xy2)
    torch.cuda.synchronize()
    after = (cuda_point.LAUNCHES["add_mixed_g2"], cuda_point.LAUNCH_SIZES["add_mixed_g2"][size])
    assert after == (before[0] + 1, before[1] + 1)
    for x, y in zip(got, plain):
        assert torch.equal(x, y)
    assert codec.g2_from_device(c, g, got) == [add(x, y) for x, y in zip(lhs, rhs)]


@pytest.mark.parametrize("n", [1, 33, 4096 + 5, 1 << 17])
@pytest.mark.parametrize("curve,form", [
    (curve, form) for curve, L in (("bn254", 18), ("bls12_381", 26), ("bls12_377", 26), ("bw6_761", 52))
    for form in cuda_point.mixed_g1_forms(L)
])
def test_mixed_add_g1_forms_match_plain(dev, curve, n, form, monkeypatch):
    """K6 in each of its forms at its L (the word kernel at its natural
    and, at L = 18 and 26, a forced occupancy) at n points, L = 18, 26
    and 52: the special lanes
    P + P, P + (-P), P + inf, inf + P and inf + inf first, then a
    projective left operand (Z != 1) plus affine points, lanes 32-63 (a
    warp of the word kernel) all with P2 infinity, the 96 lanes tiled up
    to n; digit-equal to the plain version, the first lanes the exact
    sums, counted on the launch counter and the size class."""
    c = get_curve(curve)
    lhs, rhs, add = _batches(curve, False, 96, seed=13)
    lhs, rhs = lhs[-5:] + lhs[:-5], rhs[-5:] + rhs[:-5]
    rhs = [None if 32 <= i < 64 else q for i, q in enumerate(rhs)]
    g = codec.g1_ops(c)
    p1 = codec.g1_to_device(c, lhs, "cpu")
    p1 = g.add(p1, g.infinity(g.batch_shape(p1)))  # Z != 1
    inf = torch.tensor([q is None for q in rhs])
    xy2 = tuple(torch.where(inf, torch.zeros_like(x), x) for x in codec.g1_to_device(c, rhs, "cpu")[:2])
    idx = torch.arange(n) % len(lhs)
    p1, xy2 = (tuple(x[:, idx].contiguous().to(dev) for x in pt) for pt in (p1, xy2))
    plain = cuda_point.mixed_add_plain(cuda_point._plain_ops(g.k.spec, None), g.b3_val, p1, xy2)
    monkeypatch.setattr(cuda_point, "mixed_g1_form", lambda n_, wave_: form)
    size = cuda_point.size_class(n)
    before = (cuda_point.LAUNCHES["add_mixed_g1"], cuda_point.LAUNCH_SIZES["add_mixed_g1"][size])
    got = g.add_affine(p1, xy2)
    torch.cuda.synchronize()
    after = (cuda_point.LAUNCHES["add_mixed_g1"], cuda_point.LAUNCH_SIZES["add_mixed_g1"][size])
    assert after == (before[0] + 1, before[1] + 1)
    for x, y in zip(got, plain):
        assert torch.equal(x, y)
    m = min(n, len(lhs))
    head = tuple(x[:, :m].contiguous() for x in got)
    assert codec.g1_from_device(c, g, head) == [add(x, y) for x, y in zip(lhs[:m], rhs[:m])]


@pytest.mark.parametrize(
    "curve,c,windows,lanes",
    [("bn254", 12, 22, 3), ("bls12_381", 16, 16, 1), ("bls12_377", 12, 22, 3), ("bw6_761", 12, 32, 3)],
)
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_horner_kernel_matches_plain(dev, curve, group, c, windows, lanes):
    """The Horner kernel in one launch against its plain version (the loop
    of additions it replaces) at the c and window counts of the 2^16 bn254,
    bls12_377 and bw6_761 G1 and 2^20 bls12_381 proves, one window sum
    infinity; the result is the exact sum_w 2^(c w) S_w."""
    cv = get_curve(curve)
    g2 = group == "g2"
    lhs, rhs, add = _batches(curve, g2, lanes * windows + 5, seed=11)
    g = (codec.g2_ops if g2 else codec.g1_ops)(cv)
    to_dev = codec.g2_to_device if g2 else codec.g1_to_device
    m = lanes * windows
    sums = g.add(to_dev(cv, lhs[:m], dev), to_dev(cv, rhs[:m], dev))
    inf = g.infinity((1,), device=dev)
    sums = tuple(torch.cat([i, x[..., 1:]], dim=-1) for i, x in zip(inf, sums))
    sums = tuple(x.reshape(x.shape[:-1] + (lanes, windows)).contiguous() for x in sums)
    k = g.k
    nr = getattr(k, "nr_int", None)
    name = f"horner_g{k.tower_deg}"
    before = cuda_point.LAUNCHES[name]
    got = g.horner(sums, c)
    torch.cuda.synchronize()
    assert cuda_point.LAUNCHES[name] == before + 1
    want = cuda_point.horner_plain(cuda_point._plain_ops(k.spec, nr), g.b3_val, sums, c)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    terms = [None] + [add(x, y) for x, y in zip(lhs[1:m], rhs[1:m])]
    exact = []
    for lane in range(lanes):  # the exact engine's Horner chain, from the top window
        acc = None
        for w in reversed(range(windows)):
            for _ in range(c):
                acc = add(acc, acc)
            acc = add(acc, terms[lane * windows + w])
        exact.append(acc)
    dec = codec.g2_from_device if g2 else codec.g1_from_device
    assert dec(cv, g, got) == exact


def _scan_points(prefix, totals, spec, D):
    """The points of a scan's prefix rows and chunk totals as tuples of
    Python ints: one (X, Y, Z) a point, each coordinate D components,
    digits read as they are (Montgomery form scales every coordinate
    alike)."""
    L = spec.n_limbs
    pre = prefix.reshape(-1, 3, D, L).permute(3, 1, 2, 0)  # [L, 3, D, N]
    tot = torch.stack([t.reshape(L, D, -1) for t in totals], dim=1)
    planes = torch.cat([pre, tot], dim=-1).cpu().numpy()
    coords = [[decode(planes[:, i, d], spec, mont=False) for d in range(D)] for i in range(3)]
    return [tuple(tuple(c[j] for c in coord) for coord in coords) for j in range(planes.shape[-1])]


def _same_point(a, b, p, nr):
    """Projective (X, Y, Z) over Fq (D = 1) or Fq2 = Fq[u]/(u^2 - nr):
    X1 Z2 = X2 Z1, Y1 Z2 = Y2 Z1, and Z = 0 on both or neither."""

    def mul(x, y):
        if len(x) == 1:
            return (x[0] * y[0] % p,)
        return ((x[0] * y[0] + nr * x[1] * y[1]) % p, (x[0] * y[1] + x[1] * y[0]) % p)

    (x1, y1, z1), (x2, y2, z2) = a, b
    if any(v % p for v in z1) != any(v % p for v in z2):
        return False
    return mul(x1, z2) == mul(x2, z1) and mul(y1, z2) == mul(y2, z1)


@pytest.mark.parametrize("segments", [1, 2, 3])
@pytest.mark.parametrize("curve", ["bn254", "bls12_381", "bls12_377", "bw6_761"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_suffix_scan_kernels_match_plain(dev, curve, group, segments):
    """K2/K3 at S = segments against their plain version at the same S:
    rows with random signs, infinities, and steps that double or cancel,
    and in row 0 a block of 40 chunks (a whole warp of columns) whose rows
    are all infinity at steps 1-3 (the early-out).  K = 7, which 3 does not
    divide, so the last segment is shorter; R*C = 150 columns is not a
    multiple of the 64-thread block.  Digit-equal to the plain version;
    for S > 1 the same points as S = 1, projectively; one scan launch for
    S = 1, else two and the ceil(log2(S - 1)) full adds of the carries."""
    c = get_curve(curve)
    g2 = group == "g2"
    R, K, C = 3, 7, 50
    n = R * K * C
    lhs, rhs, _ = _batches(curve, g2, n // 2, seed=7)
    pts = lhs + rhs  # storage order [r, k, c]; lhs and rhs share points
    rng = np.random.default_rng(8)
    g = (codec.g2_ops if g2 else codec.g1_ops)(c)
    to_dev = codec.g2_to_device if g2 else codec.g1_to_device
    # bw6_761's G2 lies over Fq: K2 with G2's b3
    fq2 = g.k.tower_deg == 2
    x, y, _ = to_dev(c, pts, "cpu")
    inf = torch.tensor([p is None for p in pts])
    x, y = (torch.where(inf, torch.zeros_like(t), t) for t in (x, y))

    def rows_of(t):  # [L, (2,) n] -> [n, ce], tower-major
        if fq2:
            t = t.movedim(1, 0)
        return t.reshape(-1, n).T

    rows = torch.cat([rows_of(x), rows_of(y)], dim=-1).contiguous()
    rows.view(R, K, C, -1)[0, 1:4, :40] = 0
    rows[:, 0] |= torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)) * cuda_scan.SIGN_BIT
    rows = rows.reshape(R, K * C, -1).to(dev)
    k = g.k
    nr = getattr(k, "nr_int", None)
    ops = cuda_point._plain_ops(k.spec, nr)
    name = "suffix_scan_g2" if fq2 else "suffix_scan_g1"
    add = "add_g2" if fq2 else "add_g1"

    def scan(S):
        if fq2:
            return cuda_scan.suffix_scan_g2_rows(k.spec, nr, g.b3_val, rows, K, C, segments=S)
        return cuda_scan.suffix_scan_g1_rows(k.spec, g.b3_val, rows, K, C, segments=S)

    before = (cuda_scan.LAUNCHES[name], cuda_point.LAUNCHES[add])
    got = scan(segments)
    torch.cuda.synchronize()
    after = (cuda_scan.LAUNCHES[name], cuda_point.LAUNCHES[add])
    carry_adds = 0 if segments == 1 else (segments - 2).bit_length()
    assert after == (before[0] + (1 if segments == 1 else 2), before[1] + carry_adds)
    want = cuda_scan.suffix_scan_plain(ops, g.b3_val, rows, K, C, segments)
    for x, y in zip([got[0], *got[1]], [want[0], *want[1]]):
        assert torch.equal(x, y)
    if segments > 1:
        one = scan(1)
        D = k.tower_deg
        a = _scan_points(got[0], got[1], k.spec, D)
        b = _scan_points(one[0], one[1], k.spec, D)
        assert all(_same_point(u, v, k.spec.modulus, nr or 0) for u, v in zip(a, b))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "capture"])
def test_prover_on_the_card_matches_the_exact_prover(dev, fused):
    """TorchProver on cuda gives the exact prover's proof, on each MSM
    scan path, through each of that path's kernels, the Horner kernel
    among them."""
    from groth16_tpu_torch.config import configure
    from groth16_tpu_torch.protocol.generator import setup
    from groth16_tpu_torch.protocol.prover import create_proof_with_reduction
    from groth16_tpu_torch.protocol.prover_torch import TorchProver
    from groth16_tpu_torch.protocol.verifier import prepare_verifying_key, verify_proof
    from groth16_tpu_torch.r1cs.circuits import DummyCircuit
    from groth16_tpu_torch.r1cs.system import ConstraintSystem, SynthesisMode
    from groth16_tpu_torch.utils.rng import Rng

    curve = "bn254"
    c = get_curve(curve)
    ncon, nvar = (1 << 6) - 2, 1 << 5
    rng = Rng(0x2B6)
    pk, vk = setup(DummyCircuit(nvar, ncon), curve, rng)
    r, s = rng.field_element(c.r), rng.field_element(c.r)
    cs = ConstraintSystem(c.r, mode=SynthesisMode.PROVE)
    DummyCircuit(nvar, ncon, a=3, b=5)(cs)
    prover = TorchProver(pk, cs.to_matrices())
    assert prover.device.type == "cuda"
    counters = {**cuda_fp.LAUNCHES, **cuda_point.LAUNCHES, **cuda_scan.LAUNCHES}
    scans = ("suffix_scan_g1", "suffix_scan_g2")
    mixed = ("add_mixed_g1", "add_mixed_g2")
    device_assembly = ("scalar_mul_g1", "scalar_mul_g2")  # host assembly here
    used = [k for k in counters if k not in (mixed if fused else scans) + device_assembly]
    with configure(msm_fused_scan=fused):
        got = prover.prove(cs.full_assignment(), r, s)
    after = {**cuda_fp.LAUNCHES, **cuda_point.LAUNCHES, **cuda_scan.LAUNCHES}
    assert all(after[k] > counters[k] for k in used), (counters, after)
    assert all(after[k] == counters[k] for k in counters if k not in used), (counters, after)
    want = create_proof_with_reduction(DummyCircuit(nvar, ncon, a=3, b=5), pk, r, s)
    assert (got.a, got.b, got.c) == (want.a, want.b, want.c)
    pvk = prepare_verifying_key(vk)
    assert verify_proof(pvk, got, [15]) and not verify_proof(pvk, got, [16])


@pytest.mark.parametrize("key", [op.key for op in ubench.OPS])
def test_ubench_kernel_matches_plain(dev, key):
    """Kernel V against its plain version: integer operations word for
    word, f32 ones within F32_RTOL; n = 1000 is not a multiple of the
    block."""
    a, b = ubench.inputs(key, 1000, seed=4, device=dev)
    before = ubench.LAUNCHES[key]
    got = ubench.chains(key, a, b, 64)
    torch.cuda.synchronize()
    assert ubench.LAUNCHES[key] == before + 1
    ubench.agree(key, got, ubench.chains_plain(key, a, b, 64))


@pytest.mark.parametrize("curve", ["bn254", "bls12_381", "bls12_377", "bw6_761"])
def test_batch_inv_and_to_affine_on_the_card(dev, curve):
    """fp.batch_inv (K1 products, a chunked scan of several chunks) and
    to_affine on the card give the exact inverses and affine points."""
    c = get_curve(curve)
    spec = make_spec(c.p)
    r = random.Random(6)
    n = 3000
    vals = [r.randrange(c.p) for _ in range(n)]
    vals[17] = 0
    a = torch.from_numpy(encode(vals, spec).astype(np.int32)).to(dev)
    before = cuda_fp.LAUNCHES["mont_mul"]
    got = decode(fp.batch_inv(spec, a).cpu().numpy(), spec)
    assert cuda_fp.LAUNCHES["mont_mul"] > before
    assert got == [pow(v, c.p - 2, c.p) for v in vals]
    lhs, rhs, add = _batches(curve, True, 40, seed=2)
    g = codec.g2_ops(c)
    p = g.add(*(codec.g2_to_device(c, x, dev) for x in (lhs, rhs)))  # Z != 1
    assert codec.g2_from_device(c, g, p) == [add(x, y) for x, y in zip(lhs, rhs)]


def test_setup_device_on_the_card_matches_the_exact_setup(dev):
    """generator_torch.setup_device on cuda (K1, K4, K5) gives the exact
    setup's key for the same Rng."""
    from groth16_tpu_torch.protocol.generator import setup
    from groth16_tpu_torch.protocol.generator_torch import setup_device
    from groth16_tpu_torch.r1cs.circuits import DummyCircuit
    from groth16_tpu_torch.utils.rng import Rng

    before = {**cuda_fp.LAUNCHES, **cuda_point.LAUNCHES}
    pk, _ = setup_device(DummyCircuit(6, 13), "bls12_381", Rng(3))
    after = {**cuda_fp.LAUNCHES, **cuda_point.LAUNCHES}
    assert all(after[k] > before[k] for k in ("mont_mul", "add_g1", "add_g2"))
    assert pk == setup(DummyCircuit(6, 13), "bls12_381", Rng(3))[0]


@pytest.mark.parametrize("lanes,nbits", [(1, 255), (2, 255), (3, 254), (33, 64), (4101, 16)])
@pytest.mark.parametrize("curve", ["bn254", "bls12_381", "bls12_377", "bw6_761"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_scalar_mul_kernel_matches_plain(dev, curve, group, lanes, nbits):
    """The scalar-multiplication kernel in one launch against its plain
    version (the select loop of additions it replaces): lanes with all
    bits zero and all one, and lanes of one warp with different bits;
    the first lanes also against the exact engine."""
    cv = get_curve(curve)
    g2 = group == "g2"
    g = (codec.g2_ops if g2 else codec.g1_ops)(cv)
    to_dev = codec.g2_to_device if g2 else codec.g1_to_device
    walk = _batches(curve, g2, min(lanes, 8) + 5, seed=lanes)[0][: min(lanes, 8)]
    pts = to_dev(cv, [walk[i % len(walk)] for i in range(lanes)], dev)
    rng = np.random.default_rng(lanes * nbits)
    bits = rng.integers(0, 2, (lanes, nbits), dtype=np.int32)
    bits[0] = 0
    if lanes > 1:
        bits[1] = 1
    bits = torch.from_numpy(bits).to(dev)
    k = g.k
    name = f"scalar_mul_g{k.tower_deg}"
    before = cuda_point.LAUNCHES[name]
    got = g.scalar_mul_bits(pts, bits)
    torch.cuda.synchronize()
    assert cuda_point.LAUNCHES[name] == before + 1
    want = cuda_point.scalar_mul_plain(
        cuda_point._plain_ops(k.spec, getattr(k, "nr_int", None)), g.b3_val, pts, bits)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    ref = RefGroups(curve)
    mul = ref.g2_mul if g2 else ref.g1_mul
    m = min(lanes, 3)
    scalars = [int("".join(str(int(b)) for b in row.tolist()[::-1]), 2) for row in bits[:m].cpu()]
    dec = codec.g2_from_device if g2 else codec.g1_from_device
    first = tuple(x[..., :m] for x in got)
    assert dec(cv, g, first) == [mul(walk[i % len(walk)], s) if s else None for i, s in enumerate(scalars)]


@pytest.mark.parametrize("curve", ["bn254", "bls12_381", "bls12_377", "bw6_761"])
def test_prove_batch_and_device_assembly_on_the_card(dev, curve):
    """prove_batch (two proofs, one fetch) and prove(host_assembly=False)
    (three launches of the scalar-multiplication kernel) on the card give
    the exact prover's proofs for the same r and s."""
    from groth16_tpu_torch.protocol.generator import setup
    from groth16_tpu_torch.protocol.prover import create_proof_with_reduction
    from groth16_tpu_torch.protocol.prover_torch import TorchProver
    from groth16_tpu_torch.r1cs.circuits import DummyCircuit
    from groth16_tpu_torch.r1cs.system import ConstraintSystem, SynthesisMode
    from groth16_tpu_torch.utils.rng import Rng

    c = get_curve(curve)
    ncon, nvar = (1 << 6) - 2, 1 << 5
    rng = Rng(0xBA7)
    pk, _ = setup(DummyCircuit(nvar, ncon), curve, rng)
    cs = ConstraintSystem(c.r, mode=SynthesisMode.PROVE)
    DummyCircuit(nvar, ncon, a=3, b=5)(cs)
    z = cs.full_assignment()
    prover = TorchProver(pk, cs.to_matrices())
    rs = [rng.field_element(c.r) for _ in range(3)]
    ss = [rng.field_element(c.r) for _ in range(3)]
    want = [create_proof_with_reduction(DummyCircuit(nvar, ncon, a=3, b=5), pk, r, s) for r, s in zip(rs, ss)]
    got = prover.prove_batch([z, z], rs[:2], ss[:2])
    before = dict(cuda_point.LAUNCHES)
    got.append(prover.prove(z, rs[2], ss[2], host_assembly=False))
    # bw6_761's G2 lies over Fq: its G2 multiple runs G1's kernel
    g2_over_fq = c.g2_over_base
    assert cuda_point.LAUNCHES["scalar_mul_g1"] == before["scalar_mul_g1"] + 2 + g2_over_fq
    assert cuda_point.LAUNCHES["scalar_mul_g2"] == before["scalar_mul_g2"] + 1 - g2_over_fq
    assert [(p.a, p.b, p.c) for p in got] == [(p.a, p.b, p.c) for p in want]


def test_bench_on_the_card_verifies_on_the_native_engine(dev):
    """groth16_tpu_torch.bench at 2^10 on bls12_377: the line's steady
    proves verify (run raises otherwise) on the native engine, and its
    speed-of-light fractions divide by the card's measured rate."""
    from groth16_tpu_torch.bench import run

    line = run("bls12_377", 10, steady=1, batch=2, verify_reps=2, nnz=(100,))
    e = line["extras"]
    assert e["verify_engine"] == "native"
    assert line["value"] > 0 and e["int32_mad_per_s"] > 0
    assert 0 < e["msm_g1_sol_frac"] < 1 and 0 < e["msm_g2_sol_frac"] < 1 and 0 < e["ntt_sol_frac"] < 1


def test_bw6_bench_on_the_card_verifies_on_the_native_engine(dev):
    """groth16_tpu_torch.bench at 2^10 on bw6_761 (L = 52, G2 over Fq):
    the line's proves verify on the native (Tate) engine, and its
    speed-of-light fractions divide by the card's measured rate."""
    from groth16_tpu_torch.bench import run

    line = run("bw6_761", 10, steady=1, batch=2, verify_reps=2, nnz=(100,))
    e = line["extras"]
    assert e["verify_engine"] == "native"
    assert line["value"] > 0 and e["int32_mad_per_s"] > 0
    assert 0 < e["msm_g1_sol_frac"] < 1 and 0 < e["msm_g2_sol_frac"] < 1 and 0 < e["ntt_sol_frac"] < 1
