"""Port field engine (plain version of K1 and the tensor ops) against the
JAX package's fields/fp.py on the CPU.  Tolerance: digit-for-digit
equality — both run the same interleaved CIOS, fold/rex passes and k*p
offsets."""

import random

import jax
import numpy as np
import pytest
import torch

from groth16_tpu.curves.params import get_curve
from groth16_tpu.fields import fp as jfp
from groth16_tpu.fields.spec import make_spec as jmake_spec
from groth16_tpu_torch.curves import codec, cuda_point
from groth16_tpu_torch.curves.params import get_curve as tget_curve
from groth16_tpu_torch.fields import cuda_fp, fp
from groth16_tpu_torch.fields.spec import encode, make_spec
from groth16_tpu_torch.ntt.ntt import NttDomain

torch.set_num_threads(1)

FIELDS = [
    pytest.param(get_curve("bn254").p, id="bn254.Fq"),
    pytest.param(get_curve("bn254").r, id="bn254.Fr"),
    pytest.param(get_curve("bls12_381").p, id="bls12_381.Fq"),
    pytest.param(get_curve("bls12_377").p, id="bls12_377.Fq"),
]
N = 16


def _digits(values, spec, cls, seed):
    """uint32[L, N] digits of values (< 8p) in digit class cls:
    exact (< 2^15), semi (<= 2^15 + 2^12) or lazy (< 2^27)."""
    L = spec.n_limbs
    d = np.array([[(v >> (15 * i)) & 0x7FFF for v in values] for i in range(L)], np.int64)
    if cls == "exact":
        return d.astype(np.uint32)
    rng = np.random.default_rng(seed)
    cap = 1 if cls == "semi" else 1 << 11
    for i in range(L - 1):
        # move r units of 2^15 from digit i+1 down into digit i
        r = np.minimum(rng.integers(0, cap + 1, size=d.shape[1]), d[i + 1])
        if cls == "semi":
            r = np.where(d[i] <= 1 << 12, r, 0)
        d[i] += r << 15
        d[i + 1] -= r
    return d.astype(np.uint32)


def _vals(p, seed, bound=8):
    r = random.Random(seed)
    return [r.randrange(bound * p) for _ in range(N - 3)] + [0, 1, bound * p - 1]


def _value(arr):
    arr = np.asarray(arr, dtype=object)
    return [sum(int(arr[i, j]) << (15 * i) for i in range(arr.shape[0])) for j in range(arr.shape[1])]


@pytest.mark.parametrize("modulus", FIELDS)
@pytest.mark.parametrize("cls", ["exact", "semi", "lazy"])
def test_mont_mul_matches_jax(modulus, cls):
    s, js = make_spec(modulus), jmake_spec(modulus)
    a = _digits(_vals(modulus, 1), s, cls, 3)
    b = _digits(_vals(modulus, 2), s, cls, 4)
    assert _value(a) == _vals(modulus, 1)
    got = fp.mont_mul(s, torch.from_numpy(a.astype(np.int32)), torch.from_numpy(b.astype(np.int32)))
    want = np.asarray(jax.jit(lambda x, y: jfp.mont_mul(js, x, y))(a, b))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    rinv = pow(s.R, -1, modulus)
    assert [v % modulus for v in _value(got.numpy())] == [
        x * y * rinv % modulus for x, y in zip(_vals(modulus, 1), _vals(modulus, 2))
    ]


@pytest.mark.parametrize("modulus", FIELDS)
def test_sub_cond_sub_mont_conversions_match_jax(modulus):
    s, js = make_spec(modulus), jmake_spec(modulus)
    a = _digits(_vals(modulus, 5, bound=4), s, "lazy", 6)
    b = _digits(_vals(modulus, 7, bound=2), s, "exact", 8)
    ta, tb = (torch.from_numpy(x.astype(np.int32)) for x in (a, b))

    def jx(f, *args):
        return np.asarray(jax.jit(f)(*args))

    def eq(got, want):
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)

    eq(fp.sub(s, ta, tb, k=2), jx(lambda x, y: jfp.sub(js, x, y, k=2), a, b))
    eq(fp.cond_sub(s, ta, s.two_p_limbs), jx(lambda x: jfp.cond_sub(js, x, js.two_p_limbs), a))
    std = encode(_vals(modulus, 9, bound=1), s, mont=False)
    eq(fp.to_mont(s, torch.from_numpy(std.astype(np.int32))), jx(lambda x: jfp.to_mont(js, x), std))
    eq(fp.from_mont(s, tb), jx(lambda x: jfp.from_mont(js, x), b))


def test_wrappers_have_no_fallback_off_the_cpu():
    """A wrapper runs the plain version only for CPU tensors: any other
    device launches the kernel (CUDA) or raises, as here on `meta`."""
    c = get_curve("bn254")
    s = make_spec(c.p)
    a = torch.zeros((s.n_limbs, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        cuda_fp.mont_mul(s, a, a)
    with pytest.raises(ValueError):
        cuda_point.add_g1(s, codec.g1_ops(c).b3_val, (a, a, a), (a, a, a))


def _at_limit(values, L):
    """int32-safe digits of values (< 8p) with the most each digit can take
    moved down from the next (lazy, digits near 2^27)."""
    d = np.array([[(v >> (15 * i)) & 0x7FFF for v in values] for i in range(L)], np.int64)
    for i in range(L - 1):
        r = np.minimum((1 << 12) - 1, d[i + 1])
        d[i] += r << 15
        d[i + 1] -= r
    return d.astype(np.uint32)


@pytest.mark.parametrize("curve,field", [
    ("bn254", "p"), ("bn254", "r"), ("bls12_381", "p"), ("bls12_377", "p"), ("bw6_761", "p")])
def test_plain_int_route_matches_int64_cios(curve, field):
    """mont_mul_plain's two CPU routes give the same digits: the same
    lazy operands (digits at their limit, values up to 8p - 1, a period-1
    constant among them) at n = PLAIN_INT_MAX_N (Python ints) and tiled
    to twice that (the int64 CIOS)."""
    p = getattr(tget_curve(curve), field)
    s = make_spec(p)
    L, n = s.n_limbs, cuda_fp.PLAIN_INT_MAX_N
    r = random.Random(L)
    va = [0, 1, p - 1, 8 * p - 1] + [r.randrange(8 * p) for _ in range(n - 4)]
    vb = [8 * p - 1, 8 * p - 1, 2 * p + 1, 8 * p - 2] + [r.randrange(8 * p) for _ in range(n - 4)]
    a = torch.from_numpy(_at_limit(va, L).astype(np.int32))
    b = torch.from_numpy(_digits(vb, s, "lazy", 5).astype(np.int32))
    ints = cuda_fp.mont_mul_plain(s, a, b)
    cios = cuda_fp.mont_mul_plain(s, a.repeat(1, 2), b.repeat(1, 2))
    assert torch.equal(cios, torch.cat([ints, ints], dim=1))
    rinv = pow(s.R, -1, p)
    assert [v % p for v in _value(ints.numpy())] == [x * y * rinv % p for x, y in zip(va, vb)]
    const = cuda_fp.mont_mul_plain(s, a, b[:, :1])
    assert torch.equal(cuda_fp.mont_mul_plain(s, a.repeat(1, 2), b[:, :1], 2 * n), torch.cat([const, const], dim=1))


@pytest.mark.parametrize(
    "modulus,curve",
    [
        pytest.param(get_curve("bn254").r, "bn254", id="bn254.Fr"),
        pytest.param(get_curve("bls12_381").p, "bls12_381", id="bls12_381.Fq"),
    ],
)
def test_mont_mul_period_operands_match_jax(modulus, curve, monkeypatch):
    """fp.mont_mul hands an [L, 1] constant and the NTT-shaped [L, 1, h]
    operand (against [L, n/h, h]) to K1's wrapper as [L, 1] and [L, h],
    read with a period: the same digits as the materialised operands, as
    the JAX package's mont_mul on the same broadcast shapes, and a*b*R^-1
    mod p.  In an NTT over the curve's Fr every stage's twiddles reach the
    wrapper as [L, h], never as an [L, n/2] copy, and ifft's 1/n as
    [L, 1]."""
    s, js = make_spec(modulus), jmake_spec(modulus)
    L, n, h = s.n_limbs, 64, 8
    r = random.Random(11)
    va = [0, 1, modulus - 1, 8 * modulus - 1] + [r.randrange(8 * modulus) for _ in range(n - 4)]
    vc = [8 * modulus - 1]
    vt = [r.randrange(8 * modulus) for _ in range(h)]
    a, c, t = _at_limit(va, L), _at_limit(vc, L), _digits(vt, s, "lazy", 12)
    seen = []
    real = cuda_fp.mont_mul

    def record(spec, x, y, n=None):
        seen.append((tuple(x.shape), tuple(y.shape), n))
        return real(spec, x, y, n)

    monkeypatch.setattr(cuda_fp, "mont_mul", record)
    ta, tc, tt = (torch.from_numpy(x.astype(np.int32)) for x in (a, c, t))
    got_c = fp.mont_mul(s, ta, tc)
    got_t = fp.mont_mul(s, ta.reshape(L, n // h, h), tt.reshape(L, 1, h))
    assert seen == [((L, n), (L, 1), n), ((L, n), (L, h), n)]
    full_t = tt.reshape(L, 1, h).expand(L, n // h, h).contiguous()
    assert torch.equal(got_c, fp.mont_mul(s, ta, tc.expand(L, n).contiguous()))
    assert torch.equal(got_t, fp.mont_mul(s, ta.reshape(L, n // h, h), full_t))
    want_c, want_t = jax.jit(lambda x, y, x3, y3: (jfp.mont_mul(js, x, y), jfp.mont_mul(js, x3, y3)))(
        a, c, a.reshape(L, n // h, h), t.reshape(L, 1, h)
    )
    np.testing.assert_array_equal(got_c.numpy().astype(np.uint32), np.asarray(want_c))
    np.testing.assert_array_equal(got_t.numpy().astype(np.uint32), np.asarray(want_t))
    rinv = pow(s.R, -1, modulus)
    assert [v % modulus for v in _value(got_c.numpy())] == [x * vc[0] * rinv % modulus for x in va]
    assert [v % modulus for v in _value(got_t.reshape(L, n).numpy())] == [
        x * vt[i % h] * rinv % modulus for i, x in enumerate(va)
    ]

    # a 2^5 domain, forward and inverse (run once first: the power tables
    # are built and cached on first use)
    dom = NttDomain(tget_curve(curve).fr, 32, device="cpu")
    x = fp.const(dom.spec, 5, (32,)).contiguous()
    dom.ifft(dom.fft(x))
    seen.clear()
    dom.ifft(dom.fft(x))
    widths = [(x_shape[1], y_shape[1]) for x_shape, y_shape, _ in seen]
    # (elements, twiddle period) of each stage, both transforms, then 1/n
    assert widths == [(16, 16), (16, 8), (16, 4), (16, 2), (16, 1)] * 2 + [(32, 1)]


def _words_model(digits, p, L, full=None):
    """Python-int model of K1's word engine (csrc/field.cuh:
    mont_mul_words) on one element: the operands' exact digits packed into
    W words of 32 bits, FULL = floor(15 L / 32) CIOS steps of 32 bits and
    one partial step of the PART = 15 L - 32 FULL bits left, the result
    unpacked into 15-bit digits.  full=n instead runs n full steps and no
    partial one."""
    W = {18: 9, 21: 10, 26: 12, 52: 24}[L]
    steps = 15 * L // 32 if full is None else full
    part = 15 * L - 32 * steps if full is None else 0
    n0 = -pow(p, -1, 1 << 32) % (1 << 32)

    def pack(d):
        value = sum(int(x) << (15 * j) for j, x in enumerate(d))
        exact = [(value >> (15 * j)) & 0x7FFF for j in range(L)]  # rex
        w = [0] * W
        for j, x in enumerate(exact):
            bit = 15 * j
            if bit // 32 < W:
                w[bit // 32] |= (x << (bit % 32)) & 0xFFFFFFFF
            if bit % 32 > 17 and bit // 32 + 1 < W:
                w[bit // 32 + 1] |= x >> (32 - bit % 32)
        return w

    a, b = (pack(d) for d in digits)
    bv = sum(x << (32 * i) for i, x in enumerate(b))
    t = 0
    for i in range(W):
        t += a[i] * bv
        if i < steps:
            t = (t + (t * n0 % (1 << 32)) * p) >> 32
    if part:
        t = (t + (t * n0 % (1 << part)) * p) >> part
    assert t < 1 << (32 * W)
    return [(t >> (15 * j)) & 0x7FFF for j in range(L)]


@pytest.mark.parametrize(
    "modulus",
    [pytest.param(get_curve("bn254").p, id="bn254.Fq"), pytest.param(get_curve("bls12_381").p, id="bls12_381.Fq")],
)
def test_word_engine_model_matches_plain_mont_mul(modulus):
    """The argument K1 rests on: Montgomery with R = 2^(15 L) built from
    32-bit steps (8 full and a 14-bit one at L = 18, 12 full and a 6-bit
    one at L = 26; L = 52: tests/test_torch_bw6.py) gives the 15-bit
    CIOS's digits, on 0, 1, p - 1, values
    just below 8p with digits near 2^27 and 64 random lazy values; a ninth
    full step at L = 18 (R = 2^288) gives other values."""
    s = make_spec(modulus)
    L = s.n_limbs
    r = random.Random(13)
    va = [0, 1, modulus - 1, 8 * modulus - 1, 8 * modulus - 2] + [r.randrange(8 * modulus) for _ in range(64)]
    vb = [8 * modulus - 1, modulus - 1, 1, 8 * modulus - 1, 8 * modulus - 3] + [r.randrange(8 * modulus) for _ in range(64)]
    a = np.concatenate([_at_limit(va[:5], L), _digits(va[5:], s, "lazy", 14)], axis=1)
    b = np.concatenate([_at_limit(vb[:5], L), _digits(vb[5:], s, "lazy", 15)], axis=1)
    plain = cuda_fp.mont_mul_plain(s, torch.from_numpy(a.astype(np.int32)), torch.from_numpy(b.astype(np.int32)))
    plain = plain.numpy().T.tolist()
    model = [_words_model((a[:, i], b[:, i]), modulus, L) for i in range(a.shape[1])]
    assert model == plain
    if L == 18:
        ninth = [_words_model((a[:, i], b[:, i]), modulus, L, full=9) for i in range(a.shape[1])]
        assert all(x != y for x, y in zip(ninth[5:], plain[5:]))
