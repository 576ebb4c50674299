"""The MNT fields on the port's engine against the JAX package on the
CPU: K1's plain version at L = 21 (the 298-bit Fq and Fr of MNT4-298 and
MNT6-298: MNT4's p is MNT6's r and the other way round) digit-equal to
`groth16_tpu.fields.fp.mont_mul` (the XLA path), beside a Python model of
K1's word engine at L = 21 (10 words, 9 full 32-bit steps and a 27-bit
one); and `Fp3Ops` (MNT6's G2 tower) against the JAX package's `Fp3Ops`.
Tolerance: digit-for-digit equality (the same CIOS, folds and k*p
offsets).  Three cases, so pytest-xdist's --dist loadfile hands the file
out after tests/test_gadget.py."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fp import _at_limit, _digits, _value, _words_model

from groth16_tpu.fields import fp as jfp
from groth16_tpu.fields.ops import Fp3Ops as JFp3Ops
from groth16_tpu.fields.spec import make_spec as jmake_spec
from groth16_tpu_torch.curves.params import get_curve
from groth16_tpu_torch.fields import cuda_fp
from groth16_tpu_torch.fields.ops import Fp3Ops
from groth16_tpu_torch.fields.spec import decode, encode, make_spec

torch.set_num_threads(1)


@pytest.mark.parametrize("curve", ["mnt4_298", "mnt6_298"])
def test_mont_mul_l21_matches_jax(curve):
    """K1's plain version on curve's Fq (L = 21) against fp.mont_mul of
    the JAX package on lazy operands and operands at the digit limit
    (values up to 8p - 1), the result the Montgomery product mod p; the
    word-engine model gives the same digits."""
    p = get_curve(curve).p
    s, js = make_spec(p), jmake_spec(p)
    assert s.n_limbs == 21 and cuda_fp.KERNEL_WORDS[21] == 10 and 8 * p < 1 << 320
    r = random.Random(21)
    va = [0, 1, p - 1, 8 * p - 1] + [r.randrange(8 * p) for _ in range(28)]
    vb = [8 * p - 1, p - 1, 1, 8 * p - 2] + [r.randrange(8 * p) for _ in range(28)]
    a = np.concatenate([_at_limit(va[:4], 21), _digits(va[4:], s, "lazy", 3)], axis=1)
    b = np.concatenate([_at_limit(vb[:4], 21), _digits(vb[4:], s, "lazy", 4)], axis=1)
    assert _value(a) == va and _value(b) == vb
    got = cuda_fp.mont_mul_plain(s, torch.from_numpy(a.astype(np.int32)), torch.from_numpy(b.astype(np.int32)))
    want = np.asarray(jax.jit(lambda x, y: jfp.mont_mul(js, x, y))(a, b))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    rinv = pow(s.R, -1, p)
    assert [v % p for v in _value(got.numpy())] == [x * y * rinv % p for x, y in zip(va, vb)]
    model = [_words_model((a[:, i], b[:, i]), p, 21) for i in range(a.shape[1])]
    assert model == got.numpy().T.tolist()


def _fp3(vals, spec):
    """Fq3 triples -> int32 [L, 3, n] Montgomery digits."""
    flat = [x for v in vals for x in v]
    return encode(flat, spec).reshape(spec.n_limbs, len(vals), 3).transpose(0, 2, 1).copy()


def test_fp3_ops_match_jax():
    """Fp3Ops (MNT6-298's Fq3 = Fq[v]/(v^3 - 5)): mul, square, inv and
    batch_inv (a zero element maps to zero) digit-equal to the JAX
    package's Fp3Ops, and the products equal to the schoolbook product
    mod (v^3 - 5) on ints."""
    c = get_curve("mnt6_298")
    p, nr = c.p, c.fp2_nonresidue
    s, js = make_spec(p), jmake_spec(p)
    r = random.Random(3)
    va = [tuple(r.randrange(p) for _ in range(3)) for _ in range(3)] + [(0, 0, 0), (1, 0, 0)]
    vb = [tuple(r.randrange(p) for _ in range(3)) for _ in range(5)]
    a, b = _fp3(va, s), _fp3(vb, s)
    k, jk = Fp3Ops(s, nr), JFp3Ops(js, nr)
    ta, tb = torch.from_numpy(a.astype(np.int32)), torch.from_numpy(b.astype(np.int32))
    ja, jb = jnp.asarray(a.astype(np.uint32)), jnp.asarray(b.astype(np.uint32))

    def eq(got, want):
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), np.asarray(want))

    prod, sq = k.mul_many([(ta, tb), (ta, ta)])
    jprod, jsq = jk.mul_many([(ja, jb), (ja, ja)])
    eq(prod, jprod)
    eq(sq, jsq)
    eq(k.inv(ta[..., :3]), jk.inv(ja[..., :3]))
    eq(k.batch_inv(ta), jk.batch_inv(ja))

    def dec(x):  # [L, 3, n] Montgomery -> triples
        v = decode(np.moveaxis(x.numpy(), 1, 2).reshape(s.n_limbs, -1), s)
        return [tuple(v[3 * i : 3 * i + 3]) for i in range(x.shape[-1])]

    def mul3(x, y):
        t = [0] * 5
        for i in range(3):
            for j in range(3):
                t[i + j] += x[i] * y[j]
        return ((t[0] + nr * t[3]) % p, (t[1] + nr * t[4]) % p, t[2] % p)

    assert dec(prod) == [mul3(x, y) for x, y in zip(va, vb)]
    inv = dec(k.batch_inv(ta))
    assert inv[3] == (0, 0, 0)
    assert all(mul3(x, y) == (1, 0, 0) for i, (x, y) in enumerate(zip(va, inv)) if i != 3)
