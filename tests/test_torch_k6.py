"""K6, the G1 mixed addition on 32-bit words, modelled with Python ints.

The kernel (csrc/point_add.cu: point_add_words_kernel over
csrc/point.cuh: rcb_add_mixed_w) packs each coordinate's digits into W
words of 32 bits (9 at L = 18, 12 at L = 26) and keeps every value of the
formula in words: Montgomery products on words (mont_mul_w), and the lazy
adds, subtractions with kp and cond_subs as carry and borrow chains.  The
model below runs the same steps in the same order on the same word
constants (p, 2p, 4p, b3 of `cuda_point.mixed_word_consts`), asserts that
no chain carries out of its top word and no product leaves its W + 2
accumulator words, and must return the plain version's digits
(`cuda_point.mixed_add_plain`) digit for digit: the argument that the
kernel is digit-equal to it.  Inputs are coordinates as representatives
in [p, 2p), with P2 infinity, P1 infinity, P1 = P2 and P1 = -P2.
"""

import random

import pytest
import torch

from groth16_tpu_torch.curves import codec, cuda_point
from groth16_tpu_torch.curves.params import get_curve
from groth16_tpu_torch.fields.spec import LIMB_BITS, LIMB_MASK
from groth16_tpu_torch.ref.curve import RefGroups
from groth16_tpu_torch.utils import profiling

torch.set_num_threads(1)

M32 = (1 << 32) - 1


class WordModel:
    """The word steps of rcb_add_mixed_w for one field; words are lists
    of W ints below 2^32, least significant first."""

    def __init__(self, spec, b3_val):
        self.L = spec.n_limbs
        consts = list(cuda_point.mixed_word_consts(spec, b3_val))
        W = self.W = (len(consts) - 1) // 4
        self.p, self.n0 = consts[:W], consts[W]
        self.p2, self.p4, self.b3 = (consts[W + 1 + k * W : W + 1 + (k + 1) * W] for k in range(3))
        self.full = 15 * self.L // 32
        self.part = 15 * self.L - 32 * self.full
        self.pv = spec.modulus

    @staticmethod
    def value(w):
        return sum(x << (32 * i) for i, x in enumerate(w))

    def words(self, v):
        assert 0 <= v < 1 << (32 * self.W)
        return [(v >> (32 * i)) & M32 for i in range(self.W)]

    def pack(self, digits):
        """digits_to_words: rex (a ripple carry), then each 15-bit digit
        ORed into its word(s)."""
        w, c = [0] * self.W, 0
        for j, d in enumerate(digits):
            t = int(d) + c
            c = t >> LIMB_BITS
            d = t & LIMB_MASK
            bit = LIMB_BITS * j
            if bit // 32 < self.W:
                w[bit // 32] |= (d << (bit % 32)) & M32
            if bit % 32 > 32 - LIMB_BITS and bit // 32 + 1 < self.W:
                w[bit // 32 + 1] |= d >> (32 - bit % 32)
        return w

    def unpack(self, w):
        v = self.value(w)
        return [(v >> (LIMB_BITS * j)) & LIMB_MASK for j in range(self.L)]

    def add(self, a, b):  # add.cc / addc.cc / addc
        r, cc = [], 0
        for x, y in zip(a, b):
            s = x + y + cc
            r.append(s & M32)
            cc = s >> 32
        assert cc == 0, "carry out of the top word"
        return r

    def sub(self, a, b, m):  # a + m, then the borrow chain of b
        t = self.add(a, m)
        r, bw = [], 0
        for x, y in zip(t, b):
            d = x - y - bw
            r.append(d & M32)
            bw = int(d < 0)
        assert bw == 0, "borrow out of the top word"
        return r

    def cond_sub(self, x, m):
        u, bw = [], 0
        for a, b in zip(x, m):
            d = a - b - bw
            u.append(d & M32)
            bw = int(d < 0)
        return x if bw else u

    def mul(self, a, b):
        """mont_mul_w: W rows of a_i * b, the first FULL each followed by
        a 32-bit reduction step, then the PART-bit step."""
        assert self.value(a) < 8 * self.pv and self.value(b) < 8 * self.pv
        bv, t = self.value(b), 0
        for i in range(self.W):
            t += a[i] * bv
            assert t < 1 << (32 * (self.W + 2))
            if i < self.full:
                t += ((t * self.n0) & M32) * self.value(self.p)
                assert t < 1 << (32 * (self.W + 2)) and t & M32 == 0
                t >>= 32
        t += ((t * self.n0) & ((1 << self.part) - 1)) * self.value(self.p)
        t >>= self.part
        assert t < 2 * self.pv
        return self.words(t)

    def add_mixed(self, X1, Y1, Z1, X2, Y2):
        """The kernel on one point's digit columns: the infinity test on
        Y2's digits first, then rcb_add_mixed_w's steps in its order."""
        if not any(int(d) for d in Y2):
            return [list(map(int, v)) for v in (X1, Y1, Z1)]
        X1, Y1, Z1, X2, Y2 = (self.pack(v) for v in (X1, Y1, Z1, X2, Y2))
        m3 = self.mul(self.add(X1, Y1), self.add(X2, Y2))
        t0 = self.mul(X1, X2)
        t5 = self.add(X1, self.mul(X2, Z1))
        t1 = self.mul(Y1, Y2)
        t4 = self.add(Y1, self.mul(Y2, Z1))
        t3 = self.sub(m3, self.add(t0, t1), self.p4)
        t2b = self.mul(Z1, self.b3)
        Z3s = self.add(t1, t2b)
        t1m = self.sub(t1, t2b, self.p2)
        t0t = self.add(self.add(t0, t0), t0)
        t5b = self.mul(t5, self.b3)
        X3 = self.sub(self.mul(t3, t1m), self.mul(t4, t5b), self.p2)
        Y3 = self.add(self.mul(t1m, Z3s), self.mul(t5b, t0t))
        Z3 = self.add(self.mul(Z3s, t4), self.mul(t0t, t3))
        return [self.unpack(self.cond_sub(v, self.p2)) for v in (X3, Y3, Z3)]


def _plus_p(x: torch.Tensor, modulus: int, keep: torch.Tensor) -> torch.Tensor:
    """Exact digits of each column's value + p (a representative in
    [p, 2p)), except the columns where `keep` holds."""
    L = x.shape[0]
    cols = []
    for i in range(x.shape[1]):
        v = sum(int(d) << (LIMB_BITS * j) for j, d in enumerate(x[:, i].tolist()))
        if not keep[i]:
            v += modulus
        cols.append([(v >> (LIMB_BITS * j)) & LIMB_MASK for j in range(L)])
    return torch.tensor(cols, dtype=torch.int32).T.contiguous()


@pytest.mark.parametrize("curve", ["bn254", "bls12_381"])
def test_word_model_matches_plain_mixed_add(curve):
    c = get_curve(curve)
    ref = RefGroups(curve)
    r = random.Random(17)
    base = ref.g1_sample(5)
    pts = [ref.g1_mul(base, r.randrange(1, c.r)) for _ in range(4)]
    # random, P2 infinity, P1 infinity, P1 = P2, P1 = -P2
    lhs = [pts[0], pts[1], None, pts[2], pts[3]]
    rhs = [pts[1], None, pts[0], pts[2], ref.g1_neg(pts[3])]
    g = codec.g1_ops(c)
    p1 = codec.g1_to_device(c, lhs, "cpu")
    p1 = g.add(p1, g.infinity(g.batch_shape(p1)))  # projective, Z != 1
    inf2 = torch.tensor([q is None for q in rhs])
    xy = tuple(torch.where(inf2, torch.zeros_like(x), x) for x in codec.g1_to_device(c, rhs, "cpu")[:2])
    never = torch.zeros_like(inf2)
    p1 = tuple(_plus_p(x, c.p, never) for x in p1)
    xy = tuple(_plus_p(x, c.p, inf2) for x in xy)  # (0, 0) stays infinity
    want = cuda_point.mixed_add_plain(cuda_point._plain_ops(g.k.spec, None), g.b3_val, p1, xy)
    model = WordModel(g.k.spec, g.b3_val)
    assert model.W == {18: 9, 26: 12}[model.L]
    for i in range(len(lhs)):
        got = model.add_mixed(*(x[:, i].tolist() for x in p1 + xy))
        assert got == [x[:, i].tolist() for x in want], f"point {i}"
    assert codec.g1_from_device(c, g, want) == [ref.g1_add(a, b) for a, b in zip(lhs, rhs)]


def test_point_add_word_ops():
    """K6's word bound: 13 word products of 333 (L = 18) or 613 (L = 26)
    multiplies."""
    assert profiling.point_add_word_ops(18) == 4329 == 13 * profiling.mont_mul_word_ops(18)
    assert profiling.point_add_word_ops(26) == 7969 == 13 * profiling.mont_mul_word_ops(26)
    for L in (18, 26):
        w = profiling.mont_mul_word_ops(L)
        assert profiling.point_add_word_ops(L, fp2=True) == 52 * w
        assert profiling.point_add_word_ops(L, mixed=False) == 12 * w
        assert profiling.point_add_word_ops(L) < profiling.point_add_u32_ops(L) // 2 + L


def test_point_add_general_products():
    """The generic-a bound counts the products MNT's addition needs: 12
    field products of deg^2 base products, and 2 by b3 (large, a monomial
    on the twists); the products by a (2, 11, 34) are additions."""
    counts = []
    for name in ("mnt4_298", "mnt6_298"):
        c = get_curve(name)
        for g in (codec.g1_ops(c), codec.g2_ops(c)):
            counts.append(profiling.general_add_products(g))
            w = profiling.point_add_general_word_ops(g)
            assert w == counts[-1] * profiling.mont_mul_word_ops(21)
    assert counts == [14, 12 * 4 + 2 * 2, 14, 12 * 9 + 2 * 3]
    assert profiling.const_products(-5 % get_curve("mnt6_298").p, get_curve("mnt6_298").p) == 0


# points a wave of K6's forms holds on an H100 (132 SMs, 128 threads a
# block): 6 and 8 blocks an SM at L = 18, 4 and 6 at L = 26, and 2 of the
# one form built at L = 52
H100_WAVES = {18: {"words": 6 * 132 * 128, "words_wide": 8 * 132 * 128},
              26: {"words": 4 * 132 * 128, "words_wide": 6 * 132 * 128},
              52: {"words": 2 * 132 * 128}}


@pytest.mark.parametrize("L,n,form", [
    (18, 4097, "words"), (18, 1 << 16, "words"), (18, 6 * 132 * 128, "words"),
    (18, 6 * 132 * 128 + 1, "words_wide"), (18, 1 << 17, "words_wide"),
    (18, 8 * 132 * 128 + 1, "words"), (18, 3 << 17, "words_wide"), (18, 1 << 20, "words_wide"),
    (26, 1 << 16, "words"), (26, 73728, "words_wide"), (26, 1 << 17, "words"),
    (26, 1 << 18, "words_wide"),
    (52, 1 << 16, "words"), (52, 2 * 132 * 128 + 1, "words"), (52, 1 << 17, "words"),
])
def test_mixed_g1_form_by_waves(L, n, form):
    """K6 takes its wide form where that runs the launch in fewer waves,
    else its natural one (one wave of the wide form takes longer); at
    L = 52, where only the natural form is built, always that one."""
    assert tuple(H100_WAVES[L]) == cuda_point.mixed_g1_forms(L)
    assert cuda_point.mixed_g1_form(n, H100_WAVES[L]) == form
