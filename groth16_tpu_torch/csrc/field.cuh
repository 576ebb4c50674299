// Field engine shared by the CUDA kernels of groth16_tpu_torch.
//
// Elements are L little-endian 15-bit digits held in uint32 registers, in
// Montgomery form with R = 2^(15 L) — the digit and value classes of
// groth16_tpu/fields/fp.py (exact < 2^15, semi <= 2^15 + 2^12, lazy < 2^27;
// values bounded by multiples of p, R >= 64 p).  Global buffers are
// limb-major: digit j of element i sits at j * N + i (Fp2: (j * 2 + c) * N
// + i), so thread i of a warp reads neighbouring words.
//
// Every function here returns the same digits as its PyTorch counterpart in
// fields/fp.py: mont_mul is the interleaved CIOS of pallas_fp.cios; `rex`
// resolves columns to exact digits of (value mod 2^(15 L)) with a ripple
// carry, which gives the same digits as fp.rex's two folds and packed
// carry addition (both compute value mod 2^(15 L) exactly).
//
// The constant table (fields/cuda_fp.py:kernel_consts) holds rows k*p for
// k = 0..34, then b3 = 3b in Montgomery form (rows c0, c1), then one in
// Montgomery form (R mod p).

#pragma once

#include <cstdint>

namespace g16 {

constexpr uint32_t MASK = 0x7fffu;
constexpr int BITS = 15;
constexpr int KP_ROWS = 35;

template <int L>
struct Consts {
  const uint32_t* __restrict__ c;
  uint32_t n0;  // -p^-1 mod 2^15
  __device__ __forceinline__ uint32_t kp(int k, int j) const { return __ldg(c + k * L + j); }
  __device__ __forceinline__ uint32_t b3(int comp, int j) const {
    return __ldg(c + (KP_ROWS + comp) * L + j);
  }
  __device__ __forceinline__ uint32_t one(int j) const { return __ldg(c + (KP_ROWS + 2) * L + j); }
};

// fp.fold: lazy -> semi; the top digit's high part is dropped (callers keep
// value < R, which makes it zero).
template <int L>
__device__ __forceinline__ void fold(uint32_t (&x)[L]) {
  uint32_t prev = 0;
#pragma unroll
  for (int j = 0; j < L; j++) {
    uint32_t hi = x[j] >> BITS;
    x[j] = (x[j] & MASK) + prev;
    prev = hi;
  }
}

// fp.rex(cols, L): columns < 2^30 -> exact digits of value mod 2^(15 L).
// Returns the next digit (fp.rex's want_carry digit at index L).
template <int L>
__device__ __forceinline__ uint32_t rex(uint32_t (&x)[L]) {
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < L; j++) {
    uint32_t t = x[j] + c;
    x[j] = t & MASK;
    c = t >> BITS;
  }
  return c & MASK;
}

// G16_OUTLINE_MUL (utils/cuda_build.py sets it for the L = 26 libraries of
// the scans K2/K3): mont_mul is compiled once and called, instead of being
// inlined into each of the 12-52 products of a point addition.  Inlined at
// L = 26, one such kernel took ptxas 12-15 minutes (spilling up to 27 KB a
// thread over Fq2); a call passes its operands through the stack, a few
// dozen words against the ~4,000 instructions of the product.
#ifdef G16_OUTLINE_MUL
#define G16_MUL_ATTR __noinline__
#else
#define G16_MUL_ATTR __forceinline__
#endif

// fp.mont_mul / pallas_fp.cios: inputs any digit class with value < 8p,
// output exact digits < 2p.  The columns of acc stay < 2^23 (fp.py ledger).
// Both loops are unrolled, so every register index is static.  Always
// inlined: the cooperative point additions (point_add.cu) call it from one
// site per kernel; `mont_mul` below is the form the scans' formulas call
// (out of line under G16_OUTLINE_MUL).
template <int L>
__device__ __forceinline__ void mont_mul_inline(const uint32_t (&a_in)[L],
                                                const uint32_t (&b_in)[L], uint32_t (&out)[L],
                                                const Consts<L>& k) {
  uint32_t a[L], b[L], acc[L + 1];
#pragma unroll
  for (int j = 0; j < L; j++) {
    a[j] = a_in[j];
    b[j] = b_in[j];
    acc[j] = 0;
  }
  acc[L] = 0;
  fold<L>(a);
  fold<L>(b);
#pragma unroll
  for (int i = 0; i < L; i++) {
    const uint32_t ai = a[i];
#pragma unroll
    for (int j = 0; j < L; j++) {
      uint32_t pr = ai * b[j];  // semi * semi < 2^31
      acc[j] += pr & MASK;
      acc[j + 1] += pr >> BITS;
    }
    uint32_t m = ((acc[0] & MASK) * k.n0) & MASK;
#pragma unroll
    for (int j = 0; j < L; j++) {
      uint32_t pr = m * k.kp(1, j);
      acc[j] += pr & MASK;
      acc[j + 1] += pr >> BITS;
    }
    uint32_t carry = acc[0] >> BITS;  // acc[0] = 0 mod 2^15 now
    acc[0] = acc[1] + carry;
#pragma unroll
    for (int j = 1; j < L; j++) acc[j] = acc[j + 1];
    acc[L] = 0;
  }
#pragma unroll
  for (int j = 0; j < L; j++) out[j] = acc[j];
  rex<L>(out);
}

template <int L>
__device__ G16_MUL_ATTR void mont_mul(const uint32_t (&a_in)[L], const uint32_t (&b_in)[L],
                                      uint32_t (&out)[L], const Consts<L>& k) {
  mont_mul_inline<L>(a_in, b_in, out, k);
}

// fp.sub(a, b, k): a - b + k*p with exact digits; b any digit class
// (resolved first), a lazy.  Needs value(b) < k*p.
template <int L>
__device__ __forceinline__ void sub(const uint32_t (&a)[L], const uint32_t (&b_in)[L], int kmul,
                                    uint32_t (&out)[L], const Consts<L>& k) {
  uint32_t b[L];
#pragma unroll
  for (int j = 0; j < L; j++) b[j] = b_in[j];
  rex<L>(b);
#pragma unroll
  for (int j = 0; j < L; j++) out[j] = a[j] + (MASK - b[j]) + k.kp(kmul, j);
  out[0] += 1;
  rex<L>(out);
}

// fp.sub_exact: as sub, b already exact.
template <int L>
__device__ __forceinline__ void sub_exact(const uint32_t (&a)[L], const uint32_t (&b)[L], int kmul,
                                          uint32_t (&out)[L], const Consts<L>& k) {
#pragma unroll
  for (int j = 0; j < L; j++) out[j] = a[j] + (MASK - b[j]) + k.kp(kmul, j);
  out[0] += 1;
  rex<L>(out);
}

// fp.cond_sub(x, kmul * p): x if x < m else x - m; exact digits out.
template <int L>
__device__ __forceinline__ void cond_sub(uint32_t (&x)[L], int kmul, const Consts<L>& k) {
  rex<L>(x);
  uint32_t u[L];
#pragma unroll
  for (int j = 0; j < L; j++) u[j] = x[j] + (MASK - k.kp(kmul, j));
  u[0] += 1;
  uint32_t carry = rex<L>(u);
  if (carry) {
#pragma unroll
    for (int j = 0; j < L; j++) x[j] = u[j];
  }
}

// fp.reduce_to_2p(x, bound): value < bound * p -> [0, 2p) through the same
// halving sequence of cond_subs.
template <int L, int BOUND>
__device__ __forceinline__ void reduce_to_2p(uint32_t (&x)[L], const Consts<L>& k) {
  int kk = BOUND;
#pragma unroll
  for (int it = 0; it < 8; it++) {
    if (kk > 2) {
      kk = (kk + 1) / 2;
      cond_sub<L>(x, kk, k);
    }
  }
}

// An element of Fp (D = 1) or Fp2 = Fp[u]/(u^2 - NR) (D = 2).
template <int L, int D>
struct Fe {
  uint32_t v[D][L];
};

template <int L, int D>
__device__ __forceinline__ Fe<L, D> load(const uint32_t* __restrict__ p, long long i, long long n) {
  Fe<L, D> r;
#pragma unroll
  for (int j = 0; j < L; j++)
#pragma unroll
    for (int c = 0; c < D; c++) r.v[c][j] = __ldg(p + (long long)(j * D + c) * n + i);
  return r;
}

template <int L, int D>
__device__ __forceinline__ void store(uint32_t* __restrict__ p, long long i, long long n,
                                      const Fe<L, D>& x) {
#pragma unroll
  for (int j = 0; j < L; j++)
#pragma unroll
    for (int c = 0; c < D; c++) p[(long long)(j * D + c) * n + i] = x.v[c][j];
}

template <int L, int D>
__device__ __forceinline__ Fe<L, D> fadd(const Fe<L, D>& a, const Fe<L, D>& b) {
  Fe<L, D> r;
#pragma unroll
  for (int c = 0; c < D; c++)
#pragma unroll
    for (int j = 0; j < L; j++) r.v[c][j] = a.v[c][j] + b.v[c][j];
  return r;
}

template <int L, int D>
__device__ __forceinline__ Fe<L, D> fsub(const Fe<L, D>& a, const Fe<L, D>& b, int kmul,
                                         const Consts<L>& k) {
  Fe<L, D> r;
#pragma unroll
  for (int c = 0; c < D; c++) sub<L>(a.v[c], b.v[c], kmul, r.v[c], k);
  return r;
}

template <int L, int D>
__device__ __forceinline__ Fe<L, D> fsub_exact(const Fe<L, D>& a, const Fe<L, D>& b, int kmul,
                                               const Consts<L>& k) {
  Fe<L, D> r;
#pragma unroll
  for (int c = 0; c < D; c++) sub_exact<L>(a.v[c], b.v[c], kmul, r.v[c], k);
  return r;
}

template <int L, int D>
__device__ __forceinline__ void fcond_sub(Fe<L, D>& a, int kmul, const Consts<L>& k) {
#pragma unroll
  for (int c = 0; c < D; c++) cond_sub<L>(a.v[c], kmul, k);
}

template <int L, int D>
__device__ __forceinline__ Fe<L, D> fb3(const Consts<L>& k) {
  Fe<L, D> r;
#pragma unroll
  for (int c = 0; c < D; c++)
#pragma unroll
    for (int j = 0; j < L; j++) r.v[c][j] = k.b3(c, j);
  return r;
}

// -- the word engine: the same Montgomery product on 32-bit words -----------------
//
// mont_mul_words<L> returns mont_mul's digits with a fraction of its
// instructions: Hopper multiplies 32 x 32 -> 64 bits (the PTX carry chains
// mad.lo.cc / madc.hi.cc), so an operand of 15 L bits is W words instead of
// L digits.  R stays 2^(15 L): FULL = floor(15 L / 32) reduction steps of
// 32 bits, then one PART = 15 L - 32 FULL bit step, with m taken mod
// 2^PART.  T = (a b + M p) / R with 0 <= M < R and M = -a b p^-1 (mod R)
// has one such M, whatever word size builds it, so T and its exact digits
// are those of the 15-bit CIOS (tests/test_torch_fp.py holds a model of
// these steps against the plain version).  Values below 8p must fit in W
// words: W = 9 at L = 18; at L = 26, 12 words hold 8p for p < 2^381, and
// at L = 52 (BW6-761's Fq), 24 words hold 8p for p < 2^765 (BW6-761's p
// has 761 bits), so W = FULL there and the last step takes PART = 12
// bits; the 25 words of the general rule would add a multiply row and a
// word to every operand (fields/cuda_fp.py checks that 8p fits).  K1
// (mont_mul.cu) and K6 (point_add.cu) use it.

template <int L>
struct Words {
  static constexpr int W = L == 26 ? 12 : L == 52 ? 24 : (15 * L - 3 + 31) / 32;  // holds 8p
  static constexpr int FULL = 15 * L / 32;
  static constexpr int PART = 15 * L - 32 * FULL;
  static_assert(W - FULL <= 1 && FULL <= W && PART > 0, "one multiply row past the full steps");
};

// the most words of an operand at any L with a kernel (L = 52)
constexpr int MAX_WORDS = 24;

// p as words and -p^-1 mod 2^32 (its low PART bits are -p^-1 mod 2^PART)
struct WordConsts {
  uint32_t p[MAX_WORDS];
  uint32_t n0;
};

// t[0, W + 2) += x * y[0, W): the low halves, carries into t[W] and t[W+1],
// then the high halves one word up.  Each chain is one run of asm
// statements with nothing between them that touches the carry flag.
template <int W>
__device__ __forceinline__ void mad_row(uint32_t (&t)[W + 2], uint32_t x, const uint32_t* y) {
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[0]) : "r"(x), "r"(y[0]));
#pragma unroll
  for (int j = 1; j < W; j++)
    asm volatile("madc.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[j]) : "r"(x), "r"(y[j]));
  asm volatile("addc.cc.u32 %0, %0, 0;" : "+r"(t[W]));
  asm volatile("addc.u32 %0, %0, 0;" : "+r"(t[W + 1]));
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[1]) : "r"(x), "r"(y[0]));
#pragma unroll
  for (int j = 1; j < W; j++)
    asm volatile("madc.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[j + 1]) : "r"(x), "r"(y[j]));
  asm volatile("addc.u32 %0, %0, 0;" : "+r"(t[W + 1]));
}

// digit j (exact, < 2^15) of an operand into its words
template <int W>
__device__ __forceinline__ void pack_digit(uint32_t (&w)[W], int j, uint32_t d) {
  const int bit = BITS * j, wi = bit / 32, off = bit % 32;
  if (wi < W) w[wi] |= d << off;
  if (off > 32 - BITS && wi + 1 < W) w[wi + 1] |= d >> (32 - off);
}

// G16_OUTLINE_MUL_W (utils/cuda_build.py sets it for K6's library at L =
// 52): mont_mul_w is compiled once and called, instead of being inlined
// into each of rcb_add_mixed_w's 13 products, as G16_OUTLINE_MUL does for
// the scans' digit product.
#ifdef G16_OUTLINE_MUL_W
#define G16_MUL_W_ATTR __noinline__
#else
#define G16_MUL_W_ATTR __forceinline__
#endif

// a b R^-1 on words (a, b < 8p) -> words of a value < 2p.  CIOS: rows
// i < FULL add a_i b, then m p with m = t_0 n0 and shift one word; the
// row past them (L = 18) adds a_8 b unshifted; the PART-bit step last.
template <int L>
__device__ G16_MUL_W_ATTR void mont_mul_w(const uint32_t (&a)[Words<L>::W],
                                           const uint32_t (&b)[Words<L>::W],
                                           uint32_t (&out)[Words<L>::W], const WordConsts& k) {
  constexpr int W = Words<L>::W, FULL = Words<L>::FULL, PART = Words<L>::PART;
  uint32_t t[W + 2];
#pragma unroll
  for (int j = 0; j < W + 2; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < W; i++) {
    mad_row<W>(t, a[i], b);
    if (i < FULL) {
      mad_row<W>(t, t[0] * k.n0, k.p);  // t[0] becomes 0
#pragma unroll
      for (int j = 0; j < W + 1; j++) t[j] = t[j + 1];
      t[W + 1] = 0;
    }
  }
  mad_row<W>(t, (t[0] * k.n0) & ((1u << PART) - 1), k.p);
#pragma unroll
  for (int j = 0; j < W; j++) out[j] = __funnelshift_r(t[j], t[j + 1], PART);
}

// words of a value < 2^(15 L) -> its exact digits
template <int L>
__device__ __forceinline__ void unpack_digits(const uint32_t (&w)[Words<L>::W], uint32_t (&d)[L]) {
  constexpr int W = Words<L>::W;
#pragma unroll
  for (int j = 0; j < L; j++) {
    const int bit = BITS * j, wi = bit / 32, off = bit % 32;
    uint32_t v = wi < W ? w[wi] >> off : 0;
    if (off > 32 - BITS && wi + 1 < W) v |= w[wi + 1] << (32 - off);
    d[j] = v & MASK;
  }
}

// mont_mul's contract and digits (inputs any digit class, values < 8p;
// output exact digits < 2p) on the word engine: resolve each operand to
// exact digits (rex: columns < 2^30, value < R), pack, multiply, unpack.
template <int L>
__device__ __forceinline__ void mont_mul_words(const uint32_t (&a_in)[L],
                                               const uint32_t (&b_in)[L], uint32_t (&out)[L],
                                               const WordConsts& k) {
  constexpr int W = Words<L>::W;
  uint32_t a[L], b[L], wa[W], wb[W], wr[W];
#pragma unroll
  for (int j = 0; j < L; j++) {
    a[j] = a_in[j];
    b[j] = b_in[j];
  }
  rex<L>(a);
  rex<L>(b);
#pragma unroll
  for (int j = 0; j < W; j++) wa[j] = wb[j] = 0;
#pragma unroll
  for (int j = 0; j < L; j++) {
    pack_digit<W>(wa, j, a[j]);
    pack_digit<W>(wb, j, b[j]);
  }
  mont_mul_w<L>(wa, wb, wr, k);
  unpack_digits<L>(wr, out);
}

// -- word-resident elements (K6): the integers of fp.py's lazy adds, subs and
// cond_subs, kept in W words between products.  Every value stays below
// 8p, so below 2^(32 W), and no chain carries out of its top word.

// r = a + b (the integer of a lazy digit-wise add)
template <int W>
__device__ __forceinline__ void add_w(const uint32_t (&a)[W], const uint32_t (&b)[W],
                                      uint32_t (&r)[W]) {
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r[0]) : "r"(a[0]), "r"(b[0]));
#pragma unroll
  for (int j = 1; j < W - 1; j++)
    asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r[j]) : "r"(a[j]), "r"(b[j]));
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r[W - 1]) : "r"(a[W - 1]), "r"(b[W - 1]));
}

// r = a - b + m with m = k p and b < m (fp.sub's integer): a + m first,
// then the borrow chain of b
template <int W>
__device__ __forceinline__ void sub_w(const uint32_t (&a)[W], const uint32_t (&b)[W],
                                      const uint32_t (&m)[W], uint32_t (&r)[W]) {
  uint32_t t[W];
  add_w<W>(a, m, t);
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r[0]) : "r"(t[0]), "r"(b[0]));
#pragma unroll
  for (int j = 1; j < W - 1; j++)
    asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r[j]) : "r"(t[j]), "r"(b[j]));
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r[W - 1]) : "r"(t[W - 1]), "r"(b[W - 1]));
}

// x <- x - m where x >= m (fp.cond_sub's integer): the borrow of x - m
// picks x or the difference
template <int W>
__device__ __forceinline__ void cond_sub_w(uint32_t (&x)[W], const uint32_t (&m)[W]) {
  uint32_t u[W], borrow;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(u[0]) : "r"(x[0]), "r"(m[0]));
#pragma unroll
  for (int j = 1; j < W; j++)
    asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(u[j]) : "r"(x[j]), "r"(m[j]));
  asm volatile("subc.u32 %0, 0, 0;" : "=r"(borrow));  // 0, or ~0 where x < m
#pragma unroll
  for (int j = 0; j < W; j++) x[j] = borrow ? x[j] : u[j];
}

// digits of any class (value < 2^(15 L)) -> words: rex, then pack
template <int L>
__device__ __forceinline__ void digits_to_words(const uint32_t (&d)[L],
                                                uint32_t (&w)[Words<L>::W]) {
  constexpr int W = Words<L>::W;
#pragma unroll
  for (int j = 0; j < W; j++) w[j] = 0;
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < L; j++) {
    const uint32_t t = d[j] + c;
    c = t >> BITS;
    pack_digit<W>(w, j, t & MASK);
  }
}

// Fp: mont_mul.  Fp2 (|NR| <= 16): Fp2Ops.mul_many — schoolbook with the
// nonresidue as a lazy multiple, c0 = v00 + NR v11, c1 = v01 + v10;
// inputs < 4p per component, outputs < 2p exact.
template <int L, int D, int NR>
__device__ __forceinline__ Fe<L, D> fmul(const Fe<L, D>& a, const Fe<L, D>& b,
                                         const Consts<L>& k) {
  Fe<L, D> r;
  if constexpr (D == 1) {
    mont_mul<L>(a.v[0], b.v[0], r.v[0], k);
  } else {
    static_assert(NR != 0 && NR >= -16 && NR <= 16, "small nonresidue only");
    constexpr int ANR = NR < 0 ? -NR : NR;
    constexpr int BOUND = 2 + 2 * ANR;
    uint32_t v00[L], v11[L], v01[L], v10[L];
    mont_mul<L>(a.v[0], b.v[0], v00, k);
    mont_mul<L>(a.v[1], b.v[1], v11, k);
    mont_mul<L>(a.v[0], b.v[1], v01, k);
    mont_mul<L>(a.v[1], b.v[0], v10, k);
#pragma unroll
    for (int j = 0; j < L; j++) v11[j] *= ANR;  // < 2|NR| p, lazy
    if constexpr (NR < 0) {
      sub<L>(v00, v11, 2 * ANR, r.v[0], k);
    } else {
#pragma unroll
      for (int j = 0; j < L; j++) r.v[0][j] = v00[j] + v11[j];
    }
    reduce_to_2p<L, (BOUND > 4 ? BOUND : 4)>(r.v[0], k);
#pragma unroll
    for (int j = 0; j < L; j++) r.v[1][j] = v01[j] + v10[j];
    cond_sub<L>(r.v[1], 2, k);
  }
  return r;
}

}  // namespace g16
