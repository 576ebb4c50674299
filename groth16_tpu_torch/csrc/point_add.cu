// K4-K7: complete point additions for a = 0 curves (formulas in point.cuh):
//   rcb_add<F>        K4 (G1) replaces groth16_tpu/curves/pallas_point.py:
//                     add_g1_pallas (_add_kernel -> full_add_g1_math);
//                     K5 (G2) replaces add_g2_pallas (_add_g2_kernel).
//   rcb_add_mixed<F>  K7 (G2) replaces add_mixed_g2_pallas
//                     (_add_mixed_g2_kernel).
//   rcb_add_mixed_w   K6 (G1, on 32-bit words, point_add_words_kernel)
//                     replaces add_mixed_g1_pallas (_add_mixed_kernel ->
//                     mixed_add_g1_math).
// Each library holds one formula, so the four build in parallel:
// -DG16_LIMBS=L (digits of Fq), -DG16_D=1 (G1, Fq) or 2 (G2, Fq2),
// -DG16_MIXED=0 (rcb_add) or 1 (the mixed formula), -DG16_NR=nr (the Fq2
// nonresidue; unused for G1).  The library's name says which
// (utils/cuda_build.py:point_add_variant).
//
// Bound on an H100: integer multiply-add bound.  An addition needs 12
// (mixed: 13) Montgomery products of 2 L^2 + L multiply-adds each on 15-bit
// digits (x4 over Fp2): 7,992 (8,658) at L = 18, against 9 (mixed: 8)
// coordinates of 4 L bytes (x2 over Fp2) of traffic, 12-15 multiply-adds
// per byte against the card's ~5 (64 per SM per clock on 132 SMs against
// 3.35 TB/s).  On 32-bit words (field.cuh: mont_mul_w) a product takes 333
// (L = 18) or 613 (L = 26) 32-bit multiplies, still ~6 per byte.
//
// The full addition (K4, K5), the G2 mixed one (K7) and the MSM's Horner
// chain run on a group of lanes; the G1 mixed addition (K6) on one thread
// on words:
//   point_add_group_kernel a group of lanes per point (6 for G1, 5 groups a
//                          warp; 24 for G2, one a warp): each of the
//                          formula's three product stages (full: 6, 2 and
//                          6 products; mixed: 6, 1 and 6; x4 Fq products
//                          over Fp2) runs one product a lane, its operands
//                          and results in shared memory; the pre-adds, the Fp2
//                          combinations, the subtractions and the final
//                          reductions run one element a lane between them.
//                          The chain of a point falls from 12 (G1) or 48
//                          (G2) sequential products to 3, and a lane holds
//                          one product's digits, so nothing spills.  The
//                          mixed form tests P2 for infinity first: such a
//                          point skips every stage (a G2 warp as a whole).
//                          Most launches of a prove carry a few points,
//                          where one addition's latency is the launch's
//                          time.
//   horner_kernel          res = sum_w 2^(c w) S_w for every lane of one MSM
//                          in one launch: per window from the top c
//                          doublings add(P, P) and one add of S_w, each the
//                          group body, the running point in shared memory.
//   scalar_mul_kernel      bits * P for every lane in one launch (the proof
//                          assembly's r, s and rs multiples: 1-3 points of
//                          ~255 bits): the double-and-add select loop,
//                          each add the group body; the add runs where any
//                          point of the warp takes the bit.
//   point_add_words_kernel K6, one thread per point: every K6 launch of a
//                          prove carries thousands of points (the capture
//                          scan's steps), so its cost is throughput.  The
//                          coordinates are packed into 32-bit words at
//                          load (9 at L = 18, 12 at L = 26, 24 at L = 52)
//                          and stay in words through the formula
//                          (rcb_add_mixed_w):
//                          half the multiplies of the 15-bit digits and
//                          half the registers (the five inputs 45 or 60),
//                          so more warps an SM hide the products' chains,
//                          and it inlines at L = 26 in the time K1 takes.
//                          P2 is tested for infinity before any product.
// The group form on digits runs every element through the same mont_mul,
// sub, sub_exact, cond_sub and reduce_to_2p of field.cuh in the same order as
// rcb_add and rcb_add_mixed (point.cuh); the word form computes the same
// integers.  So the digits are the plain versions' (curves/cuda_point.py).
// A mixed G2 library holds the group form, a mixed G1 library the word
// kernel at two occupancies at L = 18 and 26 (WordBlocks;
// cuda_point.mixed_g1_form picks the one that runs a launch in fewer
// waves), at one at L = 52.

#include <cuda_runtime.h>

#include "point.cuh"

#if !defined(G16_LIMBS) || !defined(G16_D) || !defined(G16_MIXED) || !defined(G16_NR)
#error "compile with -DG16_LIMBS=<digits> -DG16_D=<1|2> -DG16_MIXED=<0|1> -DG16_NR=<Fq2 nonresidue>"
#endif

namespace {

using g16::Consts;
using g16::Fe;

// -- the group form --------------------------------------------------------------

// Warps a block of the group kernels (K4, K5, K7, Horner).  A block's
// points keep their words in static shared memory, which a block may hold
// up to 48 KB of: 4 warps take 41 KB at L = 26 (G1; 27 KB over Fq2), so
// at L = 52 (BW6-761, G1 and G2 over Fq: 20 KB a warp) a block has 2.
template <int L>
constexpr int kGroupWarps = L > 26 ? 2 : 4;

// A point's shared words: SLOTS elements of D components, each component L
// digits at an odd stride (lanes that read neighbouring components hit
// distinct banks), then, over Fp2, the 24 raw Fq products of a stage.
template <int L, int D>
struct Group {
  static constexpr int LP = L | 1;
  static constexpr int E = D * LP;          // words an element
  static constexpr int SLOTS = 19;
  static constexpr int LANES = 6 * D * D;   // lanes a point
  static constexpr int PER_WARP = 32 / LANES;
  static constexpr int WORDS = SLOTS * E + (D == 2 ? 24 * LP : 0);
};

// Slots.  The inputs and the pre-adds are dead after the first product
// stage, so the later values reuse them; X3, Y3, Z3 end in slots 0-2, where
// the next addition of a chain reads P1.
enum : int {
  X1 = 0, Y1 = 1, Z1 = 2, X2 = 3, Y2 = 4, Z2 = 5,
  PRE = 6,                                       // 6-11: X1+Y1, X2+Y2, Y1+Z1, Y2+Z2, X1+Z1, X2+Z2
  T0 = 12, T1 = 13, T2 = 14, M3 = 15, M4 = 16, M5 = 17,
  B3 = 18,
  T3 = 0, T4 = 1, T5 = 2, T0T = 3, T2B = 4, T5B = 5, Z3S = 6, T1M = 7,
  W0 = 8,                                        // 8-13: w0..w5
};

// Six 5-bit slot numbers in one word, picked by a lane's product index.
__host__ __device__ constexpr unsigned long long slots6(int a, int b, int c, int d, int e, int f) {
  return (unsigned long long)a | (unsigned long long)b << 5 | (unsigned long long)c << 10 |
         (unsigned long long)d << 15 | (unsigned long long)e << 20 |
         (unsigned long long)f << 25;
}
__device__ __forceinline__ int pick(unsigned long long t, int i) {
  return (int)((t >> (5 * i)) & 31);
}

template <int L>
__device__ __forceinline__ void ld(uint32_t (&x)[L], const uint32_t* s) {
#pragma unroll
  for (int j = 0; j < L; j++) x[j] = s[j];
}

template <int L>
__device__ __forceinline__ void st(uint32_t* s, const uint32_t (&x)[L]) {
#pragma unroll
  for (int j = 0; j < L; j++) s[j] = x[j];
}

// fmul's combination of stage products q < nq over Fp2 (the raw Fq
// products a0 b0, a1 b1, a0 b1, a1 b0 of each after the slots), two lanes
// a product: c0 = v00 + NR v11 to [0, 2p), c1 = v01 + v10 to [0, 2p),
// into slot pick(to, q).
template <int L, int NR>
__device__ __forceinline__ void fp2_combine(uint32_t* s, int t, int nq, unsigned long long to,
                                            const Consts<L>& k) {
  using G = Group<L, 2>;
  constexpr int E = G::E, LP = G::LP;
  constexpr int ANR = NR < 0 ? -NR : NR;
  constexpr int BOUND = 2 + 2 * ANR;
  if (t >= 0 && t < nq * 2) {
    const int q = t / 2;
    const uint32_t* raw = s + G::SLOTS * E + q * 4 * LP;
    uint32_t u[L], v[L], r[L];
    if (t % 2 == 0) {
      ld<L>(u, raw);
      ld<L>(v, raw + LP);
#pragma unroll
      for (int j = 0; j < L; j++) v[j] *= ANR;
      if constexpr (NR < 0) {
        g16::sub<L>(u, v, 2 * ANR, r, k);
      } else {
#pragma unroll
        for (int j = 0; j < L; j++) r[j] = u[j] + v[j];
      }
      g16::reduce_to_2p<L, (BOUND > 4 ? BOUND : 4)>(r, k);
    } else {
      ld<L>(u, raw + 2 * LP);
      ld<L>(v, raw + 3 * LP);
#pragma unroll
      for (int j = 0; j < L; j++) r[j] = u[j] + v[j];
      g16::cond_sub<L>(r, 2, k);
    }
    st<L>(s + pick(to, q) * E + (t % 2) * LP, r);
  }
}

// rcb_add (point.cuh) on one point's shared words s, by its group of lanes:
// t is the lane's index in the group, -1 on a lane without a point.  Every
// lane of the warp calls it (it synchronises the warp).  Inputs in slots
// X1..Z2 and b3 in B3; (X3, Y3, Z3) out in slots 0-2.
template <int L, int D, int NR>
__device__ __forceinline__ void group_add(uint32_t* s, int t, const Consts<L>& k) {
  using G = Group<L, D>;
  constexpr int E = G::E, LP = G::LP, DD = D * D;
  // pre-adds (lazy), one component a lane
  if (t >= 0 && t < 6 * D) {
    const int e = t / D, c = t % D;
    const int a = pick(slots6(X1, X2, Y1, Y2, X1, X2), e);
    const int b = pick(slots6(Y1, Y2, Z1, Z2, Z1, Z2), e);
#pragma unroll
    for (int j = 0; j < L; j++)
      s[(PRE + e) * E + c * LP + j] = s[a * E + c * LP + j] + s[b * E + c * LP + j];
  }
  __syncwarp();
#pragma unroll 1
  for (int stage = 0; stage < 3; stage++) {
    // products: t0 t1 t2 m3 m4 m5 | t2b t5b | w0..w5
    const int nq = stage == 1 ? 2 : 6;
    const unsigned long long ta = stage == 0   ? slots6(X1, Y1, Z1, PRE, PRE + 2, PRE + 4)
                                  : stage == 1 ? slots6(T2, T5, 0, 0, 0, 0)
                                               : slots6(T4, T3, T5B, T1M, T0T, Z3S);
    const unsigned long long tb = stage == 0   ? slots6(X2, Y2, Z2, PRE + 1, PRE + 3, PRE + 5)
                                  : stage == 1 ? slots6(B3, B3, 0, 0, 0, 0)
                                               : slots6(T5B, T1M, T0T, Z3S, T3, T4);
    const unsigned long long to = stage == 0   ? slots6(T0, T1, T2, M3, M4, M5)
                                  : stage == 1 ? slots6(T2B, T5B, 0, 0, 0, 0)
                                               : slots6(W0, W0 + 1, W0 + 2, W0 + 3, W0 + 4, W0 + 5);
    if (t >= 0 && t < nq * DD) {
      // Fp2: Fq product m of Fp2 product q in Fp2Ops.mul_many's order
      // a0 b0, a1 b1, a0 b1, a1 b0
      const int q = t / DD, m = t % DD;
      const int ca = (m == 1 || m == 3), cb = (m == 1 || m == 2);
      uint32_t a[L], b[L], r[L];
      ld<L>(a, s + pick(ta, q) * E + ca * LP);
      ld<L>(b, s + pick(tb, q) * E + cb * LP);
      g16::mont_mul_inline<L>(a, b, r, k);
      st<L>(D == 1 ? s + pick(to, q) * E : s + G::SLOTS * E + t * LP, r);
    }
    __syncwarp();
    if constexpr (D == 2) {
      fp2_combine<L, NR>(s, t, nq, to, k);
      __syncwarp();
    }
    // the element work after each stage, one component a lane
    const int ne = stage == 0 ? 4 : stage == 1 ? 2 : 3;
    if (t >= 0 && t < ne * D) {
      const int e = t / D, c = t % D;
      const int off = c * LP;
      uint32_t a[L], b[L], r[L];
      if (stage == 0) {
        if (e < 3) {
          // t3 = m3 - (t0 + t1), t4 = m4 - (t1 + t2), t5 = m5 - (t0 + t2), + 4p
          const int b1 = e == 1 ? T1 : T0, b2 = e == 0 ? T1 : T2;
          ld<L>(a, s + (M3 + e) * E + off);
#pragma unroll
          for (int j = 0; j < L; j++) b[j] = s[b1 * E + off + j] + s[b2 * E + off + j];
          g16::sub<L>(a, b, 4, r, k);
        } else {  // t0t = 3 t0 (lazy)
          ld<L>(a, s + T0 * E + off);
#pragma unroll
          for (int j = 0; j < L; j++) r[j] = a[j] + a[j] + a[j];
        }
        st<L>(s + (T3 + e) * E + off, r);  // T3, T4, T5, T0T
      } else if (stage == 1) {
        ld<L>(a, s + T1 * E + off);
        ld<L>(b, s + T2B * E + off);
        if (e == 0) {  // Z3s = t1 + t2b (lazy)
#pragma unroll
          for (int j = 0; j < L; j++) r[j] = a[j] + b[j];
        } else {  // t1m = t1 - t2b + 2p
          g16::sub_exact<L>(a, b, 2, r, k);
        }
        st<L>(s + (Z3S + e) * E + off, r);  // Z3S, T1M
      } else {
        // X3 = w1 - w0 + 2p, Y3 = w3 + w2, Z3 = w5 + w4, each to [0, 2p)
        ld<L>(a, s + (W0 + 2 * e + 1) * E + off);
        ld<L>(b, s + (W0 + 2 * e) * E + off);
        if (e == 0) {
          g16::sub_exact<L>(a, b, 2, r, k);
        } else {
#pragma unroll
          for (int j = 0; j < L; j++) r[j] = a[j] + b[j];
        }
        g16::cond_sub<L>(r, 2, k);
        st<L>(s + e * E + off, r);  // X3, Y3, Z3 in slots 0-2
      }
    }
    __syncwarp();
  }
}

// Slots of the mixed addition (rcb_add_mixed): inputs X1..Y2 as above, the
// pre-adds X1+Y1 and X2+Y2 in PRE, PRE+1, b3 in B3.  Stage 1's products
// land in 12-17; the element work after it writes over Z2's slot and the
// pre-adds' and into 8-11; t5b overwrites t0 and w0..w5 end in 13-18.
enum : int {
  MT0 = 12, MT1 = 13, MM3 = 14, MY2Z1 = 15, MX2Z1 = 16, MT2B = 17,
  MZ3S = 5, MT1M = 7, MT3 = 8, MT4 = 9, MT5 = 10, MT0T = 11,
  MT5B = 12, MW0 = 13,
};

// rcb_add_mixed (point.cuh) on one point's shared words s by its group of
// lanes, as group_add: the same three product stages (6, 1 and 6
// products), t the lane's index in the group or -1 (no point, or P2
// infinity: that point's P1 stays in slots 0-2).  Inputs in slots X1..Y2
// and b3 in B3; (X3, Y3, Z3) out in slots 0-2.
template <int L, int D, int NR>
__device__ __forceinline__ void group_add_mixed(uint32_t* s, int t, const Consts<L>& k) {
  using G = Group<L, D>;
  constexpr int E = G::E, LP = G::LP, DD = D * D;
  if (t >= 0 && t < 2 * D) {  // X1 + Y1, X2 + Y2 (lazy)
    const int e = t / D, c = t % D;
#pragma unroll
    for (int j = 0; j < L; j++)
      s[(PRE + e) * E + c * LP + j] = s[(X1 + 3 * e) * E + c * LP + j] + s[(Y1 + 3 * e) * E + c * LP + j];
  }
  __syncwarp();
#pragma unroll 1
  for (int stage = 0; stage < 3; stage++) {
    // t0 t1 m3 y2z1 x2z1 t2b | t5b | w0..w5
    const int nq = stage == 1 ? 1 : 6;
    const unsigned long long ta = stage == 0   ? slots6(X1, Y1, PRE, Y2, X2, Z1)
                                  : stage == 1 ? slots6(MT5, 0, 0, 0, 0, 0)
                                               : slots6(MT4, MT3, MT5B, MT1M, MT0T, MZ3S);
    const unsigned long long tb = stage == 0   ? slots6(X2, Y2, PRE + 1, Z1, Z1, B3)
                                  : stage == 1 ? slots6(B3, 0, 0, 0, 0, 0)
                                               : slots6(MT5B, MT1M, MT0T, MZ3S, MT3, MT4);
    const unsigned long long to = stage == 0   ? slots6(MT0, MT1, MM3, MY2Z1, MX2Z1, MT2B)
                                  : stage == 1 ? slots6(MT5B, 0, 0, 0, 0, 0)
                                               : slots6(MW0, MW0 + 1, MW0 + 2, MW0 + 3, MW0 + 4, MW0 + 5);
    if (t >= 0 && t < nq * DD) {
      const int q = t / DD, m = t % DD;
      const int ca = (m == 1 || m == 3), cb = (m == 1 || m == 2);
      uint32_t a[L], b[L], r[L];
      ld<L>(a, s + pick(ta, q) * E + ca * LP);
      ld<L>(b, s + pick(tb, q) * E + cb * LP);
      g16::mont_mul_inline<L>(a, b, r, k);
      st<L>(D == 1 ? s + pick(to, q) * E : s + G::SLOTS * E + t * LP, r);
    }
    __syncwarp();
    if constexpr (D == 2) {
      fp2_combine<L, NR>(s, t, nq, to, k);
      __syncwarp();
    }
    if (stage == 1) continue;  // nothing between t5b and the w's
    const int ne = stage == 0 ? 6 : 3;
    if (t >= 0 && t < ne * D) {
      const int e = t / D, c = t % D;
      const int off = c * LP;
      uint32_t a[L], b[L], r[L];
      if (stage == 0) {
        // t3 = m3 - (t0 + t1) + 4p, t4 = Y1 + y2z1, t5 = X1 + x2z1,
        // t0t = 3 t0, Z3s = t1 + t2b (lazy), t1m = t1 - t2b + 2p
        const int a_slot = pick(slots6(MM3, Y1, X1, MT0, MT1, MT1), e);
        const int b_slot = pick(slots6(MT0, MY2Z1, MX2Z1, MT0, MT2B, MT2B), e);
        ld<L>(a, s + a_slot * E + off);
        ld<L>(b, s + b_slot * E + off);
        if (e == 0) {
#pragma unroll
          for (int j = 0; j < L; j++) b[j] += s[MT1 * E + off + j];
          g16::sub<L>(a, b, 4, r, k);
        } else if (e == 5) {
          g16::sub<L>(a, b, 2, r, k);
        } else if (e == 3) {
#pragma unroll
          for (int j = 0; j < L; j++) r[j] = a[j] + a[j] + a[j];
        } else {
#pragma unroll
          for (int j = 0; j < L; j++) r[j] = a[j] + b[j];
        }
        st<L>(s + pick(slots6(MT3, MT4, MT5, MT0T, MZ3S, MT1M), e) * E + off, r);
      } else {
        // X3 = w1 - w0 + 2p, Y3 = w3 + w2, Z3 = w5 + w4, each to [0, 2p)
        ld<L>(a, s + (MW0 + 2 * e + 1) * E + off);
        ld<L>(b, s + (MW0 + 2 * e) * E + off);
        if (e == 0) {
          g16::sub<L>(a, b, 2, r, k);
        } else {
#pragma unroll
          for (int j = 0; j < L; j++) r[j] = a[j] + b[j];
        }
        g16::cond_sub<L>(r, 2, k);
        st<L>(s + e * E + off, r);  // X3, Y3, Z3 in slots 0-2
      }
    }
    __syncwarp();
  }
}

// Element slot of s <- digit (j, c) of point idx at src[(j D + c) stride +
// idx] (the wrappers' limb-major planes), words t, t + LANES, ...
template <int L, int D>
__device__ __forceinline__ void load_elem(uint32_t* s, const uint32_t* __restrict__ src,
                                          long long stride, long long idx, int t) {
  using G = Group<L, D>;
  for (int w = t; w < D * L; w += G::LANES)
    s[(w % D) * G::LP + w / D] = __ldg(src + w * stride + idx);
}

template <int L, int D>
__device__ __forceinline__ void store_elem(uint32_t* __restrict__ dst, long long stride,
                                           long long idx, const uint32_t* s, int t) {
  using G = Group<L, D>;
  for (int w = t; w < D * L; w += G::LANES) dst[w * stride + idx] = s[(w % D) * G::LP + w / D];
}

// b3 into slot B3 (the constant table's rows c0, c1)
template <int L, int D>
__device__ __forceinline__ void load_b3(uint32_t* s, int t, const Consts<L>& k) {
  using G = Group<L, D>;
  for (int w = t; w < D * L; w += G::LANES)
    s[B3 * G::E + (w % D) * G::LP + w / D] = k.b3(w % D, w / D);
}

// The warp's points start at `first`; the lane's point is first + its group.
// Returns the lane's index in its group (-1 without a point) and its words.
template <int L, int D>
__device__ __forceinline__ int group_lane(uint32_t* smem, long long first, long long n,
                                          uint32_t*& s) {
  using G = Group<L, D>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gp = lane / G::LANES;
  const bool live = gp < G::PER_WARP && first + gp < n;
  s = smem + (warp * G::PER_WARP + (gp < G::PER_WARP ? gp : 0)) * G::WORDS;
  return live ? lane % G::LANES : -1;
}

// P2's infinity test of the mixed addition: Y2 all zero (the group's
// lanes OR the words each loaded, then a ballot).  Returns t, or -1 where
// the point's P2 is infinity (its lanes then idle and P1 passes through).
template <int L, int D>
__device__ __forceinline__ int finite_lane(const uint32_t* s, int t) {
  using G = Group<L, D>;
  uint32_t any = 0;
  if (t >= 0)
    for (int w = t; w < D * L; w += G::LANES) any |= s[Y2 * G::E + (w % D) * G::LP + w / D];
  const unsigned nz = __ballot_sync(0xffffffffu, any != 0);
  const int gp = (threadIdx.x % 32) / G::LANES;
  return t >= 0 && ((nz >> (gp * G::LANES)) & ((1u << G::LANES) - 1)) ? t : -1;
}

// The full addition (MIXED false: K4, K5) or the mixed one (MIXED true,
// z2 unused: K7), a lane group a point.
template <int L, int D, int NR, bool MIXED>
__global__ void __launch_bounds__(32 * kGroupWarps<L>, 4)
    point_add_group_kernel(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
                           const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
                           const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
                           uint32_t* __restrict__ x3, uint32_t* __restrict__ y3,
                           uint32_t* __restrict__ z3, long long n,
                           const uint32_t* __restrict__ consts, uint32_t n0) {
  using G = Group<L, D>;
  __shared__ uint32_t smem[kGroupWarps<L> * G::PER_WARP * G::WORDS];
  const long long first =
      ((long long)blockIdx.x * kGroupWarps<L> + threadIdx.x / 32) * G::PER_WARP;
  if (first >= n) return;  // the whole warp
  uint32_t* s;
  const int t = group_lane<L, D>(smem, first, n, s);
  const long long i = first + (threadIdx.x % 32) / G::LANES;
  Consts<L> k{consts, n0};
  if (t >= 0) {
    load_elem<L, D>(s + X1 * G::E, x1, n, i, t);
    load_elem<L, D>(s + Y1 * G::E, y1, n, i, t);
    load_elem<L, D>(s + Z1 * G::E, z1, n, i, t);
    load_elem<L, D>(s + X2 * G::E, x2, n, i, t);
    load_elem<L, D>(s + Y2 * G::E, y2, n, i, t);
    if constexpr (!MIXED) load_elem<L, D>(s + Z2 * G::E, z2, n, i, t);
    load_b3<L, D>(s, t, k);
  }
  __syncwarp();
  if constexpr (MIXED) {
    // a warp whose points' P2 are all infinity skips every product stage
    // (for G2, one point a warp, the skip is the point's own)
    const int tf = finite_lane<L, D>(s, t);
    if (__any_sync(0xffffffffu, tf >= 0)) group_add_mixed<L, D, NR>(s, tf, k);
  } else {
    group_add<L, D, NR>(s, t, k);
  }
  if (t >= 0) {
    store_elem<L, D>(x3, n, i, s + 0 * G::E, t);
    store_elem<L, D>(y3, n, i, s + 1 * G::E, t);
    store_elem<L, D>(z3, n, i, s + 2 * G::E, t);
  }
}

// res[l] = sum_w 2^(c w) sums[l, w] from res = (0 : 1 : 0): for each
// window from the top, c doublings add(P, P), then add(P, sums[l, w]);
// sums planes [*coords, lanes, windows], res planes [*coords, lanes].
template <int L, int D, int NR>
__global__ void __launch_bounds__(32 * kGroupWarps<L>, 4)
    horner_kernel(const uint32_t* __restrict__ sx, const uint32_t* __restrict__ sy,
                  const uint32_t* __restrict__ sz, uint32_t* __restrict__ rx,
                  uint32_t* __restrict__ ry, uint32_t* __restrict__ rz, long long lanes,
                  int windows, int c, const uint32_t* __restrict__ consts, uint32_t n0) {
  using G = Group<L, D>;
  __shared__ uint32_t smem[kGroupWarps<L> * G::PER_WARP * G::WORDS];
  const long long first =
      ((long long)blockIdx.x * kGroupWarps<L> + threadIdx.x / 32) * G::PER_WARP;
  if (first >= lanes) return;
  uint32_t* s;
  const int t = group_lane<L, D>(smem, first, lanes, s);
  const long long l = first + (threadIdx.x % 32) / G::LANES;
  Consts<L> k{consts, n0};
  if (t >= 0) {
    for (int w = t; w < D * L; w += G::LANES) {
      const int j = w / D, cc = w % D, o = cc * G::LP + j;
      s[X1 * G::E + o] = 0;
      s[Y1 * G::E + o] = cc == 0 ? k.one(j) : 0;
      s[Z1 * G::E + o] = 0;
    }
    load_b3<L, D>(s, t, k);
  }
  __syncwarp();
  const long long stride = lanes * windows;
#pragma unroll 1
  for (int w = windows - 1; w >= 0; w--) {
#pragma unroll 1
    for (int d = 0; d <= c; d++) {
      if (t >= 0) {
        if (d < c) {  // P2 = P
          for (int x = t; x < 3 * G::E; x += G::LANES) s[X2 * G::E + x] = s[X1 * G::E + x];
        } else {  // P2 = sums[l, w]
          load_elem<L, D>(s + X2 * G::E, sx, stride, l * windows + w, t);
          load_elem<L, D>(s + Y2 * G::E, sy, stride, l * windows + w, t);
          load_elem<L, D>(s + Z2 * G::E, sz, stride, l * windows + w, t);
        }
      }
      __syncwarp();
      group_add<L, D, NR>(s, t, k);
    }
  }
  if (t >= 0) {
    store_elem<L, D>(rx, lanes, l, s + 0 * G::E, t);
    store_elem<L, D>(ry, lanes, l, s + 1 * G::E, t);
    store_elem<L, D>(rz, lanes, l, s + 2 * G::E, t);
  }
}

// warps a block of the scalar multiplication (26 KB of shared memory a
// warp at L = 52)
template <int L>
constexpr int kScalarWarps = L > 26 ? 1 : 2;

// A point's shared words in the scalar multiplication: the group body's,
// then the running sum (ACC) and the doubled base (BASE), 3 elements each.
template <int L, int D>
struct ScalarGroup {
  using G = Group<L, D>;
  static constexpr int ACC = G::WORDS, BASE = G::WORDS + 3 * G::E;
  static constexpr int WORDS = G::WORDS + 6 * G::E;
};

// res[l] = bits[l] * P[l] for every lane, bits[l] nbits little-endian:
// from acc = (0 : 1 : 0) and base = P, for each bit i acc = add(acc, base)
// where bit i is set, then base = add(base, base); each add the group body.
// group_add synchronises the warp, so the warp runs acc + base when any of
// its points takes bit i, and a point whose bit is clear keeps its acc: the
// digits are those of the select loop (CurveDevice.scalar_mul_bits).  The
// last doubling feeds nothing and is left out.  p planes [*coords, lanes],
// bits int32 [lanes, nbits].
template <int L, int D, int NR>
__global__ void __launch_bounds__(32 * kScalarWarps<L>, 8)
    scalar_mul_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                      const uint32_t* __restrict__ pz, const int32_t* __restrict__ bits,
                      uint32_t* __restrict__ rx, uint32_t* __restrict__ ry,
                      uint32_t* __restrict__ rz, long long lanes, int nbits,
                      const uint32_t* __restrict__ consts, uint32_t n0) {
  using G = Group<L, D>;
  using SG = ScalarGroup<L, D>;
  __shared__ uint32_t smem[kScalarWarps<L> * G::PER_WARP * SG::WORDS];
  const long long first =
      ((long long)blockIdx.x * kScalarWarps<L> + threadIdx.x / 32) * G::PER_WARP;
  if (first >= lanes) return;  // the whole warp
  const int lane = threadIdx.x % 32, gp = lane / G::LANES;
  const bool live = gp < G::PER_WARP && first + gp < lanes;
  uint32_t* s = smem + (threadIdx.x / 32 * G::PER_WARP + (gp < G::PER_WARP ? gp : 0)) * SG::WORDS;
  const int t = live ? lane % G::LANES : -1;
  const long long l = first + gp;
  Consts<L> k{consts, n0};
  if (t >= 0) {
    for (int w = t; w < D * L; w += G::LANES) {
      const int j = w / D, cc = w % D, o = cc * G::LP + j;
      s[SG::ACC + X1 * G::E + o] = 0;
      s[SG::ACC + Y1 * G::E + o] = cc == 0 ? k.one(j) : 0;
      s[SG::ACC + Z1 * G::E + o] = 0;
    }
    load_elem<L, D>(s + SG::BASE + 0 * G::E, px, lanes, l, t);
    load_elem<L, D>(s + SG::BASE + 1 * G::E, py, lanes, l, t);
    load_elem<L, D>(s + SG::BASE + 2 * G::E, pz, lanes, l, t);
    load_b3<L, D>(s, t, k);
  }
  __syncwarp();
  // step 2i: acc + base for bit i; step 2i + 1: base + base.  One call
  // site of the group body, so its code is inlined once.
  bool take = false;
#pragma unroll 1
  for (int step = 0; step < 2 * nbits - 1; step++) {
    const bool dbl = step % 2;
    if (!dbl) {
      take = t >= 0 && (__ldg(bits + l * nbits + step / 2) & 1);
      if (!__any_sync(0xffffffffu, take)) continue;  // no point of the warp takes the bit
    }
    const int from = dbl ? SG::BASE : SG::ACC;
    if (t >= 0) {
      for (int x = t; x < 3 * G::E; x += G::LANES) {
        s[X1 * G::E + x] = s[from + x];
        s[X2 * G::E + x] = s[SG::BASE + x];
      }
    }
    __syncwarp();
    group_add<L, D, NR>(s, t, k);
    if (dbl ? t >= 0 : take)
      for (int x = t; x < 3 * G::E; x += G::LANES) s[from + x] = s[X1 * G::E + x];
    __syncwarp();
  }
  if (t >= 0) {
    store_elem<L, D>(rx, lanes, l, s + SG::ACC + 0 * G::E, t);
    store_elem<L, D>(ry, lanes, l, s + SG::ACC + 1 * G::E, t);
    store_elem<L, D>(rz, lanes, l, s + SG::ACC + 2 * G::E, t);
  }
}

// -- K6 on words -------------------------------------------------------------------

constexpr int kWordThreads = 128;

// Blocks an SM holds of the word kernel at least: as many as the
// formula's registers allow (80 a thread at L = 18, 128 at L = 26), or
// more, forced (64 and 80 registers, a few hundred bytes a thread spilled
// to L1).  A wave of the forced form holds a third (L = 18) or a half
// (L = 26) more points, each slower: it wins where it runs a launch in
// fewer waves (cuda_point.mixed_g1_form, PERF.md).  At L = 52 the
// formula's 24-word elements pass through ~1.8 KB of stack a thread (the
// product out of line) at any count, and a forced third block a SM made
// no launch of 2^16 or 2^17 points faster, so L = 52 has the natural form
// only (wide = 0: no forced form).
template <int L>
struct WordBlocks {
  static constexpr int natural = L == 18 ? 6 : L == 26 ? 4 : 2;
  static constexpr int wide = L == 18 ? 8 : L == 26 ? 6 : 0;
};

// digits [L] of element i of a limb-major plane
template <int L>
__device__ __forceinline__ void load_digits(const uint32_t* __restrict__ p, long long i,
                                            long long n, uint32_t (&d)[L]) {
#pragma unroll
  for (int j = 0; j < L; j++) d[j] = __ldg(p + j * n + i);
}

template <int L>
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ p, long long i,
                                           long long n, uint32_t (&w)[g16::Words<L>::W]) {
  uint32_t d[L];
  load_digits<L>(p, i, n, d);
  g16::digits_to_words<L>(d, w);
}

template <int L>
__device__ __forceinline__ void store_words(uint32_t* __restrict__ p, long long i, long long n,
                                            const uint32_t (&w)[g16::Words<L>::W]) {
  uint32_t d[L];
  g16::unpack_digits<L>(w, d);
#pragma unroll
  for (int j = 0; j < L; j++) p[j * n + i] = d[j];
}

// (x1, y1, z1) + affine (x2, y2) over Fq, one thread a point.  A point
// whose Y2 digits are all zero (affine infinity) does no product and
// returns P1's digits unchanged; a warp whose points all are skips the
// formula as a whole.
template <int L, int MIN_BLOCKS>
__global__ void __launch_bounds__(kWordThreads, MIN_BLOCKS)
    point_add_words_kernel(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
                           const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
                           const uint32_t* __restrict__ y2, uint32_t* __restrict__ x3,
                           uint32_t* __restrict__ y3, uint32_t* __restrict__ z3, long long n,
                           const g16::MixedWordConsts<L> c) {
  constexpr int W = g16::Words<L>::W;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t d[L], any = 0;
  load_digits<L>(y2, i, n, d);
#pragma unroll
  for (int j = 0; j < L; j++) any |= d[j];
  if (any == 0) {
#pragma unroll
    for (int j = 0; j < L; j++) {
      x3[j * n + i] = __ldg(x1 + j * n + i);
      y3[j * n + i] = __ldg(y1 + j * n + i);
      z3[j * n + i] = __ldg(z1 + j * n + i);
    }
    return;
  }
  uint32_t X1[W], Y1[W], Z1[W], X2[W], Y2[W], X3[W], Y3[W], Z3[W];
  g16::digits_to_words<L>(d, Y2);
  load_words<L>(x1, i, n, X1);
  load_words<L>(y1, i, n, Y1);
  load_words<L>(z1, i, n, Z1);
  load_words<L>(x2, i, n, X2);
  g16::rcb_add_mixed_w<L>(X1, Y1, Z1, X2, Y2, X3, Y3, Z3, c);
  store_words<L>(x3, i, n, X3);
  store_words<L>(y3, i, n, Y3);
  store_words<L>(z3, i, n, Z3);
}

}  // namespace

#if G16_MIXED && G16_D == 1
template <int L>
using WordKernel = void (*)(const uint32_t*, const uint32_t*, const uint32_t*, const uint32_t*,
                            const uint32_t*, uint32_t*, uint32_t*, uint32_t*, long long,
                            g16::MixedWordConsts<L>);

// K6's word kernel at its natural (form 0) or forced (form 1) occupancy;
// nullptr for a form this L does not have
template <int L>
WordKernel<L> word_kernel(int form) {
  if (form == 0) return point_add_words_kernel<L, WordBlocks<L>::natural>;
  if constexpr (WordBlocks<L>::wide > 0) {
    if (form == 1) return point_add_words_kernel<L, WordBlocks<L>::wide>;
  }
  return nullptr;
}

// K6: (x1, y1, z1) + affine (x2, y2) by the word kernel in form 0 or 1.
// words: p, -p^-1 mod 2^32, 2p, 4p and b3 (Montgomery form), each as
// Words<L>::W words (one for n0).  Returns 0, the CUDA error of the
// launch, or -1 for an unknown form.
extern "C" int g16_point_add_mixed_g1(int form, const void* x1, const void* y1, const void* z1,
                                      const void* x2, const void* y2, void* x3, void* y3,
                                      void* z3, long long n, const unsigned* words,
                                      void* stream) {
  constexpr int L = G16_LIMBS, W = g16::Words<L>::W;
  const WordKernel<L> kernel = word_kernel<L>(form);
  if (kernel == nullptr) return -1;
  g16::MixedWordConsts<L> c{};
  for (int j = 0; j < W; j++) {
    c.k.p[j] = words[j];
    c.p2[j] = words[W + 1 + j];
    c.p4[j] = words[2 * W + 1 + j];
    c.b3[j] = words[3 * W + 1 + j];
  }
  c.k.n0 = words[W];
  const unsigned blocks = (unsigned)((n + kWordThreads - 1) / kWordThreads);
  kernel<<<blocks, kWordThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1, (const uint32_t*)x2,
      (const uint32_t*)y2, (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, n, c);
  return (int)cudaGetLastError();
}

// Blocks of kWordThreads an SM holds of form 0 or 1 on the current card
// (the CUDA occupancy query): > 0, -1 for an unknown form, or minus the
// CUDA error.
extern "C" int g16_point_add_mixed_g1_blocks(int form) {
  const WordKernel<G16_LIMBS> kernel = word_kernel<G16_LIMBS>(form);
  if (kernel == nullptr) return -1;
  int blocks = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, (const void*)kernel, kWordThreads, 0);
  return e == cudaSuccess ? blocks : -(int)e;
}
#elif G16_MIXED
// (x1, y1, z1) + affine (x2, y2) in the group form (K7).
extern "C" int g16_point_add_mixed_group(const void* x1, const void* y1, const void* z1,
                                         const void* x2, const void* y2, void* x3, void* y3,
                                         void* z3, long long n, const void* consts, unsigned n0,
                                         void* stream) {
  constexpr int per_block = kGroupWarps<G16_LIMBS> * Group<G16_LIMBS, G16_D>::PER_WARP;
  long long blocks = (n + per_block - 1) / per_block;
  point_add_group_kernel<G16_LIMBS, G16_D, G16_NR, true>
      <<<(unsigned)blocks, 32 * kGroupWarps<G16_LIMBS>, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1, (const uint32_t*)x2,
          (const uint32_t*)y2, nullptr, (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, n,
          (const uint32_t*)consts, n0);
  return (int)cudaGetLastError();
}
#else
// The full addition in the group form (K4, K5).
extern "C" int g16_point_add_group(const void* x1, const void* y1, const void* z1,
                                   const void* x2, const void* y2, const void* z2, void* x3,
                                   void* y3, void* z3, long long n, const void* consts,
                                   unsigned n0, void* stream) {
  constexpr int per_block = kGroupWarps<G16_LIMBS> * Group<G16_LIMBS, G16_D>::PER_WARP;
  long long blocks = (n + per_block - 1) / per_block;
  point_add_group_kernel<G16_LIMBS, G16_D, G16_NR, false>
      <<<(unsigned)blocks, 32 * kGroupWarps<G16_LIMBS>, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1, (const uint32_t*)x2,
          (const uint32_t*)y2, (const uint32_t*)z2, (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3,
          n, (const uint32_t*)consts, n0);
  return (int)cudaGetLastError();
}

// Horner over `windows` window sums of `lanes` MSMs with c-bit windows.
extern "C" int g16_horner(const void* sx, const void* sy, const void* sz, void* rx, void* ry,
                          void* rz, long long lanes, int windows, int c, const void* consts,
                          unsigned n0, void* stream) {
  constexpr int per_block = kGroupWarps<G16_LIMBS> * Group<G16_LIMBS, G16_D>::PER_WARP;
  long long blocks = (lanes + per_block - 1) / per_block;
  horner_kernel<G16_LIMBS, G16_D, G16_NR><<<(unsigned)blocks, 32 * kGroupWarps<G16_LIMBS>, 0,
                                            (cudaStream_t)stream>>>(
      (const uint32_t*)sx, (const uint32_t*)sy, (const uint32_t*)sz, (uint32_t*)rx,
      (uint32_t*)ry, (uint32_t*)rz, lanes, windows, c, (const uint32_t*)consts, n0);
  return (int)cudaGetLastError();
}

// bits[l] * P[l] for `lanes` points, bits int32 [lanes, nbits] little-endian.
extern "C" int g16_scalar_mul(const void* px, const void* py, const void* pz, const void* bits,
                              void* rx, void* ry, void* rz, long long lanes, int nbits,
                              const void* consts, unsigned n0, void* stream) {
  constexpr int per_block = kScalarWarps<G16_LIMBS> * Group<G16_LIMBS, G16_D>::PER_WARP;
  long long blocks = (lanes + per_block - 1) / per_block;
  scalar_mul_kernel<G16_LIMBS, G16_D, G16_NR><<<(unsigned)blocks, 32 * kScalarWarps<G16_LIMBS>, 0,
                                                (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (const int32_t*)bits,
      (uint32_t*)rx, (uint32_t*)ry, (uint32_t*)rz, lanes, nbits, (const uint32_t*)consts, n0);
  return (int)cudaGetLastError();
}
#endif
