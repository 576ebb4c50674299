// The generic-a group kernel: the complete addition of the MNT curves
// (a = 2, 11; RCB 2015/1060 algorithm 1) over Fq, Fq2 or Fq3 on 32-bit
// words, for projective points (K4/K5's generic-a form: add_g1, add_g2
// with a != 0) and for the capture scan's step (a projective accumulator
// plus an affine row, with the capture of the step before in the same
// launch).
//
// Replaces: the generic-a form of K4/K5 (a lane group a point on 15-bit
// digits in four product stages, which the port's point_add.cu held
// until the scalar multiplication moved to csrc/horner.cu).  It has no Pallas counterpart: the JAX package computes the
// law in XLA (groth16_tpu/curves/point.py:200, _add_general), and its
// capture scan is a Python loop of from_affine, _add_general and a
// select (groth16_tpu/msm/scans.py); the port's plain version
// (curves/cuda_point.py: add_general_plain, capture_step_plain) runs
// curves/formulas.py:general_add, this kernel's order of operations, so
// the digits are equal.
//
// Bound: integer multiply-adds.  A point takes 14, 52 or 114 base-field
// products (12 tower products of D^2, 2 by b3, a monomial on the
// twists: D each), ~2 W^2 32-bit multiply-adds each, against ~6 D W
// words of traffic; the capture scan's launches carry 28,672-466,944
// points, so the time is throughput.
//
// Design:
//   - one thread a point over Fq (as K6), and over Fq2 and Fq3 one lane a
//     tower component (D lanes a point: 16 or 10 points a warp), every
//     value of the formula in registers as W words (field.cuh:
//     mont_mul_w; digits converted at load and store);
//   - a tower product: lane c runs the D raw products of component c,
//     a_m b_((c - m) mod D), reading the other lanes' components with
//     warp shuffles, and combines them with the nonresidue as a small
//     multiple (17 and 5, no product by its Montgomery form);
//   - the products by a (2, 11; over the twists 34, and 11 v^2: 55 and
//     11 from a rotated component) are small multiples reduced by the
//     halving sequence their bound needs, those by b3 one raw product a
//     component against a per-lane constant: exactly the 14, 52 and 114
//     products the bound counts, in three product rounds;
//   - the capture step reads the affine row ((0, 0) at infinity), forms
//     Z2 = 1 and the infinity test (y = 0 or p in every component) in
//     registers, and copies the step before's captured points
//     (cap[t] = acc_in[src[t]] where jk[t] = k_prev) from its input
//     accumulator in the same launch: one launch a step, one after the
//     last.
// The MSM's Horner chain and the proof assembly's scalar multiplication
// run the same law as a program of curves/formulas.py (csrc/horner.cu).

#include <cuda_runtime.h>

#include "field.cuh"

#if !defined(G16_LIMBS) || !defined(G16_D) || !defined(G16_NR)
#error "compile with -DG16_LIMBS=<digits> -DG16_D=<1|2|3> -DG16_NR=<nonresidue>"
#endif

namespace {

constexpr int kThreads = 128;
// Blocks of kThreads an SM the compiler is held to, registers a thread
// capped to fit them and a few spilled (chip_smoke.py prints the
// registers and spills): more resident warps hide the formula's product
// chains.  Picked by timing 1-4 blocks an SM on an H100 at 2^16 points
// and at the capture proves' widths; over Fq3 a fourth block spilled far
// more and ran slower than three.
constexpr int kMinBlocks = G16_D == 3 ? 3 : 4;

template <int L>
struct GW {
  static constexpr int W = g16::Words<L>::W;
};

// The launch's constants: p and n0, one (R mod p), and per component c
// (lane) b3's constant and the components the products by a and b3 read
// (curves/formulas.py: _ga_constants), a's multipliers and their largest.
struct GeneralConsts {
  g16::WordConsts k;
  uint32_t one[g16::MAX_WORDS];
  uint32_t beta[3][g16::MAX_WORDS];
  int a_mult[3], a_src[3], b_src[3], a_max;
};

template <int D>
struct Lanes {
  static constexpr int POINTS = 32 / D;  // points a warp (D = 3: lanes 30, 31 idle)
};

// x of the point's lane `comp` (all 32 lanes call it)
template <int L, int D>
__device__ __forceinline__ void from_lane(const uint32_t (&x)[GW<L>::W], int base, int comp,
                                          uint32_t (&out)[GW<L>::W]) {
#pragma unroll
  for (int j = 0; j < GW<L>::W; j++) out[j] = D == 1 ? x[j] : __shfl_sync(0xffffffffu, x[j], base + comp);
}

// component c of the tower product a b (curves/formulas.py: tmul_raw and
// _ga_comb): sum_m (NR where it wraps) a_m b_((c - m) mod D), reduced
// from the largest component's bound
template <int L, int D, int NR>
__device__ __forceinline__ void tmul(const uint32_t (&a)[GW<L>::W], const uint32_t (&b)[GW<L>::W],
                                     uint32_t (&out)[GW<L>::W], int base, int c,
                                     const GeneralConsts& g) {
  constexpr int W = GW<L>::W;
  if constexpr (D == 1) {
    g16::mont_mul_w<L>(a, b, out, g.k);
  } else {
    constexpr int RED = D == 2 ? 2 * (1 + NR) : 2 * (1 + 2 * NR);
    uint32_t acc[W];
#pragma unroll
    for (int j = 0; j < W; j++) acc[j] = 0;
#pragma unroll
    for (int m = 0; m < D; m++) {
      const int cb = (c - m + D) % D;
      uint32_t am[W], bm[W], r[W];
      from_lane<L, D>(a, base, m, am);
      from_lane<L, D>(b, base, cb, bm);
      g16::mont_mul_w<L>(am, bm, r, g.k);
      g16::lin_w<W>(acc, r, 0, acc, 1, r, m + cb >= D ? NR : 1);
    }
    g16::reduce_from_w<W>(acc, RED, g.k.p);
#pragma unroll
    for (int j = 0; j < W; j++) out[j] = acc[j];
  }
}

// component c of a x (a = s v^ja): s_c x_(a_src c), reduced from bound * a_max
template <int L, int D>
__device__ __forceinline__ void by_a(const uint32_t (&x)[GW<L>::W], uint32_t (&out)[GW<L>::W], int base,
                                     int c, int bound, const GeneralConsts& g) {
  constexpr int W = GW<L>::W;
  uint32_t xs[W];
  from_lane<L, D>(x, base, g.a_src[c], xs);
  g16::lin_w<W>(out, xs, 0, xs, g.a_mult[c]);
  g16::reduce_from_w<W>(out, bound * g.a_max, g.k.p);
}

// component c of b3 x (b3 = beta v^jb): one raw product by the lane's constant
template <int L, int D>
__device__ __forceinline__ void by_b3(const uint32_t (&x)[GW<L>::W], uint32_t (&out)[GW<L>::W], int base,
                                      int c, const GeneralConsts& g) {
  constexpr int W = GW<L>::W;
  uint32_t xs[W], bc[W];
  from_lane<L, D>(x, base, g.b_src[c], xs);
#pragma unroll
  for (int j = 0; j < W; j++) bc[j] = g.beta[c][j];
  g16::mont_mul_w<L>(xs, bc, out, g.k);
}

// curves/formulas.py:general_add for component c of one point, the
// inputs' words overwritten by the result's (< 2p).  Order: t0 t1 t2 m3
// m4 m5 | b3 t2, b3 xz | y3a ef w0 xyx3 xye yzz3, the combinations
// between them.
template <int L, int D, int NR>
__device__ __forceinline__ void general_add(uint32_t (&X1)[GW<L>::W], uint32_t (&Y1)[GW<L>::W],
                                            uint32_t (&Z1)[GW<L>::W], const uint32_t (&X2)[GW<L>::W],
                                            const uint32_t (&Y2)[GW<L>::W], const uint32_t (&Z2)[GW<L>::W],
                                            int base, int c, const GeneralConsts& g) {
  constexpr int W = GW<L>::W;
  const uint32_t* p = g.k.p;
  uint32_t t0[W], t1[W], t2[W], xy[W], yz[W], xz[W], u[W], v[W];
  tmul<L, D, NR>(X1, X2, t0, base, c, g);
  tmul<L, D, NR>(Y1, Y2, t1, base, c, g);
  tmul<L, D, NR>(Z1, Z2, t2, base, c, g);
  g16::add_w<W>(X1, Y1, u);
  g16::add_w<W>(X2, Y2, v);
  tmul<L, D, NR>(u, v, xy, base, c, g);  // m3
  g16::add_w<W>(Y1, Z1, u);
  g16::add_w<W>(Y2, Z2, v);
  tmul<L, D, NR>(u, v, yz, base, c, g);  // m4
  g16::add_w<W>(X1, Z1, u);
  g16::add_w<W>(X2, Z2, v);
  tmul<L, D, NR>(u, v, xz, base, c, g);  // m5
  // in place: lin_w reads word j of its terms before it writes word j
  g16::lin_w<W>(xy, p, 4, xy, 1, t0, -1, t1, -1);  // xy = m3 - t0 - t1 + 4p < 6p
  g16::lin_w<W>(yz, p, 4, yz, 1, t1, -1, t2, -1);  // yz < 6p
  g16::lin_w<W>(xz, p, 4, xz, 1, t0, -1, t2, -1);  // xz < 6p
  // round 2 and its combinations: X3t, Z3t in X1, Z1; t2m in t2; f in xz
  uint32_t d[W], e[W];
  by_b3<L, D>(t2, d, base, c, g);   // b3 t2
  by_a<L, D>(xz, u, base, c, 6, g);  // a xz < 2p
  g16::add_w<W>(u, d, d);            // d = a xz + b3 t2 < 4p
  by_b3<L, D>(xz, v, base, c, g);    // b3 xz
  by_a<L, D>(t2, u, base, c, 2, g);  // a t2 < 2p
  g16::lin_w<W>(e, p, 0, t0, 3, u, 1);    // e = 3 t0 + a t2 < 8p
  g16::lin_w<W>(t2, p, 2, t0, 1, u, -1);  // t2m = t0 - a t2 + 2p < 4p
  g16::lin_w<W>(X1, p, 4, t1, 1, d, -1);  // X3t < 6p
  g16::add_w<W>(t1, d, Z1);          // Z3t < 6p
  by_a<L, D>(t2, u, base, c, 4, g);  // a t2m < 2p
  g16::add_w<W>(v, u, xz);           // f = b3 xz + a t2m < 4p
  // round 3: X3 = xyx3 - w0 + 2p, Y3 = y3a + ef, Z3 = yzz3 + xye, each to [0, 2p)
  tmul<L, D, NR>(X1, Z1, t0, base, c, g);  // y3a
  tmul<L, D, NR>(e, xz, t1, base, c, g);   // ef
  tmul<L, D, NR>(yz, xz, t2, base, c, g);  // w0
  tmul<L, D, NR>(xy, X1, u, base, c, g);   // xyx3
  g16::lin_w<W>(X1, p, 2, u, 1, t2, -1);
  g16::reduce_from_w<W>(X1, 4, p);
  tmul<L, D, NR>(xy, e, u, base, c, g);  // xye
  tmul<L, D, NR>(yz, Z1, v, base, c, g);  // yzz3
  g16::add_w<W>(v, u, Z1);
  g16::reduce_from_w<W>(Z1, 4, p);
  g16::add_w<W>(t0, t1, Y1);
  g16::reduce_from_w<W>(Y1, 4, p);
}

template <int L>
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ src, long long stride, long long idx,
                                           int D, int c, uint32_t (&w)[GW<L>::W]) {
  uint32_t d[L];
#pragma unroll
  for (int j = 0; j < L; j++) d[j] = __ldg(src + (long long)(j * D + c) * stride + idx);
  g16::digits_to_words<L>(d, w);
}

template <int L>
__device__ __forceinline__ void store_words(uint32_t* __restrict__ dst, long long stride, long long idx, int D,
                                            int c, const uint32_t (&w)[GW<L>::W]) {
  uint32_t d[L];
  g16::unpack_digits<L>(w, d);
#pragma unroll
  for (int j = 0; j < L; j++) dst[(long long)(j * D + c) * stride + idx] = d[j];
}

// P1 + P2 for the n points of the planes where `add` (else nothing), D
// lanes a point: P2 projective (AFFINE false), or the affine row (x2, y2)
// (AFFINE true, z2 unused).  Then, from thread 0 on, cap[t] = P1[src[t]]
// for every t < targets with jk[t] == k_prev (the capture of the step
// before, from this launch's input).
template <int L, int D, int NR, bool AFFINE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    general_add_kernel(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
                       const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
                       const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
                       uint32_t* __restrict__ x3, uint32_t* __restrict__ y3, uint32_t* __restrict__ z3,
                       long long n, bool add, uint32_t* __restrict__ capx, uint32_t* __restrict__ capy,
                       uint32_t* __restrict__ capz, const int* __restrict__ jk, const int* __restrict__ src,
                       long long targets, int k_prev, const GeneralConsts g) {
  constexpr int W = GW<L>::W;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x % 32, grp = lane / D, c = lane % D, base = grp * D;
  const long long i = (gid / 32) * Lanes<D>::POINTS + grp;
  const bool live = add && grp < Lanes<D>::POINTS && i < n;
  // every lane of a warp with a point runs the formula (its shuffles);
  // the others read point 0
  if (__any_sync(0xffffffffu, live)) {
    const long long at = live ? i : 0;
    uint32_t X1[W], Y1[W], Z1[W], X2[W], Y2[W], Z2[W];
    load_words<L>(x1, n, at, D, c, X1);
    load_words<L>(y1, n, at, D, c, Y1);
    load_words<L>(z1, n, at, D, c, Z1);
    load_words<L>(x2, n, at, D, c, X2);
    load_words<L>(y2, n, at, D, c, Y2);
    if constexpr (AFFINE) {
      // infinity: y = 0 mod p (0 or p: Fp's is_zero at bound 2) in every
      // component; then (0 : 1 : 0), else (x : y : 1)
      bool zero = true, is_p = true;
#pragma unroll
      for (int j = 0; j < W; j++) {
        zero &= Y2[j] == 0;
        is_p &= Y2[j] == g.k.p[j];
      }
      const unsigned z = __ballot_sync(0xffffffffu, zero || is_p);
      const unsigned mine = ((1u << D) - 1) << base;
      const bool inf = (z & mine) == mine;
#pragma unroll
      for (int j = 0; j < W; j++) {
        const uint32_t one = c == 0 ? g.one[j] : 0;
        X2[j] = inf ? 0 : X2[j];
        Y2[j] = inf ? one : Y2[j];
        Z2[j] = inf ? 0 : one;
      }
    } else {
      load_words<L>(z2, n, at, D, c, Z2);
    }
    general_add<L, D, NR>(X1, Y1, Z1, X2, Y2, Z2, base, c, g);
    if (live) {
      store_words<L>(x3, n, i, D, c, X1);
      store_words<L>(y3, n, i, D, c, Y1);
      store_words<L>(z3, n, i, D, c, Z1);
    }
  }
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = gid; t < targets; t += step) {
    if (__ldg(jk + t) != k_prev) continue;
    const long long s = __ldg(src + t);
    for (int w = 0; w < L * D; w++) {
      capx[w * targets + t] = __ldg(x1 + w * n + s);
      capy[w * targets + t] = __ldg(y1 + w * n + s);
      capz[w * targets + t] = __ldg(z1 + w * n + s);
    }
  }
}

GeneralConsts read_consts(const unsigned* words) {
  constexpr int W = GW<G16_LIMBS>::W;
  GeneralConsts g{};
  for (int j = 0; j < W; j++) {
    g.k.p[j] = words[j];
    g.one[j] = words[W + 1 + j];
    for (int c = 0; c < 3; c++) g.beta[c][j] = words[(2 + c) * W + 1 + j];
  }
  g.k.n0 = words[W];
  const unsigned* small = words + 5 * W + 1;
  for (int c = 0; c < 3; c++) {
    g.a_mult[c] = (int)small[c];
    g.a_src[c] = (int)small[3 + c];
    g.b_src[c] = (int)small[6 + c];
  }
  g.a_max = (int)small[9];
  return g;
}

unsigned blocks_for(long long n, long long targets) {
  const long long warps = (n + Lanes<G16_D>::POINTS - 1) / Lanes<G16_D>::POINTS;  // n: points to add
  const long long threads = warps * 32 > targets ? warps * 32 : targets;
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

}  // namespace

// words: p (W words), -p^-1 mod 2^32, one, beta[0..2] (W words each),
// a_mult[3], a_src[3], b_src[3], a_max.

// (x1, y1, z1) + (x2, y2, z2) for n projective points.  Returns 0 or the
// CUDA error of the launch.
extern "C" int g16_general_add(const void* x1, const void* y1, const void* z1, const void* x2,
                               const void* y2, const void* z2, void* x3, void* y3, void* z3, long long n,
                               const unsigned* words, void* stream) {
  if (n <= 0) return 0;
  general_add_kernel<G16_LIMBS, G16_D, G16_NR, false>
      <<<blocks_for(n, 0), kThreads, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1, (const uint32_t*)x2,
          (const uint32_t*)y2, (const uint32_t*)z2, (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, n,
          true, nullptr, nullptr, nullptr, nullptr, nullptr, 0, -1, read_consts(words));
  return (int)cudaGetLastError();
}

// One capture step on planes of n points: (x1, y1, z1) + affine (x2, y2)
// where `add` (else the capture alone: the last one of a scan), and cap[t]
// = (x1, y1, z1)[src[t]] for t < targets with jk[t] == k_prev (jk, src
// int32).  Returns 0 or the CUDA error of the launch.
extern "C" int g16_general_capture_step(const void* x1, const void* y1, const void* z1, const void* x2,
                                        const void* y2, void* x3, void* y3, void* z3, long long n,
                                        int add, void* capx, void* capy, void* capz, const void* jk,
                                        const void* src, long long targets, int k_prev,
                                        const unsigned* words, void* stream) {
  if ((n <= 0 || !add) && targets <= 0) return 0;
  general_add_kernel<G16_LIMBS, G16_D, G16_NR, true>
      <<<blocks_for(add ? n : 0, targets), kThreads, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1, (const uint32_t*)x2,
          (const uint32_t*)y2, nullptr, (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, n, add != 0,
          (uint32_t*)capx, (uint32_t*)capy, (uint32_t*)capz, (const int*)jk, (const int*)src, targets,
          k_prev, read_consts(words));
  return (int)cudaGetLastError();
}
