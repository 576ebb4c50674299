// K2/K3: the within-chunk suffix scans of the MSM bucket accumulation:
//   K2 (G1, Fq)  replaces groth16_tpu/msm/pallas_scan.py:suffix_scan_g1_rows
//                (_scan_kernel_g1);
//   K3 (G2, Fq2) replaces suffix_scan_g2_rows (_scan_kernel_g2).
// The TPU kernel keeps the accumulator in VMEM scratch across its sequential
// grid over the K steps, with the chunks across its lanes.  Blocks on this
// card run in no order, and one thread per (row, chunk) column leaves most
// of the card idle when the columns are few (a 2^20 G2 scan has 2,048), so
// the step axis is cut into S segments and scanned in two passes
// (msm/cuda_scan.py chooses S and runs them):
//   pass 1 (no prefix)  each thread owns one (row, segment, chunk) and adds
//                       its segment's steps from the top down, from the
//                       identity, into the segment total;
//   carries             carry_s = sum of the totals of segments above s,
//                       by the full-add kernels K4/K5 (msm/cuda_scan.py);
//   pass 2 (prefix)     the same loop from each thread's carry, writing
//                       every prefix row of its segment; segment 0's final
//                       accumulator is the chunk total.
// With S = 1 only pass 2 runs, from the identity: one thread per column.
// Consecutive chunks sit in consecutive lanes, so at each step a warp reads
// 32 neighbouring rows.  -DG16_LIMBS, -DG16_D and -DG16_NR as in
// point_add.cu.
//
// Layout (msm/cuda_scan.py), all uint32, element-major rows as in the JAX
// package:
//   rows    [R, K*C, 2*D*L]  affine x || y, tower-major within a coordinate
//                            (x0 digits, x1 digits, y0, y1); storage index
//                            k*C + c holds step k of chunk c; affine
//                            infinity is (0, 0); the signed digit's sign
//                            rides in bit 31 of x's digit 0.
//   prefix  [R, K*C, 3*D*L]  X || Y || Z at (k, c) = sum of steps k..K-1 of
//                            chunk c (inclusive suffix).
//   carry   3 x [L, D, R*S*C]  pass 2's starting accumulators (limb-major,
//                            thread t = (r*S + s)*C + c); none with S = 1.
//   out     3 x [L, D, R*S*C]  pass 1: the segment totals; pass 2: the chunk
//                            totals, 3 x [L, D, R*C] (= prefix at k = 0).
// A set sign bit negates y as 2p - y (a zero Fq2 component becomes 2p, a
// legal multiply input); infinity rows keep (0, 0).  Each step is the mixed
// addition of point.cuh, so prefix and totals are digit-identical to the
// plain version in msm/cuda_scan.py for the same S.
//
// Bound on an H100: integer multiply-add bound on dense rows, as K6/K7: 13
// Montgomery products of 2 L^2 + L multiply-adds per finite step (x4 over
// Fq2) against 5 D L words of traffic per step (one row read, one prefix
// row written); the two passes do about twice the products of one.  A step
// on an infinity row (y = 0) reads y alone and skips the addition before
// any product (its accumulator passes on unchanged, as rcb_add_mixed would
// return it), so on sparse rows (most of a Groth16 key's a, b and B query
// points can be infinity) the bytes bound it.  The early-out diverges per
// warp only.

#include <cuda_runtime.h>

#include "point.cuh"

#if !defined(G16_LIMBS) || !defined(G16_D) || !defined(G16_NR)
#error "compile with -DG16_LIMBS=<digits> -DG16_D=<1|2> -DG16_NR=<Fq2 nonresidue>"
#endif

namespace {

using g16::Consts;
using g16::Fe;

constexpr int kThreads = 64;

template <int L, int D>
__device__ __forceinline__ Fe<L, D> load_coord(const uint32_t* __restrict__ row, int coord) {
  Fe<L, D> r;
#pragma unroll
  for (int c = 0; c < D; c++)
#pragma unroll
    for (int j = 0; j < L; j++) r.v[c][j] = __ldg(row + (coord * D + c) * L + j);
  return r;
}

template <int L, int D>
__device__ __forceinline__ void store_coord(uint32_t* __restrict__ row, int coord,
                                            const Fe<L, D>& x) {
#pragma unroll
  for (int c = 0; c < D; c++)
#pragma unroll
    for (int j = 0; j < L; j++) row[(coord * D + c) * L + j] = x.v[c][j];
}

// One thread per (row r, segment s, chunk c).  prefix == nullptr: pass 1
// (segment totals into out at t); else pass 2 (prefix rows; segment 0
// writes the chunk total into out at r*C + c).  cx == nullptr: start from
// the identity (0 : 1 : 0).
template <int L, int D, int NR>
__global__ void __launch_bounds__(kThreads)
    suffix_scan_kernel(const uint32_t* __restrict__ rows, uint32_t* __restrict__ prefix,
                       const uint32_t* __restrict__ cx, const uint32_t* __restrict__ cy,
                       const uint32_t* __restrict__ cz, uint32_t* __restrict__ ox,
                       uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, long long R,
                       long long K, long long C, long long S,
                       const uint32_t* __restrict__ consts, uint32_t n0) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = R * S * C;
  if (t >= n) return;
  const long long c = t % C, s = (t / C) % S, r = t / (C * S);
  const long long seg = (K + S - 1) / S;
  const long long lo = s * seg, hi = lo + seg < K ? lo + seg : K;
  Consts<L> k{consts, n0};
  uint32_t twop[L];
#pragma unroll
  for (int j = 0; j < L; j++) twop[j] = k.kp(2, j);
  Fe<L, D> AX, AY, AZ;
  if (cx != nullptr) {
    AX = g16::load<L, D>(cx, t, n);
    AY = g16::load<L, D>(cy, t, n);
    AZ = g16::load<L, D>(cz, t, n);
  } else {
#pragma unroll
    for (int cc = 0; cc < D; cc++)
#pragma unroll
      for (int j = 0; j < L; j++) {
        AX.v[cc][j] = 0;
        AY.v[cc][j] = cc == 0 ? k.one(j) : 0;
        AZ.v[cc][j] = 0;
      }
  }
  for (long long kk = hi - 1; kk >= lo; kk--) {
    const long long e = (r * K + kk) * C + c;
    const uint32_t* row = rows + e * (2 * D * L);
    Fe<L, D> Y2 = load_coord<L, D>(row, 1);
    uint32_t any = 0;
#pragma unroll
    for (int cc = 0; cc < D; cc++)
#pragma unroll
      for (int j = 0; j < L; j++) any |= Y2.v[cc][j];
    if (any != 0) {  // affine infinity (y = 0) passes the accumulator on
      Fe<L, D> X2 = load_coord<L, D>(row, 0);
      const uint32_t sgn = X2.v[0][0] >> 31;
      X2.v[0][0] &= 0x7fffffffu;
      if (sgn) {
#pragma unroll
        for (int cc = 0; cc < D; cc++) {
          uint32_t ny[L];
          g16::sub_exact<L>(twop, Y2.v[cc], 0, ny, k);
#pragma unroll
          for (int j = 0; j < L; j++) Y2.v[cc][j] = ny[j];
        }
      }
      Fe<L, D> X3, Y3, Z3;
      g16::rcb_add_mixed<L, D, NR>(AX, AY, AZ, X2, Y2, X3, Y3, Z3, k);
      AX = X3;
      AY = Y3;
      AZ = Z3;
    }
    if (prefix != nullptr) {
      uint32_t* out = prefix + e * (3 * D * L);
      store_coord<L, D>(out, 0, AX);
      store_coord<L, D>(out, 1, AY);
      store_coord<L, D>(out, 2, AZ);
    }
  }
  if (prefix == nullptr) {
    g16::store<L, D>(ox, t, n, AX);
    g16::store<L, D>(oy, t, n, AY);
    g16::store<L, D>(oz, t, n, AZ);
  } else if (s == 0) {
    g16::store<L, D>(ox, r * C + c, R * C, AX);
    g16::store<L, D>(oy, r * C + c, R * C, AY);
    g16::store<L, D>(oz, r * C + c, R * C, AZ);
  }
}

}  // namespace

// One pass over R*S*C threads (see above).  Returns 0 or the CUDA error of
// the launch.
extern "C" int g16_suffix_scan(const void* rows, void* prefix, const void* cx, const void* cy,
                               const void* cz, void* ox, void* oy, void* oz, long long R,
                               long long K, long long C, long long S, const void* consts,
                               unsigned n0, void* stream) {
  long long blocks = (R * S * C + kThreads - 1) / kThreads;
  suffix_scan_kernel<G16_LIMBS, G16_D, G16_NR><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)rows, (uint32_t*)prefix, (const uint32_t*)cx, (const uint32_t*)cy,
      (const uint32_t*)cz, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, R, K, C, S,
      (const uint32_t*)consts, n0);
  return (int)cudaGetLastError();
}
