// The MSM's Horner chain: res[l] = sum_w 2^(c w) S[l, w] for every MSM lane
// l in one launch.
//
// Replaces the JAX package's fori_loop of CurveDevice.add calls at
// groth16_tpu/msm/pippenger.py:660-664 (no Pallas kernel), and the port's
// earlier horner_kernel on point_add.cu's group body, which ran each
// addition of the chain, doublings as add(P, P) included, on a lane
// group.
//
// Bound: latency.  The chain is W (c + 1) dependent point operations, a
// launch carries 1-4 MSM lanes, and the card's multiply rate would run
// a whole chain's products in microseconds (its word-product bound is a
// few microseconds): each operation's critical path sets the time.
//
// Design:
//   - one block an MSM lane (blocks on separate SMs), the running point and
//     every intermediate value in shared memory as 32-bit words (W words
//     a base-field element; digits are converted at load and store);
//   - the c doublings of a window take the doubling formula (RCB 2015/1060
//     algorithm 9 for a = 0, algorithm 3 for the generic-a law: fewer
//     products than add(P, P)), the addition of S_w the complete law;
//   - both are programs of curves/formulas.py interpreted here: a round's
//     raw Fq products one a thread in parallel (field.cuh: mont_mul_w, ~L^2
//     / 2 word steps instead of the 15-bit CIOS's 2 L^2), then the
//     levels of the round's linear combinations one a thread;
//   - one kernel for every width: L = 18, 21, 26, 52 and D = 1, 2, 3 (the
//     program says which; BW6-761's L = 52 no longer runs the unrolled
//     group body).
// The plain version (curves/cuda_point.py: horner_plain) runs the same
// programs in the same order, so the digits are equal.

#include <cuda_runtime.h>

#include "field.cuh"

#ifndef G16_LIMBS
#error "compile with -DG16_LIMBS=<digits>"
#endif

namespace {

constexpr int kTerms = 4;                  // curves/formulas.py: MAX_TERMS (field.cuh: lin_w)
constexpr int kLinFields = 4 + 2 * kTerms;  // d, red, k, terms, (slot, mult) pairs

template <int L>
struct H {
  static constexpr int W = g16::Words<L>::W;
};

// One program (curves/formulas.py: encode) on the block's slots s.
template <int L>
__device__ void run_program(const int* __restrict__ prog, uint32_t* s, const g16::WordConsts& k) {
  constexpr int W = H<L>::W;
  int pc = 0;
  const int rounds = __ldg(prog + pc++);
#pragma unroll 1
  for (int r = 0; r < rounds; r++) {
    const int nm = __ldg(prog + pc), nl = __ldg(prog + pc + 1);
    pc += 2;
#pragma unroll 1
    for (int u = threadIdx.x; u < nm; u += blockDim.x) {
      const int* op = prog + pc + 3 * u;
      const uint32_t* pa = s + __ldg(op + 1) * W;
      const uint32_t* pb = s + __ldg(op + 2) * W;
      uint32_t a[W], b[W], out[W];
#pragma unroll
      for (int j = 0; j < W; j++) {
        a[j] = pa[j];
        b[j] = pb[j];
      }
      g16::mont_mul_w<L>(a, b, out, k);
      uint32_t* pd = s + __ldg(op) * W;
#pragma unroll
      for (int j = 0; j < W; j++) pd[j] = out[j];
    }
    pc += 3 * nm;
    __syncthreads();
#pragma unroll 1
    for (int lv = 0; lv < nl; lv++) {
      const int no = __ldg(prog + pc++);
#pragma unroll 1
      for (int u = threadIdx.x; u < no; u += blockDim.x) {
        const int* op = prog + pc + kLinFields * u;
        // unused terms carry slot 0 and multiplier 0
        uint32_t acc[W];
        g16::lin_w<W>(acc, k.p, __ldg(op + 2), s + __ldg(op + 4) * W, __ldg(op + 5), s + __ldg(op + 6) * W,
                      __ldg(op + 7), s + __ldg(op + 8) * W, __ldg(op + 9), s + __ldg(op + 10) * W,
                      __ldg(op + 11));
        g16::reduce_from_w<W>(acc, __ldg(op + 1), k.p);
        uint32_t* pd = s + __ldg(op) * W;
#pragma unroll
        for (int j = 0; j < W; j++) pd[j] = acc[j];
      }
      pc += kLinFields * no;
      __syncthreads();
    }
  }
}

// Element slot s <- words of digits (j, c) of element idx of limb-major
// planes (src[(j D + c) stride + idx])
template <int L>
__device__ __forceinline__ void load_slot(uint32_t* s, const uint32_t* __restrict__ src, int D, int c,
                                          long long stride, long long idx) {
  uint32_t d[L], w[H<L>::W];
#pragma unroll
  for (int j = 0; j < L; j++) d[j] = __ldg(src + (long long)(j * D + c) * stride + idx);
  g16::digits_to_words<L>(d, w);
#pragma unroll
  for (int j = 0; j < H<L>::W; j++) s[j] = w[j];
}

// res = sum_w 2^(c w) sums[l, w] from res = (0 : 1 : 0), one block a lane:
// for each window from the top, `c` runs of the doubling program, then
// the addition program on (res, sums[l, w]).  Slots: 0 .. 3D the running
// point (both programs read and write it there), p2 .. p2 + 3D the
// addition's second point; consts: (slot, W words) records of the
// programs' constants; one: R mod p in words.
template <int L>
__global__ void horner_kernel(const uint32_t* __restrict__ sx, const uint32_t* __restrict__ sy,
                              const uint32_t* __restrict__ sz, uint32_t* __restrict__ rx,
                              uint32_t* __restrict__ ry, uint32_t* __restrict__ rz, long long lanes,
                              int windows, int c, int D, const int* __restrict__ dbl,
                              const int* __restrict__ add, int p2, const uint32_t* __restrict__ consts,
                              int nconsts, g16::WordConsts k) {
  constexpr int W = H<L>::W;
  extern __shared__ uint32_t s[];
  const long long l = blockIdx.x;
  for (int i = threadIdx.x; i < nconsts; i += blockDim.x) {
    const uint32_t* rec = consts + i * (W + 1);
    for (int j = 0; j < W; j++) s[__ldg(rec) * W + j] = __ldg(rec + 1 + j);
  }
  for (int i = threadIdx.x; i < 3 * D * W; i += blockDim.x) {
    // (0 : 1 : 0): Y's component 0 is one (R mod p), every other word 0
    const int slot = i / W, j = i % W;
    s[i] = slot == D ? __ldg(consts + nconsts * (W + 1) + j) : 0;
  }
  __syncthreads();
  const long long stride = lanes * windows;
#pragma unroll 1
  for (int w = windows - 1; w >= 0; w--) {
#pragma unroll 1
    for (int d = 0; d < c; d++) run_program<L>(dbl, s, k);
    if (threadIdx.x < 3 * D) {
      const int coord = threadIdx.x / D, cc = threadIdx.x % D;
      const uint32_t* src = coord == 0 ? sx : coord == 1 ? sy : sz;
      load_slot<L>(s + (p2 + threadIdx.x) * W, src, D, cc, stride, l * windows + w);
    }
    __syncthreads();
    run_program<L>(add, s, k);
  }
  if (threadIdx.x < 3 * D) {
    const int coord = threadIdx.x / D, cc = threadIdx.x % D;
    uint32_t w[W], d[L];
#pragma unroll
    for (int j = 0; j < W; j++) w[j] = s[threadIdx.x * W + j];
    g16::unpack_digits<L>(w, d);
    uint32_t* out = coord == 0 ? rx : coord == 1 ? ry : rz;
#pragma unroll
    for (int j = 0; j < L; j++) out[(long long)(j * D + cc) * lanes + l] = d[j];
  }
}

}  // namespace

// Horner over `windows` window sums of `lanes` MSMs with c-bit windows:
// sums planes [*coords, lanes, windows], res planes [*coords, lanes]; dbl
// and add the encoded programs (device int32), p2 the addition's second
// point's first slot, slots the slots of both, consts nconsts records of
// (slot, W words) then one's W words (device uint32), words: p as W
// words then -p^-1 mod 2^32.  Returns 0, the CUDA error of the launch, or
// -1 for a block that does not fit.
extern "C" int g16_horner(const void* sx, const void* sy, const void* sz, void* rx, void* ry,
                          void* rz, long long lanes, int windows, int c, int D, const void* dbl,
                          const void* add, int p2, int slots, const void* consts, int nconsts,
                          int threads, const unsigned* words, void* stream) {
  constexpr int L = G16_LIMBS, W = g16::Words<L>::W;
  g16::WordConsts k{};
  for (int j = 0; j < W; j++) k.p[j] = words[j];
  k.n0 = words[W];
  const size_t bytes = (size_t)slots * W * 4;
  if (bytes > 227 * 1024 || threads < 1 || threads > 1024) return -1;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(horner_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  horner_kernel<L><<<(unsigned)lanes, threads, bytes, (cudaStream_t)stream>>>(
      (const uint32_t*)sx, (const uint32_t*)sy, (const uint32_t*)sz, (uint32_t*)rx, (uint32_t*)ry,
      (uint32_t*)rz, lanes, windows, c, D, (const int*)dbl, (const int*)add, p2,
      (const uint32_t*)consts, nconsts, k);
  return (int)cudaGetLastError();
}
