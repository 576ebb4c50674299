// K1: element-wise Montgomery product a * b * R^-1 mod p on uint32[L, N].
//
// Replaces the TPU kernel groth16_tpu/fields/pallas_fp.py:mont_mul_pallas
// (kernel body _kernel_fn -> cios).  Same math and contracts: inputs any
// digit class with value < 8p, output exact digits < 2p, digit-identical to
// fields/cuda_fp.py:mont_mul_plain.
//
// Bound on an H100: memory at L = 18 and 26.  One product moves 12 L bytes
// (two inputs, one output: 216 at L = 18, 312 at L = 26, 624 at L = 52,
// BW6-761's Fq) and, on the word engine (field.cuh: mont_mul_words), needs
// about 4 W^2 + 2 W FULL 32-bit multiplies (W = 9, 12 or 24 words): ~2-4
// per byte from L = 18 to L = 52 against the card's ~5 (64
// per SM per clock on 132 SMs against 3.35 TB/s).  The TPU's 15-bit
// digits took ~8 L^2 instructions (a multiply, a mask, a shift and two
// adds a digit product), which made L = 26 compute bound; 32-bit words
// with the carry chains of PTX take a fifth of them.  Times: PERF.md.
//
// Design: each thread runs VEC neighbouring elements (1 or 2, 64-bit loads
// where n and the operand allow; fields/cuda_fp.py:elements_per_thread
// picks it from chip_smoke.py's sweep, where four never won), 128 threads
// a block, a warp's loads and stores coalesced (thread i reads columns
// VEC i.. of each limb row).  An operand may be [L, h] with h | n, read in
// place with period h: element i reads column i mod h.  So a constant
// ([L, 1]) or the NTT's per-stage twiddles ([L, h], broadcast across the
// stage's blocks) are never copied to [L, n] first.

#include <cuda_runtime.h>

#include "field.cuh"

namespace {

using g16::WordConsts;

// column of element e in an operand of period h (h | n, launch-uniform)
__device__ __forceinline__ unsigned column(unsigned e, unsigned h, unsigned n) {
  if (h == n) return e;
  if ((h & (h - 1)) == 0) return e & (h - 1);
  return e % h;
}

// digits j of elements e0 .. e0 + VEC - 1 of operand x (period h)
template <int L, int VEC>
__device__ __forceinline__ void load_digits(const uint32_t* __restrict__ x, unsigned h, unsigned n,
                                            unsigned e0, uint32_t (&d)[VEC][L]) {
  if (VEC == 1 || h % VEC == 0) {  // the VEC columns are neighbours
    const uint32_t* base = x + column(e0, h, n);
#pragma unroll
    for (int j = 0; j < L; j++) {
      const uint32_t* row = base + (size_t)j * h;
      if constexpr (VEC == 2) {
        uint2 v = __ldg(reinterpret_cast<const uint2*>(row));
        d[0][j] = v.x, d[1][j] = v.y;
      } else {
        d[0][j] = __ldg(row);
      }
    }
  } else {  // h = 1, or a period that splits the vector: one column each
#pragma unroll
    for (int v = 0; v < VEC; v++) {
      const uint32_t* base = x + column(e0 + v, h, n);
#pragma unroll
      for (int j = 0; j < L; j++) d[v][j] = __ldg(base + (size_t)j * h);
    }
  }
}

constexpr int kThreads = 128;

template <int L, int VEC>
__global__ void __launch_bounds__(kThreads)
    mont_mul_kernel(const uint32_t* __restrict__ a, unsigned ha, const uint32_t* __restrict__ b,
                    unsigned hb, uint32_t* __restrict__ out, unsigned n, const WordConsts k) {
  const unsigned e0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (e0 >= n) return;  // n is a multiple of VEC
  uint32_t x[VEC][L], y[VEC][L], r[VEC][L];
  load_digits<L, VEC>(a, ha, n, e0, x);
  load_digits<L, VEC>(b, hb, n, e0, y);
#pragma unroll
  for (int v = 0; v < VEC; v++) g16::mont_mul_words<L>(x[v], y[v], r[v], k);
#pragma unroll
  for (int j = 0; j < L; j++) {
    uint32_t* row = out + (size_t)j * n + e0;
    if constexpr (VEC == 2) {
      *reinterpret_cast<uint2*>(row) = make_uint2(r[0][j], r[1][j]);
    } else {
      *row = r[0][j];
    }
  }
}

template <int L, int VEC>
int launch(const void* a, unsigned ha, const void* b, unsigned hb, void* out, unsigned n,
           const WordConsts& k, cudaStream_t stream) {
  const unsigned per_block = kThreads * VEC;
  const unsigned blocks = (n + per_block - 1) / per_block;
  mont_mul_kernel<L, VEC><<<blocks, kThreads, 0, stream>>>(
      (const uint32_t*)a, ha, (const uint32_t*)b, hb, (uint32_t*)out, n, k);
  return (int)cudaGetLastError();
}

template <int L>
int launch_vec(int vec, const void* a, unsigned ha, const void* b, unsigned hb, void* out,
               unsigned n, const WordConsts& k, cudaStream_t s) {
  if (vec == 1) return launch<L, 1>(a, ha, b, hb, out, n, k, s);
  if (vec == 2) return launch<L, 2>(a, ha, b, hb, out, n, k, s);
  return -1;
}

}  // namespace

// out[:, i] = a[:, i mod ha] * b[:, i mod hb] * R^-1 for i < n (ha, hb
// divide n).  words: p as Words<L>::W words, then -p^-1 mod 2^32.  vec (1
// or 2; 1 at L = 52) divides n and the pointers are aligned to it.
// Returns 0 or the CUDA error of the launch; -1 for an L or vec without a
// kernel.
extern "C" int g16_mont_mul(int L, const void* a, unsigned ha, const void* b, unsigned hb,
                            void* out, unsigned n, const unsigned* words, int vec,
                            void* stream) {
  WordConsts k{};
  cudaStream_t s = (cudaStream_t)stream;
  switch (L) {
    case 18:
      for (int j = 0; j < g16::Words<18>::W; j++) k.p[j] = words[j];
      k.n0 = words[g16::Words<18>::W];
      return launch_vec<18>(vec, a, ha, b, hb, out, n, k, s);
    case 26:
      for (int j = 0; j < g16::Words<26>::W; j++) k.p[j] = words[j];
      k.n0 = words[g16::Words<26>::W];
      return launch_vec<26>(vec, a, ha, b, hb, out, n, k, s);
    case 52:  // one element a thread: two would hold ~300 digits live
      for (int j = 0; j < g16::Words<52>::W; j++) k.p[j] = words[j];
      k.n0 = words[g16::Words<52>::W];
      return vec == 1 ? launch<52, 1>(a, ha, b, hb, out, n, k, s) : -1;
    default:
      return -1;
  }
}
