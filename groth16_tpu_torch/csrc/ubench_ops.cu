// V: the op-rate microbenchmark -- R steps of four cross-coupled chains of
// one operation per element, for seven operations.
//
// Replaces the TPU kernel scripts/ubench_vpu.py:bench_op.run (pallas_call at
// :60; kernel body :36-53).  Same chains: each element starts from
// (a, a+1, a+2, b) and runs R/16 rounds of
//     x0 = op(x0, x1); x1 = op(x1, x2); x2 = op(x2, x3); x3 = op(x3, x0)
// four times over, then writes x0 ^ x1 ^ x2 ^ x3 (u32) or
// ((x0 + x1) + x2) + x3 (i32 with wrap-around, f32).  The cross-coupling
// keeps any strength reduction out; three of each four ops are independent,
// and the warps of a full card hide the rest of the latency.
//
// Bound on an H100: operations.  Per element, 12 bytes of traffic against R
// operations (2048 in the benchmark).  What it measures is the issue rate of
// the instruction each chain compiles to (IMAD for the u32 and i32
// multiplies, IADD3 for the add, FMUL and FFMA for the floats; the SASS is
// read back from the built library by chip_smoke.py), and that rate is the
// denominator of every operations bound in PERF.md.
// Design: one thread per element, 256 threads a block, one kernel per
// operation with an unmangled name so the SASS of each can be found.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct MulU32 {
  __device__ __forceinline__ static uint32_t op(uint32_t x, uint32_t y) { return x * y; }
};
struct AddU32 {
  __device__ __forceinline__ static uint32_t op(uint32_t x, uint32_t y) { return x + y; }
};
// the CIOS inner step: ((x*y) & 0x7FFF) + ((x*y) >> 15) + y
struct CiosU32 {
  __device__ __forceinline__ static uint32_t op(uint32_t x, uint32_t y) {
    uint32_t p = x * y;
    return (p & 0x7FFFu) + (p >> 15) + y;
  }
};
// 16-bit operands in 32-bit lanes
struct MulU16 {
  __device__ __forceinline__ static uint32_t op(uint32_t x, uint32_t y) {
    return (x & 0xFFFFu) * (y & 0xFFFFu);
  }
};
// __fmul_rn and fmaf pin the instruction: no contraction either way
struct MulF32 {
  __device__ __forceinline__ static float op(float x, float y) { return __fmul_rn(x, y); }
};
struct FmaF32 {
  __device__ __forceinline__ static float op(float x, float y) { return fmaf(x, y, y); }
};
// two's-complement wrap-around, computed on the bit patterns (signed
// overflow is undefined in C++); the same IMAD
struct MulI32 {
  __device__ __forceinline__ static int32_t op(int32_t x, int32_t y) {
    return (int32_t)((uint32_t)x * (uint32_t)y);
  }
};

__device__ __forceinline__ uint32_t combine(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return a ^ b ^ c ^ d;
}
__device__ __forceinline__ int32_t combine(int32_t a, int32_t b, int32_t c, int32_t d) {
  return (int32_t)((uint32_t)a + (uint32_t)b + (uint32_t)c + (uint32_t)d);
}
__device__ __forceinline__ float combine(float a, float b, float c, float d) {
  return __fadd_rn(__fadd_rn(__fadd_rn(a, b), c), d);
}

template <typename T>
__device__ __forceinline__ T plus(T x, int k) {
  return (T)(x + (T)k);
}
template <>
__device__ __forceinline__ int32_t plus<int32_t>(int32_t x, int k) {
  return (int32_t)((uint32_t)x + (uint32_t)k);
}

template <typename T, typename Op>
__device__ __forceinline__ void chains(const T* __restrict__ a, const T* __restrict__ b,
                                       T* __restrict__ out, long long n, int rounds) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T x0 = a[i], x1 = plus(a[i], 1), x2 = plus(a[i], 2), x3 = b[i];
  for (int r = 0; r < rounds; r++) {
#pragma unroll
    for (int j = 0; j < 4; j++) {
      x0 = Op::op(x0, x1);
      x1 = Op::op(x1, x2);
      x2 = Op::op(x2, x3);
      x3 = Op::op(x3, x0);
    }
  }
  out[i] = combine(x0, x1, x2, x3);
}

}  // namespace

#define G16_UBENCH_KERNEL(NAME, T, OP)                                                      \
  extern "C" __global__ void __launch_bounds__(256)                                         \
      NAME(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,           \
           long long n, int rounds) {                                                       \
    chains<T, OP>(a, b, out, n, rounds);                                                    \
  }

G16_UBENCH_KERNEL(g16_ubench_u32_mul, uint32_t, MulU32)
G16_UBENCH_KERNEL(g16_ubench_u32_add, uint32_t, AddU32)
G16_UBENCH_KERNEL(g16_ubench_u32_cios, uint32_t, CiosU32)
G16_UBENCH_KERNEL(g16_ubench_u16_mul, uint32_t, MulU16)
G16_UBENCH_KERNEL(g16_ubench_f32_mul, float, MulF32)
G16_UBENCH_KERNEL(g16_ubench_f32_fma, float, FmaF32)
G16_UBENCH_KERNEL(g16_ubench_i32_mul, int32_t, MulI32)

// op: index into utils/ubench.py OPS.  rounds = R / 16.  Returns 0 or the
// CUDA error of the launch; -1 for an unknown op.
extern "C" int g16_ubench(int op, const void* a, const void* b, void* out, long long n,
                          int rounds, void* stream) {
  const int threads = 256;
  unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
#define G16_CASE(K, NAME, T)                                                                \
  case K:                                                                                   \
    NAME<<<blocks, threads, 0, s>>>((const T*)a, (const T*)b, (T*)out, n, rounds);          \
    break;
    G16_CASE(0, g16_ubench_u32_mul, uint32_t)
    G16_CASE(1, g16_ubench_u32_add, uint32_t)
    G16_CASE(2, g16_ubench_u32_cios, uint32_t)
    G16_CASE(3, g16_ubench_u16_mul, uint32_t)
    G16_CASE(4, g16_ubench_f32_mul, float)
    G16_CASE(5, g16_ubench_f32_fma, float)
    G16_CASE(6, g16_ubench_i32_mul, int32_t)
#undef G16_CASE
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}
