// The MSM's Horner chain and the proof assembly's scalar multiplication:
// two kernels on one interpreter of point-formula programs, one library
// an L (utils/cuda_build.py: horner_variant).
//
// horner_kernel: res[l] = sum_w 2^(c w) S[l, w] for every MSM lane l in
// one launch.  Replaces the JAX package's fori_loop of CurveDevice.add
// calls at groth16_tpu/msm/pippenger.py:660-664 (no Pallas kernel), and
// the port's earlier horner_kernel on point_add.cu's group body, which
// ran each addition of the chain, doublings as add(P, P) included, on a
// lane group.
//
// scalar_mul_kernel: res[l] = k_l P[l] for every lane l in one launch, k_l
// given as little-endian bits (the assembly's r, s and rs multiples: 1-3
// lanes of 254-377 bits).  Replaces the JAX package's fori_loop of
// CurveDevice.add calls in scalar_mul_bits (groth16_tpu/curves/point.py:
// 380; no Pallas kernel), and the port's earlier kernel on point_add.cu's
// group body: a select loop of 2 nbits - 1 dependent
// complete additions, a doubling being add(P, P).  Here: fixed windows of
// c bits, most significant first: a table T[j] = j P (j < 2^c) built in
// shared memory (T[2j] = dbl(T[j]), T[2j + 1] = add(T[2j], P)), res = T of
// the top non-zero digit, then for each lower window c doublings and,
// where its digit d != 0, one addition of T[d].  At 255 bits and c = 4
// the chain is 14 table steps, 252 doublings and at most 63 additions
// (~330) against the select loop's 509 additions.  c is the wrapper's
// (curves/cuda_point.py: SCALAR_MUL_WINDOW, measured on the card).
//
// Bound: latency.  A chain is hundreds of dependent point operations, a
// launch carries 1-4 lanes (Horner: MSM lanes; the scalar multiplication:
// the assembly's multiples), and the card's multiply rate would run a
// whole chain's products in microseconds (its word-product bound is a
// few microseconds): each operation's critical path sets the time.
//
// Design:
//   - one block a lane (blocks on separate SMs), the running point, the
//     table and every intermediate value in shared memory as 32-bit words
//     (W words a base-field element; digits are converted at load and
//     store);
//   - doublings take the doubling formula (RCB 2015/1060 algorithm 9 for
//     a = 0, algorithm 3 for the generic-a law: fewer products than
//     add(P, P)), additions the complete law;
//   - both are programs of curves/formulas.py interpreted here: a round's
//     raw Fq products one a thread in parallel (field.cuh: mont_mul_w, ~L^2
//     / 2 word steps instead of the 15-bit CIOS's 2 L^2), then the
//     levels of the round's linear combinations one a thread;
//   - one library for every width, law and field: L = 18, 21, 26, 52 and
//     D = 1, 2, 3 (the program says which), so BW6-761's L = 52 and MNT's
//     generic-a law run no group body of their own;
//   - the scalar multiplication's digit is the same for every thread of
//     a block (one lane), so its branches (the start at the top digit,
//     the skipped additions of zero digits) are uniform.
// The plain versions (curves/cuda_point.py: horner_plain,
// scalar_mul_plain) run the same programs in the same order, so the
// digits are equal.

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

// The programs' constants into their slots: nconsts records of (slot, W
// words), then one's W words (read by set_infinity).
template <int L>
__device__ __forceinline__ void load_consts(uint32_t* s, const uint32_t* __restrict__ consts, int nconsts) {
  constexpr int W = H<L>::W;
  for (int i = threadIdx.x; i < nconsts; i += blockDim.x) {
    const uint32_t* rec = consts + i * (W + 1);
    for (int j = 0; j < W; j++) s[__ldg(rec) * W + j] = __ldg(rec + 1 + j);
  }
}

// Slots 0 .. 3D <- (0 : 1 : 0): Y's component 0 is one (R mod p), every
// other word 0
template <int L>
__device__ __forceinline__ void set_infinity(uint32_t* s, int D, const uint32_t* __restrict__ consts,
                                             int nconsts) {
  constexpr int W = H<L>::W;
  for (int i = threadIdx.x; i < 3 * D * W; i += blockDim.x) {
    const int slot = i / W, j = i % W;
    s[i] = slot == D ? __ldg(consts + nconsts * (W + 1) + j) : 0;
  }
}

// Planes [*coords, lanes] at lane l <- the point in slots 0 .. 3D, as
// exact digits
template <int L>
__device__ __forceinline__ void store_point(const uint32_t* s, int D, uint32_t* __restrict__ rx,
                                            uint32_t* __restrict__ ry, uint32_t* __restrict__ rz,
                                            long long lanes, long long l) {
  constexpr int W = H<L>::W;
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

// n words dst <- src by the block
__device__ __forceinline__ void copy_words(uint32_t* dst, const uint32_t* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// res = sum_w 2^(c w) sums[l, w] from res = (0 : 1 : 0), one block a lane:
// for each window from the top, `c` runs of the doubling program, then
// the addition program on (res, sums[l, w]).  Slots: 0 .. 3D the running
// point (both programs read and write it there), p2 .. p2 + 3D the
// addition's second point; consts: (slot, W words) records of the
// programs' constants, then one: R mod p in words.
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
  load_consts<L>(s, consts, nconsts);
  set_infinity<L>(s, D, consts, nconsts);
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
  store_point<L>(s, D, rx, ry, rz, lanes, l);
}

// Digit of window w of a lane's little-endian bits: bits [w c, min((w +
// 1) c, nbits)), each taken & 1 (the top window is short where c does not
// divide nbits).  Every thread of the block reads the same words.
__device__ __forceinline__ int window_digit(const int32_t* __restrict__ row, int w, int c, int nbits) {
  const int lo = w * c, hi = min(lo + c, nbits);
  int d = 0;
  for (int i = hi - 1; i >= lo; i--) d = 2 * d + (__ldg(row + i) & 1);
  return d;
}

// res = bits[l] P[l], one block a lane, on the slots of horner_kernel and,
// after them, the table T[j] = j P for j = 1 .. 2^c - 1 (3D slots each, T[j]
// at point j - 1): T[2j] = dbl(T[j]) and T[2j + 1] = add(T[2j], P) in the
// order of j; then res = T[d] of the top non-zero digit d ((0 : 1 : 0)
// where every digit is zero: no doubling of infinity runs), and for each
// lower window c doublings of res and, where its digit d != 0, the
// addition of T[d].  P planes [*coords, lanes], bits int32 [lanes, nbits].
template <int L>
__global__ void scalar_mul_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                                  const uint32_t* __restrict__ pz, const int32_t* __restrict__ bits,
                                  uint32_t* __restrict__ rx, uint32_t* __restrict__ ry,
                                  uint32_t* __restrict__ rz, long long lanes, int nbits, int c, int D,
                                  const int* __restrict__ dbl, const int* __restrict__ add, int p2,
                                  int slots, const uint32_t* __restrict__ consts, int nconsts,
                                  g16::WordConsts k) {
  constexpr int W = H<L>::W;
  extern __shared__ uint32_t s[];
  const long long l = blockIdx.x;
  const int E = 3 * D * W;  // words of a point
  uint32_t* table = s + slots * W;
  load_consts<L>(s, consts, nconsts);
  if (threadIdx.x < 3 * D) {  // T[1] = P
    const int coord = threadIdx.x / D, cc = threadIdx.x % D;
    const uint32_t* src = coord == 0 ? px : coord == 1 ? py : pz;
    load_slot<L>(table + threadIdx.x * W, src, D, cc, lanes, l);
  }
  __syncthreads();
  // one call site of run_program for the table and one for the chain,
  // each program picked at run time, so its code is inlined twice
#pragma unroll 1
  for (int j = 2; j < 1 << c; j++) {
    copy_words(s, table + (j % 2 ? j - 2 : j / 2 - 1) * E, E);  // T[j - 1] or T[j / 2]
    if (j % 2) copy_words(s + p2 * W, table, E);                // + T[1]
    __syncthreads();
    run_program<L>(j % 2 ? add : dbl, s, k);
    copy_words(table + (j - 1) * E, s, E);
    __syncthreads();
  }
  const int32_t* row = bits + l * nbits;
  int w = (nbits + c - 1) / c - 1, d = 0;
  for (; w >= 0; w--) {
    d = window_digit(row, w, c, nbits);
    if (d != 0) break;
  }
  if (w < 0) {
    set_infinity<L>(s, D, consts, nconsts);
  } else {
    copy_words(s, table + (d - 1) * E, E);
  }
  __syncthreads();
#pragma unroll 1
  for (w--; w >= 0; w--) {
    d = window_digit(row, w, c, nbits);
    // steps 0 .. c - 1 the doublings, step c the addition of T[d] (none
    // where d = 0)
#pragma unroll 1
    for (int i = 0; i < c + (d != 0); i++) {
      if (i == c) {
        copy_words(s + p2 * W, table + (d - 1) * E, E);
        __syncthreads();
      }
      run_program<L>(i == c ? add : dbl, s, k);
    }
  }
  store_point<L>(s, D, rx, ry, rz, lanes, l);
}

// p and -p^-1 mod 2^32 from words: p as W words, then n0
template <int L>
g16::WordConsts word_consts(const unsigned* words) {
  constexpr int W = H<L>::W;
  g16::WordConsts k{};
  for (int j = 0; j < W; j++) k.p[j] = words[j];
  k.n0 = words[W];
  return k;
}

// 0 where `bytes` of dynamic shared memory fit a block of `kernel` (the
// attribute set past 48 KB), -1 past the card's 227 KB or the CUDA error
template <typename K>
int fit_shared(K kernel, size_t bytes) {
  if (bytes > 227 * 1024) return -1;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
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
  const size_t bytes = (size_t)slots * W * 4;
  if (threads < 1 || threads > 1024) return -1;
  const int fit = fit_shared(horner_kernel<L>, bytes);
  if (fit != 0) return fit;
  horner_kernel<L><<<(unsigned)lanes, threads, bytes, (cudaStream_t)stream>>>(
      (const uint32_t*)sx, (const uint32_t*)sy, (const uint32_t*)sz, (uint32_t*)rx, (uint32_t*)ry,
      (uint32_t*)rz, lanes, windows, c, D, (const int*)dbl, (const int*)add, p2,
      (const uint32_t*)consts, nconsts, word_consts<L>(words));
  return (int)cudaGetLastError();
}

// bits[l] P[l] for `lanes` points with c-bit windows (1 <= c <= 8): P and
// res planes [*coords, lanes], bits int32 [lanes, nbits] little-endian;
// the programs, slots, constants, threads and words as g16_horner's (the
// table's slots come after `slots`).  Returns 0, the CUDA error of the
// launch, or -1 for arguments or a block that do not fit.
extern "C" int g16_scalar_mul(const void* px, const void* py, const void* pz, const void* bits,
                              void* rx, void* ry, void* rz, long long lanes, int nbits, int c, int D,
                              const void* dbl, const void* add, int p2, int slots, const void* consts,
                              int nconsts, int threads, const unsigned* words, void* stream) {
  constexpr int L = G16_LIMBS, W = g16::Words<L>::W;
  if (c < 1 || c > 8 || nbits < 1 || threads < 1 || threads > 1024) return -1;
  const size_t bytes = ((size_t)slots + (size_t)((1 << c) - 1) * 3 * D) * W * 4;
  const int fit = fit_shared(scalar_mul_kernel<L>, bytes);
  if (fit != 0) return fit;
  scalar_mul_kernel<L><<<(unsigned)lanes, threads, bytes, (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (const int32_t*)bits,
      (uint32_t*)rx, (uint32_t*)ry, (uint32_t*)rz, lanes, nbits, c, D, (const int*)dbl,
      (const int*)add, p2, slots, (const uint32_t*)consts, nconsts, word_consts<L>(words));
  return (int)cudaGetLastError();
}
