// Complete Renes-Costello-Batina point additions for a = 0 curves, shared by
// the point-add kernels (point_add.cu: K4-K7) and the MSM suffix scans
// (suffix_scan.cu: K2/K3).  One body per formula, templated on the
// coordinate field F in {Fp<L> (D = 1), Fp2<L, NR> (D = 2)}.
//
// The formulas, the bound ledger and the order of every resolving operation
// follow curves/point.py:CurveDevice.add (the stacked path of the JAX
// package) and pallas_point.mixed_add_g1_math, and the Fp2 product follows
// Fp2Ops.mul_many, so outputs are digit-identical to the plain versions in
// curves/cuda_point.py.  Coordinates < 2p with exact digits in and out;
// affine infinity in the mixed formula is Y2 = 0 (all digits), and such
// lanes return P1 unchanged.

#pragma once

#include "field.cuh"

namespace g16 {

// CurveDevice.add (a = 0).  Ledger (multiples of p): pre-adds < 4p; M1
// products <= 16p^2; t3/t4/t5 < 6p; t0t < 6p; Z3s/t1m < 4p; M3 products
// <= 36p^2; X3/Y3/Z3 < 4p before the final reduction to < 2p.
template <int L, int D, int NR>
__device__ __forceinline__ void rcb_add(const Fe<L, D>& X1, const Fe<L, D>& Y1,
                                        const Fe<L, D>& Z1, const Fe<L, D>& X2,
                                        const Fe<L, D>& Y2, const Fe<L, D>& Z2, Fe<L, D>& X3,
                                        Fe<L, D>& Y3, Fe<L, D>& Z3, const Consts<L>& k) {
  Fe<L, D> t0 = fmul<L, D, NR>(X1, X2, k);
  Fe<L, D> t1 = fmul<L, D, NR>(Y1, Y2, k);
  Fe<L, D> t2 = fmul<L, D, NR>(Z1, Z2, k);
  Fe<L, D> m3 = fmul<L, D, NR>(fadd(X1, Y1), fadd(X2, Y2), k);
  Fe<L, D> m4 = fmul<L, D, NR>(fadd(Y1, Z1), fadd(Y2, Z2), k);
  Fe<L, D> m5 = fmul<L, D, NR>(fadd(X1, Z1), fadd(X2, Z2), k);
  Fe<L, D> t3 = fsub(m3, fadd(t0, t1), 4, k);  // X1Y2 + X2Y1 < 6p
  Fe<L, D> t4 = fsub(m4, fadd(t1, t2), 4, k);  // Y1Z2 + Y2Z1 < 6p
  Fe<L, D> t5 = fsub(m5, fadd(t0, t2), 4, k);  // X1Z2 + X2Z1 < 6p
  Fe<L, D> t0t = fadd(fadd(t0, t0), t0);       // 3 X1X2 < 6p lazy
  Fe<L, D> b3 = fb3<L, D>(k);
  Fe<L, D> t2b = fmul<L, D, NR>(t2, b3, k);
  Fe<L, D> t5b = fmul<L, D, NR>(t5, b3, k);
  Fe<L, D> Z3s = fadd(t1, t2b);             // < 4p lazy
  Fe<L, D> t1m = fsub_exact(t1, t2b, 2, k);  // < 4p exact
  Fe<L, D> w0 = fmul<L, D, NR>(t4, t5b, k);
  Fe<L, D> w1 = fmul<L, D, NR>(t3, t1m, k);
  Fe<L, D> w2 = fmul<L, D, NR>(t5b, t0t, k);
  Fe<L, D> w3 = fmul<L, D, NR>(t1m, Z3s, k);
  Fe<L, D> w4 = fmul<L, D, NR>(t0t, t3, k);
  Fe<L, D> w5 = fmul<L, D, NR>(Z3s, t4, k);
  X3 = fsub_exact(w1, w0, 2, k);  // < 4p
  Y3 = fadd(w3, w2);              // < 4p lazy
  Z3 = fadd(w5, w4);              // < 4p lazy
  fcond_sub(X3, 2, k);
  fcond_sub(Y3, 2, k);
  fcond_sub(Z3, 2, k);
}

// pallas_point.mixed_add_g1_math (and its Fp2 form): Z2 = 1, so t2 = Z1,
// t4 = Y1 + Y2 Z1, t5 = X1 + X2 Z1 (< 4p lazy); 13 products.
template <int L, int D, int NR>
__device__ __forceinline__ void rcb_add_mixed(const Fe<L, D>& X1, const Fe<L, D>& Y1,
                                              const Fe<L, D>& Z1, const Fe<L, D>& X2,
                                              const Fe<L, D>& Y2, Fe<L, D>& X3, Fe<L, D>& Y3,
                                              Fe<L, D>& Z3, const Consts<L>& k) {
  uint32_t any = 0;
#pragma unroll
  for (int c = 0; c < D; c++)
#pragma unroll
    for (int j = 0; j < L; j++) any |= Y2.v[c][j];
  Fe<L, D> t0 = fmul<L, D, NR>(X1, X2, k);
  Fe<L, D> t1 = fmul<L, D, NR>(Y1, Y2, k);
  Fe<L, D> m3 = fmul<L, D, NR>(fadd(X1, Y1), fadd(X2, Y2), k);
  Fe<L, D> t3 = fsub(m3, fadd(t0, t1), 4, k);  // < 6p
  Fe<L, D> t4 = fadd(Y1, fmul<L, D, NR>(Y2, Z1, k));  // < 4p lazy
  Fe<L, D> t5 = fadd(X1, fmul<L, D, NR>(X2, Z1, k));  // < 4p lazy
  Fe<L, D> t0t = fadd(fadd(t0, t0), t0);
  Fe<L, D> b3 = fb3<L, D>(k);
  Fe<L, D> t2b = fmul<L, D, NR>(Z1, b3, k);
  Fe<L, D> t5b = fmul<L, D, NR>(t5, b3, k);
  Fe<L, D> Z3s = fadd(t1, t2b);
  Fe<L, D> t1m = fsub(t1, t2b, 2, k);
  Fe<L, D> w0 = fmul<L, D, NR>(t4, t5b, k);
  Fe<L, D> w1 = fmul<L, D, NR>(t3, t1m, k);
  Fe<L, D> w2 = fmul<L, D, NR>(t5b, t0t, k);
  Fe<L, D> w3 = fmul<L, D, NR>(t1m, Z3s, k);
  Fe<L, D> w4 = fmul<L, D, NR>(t0t, t3, k);
  Fe<L, D> w5 = fmul<L, D, NR>(Z3s, t4, k);
  if (any == 0) {  // affine infinity: pass P1 through
    X3 = X1;
    Y3 = Y1;
    Z3 = Z1;
    return;
  }
  X3 = fsub(w1, w0, 2, k);
  Y3 = fadd(w3, w2);
  Z3 = fadd(w5, w4);
  fcond_sub(X3, 2, k);
  fcond_sub(Y3, 2, k);
  fcond_sub(Z3, 2, k);
}

// K6's constants on words: p and n0 for mont_mul_w, then 2p, 4p and b3
// (Montgomery form, < p)
template <int L>
struct MixedWordConsts {
  WordConsts k;
  uint32_t p2[Words<L>::W], p4[Words<L>::W], b3[Words<L>::W];
};

// rcb_add_mixed over Fq on words (K6): the same products, lazy adds,
// subtractions with kp and cond_subs on the same integers, so the unpacked
// digits are rcb_add_mixed's.  Inputs < 2p; every operand of a product
// < 8p (mont_mul_w's contract): X1 + Y1, X2 + Y2 < 4p; t3 < 6p, t0t < 6p,
// t4, t5, Z3s, t1m < 4p.  Outputs < 2p.  The order frees each input at
// its last use (at most seven elements live between products).
template <int L>
__device__ __forceinline__ void rcb_add_mixed_w(
    const uint32_t (&X1)[Words<L>::W], const uint32_t (&Y1)[Words<L>::W],
    const uint32_t (&Z1)[Words<L>::W], const uint32_t (&X2)[Words<L>::W],
    const uint32_t (&Y2)[Words<L>::W], uint32_t (&X3)[Words<L>::W],
    uint32_t (&Y3)[Words<L>::W], uint32_t (&Z3)[Words<L>::W], const MixedWordConsts<L>& c) {
  constexpr int W = Words<L>::W;
  uint32_t m3[W], t0[W], t1[W], t4[W], t5[W], a[W], b[W];
  add_w<W>(X1, Y1, a);
  add_w<W>(X2, Y2, b);
  mont_mul_w<L>(a, b, m3, c.k);
  mont_mul_w<L>(X1, X2, t0, c.k);
  mont_mul_w<L>(X2, Z1, a, c.k);
  add_w<W>(X1, a, t5);  // X1 + X2 Z1 < 4p
  mont_mul_w<L>(Y1, Y2, t1, c.k);
  mont_mul_w<L>(Y2, Z1, a, c.k);
  add_w<W>(Y1, a, t4);  // Y1 + Y2 Z1 < 4p
  add_w<W>(t0, t1, a);
  sub_w<W>(m3, a, c.p4, m3);  // t3 = m3 - (t0 + t1) + 4p < 6p
  uint32_t t2b[W], Z3s[W], t1m[W];
  mont_mul_w<L>(Z1, c.b3, t2b, c.k);
  add_w<W>(t1, t2b, Z3s);        // < 4p
  sub_w<W>(t1, t2b, c.p2, t1m);  // < 4p
  add_w<W>(t0, t0, a);
  add_w<W>(a, t0, t0);            // t0t = 3 t0 < 6p
  mont_mul_w<L>(t5, c.b3, t5, c.k);  // t5b
  mont_mul_w<L>(t4, t5, a, c.k);     // w0
  mont_mul_w<L>(m3, t1m, b, c.k);    // w1
  sub_w<W>(b, a, c.p2, X3);          // < 4p
  mont_mul_w<L>(t5, t0, a, c.k);     // w2
  mont_mul_w<L>(t1m, Z3s, b, c.k);   // w3
  add_w<W>(b, a, Y3);                // < 4p
  mont_mul_w<L>(t0, m3, a, c.k);     // w4
  mont_mul_w<L>(Z3s, t4, b, c.k);    // w5
  add_w<W>(b, a, Z3);                // < 4p
  cond_sub_w<W>(X3, c.p2);
  cond_sub_w<W>(Y3, c.p2);
  cond_sub_w<W>(Z3, c.p2);
}

}  // namespace g16
