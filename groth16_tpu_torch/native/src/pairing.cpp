// Native host engine for the Groth16 verify path.
//
// Implements, in fixed-width u64 Montgomery arithmetic, exactly the math
// the Python exact engine (groth16_tpu/ref/field.py, ref/pairing.py)
// performs for tower-pairing curves (BN / BLS12 families, Fp12 = Fp2 ->
// Fp6 -> Fp12, twist type D or M):
//
//   * multi-Miller loop over (G1, G2) pairs with homogeneous projective
//     twist-point steps and sparse 034/045 line multiplications
//     (reference behavior: ark-ec Pairing::multi_miller_loop consumed at
//     arkworks-rs/groth16 src/verifier.rs:49-60),
//   * final exponentiation: (p^6-1)(p^2+1) easy part, then the hard part
//     via base-p Frobenius decomposition + Straus joint exponentiation
//     with Granger-Scott cyclotomic squarings
//     (arkworks-rs/groth16 src/verifier.rs:62-64),
//   * small variable-base G1 MSM (Jacobian double-and-add) for
//     prepare_inputs (arkworks-rs/groth16 src/verifier.rs:25-39), and a
//     batch G1 subgroup check for deserialization validation
//     (ark-serialize's `Validate::Yes` behavior).
//
// The pairing value of correct algorithms is canonical, so outputs are
// bit-identical to the Python engine; tests/test_native_verify.py pins
// this.  All I/O crosses the C ABI as little-endian u64 limb arrays in
// STANDARD (non-Montgomery) form; conversion happens at the boundary.
//
// Build: g++ -O2 -shared -fPIC (see groth16_tpu/native/__init__.py).

#include <cstdint>
#include <cstring>
#include <cstdlib>

typedef uint64_t u64;
typedef unsigned __int128 u128;

static const int MAXL = 12;  // up to 768-bit moduli (bw6-761)

struct Fp {
  u64 v[MAXL];
};

struct Fp2 {
  Fp c0, c1;
};
struct Fp6 {
  Fp2 c0, c1, c2;
};
struct Fp12 {
  Fp6 c0, c1;
};

struct Ctx {
  int nl;            // active limb count
  u64 p[MAXL];       // modulus
  u64 pm2[MAXL];     // p - 2 (Fermat inverse exponent)
  u64 n0inv;         // -p^{-1} mod 2^64
  Fp r2;             // R^2 mod p (Montgomery conversion constant)
  Fp one;            // R mod p  (Montgomery 1)
  Fp nr;             // Fp2 nonresidue, Montgomery form
  Fp2 xi;            // Fp6 nonresidue (sextic twist constant)
  Fp2 b2_3;          // 3 * b' of the twist curve (doubling-step constant)
  Fp two_inv;        // 1/2 (doubling step)
  Fp2 frob_g[3];     // xi^((p^i - 1)/6), i = 1..3 (Fp12 Frobenius)
  Fp2 bn_g12, bn_g13, bn_g22, bn_g23;  // BN tail Frobenius-on-twist
  u64 ate_loop[MAXL];
  int ate_bits;      // bit length of |ate_loop_count|
  int ate_neg;
  int is_bn;
  int twist_is_D;
  // base-p digits of the hard part of the final exponentiation
  u64 hard_digits[4][MAXL];
  int ndig;
  // --- Tate engine (BW6 / MNT families; GT = Kh[v]/(v^2-u)) ---------------
  int tate_d;          // half-field degree (2 or 3); 0 = tower engine
  Fp g1_a;             // short-Weierstrass a (Montgomery; 0 for BN/BLS/BW6)
  u64 r_loop[MAXL];    // Tate Miller loop count = r (scalar field order)
  int r_bits;
  Fp tate_ucoef[3][3];  // frobenius power k=1..3: u^i coefficient i=0..d-1
  Fp tate_vcoef[3][3];  // frobenius power k: vcoef (Kh element, d coords)
};

// ---------------------------------------------------------------------------
// Fp (Montgomery)
// ---------------------------------------------------------------------------

static inline void fp_zero(const Ctx &c, Fp &r) {
  for (int i = 0; i < c.nl; i++) r.v[i] = 0;
}

static inline int fp_is_zero(const Ctx &c, const Fp &a) {
  for (int i = 0; i < c.nl; i++)
    if (a.v[i]) return 0;
  return 1;
}

static inline int fp_cmp_p(const Ctx &c, const u64 *a) {
  for (int i = c.nl - 1; i >= 0; i--) {
    if (a[i] < c.p[i]) return -1;
    if (a[i] > c.p[i]) return 1;
  }
  return 0;
}

static inline void fp_add(const Ctx &c, Fp &r, const Fp &a, const Fp &b) {
  u128 carry = 0;
  for (int i = 0; i < c.nl; i++) {
    u128 cur = (u128)a.v[i] + b.v[i] + (u64)carry;
    r.v[i] = (u64)cur;
    carry = cur >> 64;
  }
  if (carry || fp_cmp_p(c, r.v) >= 0) {
    u128 borrow = 0;
    for (int i = 0; i < c.nl; i++) {
      u128 cur = (u128)r.v[i] - c.p[i] - (u64)borrow;
      r.v[i] = (u64)cur;
      borrow = (cur >> 64) ? 1 : 0;
    }
  }
}

static inline void fp_sub(const Ctx &c, Fp &r, const Fp &a, const Fp &b) {
  u128 borrow = 0;
  for (int i = 0; i < c.nl; i++) {
    u128 cur = (u128)a.v[i] - b.v[i] - (u64)borrow;
    r.v[i] = (u64)cur;
    borrow = (cur >> 64) ? 1 : 0;
  }
  if (borrow) {
    u128 carry = 0;
    for (int i = 0; i < c.nl; i++) {
      u128 cur = (u128)r.v[i] + c.p[i] + (u64)carry;
      r.v[i] = (u64)cur;
      carry = cur >> 64;
    }
  }
}

static inline void fp_neg(const Ctx &c, Fp &r, const Fp &a) {
  if (fp_is_zero(c, a)) {
    r = a;
    return;
  }
  u128 borrow = 0;
  for (int i = 0; i < c.nl; i++) {
    u128 cur = (u128)c.p[i] - a.v[i] - (u64)borrow;
    r.v[i] = (u64)cur;
    borrow = (cur >> 64) ? 1 : 0;
  }
}

// CIOS Montgomery multiplication: r = a * b * R^{-1} mod p.
// Templated on the limb count so the compiler fully unrolls the carry
// chains for the common widths (bn254: 4, bls12: 6, 761-bit: 12).
template <int NL>
static void fp_mul_t(const Ctx &c, Fp &r, const Fp &a, const Fp &b) {
  u64 t[NL + 2];
  for (int i = 0; i < NL + 2; i++) t[i] = 0;
  for (int i = 0; i < NL; i++) {
    u128 carry = 0;
    u64 ai = a.v[i];
    for (int j = 0; j < NL; j++) {
      u128 cur = (u128)ai * b.v[j] + t[j] + (u64)carry;
      t[j] = (u64)cur;
      carry = cur >> 64;
    }
    u128 cur = (u128)t[NL] + (u64)carry;
    t[NL] = (u64)cur;
    t[NL + 1] = (u64)(cur >> 64);

    u64 m = t[0] * c.n0inv;
    u128 cur0 = (u128)m * c.p[0] + t[0];
    carry = cur0 >> 64;
    for (int j = 1; j < NL; j++) {
      u128 c2 = (u128)m * c.p[j] + t[j] + (u64)carry;
      t[j - 1] = (u64)c2;
      carry = c2 >> 64;
    }
    u128 c3 = (u128)t[NL] + (u64)carry;
    t[NL - 1] = (u64)c3;
    t[NL] = t[NL + 1] + (u64)(c3 >> 64);
    t[NL + 1] = 0;
  }
  bool ge = t[NL] != 0;
  if (!ge) {
    ge = true;
    for (int i = NL - 1; i >= 0; i--) {
      if (t[i] != c.p[i]) {
        ge = t[i] > c.p[i];
        break;
      }
    }
  }
  if (ge) {
    u128 borrow = 0;
    for (int i = 0; i < NL; i++) {
      u128 cur = (u128)t[i] - c.p[i] - (u64)borrow;
      r.v[i] = (u64)cur;
      borrow = (cur >> 64) ? 1 : 0;
    }
  } else {
    for (int i = 0; i < NL; i++) r.v[i] = t[i];
  }
}

static void fp_mul_var(const Ctx &c, Fp &r, const Fp &a, const Fp &b) {
  const int nl = c.nl;
  u64 t[MAXL + 2];
  for (int i = 0; i < nl + 2; i++) t[i] = 0;
  for (int i = 0; i < nl; i++) {
    u128 carry = 0;
    u64 ai = a.v[i];
    for (int j = 0; j < nl; j++) {
      u128 cur = (u128)ai * b.v[j] + t[j] + (u64)carry;
      t[j] = (u64)cur;
      carry = cur >> 64;
    }
    u128 cur = (u128)t[nl] + (u64)carry;
    t[nl] = (u64)cur;
    t[nl + 1] = (u64)(cur >> 64);

    u64 m = t[0] * c.n0inv;
    u128 cur0 = (u128)m * c.p[0] + t[0];
    carry = cur0 >> 64;
    for (int j = 1; j < nl; j++) {
      u128 c2 = (u128)m * c.p[j] + t[j] + (u64)carry;
      t[j - 1] = (u64)c2;
      carry = c2 >> 64;
    }
    u128 c3 = (u128)t[nl] + (u64)carry;
    t[nl - 1] = (u64)c3;
    t[nl] = t[nl + 1] + (u64)(c3 >> 64);
    t[nl + 1] = 0;
  }
  if (t[nl] || fp_cmp_p(c, t) >= 0) {
    u128 borrow = 0;
    for (int i = 0; i < nl; i++) {
      u128 cur = (u128)t[i] - c.p[i] - (u64)borrow;
      r.v[i] = (u64)cur;
      borrow = (cur >> 64) ? 1 : 0;
    }
  } else {
    for (int i = 0; i < nl; i++) r.v[i] = t[i];
  }
}

static inline void fp_mul(const Ctx &c, Fp &r, const Fp &a, const Fp &b) {
  switch (c.nl) {
    case 4:
      return fp_mul_t<4>(c, r, a, b);
    case 6:
      return fp_mul_t<6>(c, r, a, b);
    case 12:
      return fp_mul_t<12>(c, r, a, b);
    default:
      return fp_mul_var(c, r, a, b);
  }
}

static inline void fp_sqr(const Ctx &c, Fp &r, const Fp &a) { fp_mul(c, r, a, a); }

// r = a^e where e is an nl-limb little-endian exponent.
static void fp_pow_limbs(const Ctx &c, Fp &r, const Fp &a, const u64 *e, int el) {
  Fp base = a, res = c.one;
  int top = el * 64 - 1;
  while (top >= 0 && !((e[top / 64] >> (top % 64)) & 1)) top--;
  for (int bit = 0; bit <= top; bit++) {
    if ((e[bit / 64] >> (bit % 64)) & 1) fp_mul(c, res, res, base);
    if (bit != top) fp_sqr(c, base, base);
  }
  r = res;
}

static void fp_inv(const Ctx &c, Fp &r, const Fp &a) {
  fp_pow_limbs(c, r, a, c.pm2, c.nl);
}

static void fp_from_std(const Ctx &c, Fp &r, const u64 *std) {
  Fp t;
  for (int i = 0; i < c.nl; i++) t.v[i] = std[i];
  fp_mul(c, r, t, c.r2);
}

static void fp_to_std(const Ctx &c, u64 *std, const Fp &a) {
  Fp one_raw;
  fp_zero(c, one_raw);
  one_raw.v[0] = 1;
  Fp t;
  fp_mul(c, t, a, one_raw);  // Montgomery reduce
  for (int i = 0; i < c.nl; i++) std[i] = t.v[i];
}

// ---------------------------------------------------------------------------
// Fp2 = Fp[u]/(u^2 - nr)   (ref/field.py Fp2Ctx)
// ---------------------------------------------------------------------------

static inline void fp2_add(const Ctx &c, Fp2 &r, const Fp2 &a, const Fp2 &b) {
  fp_add(c, r.c0, a.c0, b.c0);
  fp_add(c, r.c1, a.c1, b.c1);
}
static inline void fp2_sub(const Ctx &c, Fp2 &r, const Fp2 &a, const Fp2 &b) {
  fp_sub(c, r.c0, a.c0, b.c0);
  fp_sub(c, r.c1, a.c1, b.c1);
}
static inline void fp2_neg(const Ctx &c, Fp2 &r, const Fp2 &a) {
  fp_neg(c, r.c0, a.c0);
  fp_neg(c, r.c1, a.c1);
}
static inline void fp2_conj(const Ctx &c, Fp2 &r, const Fp2 &a) {
  r.c0 = a.c0;
  fp_neg(c, r.c1, a.c1);
}

static void fp2_mul(const Ctx &c, Fp2 &r, const Fp2 &a, const Fp2 &b) {
  // Karatsuba: 3 base muls
  Fp t0, t1, s0, s1, cross;
  fp_mul(c, t0, a.c0, b.c0);
  fp_mul(c, t1, a.c1, b.c1);
  fp_add(c, s0, a.c0, a.c1);
  fp_add(c, s1, b.c0, b.c1);
  fp_mul(c, cross, s0, s1);
  Fp nt1;
  fp_mul(c, nt1, c.nr, t1);
  Fp out0;
  fp_add(c, out0, t0, nt1);
  fp_sub(c, cross, cross, t0);
  fp_sub(c, r.c1, cross, t1);
  r.c0 = out0;
}

static void fp2_sqr(const Ctx &c, Fp2 &r, const Fp2 &a) {
  // (a0 + a1 u)^2 = (a0^2 + nr a1^2) + 2 a0 a1 u
  Fp t, a0s, a1s, nt;
  fp_mul(c, t, a.c0, a.c1);
  fp_sqr(c, a0s, a.c0);
  fp_sqr(c, a1s, a.c1);
  fp_mul(c, nt, c.nr, a1s);
  fp_add(c, r.c0, a0s, nt);
  fp_add(c, r.c1, t, t);
}

static inline void fp2_mul_fp(const Ctx &c, Fp2 &r, const Fp2 &a, const Fp &k) {
  fp_mul(c, r.c0, a.c0, k);
  fp_mul(c, r.c1, a.c1, k);
}

static void fp2_inv(const Ctx &c, Fp2 &r, const Fp2 &a) {
  Fp n, a0s, a1s, nn, ninv;
  fp_sqr(c, a0s, a.c0);
  fp_sqr(c, a1s, a.c1);
  fp_mul(c, nn, c.nr, a1s);
  fp_sub(c, n, a0s, nn);
  fp_inv(c, ninv, n);
  fp_mul(c, r.c0, a.c0, ninv);
  Fp negc1;
  fp_neg(c, negc1, a.c1);
  fp_mul(c, r.c1, negc1, ninv);
}

static inline int fp2_is_zero(const Ctx &c, const Fp2 &a) {
  return fp_is_zero(c, a.c0) && fp_is_zero(c, a.c1);
}

// ---------------------------------------------------------------------------
// Fp6 = Fp2[v]/(v^3 - xi)   (ref/field.py Fp6Ctx)
// ---------------------------------------------------------------------------

static inline void fp6_add(const Ctx &c, Fp6 &r, const Fp6 &a, const Fp6 &b) {
  fp2_add(c, r.c0, a.c0, b.c0);
  fp2_add(c, r.c1, a.c1, b.c1);
  fp2_add(c, r.c2, a.c2, b.c2);
}
static inline void fp6_sub(const Ctx &c, Fp6 &r, const Fp6 &a, const Fp6 &b) {
  fp2_sub(c, r.c0, a.c0, b.c0);
  fp2_sub(c, r.c1, a.c1, b.c1);
  fp2_sub(c, r.c2, a.c2, b.c2);
}
static inline void fp6_neg(const Ctx &c, Fp6 &r, const Fp6 &a) {
  fp2_neg(c, r.c0, a.c0);
  fp2_neg(c, r.c1, a.c1);
  fp2_neg(c, r.c2, a.c2);
}

static inline void fp6_mul_by_xi_fp2(const Ctx &c, Fp2 &r, const Fp2 &a) {
  fp2_mul(c, r, a, c.xi);
}

static void fp6_mul(const Ctx &c, Fp6 &r, const Fp6 &a, const Fp6 &b) {
  Fp2 t0, t1, t2, s, u0, u1, tmp;
  fp2_mul(c, t0, a.c0, b.c0);
  fp2_mul(c, t1, a.c1, b.c1);
  fp2_mul(c, t2, a.c2, b.c2);
  // c0 = t0 + xi*((a1+a2)(b1+b2) - t1 - t2)
  fp2_add(c, u0, a.c1, a.c2);
  fp2_add(c, u1, b.c1, b.c2);
  fp2_mul(c, s, u0, u1);
  fp2_sub(c, s, s, t1);
  fp2_sub(c, s, s, t2);
  fp6_mul_by_xi_fp2(c, tmp, s);
  Fp2 out0;
  fp2_add(c, out0, t0, tmp);
  // c1 = (a0+a1)(b0+b1) - t0 - t1 + xi*t2
  fp2_add(c, u0, a.c0, a.c1);
  fp2_add(c, u1, b.c0, b.c1);
  fp2_mul(c, s, u0, u1);
  fp2_sub(c, s, s, t0);
  fp2_sub(c, s, s, t1);
  fp6_mul_by_xi_fp2(c, tmp, t2);
  Fp2 out1;
  fp2_add(c, out1, s, tmp);
  // c2 = (a0+a2)(b0+b2) - t0 - t2 + t1
  fp2_add(c, u0, a.c0, a.c2);
  fp2_add(c, u1, b.c0, b.c2);
  fp2_mul(c, s, u0, u1);
  fp2_sub(c, s, s, t0);
  fp2_sub(c, s, s, t2);
  fp2_add(c, r.c2, s, t1);
  r.c0 = out0;
  r.c1 = out1;
}

static void fp6_sqr(const Ctx &c, Fp6 &r, const Fp6 &a) {
  // CH-SQR3 (matches Fp6Ctx.sqr)
  Fp2 s0, ab, s1, s2, bc, s3, s4, t, tmp;
  fp2_sqr(c, s0, a.c0);
  fp2_mul(c, ab, a.c0, a.c1);
  fp2_add(c, s1, ab, ab);
  fp2_sub(c, t, a.c0, a.c1);
  fp2_add(c, t, t, a.c2);
  fp2_sqr(c, s2, t);
  fp2_mul(c, bc, a.c1, a.c2);
  fp2_add(c, s3, bc, bc);
  fp2_sqr(c, s4, a.c2);
  fp6_mul_by_xi_fp2(c, tmp, s3);
  Fp2 out0;
  fp2_add(c, out0, s0, tmp);
  fp6_mul_by_xi_fp2(c, tmp, s4);
  Fp2 out1;
  fp2_add(c, out1, s1, tmp);
  Fp2 u;
  fp2_add(c, u, s1, s2);
  fp2_add(c, u, u, s3);
  fp2_sub(c, u, u, s0);
  fp2_sub(c, r.c2, u, s4);
  r.c0 = out0;
  r.c1 = out1;
}

static void fp6_mul_by_01(const Ctx &c, Fp6 &r, const Fp6 &a, const Fp2 &b0,
                          const Fp2 &b1) {
  // a * (b0 + b1 v): matches Fp6Ctx.mul_by_01
  Fp2 m00, m21, m01, m10, m11, m20, tmp;
  fp2_mul(c, m00, a.c0, b0);
  fp2_mul(c, m21, a.c2, b1);
  fp2_mul(c, m01, a.c0, b1);
  fp2_mul(c, m10, a.c1, b0);
  fp2_mul(c, m11, a.c1, b1);
  fp2_mul(c, m20, a.c2, b0);
  fp6_mul_by_xi_fp2(c, tmp, m21);
  fp2_add(c, r.c0, m00, tmp);
  fp2_add(c, r.c1, m01, m10);
  fp2_add(c, r.c2, m11, m20);
}

static inline void fp6_mul_fp2(const Ctx &c, Fp6 &r, const Fp6 &a, const Fp2 &s) {
  fp2_mul(c, r.c0, a.c0, s);
  fp2_mul(c, r.c1, a.c1, s);
  fp2_mul(c, r.c2, a.c2, s);
}

static void fp6_mul_by_v(const Ctx &c, Fp6 &r, const Fp6 &a) {
  // (a0,a1,a2) -> (xi*a2, a0, a1)
  Fp2 t;
  fp6_mul_by_xi_fp2(c, t, a.c2);
  Fp2 a0 = a.c0, a1 = a.c1;
  r.c0 = t;
  r.c1 = a0;
  r.c2 = a1;
}

static void fp6_inv(const Ctx &c, Fp6 &r, const Fp6 &a) {
  // matches Fp6Ctx.inv
  Fp2 t0, t1, t2, d, tmp, m;
  fp2_sqr(c, t0, a.c0);
  fp2_mul(c, m, a.c1, a.c2);
  fp6_mul_by_xi_fp2(c, tmp, m);
  fp2_sub(c, t0, t0, tmp);
  fp2_sqr(c, m, a.c2);
  fp6_mul_by_xi_fp2(c, tmp, m);
  fp2_mul(c, m, a.c0, a.c1);
  fp2_sub(c, t1, tmp, m);
  fp2_sqr(c, m, a.c1);
  fp2_mul(c, tmp, a.c0, a.c2);
  fp2_sub(c, t2, m, tmp);
  // d = a0*t0 + xi*(a2*t1 + a1*t2)
  Fp2 u, w;
  fp2_mul(c, u, a.c2, t1);
  fp2_mul(c, w, a.c1, t2);
  fp2_add(c, u, u, w);
  fp6_mul_by_xi_fp2(c, tmp, u);
  fp2_mul(c, d, a.c0, t0);
  fp2_add(c, d, d, tmp);
  Fp2 dinv;
  fp2_inv(c, dinv, d);
  fp2_mul(c, r.c0, t0, dinv);
  fp2_mul(c, r.c1, t1, dinv);
  fp2_mul(c, r.c2, t2, dinv);
}

// ---------------------------------------------------------------------------
// Fp12 = Fp6[w]/(w^2 - v)   (ref/field.py Fp12Ctx)
// ---------------------------------------------------------------------------

static void fp12_mul(const Ctx &c, Fp12 &r, const Fp12 &a, const Fp12 &b) {
  Fp6 t0, t1, s0, s1, cross, vt1;
  fp6_mul(c, t0, a.c0, b.c0);
  fp6_mul(c, t1, a.c1, b.c1);
  fp6_add(c, s0, a.c0, a.c1);
  fp6_add(c, s1, b.c0, b.c1);
  fp6_mul(c, cross, s0, s1);
  fp6_mul_by_v(c, vt1, t1);
  Fp6 out0;
  fp6_add(c, out0, t0, vt1);
  fp6_sub(c, cross, cross, t0);
  fp6_sub(c, r.c1, cross, t1);
  r.c0 = out0;
}

static void fp12_sqr(const Ctx &c, Fp12 &r, const Fp12 &a) {
  // complex squaring (matches Fp12Ctx.sqr)
  Fp6 t, s0, s1, vt, u;
  fp6_mul(c, t, a.c0, a.c1);
  fp6_add(c, s0, a.c0, a.c1);
  fp6_mul_by_v(c, vt, a.c1);
  fp6_add(c, s1, a.c0, vt);
  fp6_mul(c, u, s0, s1);
  fp6_mul_by_v(c, vt, t);
  fp6_sub(c, u, u, t);
  fp6_sub(c, r.c0, u, vt);
  fp6_add(c, r.c1, t, t);
}

static inline void fp12_conj(const Ctx &c, Fp12 &r, const Fp12 &a) {
  r.c0 = a.c0;
  fp6_neg(c, r.c1, a.c1);
}

static void fp12_inv(const Ctx &c, Fp12 &r, const Fp12 &a) {
  Fp6 d, s0, s1, dinv, m;
  fp6_sqr(c, s0, a.c0);
  fp6_sqr(c, s1, a.c1);
  fp6_mul_by_v(c, m, s1);
  fp6_sub(c, d, s0, m);
  fp6_inv(c, dinv, d);
  fp6_mul(c, r.c0, a.c0, dinv);
  fp6_mul(c, m, a.c1, dinv);
  fp6_neg(c, r.c1, m);
}

static void fp12_one(const Ctx &c, Fp12 &r) {
  memset(&r, 0, sizeof(Fp12));
  r.c0.c0.c0 = c.one;
}

static void fp12_mul_by_034(const Ctx &c, Fp12 &r, const Fp12 &f, const Fp2 &c0,
                            const Fp2 &c3, const Fp2 &c4) {
  // matches Fp12Ctx.mul_by_034
  Fp6 t0, t1, fs, cross, vt1;
  fp6_mul_fp2(c, t0, f.c0, c0);
  fp6_mul_by_01(c, t1, f.c1, c3, c4);
  fp6_add(c, fs, f.c0, f.c1);
  Fp2 c0c3;
  fp2_add(c, c0c3, c0, c3);
  fp6_mul_by_01(c, cross, fs, c0c3, c4);
  fp6_sub(c, cross, cross, t0);
  fp6_sub(c, r.c1, cross, t1);
  fp6_mul_by_v(c, vt1, t1);
  fp6_add(c, r.c0, t0, vt1);
}

static void fp12_mul_by_045(const Ctx &c, Fp12 &r, const Fp12 &f, const Fp2 &c0,
                            const Fp2 &c4, const Fp2 &c5) {
  // matches Fp12Ctx.mul_by_045: f * (c0 + c4 vw + c5 v^2 w)
  Fp6 t0, t1, fs, cross, vt1;
  fp6_mul_fp2(c, t0, f.c0, c0);
  // t1 = f1 * (c4 v + c5 v^2)
  Fp2 m, m2, u;
  fp2_mul(c, m, f.c1.c1, c5);
  fp2_mul(c, m2, f.c1.c2, c4);
  fp2_add(c, u, m, m2);
  fp2_mul(c, t1.c0, c.xi, u);
  fp2_mul(c, m, f.c1.c0, c4);
  fp2_mul(c, m2, f.c1.c2, c5);
  fp2_mul(c, m2, c.xi, m2);
  fp2_add(c, t1.c1, m, m2);
  fp2_mul(c, m, f.c1.c0, c5);
  fp2_mul(c, m2, f.c1.c1, c4);
  fp2_add(c, t1.c2, m, m2);
  fp6_add(c, fs, f.c0, f.c1);
  Fp6 sparse;
  sparse.c0 = c0;
  sparse.c1 = c4;
  sparse.c2 = c5;
  fp6_mul(c, cross, fs, sparse);
  fp6_sub(c, cross, cross, t0);
  fp6_sub(c, r.c1, cross, t1);
  fp6_mul_by_v(c, vt1, t1);
  fp6_add(c, r.c0, t0, vt1);
}

static void fp12_cyclotomic_sqr(const Ctx &c, Fp12 &r, const Fp12 &a) {
  // Granger-Scott (matches Fp12Ctx.cyclotomic_sqr)
  const Fp2 &g00 = a.c0.c0, &g01 = a.c0.c1, &g02 = a.c0.c2;
  const Fp2 &g10 = a.c1.c0, &g11 = a.c1.c1, &g12 = a.c1.c2;
  Fp2 a0, a1, b0, b1, c0, c1;
  // fp4_sqr(c0_, c1_): (c0^2 + xi c1^2, 2 c0 c1)
  auto fp4_sqr = [&](Fp2 &o0, Fp2 &o1, const Fp2 &x0, const Fp2 &x1) {
    Fp2 t0, t1, m, xt;
    fp2_sqr(c, t0, x0);
    fp2_sqr(c, t1, x1);
    fp2_mul(c, m, x0, x1);
    fp2_mul(c, xt, c.xi, t1);
    fp2_add(c, o0, t0, xt);
    fp2_add(c, o1, m, m);
  };
  fp4_sqr(a0, a1, g00, g11);
  fp4_sqr(b0, b1, g10, g02);
  fp4_sqr(c0, c1, g01, g12);
  auto three_minus_two = [&](Fp2 &o, const Fp2 &t, const Fp2 &g) {
    Fp2 d;
    fp2_sub(c, d, t, g);
    fp2_add(c, d, d, d);
    fp2_add(c, o, d, t);
  };
  auto three_plus_two = [&](Fp2 &o, const Fp2 &t, const Fp2 &g) {
    Fp2 d;
    fp2_add(c, d, t, g);
    fp2_add(c, d, d, d);
    fp2_add(c, o, d, t);
  };
  Fp2 xic1;
  fp2_mul(c, xic1, c.xi, c1);
  Fp12 out;
  three_minus_two(out.c0.c0, a0, g00);
  three_minus_two(out.c0.c1, b0, g01);
  three_minus_two(out.c0.c2, c0, g02);
  three_plus_two(out.c1.c0, xic1, g10);
  three_plus_two(out.c1.c1, a1, g11);
  three_plus_two(out.c1.c2, b1, g12);
  r = out;
}

static void fp12_frobenius(const Ctx &c, Fp12 &r, const Fp12 &a, int power) {
  // matches Fp12Ctx.frobenius (power in 1..3)
  const Fp2 &g = c.frob_g[power - 1];
  Fp2 g2, g3, g4, g5;
  fp2_mul(c, g2, g, g);
  fp2_mul(c, g3, g2, g);
  fp2_mul(c, g4, g2, g2);
  fp2_mul(c, g5, g4, g);
  auto frob2 = [&](Fp2 &o, const Fp2 &x) {
    if (power % 2 == 1)
      fp2_conj(c, o, x);
    else
      o = x;
  };
  Fp2 t;
  Fp12 out;
  frob2(out.c0.c0, a.c0.c0);
  frob2(t, a.c0.c1);
  fp2_mul(c, out.c0.c1, t, g2);
  frob2(t, a.c0.c2);
  fp2_mul(c, out.c0.c2, t, g4);
  frob2(t, a.c1.c0);
  fp2_mul(c, out.c1.c0, t, g);
  frob2(t, a.c1.c1);
  fp2_mul(c, out.c1.c1, t, g3);
  frob2(t, a.c1.c2);
  fp2_mul(c, out.c1.c2, t, g5);
  r = out;
}

// ---------------------------------------------------------------------------
// Miller loop (matches ref/pairing.py RefPairing fast path)
// ---------------------------------------------------------------------------

struct TwistPt {
  Fp2 X, Y, Z;
};

// Doubling step: returns the new T and the sparse line (l0, lA, lB).
static void dbl_step(const Ctx &c, TwistPt &t, Fp2 line[3], const Fp &xp,
                     const Fp &yp) {
  Fp2 A, B, C, E, Fv, G, H, I, J, E2, tmp, t2;
  fp2_mul(c, A, t.X, t.Y);
  fp2_mul_fp(c, A, A, c.two_inv);
  fp2_sqr(c, B, t.Y);
  fp2_sqr(c, C, t.Z);
  fp2_mul(c, E, c.b2_3, C);
  fp2_add(c, Fv, E, E);
  fp2_add(c, Fv, Fv, E);
  fp2_add(c, G, B, Fv);
  fp2_mul_fp(c, G, G, c.two_inv);
  fp2_add(c, tmp, t.Y, t.Z);
  fp2_sqr(c, tmp, tmp);
  fp2_add(c, t2, B, C);
  fp2_sub(c, H, tmp, t2);
  fp2_sub(c, I, E, B);
  fp2_sqr(c, J, t.X);
  fp2_sqr(c, E2, E);
  // T' = (A(B - F), G^2 - 3E^2, B*H)
  fp2_sub(c, tmp, B, Fv);
  Fp2 nX, nY, nZ;
  fp2_mul(c, nX, A, tmp);
  fp2_sqr(c, tmp, G);
  fp2_add(c, t2, E2, E2);
  fp2_add(c, t2, t2, E2);
  fp2_sub(c, nY, tmp, t2);
  fp2_mul(c, nZ, B, H);
  t.X = nX;
  t.Y = nY;
  t.Z = nZ;
  // line: -H*yp, 3J*xp, I  (D-twist slots 0,3,4; M remaps below)
  Fp2 negH, J3;
  fp2_neg(c, negH, H);
  fp2_mul_fp(c, line[0], negH, yp);
  fp2_add(c, J3, J, J);
  fp2_add(c, J3, J3, J);
  fp2_mul_fp(c, line[1], J3, xp);
  line[2] = I;
  if (!c.twist_is_D) {
    // M: line = xi*(-H yp) + I w^3 + 3J xp w^5 (slots 0, 4, 5)
    Fp2 l0;
    fp2_mul(c, l0, c.xi, line[0]);
    Fp2 l1 = line[2];
    Fp2 l2 = line[1];
    line[0] = l0;
    line[1] = l1;
    line[2] = l2;
  }
}

// Mixed addition step T + Q.
static void add_step(const Ctx &c, TwistPt &t, Fp2 line[3], const Fp2 &xq,
                     const Fp2 &yq, const Fp &xp, const Fp &yp) {
  Fp2 theta, lam, Cc, D, E, Fv, G, H, tmp, t2;
  fp2_mul(c, tmp, yq, t.Z);
  fp2_sub(c, theta, t.Y, tmp);
  fp2_mul(c, tmp, xq, t.Z);
  fp2_sub(c, lam, t.X, tmp);
  fp2_sqr(c, Cc, theta);
  fp2_sqr(c, D, lam);
  fp2_mul(c, E, lam, D);
  fp2_mul(c, Fv, t.Z, Cc);
  fp2_mul(c, G, t.X, D);
  fp2_add(c, tmp, E, Fv);
  fp2_add(c, t2, G, G);
  fp2_sub(c, H, tmp, t2);
  Fp2 nX, nY, nZ;
  fp2_mul(c, nX, lam, H);
  fp2_sub(c, tmp, G, H);
  fp2_mul(c, tmp, theta, tmp);
  fp2_mul(c, t2, E, t.Y);
  fp2_sub(c, nY, tmp, t2);
  fp2_mul(c, nZ, t.Z, E);
  t.X = nX;
  t.Y = nY;
  t.Z = nZ;
  // line: lam*yp, -theta*xp, theta*xq - lam*yq
  Fp2 ntheta, j;
  fp2_mul_fp(c, line[0], lam, yp);
  fp2_neg(c, ntheta, theta);
  fp2_mul_fp(c, line[1], ntheta, xp);
  fp2_mul(c, tmp, theta, xq);
  fp2_mul(c, t2, lam, yq);
  fp2_sub(c, j, tmp, t2);
  line[2] = j;
  if (!c.twist_is_D) {
    // M: line = xi*(lam yp) + j w^3 + (-theta xp) w^5
    Fp2 l0;
    fp2_mul(c, l0, c.xi, line[0]);
    Fp2 l1 = line[2];
    Fp2 l2 = line[1];
    line[0] = l0;
    line[1] = l1;
    line[2] = l2;
  }
}

static inline void line_mul(const Ctx &c, Fp12 &f, const Fp2 line[3]) {
  if (c.twist_is_D)
    fp12_mul_by_034(c, f, f, line[0], line[1], line[2]);
  else
    fp12_mul_by_045(c, f, f, line[0], line[1], line[2]);
}

static void sparse_line_to_fp12(const Ctx &c, Fp12 &f, const Fp2 line[3]) {
  memset(&f, 0, sizeof(Fp12));
  if (c.twist_is_D) {
    f.c0.c0 = line[0];
    f.c1.c0 = line[1];
    f.c1.c1 = line[2];
  } else {
    f.c0.c0 = line[0];
    f.c1.c1 = line[1];
    f.c1.c2 = line[2];
  }
}

// Multi-Miller loop over n pairs; points already in Montgomery form.
static void multi_miller(const Ctx &c, Fp12 &f, int n, const Fp *xps,
                         const Fp *yps, const Fp2 *xqs, const Fp2 *yqs,
                         TwistPt *ts) {
  for (int i = 0; i < n; i++) {
    ts[i].X = xqs[i];
    ts[i].Y = yqs[i];
    memset(&ts[i].Z, 0, sizeof(Fp2));
    ts[i].Z.c0 = c.one;
  }
  fp12_one(c, f);
  int one_flag = 1;
  Fp2 line[3];
  for (int bit = c.ate_bits - 2; bit >= 0; bit--) {
    if (!one_flag) fp12_sqr(c, f, f);
    for (int i = 0; i < n; i++) {
      dbl_step(c, ts[i], line, xps[i], yps[i]);
      if (one_flag) {
        sparse_line_to_fp12(c, f, line);
        one_flag = 0;
      } else {
        line_mul(c, f, line);
      }
    }
    if ((c.ate_loop[bit / 64] >> (bit % 64)) & 1) {
      for (int i = 0; i < n; i++) {
        add_step(c, ts[i], line, xqs[i], yqs[i], xps[i], yps[i]);
        line_mul(c, f, line);
      }
    }
  }
  if (c.ate_neg) {
    fp12_conj(c, f, f);
    for (int i = 0; i < n; i++) fp2_neg(c, ts[i].Y, ts[i].Y);
  }
  if (c.is_bn) {
    // BN tail: two extra adds with pi(Q) and -pi^2(Q)
    for (int i = 0; i < n; i++) {
      Fp2 xq1, yq1, xq2, yq2, t;
      fp2_conj(c, t, xqs[i]);
      fp2_mul(c, xq1, t, c.bn_g12);
      fp2_conj(c, t, yqs[i]);
      fp2_mul(c, yq1, t, c.bn_g13);
      fp2_mul(c, xq2, xqs[i], c.bn_g22);
      fp2_mul(c, t, yqs[i], c.bn_g23);
      fp2_neg(c, yq2, t);
      add_step(c, ts[i], line, xq1, yq1, xps[i], yps[i]);
      line_mul(c, f, line);
      add_step(c, ts[i], line, xq2, yq2, xps[i], yps[i]);
      line_mul(c, f, line);
    }
  }
}

// ---------------------------------------------------------------------------
// Final exponentiation (matches ref/pairing.py)
// ---------------------------------------------------------------------------

// Frobenius-Straus joint exponentiation with cyclotomic squarings:
// f^(sum_i d_i p^i) = prod_i frob^i(f)^{d_i}, shared squaring chain.
static void frob_straus_pow(const Ctx &c, Fp12 &r, const Fp12 &f) {
  const int nd = c.ndig;
  Fp12 bases[4];
  bases[0] = f;
  for (int i = 1; i < nd; i++) fp12_frobenius(c, bases[i], f, i);
  // table over subsets
  Fp12 table[16];
  int tsize = 1 << nd;
  for (int mask = 1; mask < tsize; mask++) {
    int low = mask & (-mask);
    int i = __builtin_ctz(low);
    if (mask == low)
      table[mask] = bases[i];
    else
      fp12_mul(c, table[mask], table[mask ^ low], bases[i]);
  }
  int top = -1;
  for (int j = 0; j < nd; j++) {
    for (int bit = c.nl * 64 - 1; bit >= 0; bit--) {
      if ((c.hard_digits[j][bit / 64] >> (bit % 64)) & 1) {
        if (bit > top) top = bit;
        break;
      }
    }
  }
  int started = 0;
  Fp12 res;
  for (int bit = top; bit >= 0; bit--) {
    if (started) fp12_cyclotomic_sqr(c, res, res);
    int mask = 0;
    for (int j = 0; j < nd; j++)
      mask |= (int)((c.hard_digits[j][bit / 64] >> (bit % 64)) & 1) << j;
    if (mask) {
      if (!started) {
        res = table[mask];
        started = 1;
      } else {
        fp12_mul(c, res, res, table[mask]);
      }
    }
  }
  if (!started)
    fp12_one(c, r);
  else
    r = res;
}

static void final_exponentiation(const Ctx &c, Fp12 &r, const Fp12 &f) {
  Fp12 finv, f1, f2, fr;
  fp12_inv(c, finv, f);
  fp12_conj(c, f1, f);
  fp12_mul(c, f1, f1, finv);  // f^(p^6 - 1)
  fp12_frobenius(c, fr, f1, 2);
  fp12_mul(c, f2, fr, f1);  // ^(p^2 + 1)
  frob_straus_pow(c, r, f2);
}

// ---------------------------------------------------------------------------
// G1 Jacobian (a = 0) for prepare_inputs / subgroup checks
// ---------------------------------------------------------------------------

struct G1J {
  Fp X, Y, Z;  // Z == 0 <=> infinity
};

static void g1_dbl(const Ctx &c, G1J &r, const G1J &a) {
  if (fp_is_zero(c, a.Z)) {
    r = a;
    return;
  }
  // dbl-2007-bl (valid for general curve coefficient a = c.g1_a):
  // S=2((X+YY)^2-XX-YYYY), M=3XX+a*ZZ^2, X3=M^2-2S,
  // Y3=M(S-X3)-8YYYY, Z3=(Y+Z)^2-YY-ZZ
  Fp XX, YY, YYYY, ZZ, S, M, t, t2;
  fp_sqr(c, XX, a.X);
  fp_sqr(c, YY, a.Y);
  fp_sqr(c, YYYY, YY);
  fp_sqr(c, ZZ, a.Z);
  fp_add(c, t, a.X, YY);
  fp_sqr(c, t, t);
  fp_sub(c, t, t, XX);
  fp_sub(c, t, t, YYYY);
  fp_add(c, S, t, t);
  fp_add(c, M, XX, XX);
  fp_add(c, M, M, XX);
  if (!fp_is_zero(c, c.g1_a)) {
    fp_sqr(c, t, ZZ);
    fp_mul(c, t, t, c.g1_a);
    fp_add(c, M, M, t);
  }
  Fp X3, Y3, Z3;
  fp_sqr(c, X3, M);
  fp_add(c, t, S, S);
  fp_sub(c, X3, X3, t);
  fp_sub(c, t, S, X3);
  fp_mul(c, t, M, t);
  fp_add(c, t2, YYYY, YYYY);
  fp_add(c, t2, t2, t2);
  fp_add(c, t2, t2, t2);
  fp_sub(c, Y3, t, t2);
  fp_add(c, t, a.Y, a.Z);
  fp_sqr(c, t, t);
  fp_sub(c, t, t, YY);
  fp_sub(c, Z3, t, ZZ);
  r.X = X3;
  r.Y = Y3;
  r.Z = Z3;
}

static void g1_add(const Ctx &c, G1J &r, const G1J &a, const G1J &b) {
  if (fp_is_zero(c, a.Z)) {
    r = b;
    return;
  }
  if (fp_is_zero(c, b.Z)) {
    r = a;
    return;
  }
  // add-2007-bl
  Fp Z1Z1, Z2Z2, U1, U2, S1, S2, t;
  fp_sqr(c, Z1Z1, a.Z);
  fp_sqr(c, Z2Z2, b.Z);
  fp_mul(c, U1, a.X, Z2Z2);
  fp_mul(c, U2, b.X, Z1Z1);
  fp_mul(c, t, b.Z, Z2Z2);
  fp_mul(c, S1, a.Y, t);
  fp_mul(c, t, a.Z, Z1Z1);
  fp_mul(c, S2, b.Y, t);
  Fp H, Rr;
  fp_sub(c, H, U2, U1);
  fp_sub(c, Rr, S2, S1);
  if (fp_is_zero(c, H)) {
    if (fp_is_zero(c, Rr)) {
      g1_dbl(c, r, a);
      return;
    }
    memset(&r, 0, sizeof(G1J));  // P + (-P) = O
    return;
  }
  Fp I, J, rr2, V;
  fp_add(c, t, H, H);
  fp_sqr(c, I, t);
  fp_mul(c, J, H, I);
  fp_add(c, rr2, Rr, Rr);
  fp_mul(c, V, U1, I);
  Fp X3, Y3, Z3;
  fp_sqr(c, t, rr2);
  fp_sub(c, t, t, J);
  Fp twoV;
  fp_add(c, twoV, V, V);
  fp_sub(c, X3, t, twoV);
  fp_sub(c, t, V, X3);
  fp_mul(c, t, rr2, t);
  Fp S1J;
  fp_mul(c, S1J, S1, J);
  fp_add(c, S1J, S1J, S1J);
  fp_sub(c, Y3, t, S1J);
  fp_add(c, t, a.Z, b.Z);
  fp_sqr(c, t, t);
  fp_sub(c, t, t, Z1Z1);
  fp_sub(c, t, t, Z2Z2);
  fp_mul(c, Z3, t, H);
  r.X = X3;
  r.Y = Y3;
  r.Z = Z3;
}

static void g1_mul_limbs(const Ctx &c, G1J &r, const G1J &base, const u64 *e,
                         int el) {
  G1J acc;
  memset(&acc, 0, sizeof(G1J));
  int top = el * 64 - 1;
  while (top >= 0 && !((e[top / 64] >> (top % 64)) & 1)) top--;
  for (int bit = top; bit >= 0; bit--) {
    g1_dbl(c, acc, acc);
    if ((e[bit / 64] >> (bit % 64)) & 1) g1_add(c, acc, acc, base);
  }
  r = acc;
}

// ---------------------------------------------------------------------------
// Tate engine for BW6 / MNT families (matches ref/pairing.py
// RefPairingTate's projective fast path): Kh = Fq[u]/(u^D - nr),
// GT = Kh[v]/(v^2 - u); Miller loop over the scalar-field order r with
// lines evaluated at the untwisted Q (Kh coordinates, precomputed by
// the Python caller).
// ---------------------------------------------------------------------------

template <int D>
struct Kh {
  Fp c[D];
};
template <int D>
struct GTq {
  Kh<D> c0, c1;  // c0 + c1 v
};

template <int D>
static void kh_add(const Ctx &x, Kh<D> &r, const Kh<D> &a, const Kh<D> &b) {
  for (int i = 0; i < D; i++) fp_add(x, r.c[i], a.c[i], b.c[i]);
}
template <int D>
static void kh_sub(const Ctx &x, Kh<D> &r, const Kh<D> &a, const Kh<D> &b) {
  for (int i = 0; i < D; i++) fp_sub(x, r.c[i], a.c[i], b.c[i]);
}
template <int D>
static void kh_neg(const Ctx &x, Kh<D> &r, const Kh<D> &a) {
  for (int i = 0; i < D; i++) fp_neg(x, r.c[i], a.c[i]);
}
template <int D>
static void kh_mul_fp(const Ctx &x, Kh<D> &r, const Kh<D> &a, const Fp &k) {
  for (int i = 0; i < D; i++) fp_mul(x, r.c[i], a.c[i], k);
}
template <int D>
static int kh_is_zero(const Ctx &x, const Kh<D> &a) {
  for (int i = 0; i < D; i++)
    if (!fp_is_zero(x, a.c[i])) return 0;
  return 1;
}

template <int D>
static void kh_mul(const Ctx &x, Kh<D> &r, const Kh<D> &a, const Kh<D> &b);

template <>
void kh_mul<2>(const Ctx &x, Kh<2> &r, const Kh<2> &a, const Kh<2> &b) {
  // (matches Fp2Ctx.mul): c0 = a0b0 + nr a1b1, c1 = a0b1 + a1b0
  Fp t0, t1, s, m1, m2;
  fp_mul(x, t0, a.c[0], b.c[0]);
  fp_mul(x, t1, a.c[1], b.c[1]);
  fp_mul(x, s, x.nr, t1);
  fp_mul(x, m1, a.c[0], b.c[1]);
  fp_mul(x, m2, a.c[1], b.c[0]);
  fp_add(x, r.c[0], t0, s);
  fp_add(x, r.c[1], m1, m2);
}

template <>
void kh_mul<3>(const Ctx &x, Kh<3> &r, const Kh<3> &a, const Kh<3> &b) {
  // (matches Fp3Ctx.mul): c0 = a0b0 + nr(a1b2 + a2b1),
  // c1 = a0b1 + a1b0 + nr a2b2, c2 = a0b2 + a1b1 + a2b0
  Fp m, m2, t, out0, out1, out2;
  fp_mul(x, m, a.c[1], b.c[2]);
  fp_mul(x, m2, a.c[2], b.c[1]);
  fp_add(x, t, m, m2);
  fp_mul(x, t, t, x.nr);
  fp_mul(x, m, a.c[0], b.c[0]);
  fp_add(x, out0, m, t);
  fp_mul(x, m, a.c[0], b.c[1]);
  fp_mul(x, m2, a.c[1], b.c[0]);
  fp_add(x, t, m, m2);
  fp_mul(x, m, a.c[2], b.c[2]);
  fp_mul(x, m, m, x.nr);
  fp_add(x, out1, t, m);
  fp_mul(x, m, a.c[0], b.c[2]);
  fp_mul(x, m2, a.c[1], b.c[1]);
  fp_add(x, t, m, m2);
  fp_mul(x, m, a.c[2], b.c[0]);
  fp_add(x, out2, t, m);
  r.c[0] = out0;
  r.c[1] = out1;
  r.c[2] = out2;
}

template <int D>
static void kh_sqr(const Ctx &x, Kh<D> &r, const Kh<D> &a) {
  kh_mul<D>(x, r, a, a);
}

template <int D>
static void kh_mul_by_u(const Ctx &x, Kh<D> &r, const Kh<D> &a) {
  // u * (a0..a_{D-1}) = (nr*a_{D-1}, a0, ..)
  Fp top;
  fp_mul(x, top, x.nr, a.c[D - 1]);
  for (int i = D - 1; i > 0; i--) r.c[i] = a.c[i - 1];
  r.c[0] = top;
}

template <int D>
static void kh_inv(const Ctx &x, Kh<D> &r, const Kh<D> &a);

template <>
void kh_inv<2>(const Ctx &x, Kh<2> &r, const Kh<2> &a) {
  // norm trick: 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 - nr a1^2)
  Fp n, t0, t1, ninv;
  fp_sqr(x, t0, a.c[0]);
  fp_sqr(x, t1, a.c[1]);
  fp_mul(x, t1, t1, x.nr);
  fp_sub(x, n, t0, t1);
  fp_inv(x, ninv, n);
  fp_mul(x, r.c[0], a.c[0], ninv);
  Fp na1;
  fp_neg(x, na1, a.c[1]);
  fp_mul(x, r.c[1], na1, ninv);
}

template <>
void kh_inv<3>(const Ctx &x, Kh<3> &r, const Kh<3> &a) {
  // matches Fp3Ctx.inv
  Fp t0, t1, t2, den, m, m2, dinv;
  fp_sqr(x, t0, a.c[0]);
  fp_mul(x, m, a.c[1], a.c[2]);
  fp_mul(x, m, m, x.nr);
  fp_sub(x, t0, t0, m);
  fp_sqr(x, t1, a.c[2]);
  fp_mul(x, t1, t1, x.nr);
  fp_mul(x, m, a.c[0], a.c[1]);
  fp_sub(x, t1, t1, m);
  fp_sqr(x, t2, a.c[1]);
  fp_mul(x, m, a.c[0], a.c[2]);
  fp_sub(x, t2, t2, m);
  fp_mul(x, m, a.c[2], t1);
  fp_mul(x, m2, a.c[1], t2);
  fp_add(x, m, m, m2);
  fp_mul(x, m, m, x.nr);
  fp_mul(x, den, a.c[0], t0);
  fp_add(x, den, den, m);
  fp_inv(x, dinv, den);
  fp_mul(x, r.c[0], t0, dinv);
  fp_mul(x, r.c[1], t1, dinv);
  fp_mul(x, r.c[2], t2, dinv);
}

template <int D>
static void gt_mul(const Ctx &x, GTq<D> &r, const GTq<D> &a, const GTq<D> &b) {
  // (matches Fp6Direct3Ctx.mul): c0 = a0b0 + u a1b1, c1 = a0b1 + a1b0
  Kh<D> v00, v11, u1, m1, m2;
  kh_mul<D>(x, v00, a.c0, b.c0);
  kh_mul<D>(x, v11, a.c1, b.c1);
  kh_mul_by_u<D>(x, u1, v11);
  kh_mul<D>(x, m1, a.c0, b.c1);
  kh_mul<D>(x, m2, a.c1, b.c0);
  kh_add<D>(x, r.c0, v00, u1);
  kh_add<D>(x, r.c1, m1, m2);
}

template <int D>
static void gt_sqr(const Ctx &x, GTq<D> &r, const GTq<D> &a) {
  // (a0 + a1 v)^2 = (a0^2 + u a1^2) + 2 a0 a1 v
  Kh<D> m, s0, s1, u1;
  kh_mul<D>(x, m, a.c0, a.c1);
  kh_sqr<D>(x, s0, a.c0);
  kh_sqr<D>(x, s1, a.c1);
  kh_mul_by_u<D>(x, u1, s1);
  kh_add<D>(x, r.c0, s0, u1);
  kh_add<D>(x, r.c1, m, m);
}

template <int D>
static void gt_conj(const Ctx &x, GTq<D> &r, const GTq<D> &a) {
  r.c0 = a.c0;
  kh_neg<D>(x, r.c1, a.c1);
}

template <int D>
static void gt_inv(const Ctx &x, GTq<D> &r, const GTq<D> &a) {
  Kh<D> n, s0, s1, u1, ninv;
  kh_sqr<D>(x, s0, a.c0);
  kh_sqr<D>(x, s1, a.c1);
  kh_mul_by_u<D>(x, u1, s1);
  kh_sub<D>(x, n, s0, u1);
  kh_inv<D>(x, ninv, n);
  kh_mul<D>(x, r.c0, a.c0, ninv);
  Kh<D> m;
  kh_mul<D>(x, m, a.c1, ninv);
  kh_neg<D>(x, r.c1, m);
}

template <int D>
static void gt_one(const Ctx &x, GTq<D> &r) {
  memset(&r, 0, sizeof(GTq<D>));
  r.c0.c[0] = x.one;
}

template <int D>
static void gt_frobenius(const Ctx &x, GTq<D> &r, const GTq<D> &a, int power) {
  // (matches Fp6Direct3Ctx.frobenius): coefficient-wise u-power twists,
  // then the v-part is multiplied by vcoef
  const Fp *uc = x.tate_ucoef[power - 1];
  Kh<D> f0, f1, vc;
  for (int i = 0; i < D; i++) {
    fp_mul(x, f0.c[i], a.c0.c[i], uc[i]);
    fp_mul(x, f1.c[i], a.c1.c[i], uc[i]);
    vc.c[i] = x.tate_vcoef[power - 1][i];
  }
  r.c0 = f0;
  kh_mul<D>(x, r.c1, f1, vc);
}

// Projective Miller doubling on E(Fq); line at untwisted Q.
template <int D>
static void tate_dbl_step(const Ctx &x, G1J &t, GTq<D> &line, const Kh<D> &xq3,
                          const Kh<D> &yq3) {
  // (matches RefPairingTate._dbl_step_fp)
  Fp W, S, B, H, YS, t1, t2;
  fp_sqr(x, t1, t.Z);
  fp_mul(x, W, t1, x.g1_a);
  fp_sqr(x, t2, t.X);
  fp_add(x, t1, t2, t2);
  fp_add(x, t1, t1, t2);
  fp_add(x, W, W, t1);  // W = a Z^2 + 3 X^2
  fp_mul(x, S, t.Y, t.Z);
  fp_mul(x, B, t.X, t.Y);
  fp_mul(x, B, B, S);
  fp_sqr(x, t1, W);
  Fp B8;
  fp_add(x, B8, B, B);
  fp_add(x, B8, B8, B8);
  fp_add(x, B8, B8, B8);
  fp_sub(x, H, t1, B8);
  fp_mul(x, YS, t.Y, S);
  // T' = (2HS, W(4B - H) - 8(YS)^2, 8S^3)
  G1J nt;
  fp_mul(x, t1, H, S);
  fp_add(x, nt.X, t1, t1);
  fp_add(x, t1, B, B);
  fp_add(x, t1, t1, t1);
  fp_sub(x, t1, t1, H);
  fp_mul(x, t1, W, t1);
  fp_sqr(x, t2, YS);
  fp_add(x, t2, t2, t2);
  fp_add(x, t2, t2, t2);
  fp_add(x, t2, t2, t2);
  fp_sub(x, nt.Y, t1, t2);
  fp_sqr(x, t1, S);
  fp_mul(x, t1, t1, S);
  fp_add(x, t1, t1, t1);
  fp_add(x, t1, t1, t1);
  fp_add(x, t1, t1, t1);
  nt.Z = t1;
  // line c0 = xq3 * (-W Z) + embed(W X - 2 Y^2 Z); c1 = yq3 * (2 S Z)
  Fp wz, wx, e;
  fp_mul(x, wz, W, t.Z);
  fp_neg(x, wz, wz);
  fp_mul(x, wx, W, t.X);
  fp_sqr(x, t1, t.Y);
  fp_mul(x, t1, t1, t.Z);
  fp_add(x, t1, t1, t1);
  fp_sub(x, e, wx, t1);
  kh_mul_fp<D>(x, line.c0, xq3, wz);
  fp_add(x, line.c0.c[0], line.c0.c[0], e);
  fp_mul(x, t1, S, t.Z);
  fp_add(x, t1, t1, t1);
  kh_mul_fp<D>(x, line.c1, yq3, t1);
  t = nt;
}

// Mixed add T + P; line through P at untwisted Q.  Returns:
//   0 = normal add, 1 = degenerated to a doubling (T == P),
//   2 = vertical (T + (-T) = O: caller kills T; line dies).
template <int D>
static int tate_add_step(const Ctx &x, G1J &t, GTq<D> &line, const Fp &xp,
                         const Fp &yp, const Kh<D> &xq3, const Kh<D> &yq3) {
  // (matches RefPairingTate._add_step_fp)
  Fp u_, v_, t1, t2;
  fp_mul(x, t1, yp, t.Z);
  fp_sub(x, u_, t1, t.Y);
  fp_mul(x, t1, xp, t.Z);
  fp_sub(x, v_, t1, t.X);
  if (fp_is_zero(x, v_)) {
    if (fp_is_zero(x, u_)) {
      tate_dbl_step<D>(x, t, line, xq3, yq3);
      return 1;
    }
    return 2;
  }
  Fp v2, v3, A_;
  fp_sqr(x, v2, v_);
  fp_mul(x, v3, v2, v_);
  fp_sqr(x, t1, u_);
  fp_mul(x, t1, t1, t.Z);
  fp_sub(x, t1, t1, v3);
  fp_mul(x, t2, v2, t.X);
  fp_add(x, t2, t2, t2);
  fp_sub(x, A_, t1, t2);
  G1J nt;
  fp_mul(x, nt.X, v_, A_);
  fp_mul(x, t1, v2, t.X);
  fp_sub(x, t1, t1, A_);
  fp_mul(x, t1, u_, t1);
  fp_mul(x, t2, v3, t.Y);
  fp_sub(x, nt.Y, t1, t2);
  fp_mul(x, nt.Z, v3, t.Z);
  // line c0 = xq3 * (-u) + embed(u xp - v yp); c1 = yq3 * v
  Fp nu, e;
  fp_neg(x, nu, u_);
  fp_mul(x, t1, u_, xp);
  fp_mul(x, t2, v_, yp);
  fp_sub(x, e, t1, t2);
  kh_mul_fp<D>(x, line.c0, xq3, nu);
  fp_add(x, line.c0.c[0], line.c0.c[0], e);
  kh_mul_fp<D>(x, line.c1, yq3, v_);
  t = nt;
  return 0;
}

// Multi-pair Tate Miller loop over bits of r, one shared squaring chain
// (matches RefPairingTate.multi_miller_loop).
template <int D>
static void tate_multi_miller(const Ctx &x, GTq<D> &f, int n, const Fp *xps,
                              const Fp *yps, const Kh<D> *xq3s,
                              const Kh<D> *yq3s) {
  G1J ts[8];
  bool dead[8];
  for (int i = 0; i < n; i++) {
    ts[i].X = xps[i];
    ts[i].Y = yps[i];
    ts[i].Z = x.one;
    dead[i] = false;
  }
  bool started = false;
  GTq<D> line;
  for (int bit = x.r_bits - 2; bit >= 0; bit--) {
    if (started) gt_sqr<D>(x, f, f);
    for (int i = 0; i < n; i++) {
      if (dead[i]) continue;
      tate_dbl_step<D>(x, ts[i], line, xq3s[i], yq3s[i]);
      if (started)
        gt_mul<D>(x, f, f, line);
      else {
        f = line;
        started = true;
      }
    }
    if ((x.r_loop[bit / 64] >> (bit % 64)) & 1) {
      for (int i = 0; i < n; i++) {
        if (dead[i]) {
          // O + P = P; the vertical line at P dies in the final exp
          ts[i].X = xps[i];
          ts[i].Y = yps[i];
          ts[i].Z = x.one;
          dead[i] = false;
          continue;
        }
        int rc = tate_add_step<D>(x, ts[i], line, xps[i], yps[i], xq3s[i],
                                  yq3s[i]);
        if (rc == 2) {
          dead[i] = true;
          continue;
        }
        if (started)
          gt_mul<D>(x, f, f, line);
        else {
          f = line;
          started = true;
        }
      }
    }
  }
  if (!started) gt_one<D>(x, f);
}

// Frobenius-Straus joint exponentiation in GT by the base-q digits of
// (q^D + 1)/r (the hard part; easy part = conj * inv).
template <int D>
static void tate_final_exp(const Ctx &x, GTq<D> &r, const GTq<D> &f) {
  GTq<D> finv, f1;
  gt_inv<D>(x, finv, f);
  gt_conj<D>(x, f1, f);
  gt_mul<D>(x, f1, f1, finv);  // ^(q^D - 1)
  const int nd = x.ndig;
  GTq<D> bases[4];
  bases[0] = f1;
  for (int i = 1; i < nd; i++) gt_frobenius<D>(x, bases[i], f1, i);
  GTq<D> table[16];
  int tsize = 1 << nd;
  for (int mask = 1; mask < tsize; mask++) {
    int low = mask & (-mask);
    int i = __builtin_ctz(low);
    if (mask == low)
      table[mask] = bases[i];
    else
      gt_mul<D>(x, table[mask], table[mask ^ low], bases[i]);
  }
  int top = -1;
  for (int j = 0; j < nd; j++)
    for (int bit = x.nl * 64 - 1; bit >= 0; bit--)
      if ((x.hard_digits[j][bit / 64] >> (bit % 64)) & 1) {
        if (bit > top) top = bit;
        break;
      }
  bool started = false;
  GTq<D> res;
  for (int bit = top; bit >= 0; bit--) {
    if (started) gt_sqr<D>(x, res, res);
    int mask = 0;
    for (int j = 0; j < nd; j++)
      mask |= (int)((x.hard_digits[j][bit / 64] >> (bit % 64)) & 1) << j;
    if (mask) {
      if (!started) {
        res = table[mask];
        started = true;
      } else {
        gt_mul<D>(x, res, res, table[mask]);
      }
    }
  }
  if (!started)
    gt_one<D>(x, r);
  else
    r = res;
}

// ---------------------------------------------------------------------------
// Field-generic Jacobian point ops (for G2 subgroup checks over Fp2/Fp3
// as well as Fq).  `el_*` overloads dispatch per coordinate ring.
// ---------------------------------------------------------------------------

static inline void el_add(const Ctx &c, Fp &r, const Fp &a, const Fp &b) { fp_add(c, r, a, b); }
static inline void el_sub(const Ctx &c, Fp &r, const Fp &a, const Fp &b) { fp_sub(c, r, a, b); }
static inline void el_mul(const Ctx &c, Fp &r, const Fp &a, const Fp &b) { fp_mul(c, r, a, b); }
static inline int el_is_zero(const Ctx &c, const Fp &a) { return fp_is_zero(c, a); }
template <int D>
static inline void el_add(const Ctx &c, Kh<D> &r, const Kh<D> &a, const Kh<D> &b) { kh_add<D>(c, r, a, b); }
template <int D>
static inline void el_sub(const Ctx &c, Kh<D> &r, const Kh<D> &a, const Kh<D> &b) { kh_sub<D>(c, r, a, b); }
template <int D>
static inline void el_mul(const Ctx &c, Kh<D> &r, const Kh<D> &a, const Kh<D> &b) { kh_mul<D>(c, r, a, b); }
template <int D>
static inline int el_is_zero(const Ctx &c, const Kh<D> &a) { return kh_is_zero<D>(c, a); }

template <typename T>
struct JacPt {
  T X, Y, Z;
};

template <typename T>
static void jac_dbl(const Ctx &c, const T &acoef, int a_zero, JacPt<T> &r,
                    const JacPt<T> &a) {
  if (el_is_zero(c, a.Z)) {
    r = a;
    return;
  }
  T XX, YY, YYYY, ZZ, S, M, t, t2;
  el_mul(c, XX, a.X, a.X);
  el_mul(c, YY, a.Y, a.Y);
  el_mul(c, YYYY, YY, YY);
  el_mul(c, ZZ, a.Z, a.Z);
  el_add(c, t, a.X, YY);
  el_mul(c, t, t, t);
  el_sub(c, t, t, XX);
  el_sub(c, t, t, YYYY);
  el_add(c, S, t, t);
  el_add(c, M, XX, XX);
  el_add(c, M, M, XX);
  if (!a_zero) {
    el_mul(c, t, ZZ, ZZ);
    el_mul(c, t, t, acoef);
    el_add(c, M, M, t);
  }
  JacPt<T> o;
  el_mul(c, o.X, M, M);
  el_add(c, t, S, S);
  el_sub(c, o.X, o.X, t);
  el_sub(c, t, S, o.X);
  el_mul(c, t, M, t);
  el_add(c, t2, YYYY, YYYY);
  el_add(c, t2, t2, t2);
  el_add(c, t2, t2, t2);
  el_sub(c, o.Y, t, t2);
  el_add(c, t, a.Y, a.Z);
  el_mul(c, t, t, t);
  el_sub(c, t, t, YY);
  el_sub(c, o.Z, t, ZZ);
  r = o;
}

template <typename T>
static void jac_add(const Ctx &c, const T &acoef, int a_zero, JacPt<T> &r,
                    const JacPt<T> &a, const JacPt<T> &b) {
  if (el_is_zero(c, a.Z)) {
    r = b;
    return;
  }
  if (el_is_zero(c, b.Z)) {
    r = a;
    return;
  }
  T Z1Z1, Z2Z2, U1, U2, S1, S2, t, H, Rr;
  el_mul(c, Z1Z1, a.Z, a.Z);
  el_mul(c, Z2Z2, b.Z, b.Z);
  el_mul(c, U1, a.X, Z2Z2);
  el_mul(c, U2, b.X, Z1Z1);
  el_mul(c, t, b.Z, Z2Z2);
  el_mul(c, S1, a.Y, t);
  el_mul(c, t, a.Z, Z1Z1);
  el_mul(c, S2, b.Y, t);
  el_sub(c, H, U2, U1);
  el_sub(c, Rr, S2, S1);
  if (el_is_zero(c, H)) {
    if (el_is_zero(c, Rr)) {
      jac_dbl(c, acoef, a_zero, r, a);
      return;
    }
    memset(&r, 0, sizeof(JacPt<T>));
    return;
  }
  T I, J, rr2, V;
  el_add(c, t, H, H);
  el_mul(c, I, t, t);
  el_mul(c, J, H, I);
  el_add(c, rr2, Rr, Rr);
  el_mul(c, V, U1, I);
  JacPt<T> o;
  el_mul(c, o.X, rr2, rr2);
  el_sub(c, o.X, o.X, J);
  T twoV;
  el_add(c, twoV, V, V);
  el_sub(c, o.X, o.X, twoV);
  el_sub(c, t, V, o.X);
  el_mul(c, t, rr2, t);
  T S1J;
  el_mul(c, S1J, S1, J);
  el_add(c, S1J, S1J, S1J);
  el_sub(c, o.Y, t, S1J);
  el_add(c, t, a.Z, b.Z);
  el_mul(c, t, t, t);
  el_sub(c, t, t, Z1Z1);
  el_sub(c, t, t, Z2Z2);
  el_mul(c, o.Z, t, H);
  r = o;
}

template <typename T>
static void jac_mul_limbs(const Ctx &c, const T &acoef, int a_zero, JacPt<T> &r,
                          const JacPt<T> &base, const u64 *e, int el) {
  JacPt<T> acc;
  memset(&acc, 0, sizeof(JacPt<T>));
  int top = el * 64 - 1;
  while (top >= 0 && !((e[top / 64] >> (top % 64)) & 1)) top--;
  for (int bit = top; bit >= 0; bit--) {
    jac_dbl(c, acoef, a_zero, acc, acc);
    if ((e[bit / 64] >> (bit % 64)) & 1) jac_add(c, acoef, a_zero, acc, acc, base);
  }
  r = acc;
}

template <typename T>
static int g2_check_impl(const Ctx &c, const T &acoef, int a_zero, int n,
                         int deg, const u64 *bases, const unsigned char *inf,
                         const u64 *scalar_r) {
  int bad = 0;
  for (int i = 0; i < n; i++) {
    if (inf && inf[i]) continue;
    JacPt<T> b;
    const u64 *pb = bases + (size_t)i * 2 * deg * c.nl;
    Fp *bx = (Fp *)&b.X;
    Fp *by = (Fp *)&b.Y;
    for (int j = 0; j < deg; j++) {
      fp_from_std(c, bx[j], pb + (size_t)j * c.nl);
      fp_from_std(c, by[j], pb + (size_t)(deg + j) * c.nl);
    }
    memset(&b.Z, 0, sizeof(T));
    ((Fp *)&b.Z)[0] = c.one;
    JacPt<T> res;
    jac_mul_limbs(c, acoef, a_zero, res, b, scalar_r, c.nl);
    if (!el_is_zero(c, res.Z)) bad++;
  }
  return bad;
}

template <int D>
static int tate_pairing_impl(const Ctx &x, int n, const u64 *g1,
                             const u64 *q_kh, const unsigned char *inf,
                             u64 *out_gt) {
  Fp xps[8], yps[8];
  Kh<D> xq3s[8], yq3s[8];
  int m = 0;
  for (int i = 0; i < n; i++) {
    if (inf && inf[i]) continue;
    const u64 *pg1 = g1 + (size_t)i * 2 * x.nl;
    fp_from_std(x, xps[m], pg1);
    fp_from_std(x, yps[m], pg1 + x.nl);
    const u64 *pq = q_kh + (size_t)i * 2 * D * x.nl;
    for (int j = 0; j < D; j++) fp_from_std(x, xq3s[m].c[j], pq + (size_t)j * x.nl);
    for (int j = 0; j < D; j++)
      fp_from_std(x, yq3s[m].c[j], pq + (size_t)(D + j) * x.nl);
    m++;
  }
  GTq<D> f, out;
  if (m == 0)
    gt_one<D>(x, f);
  else
    tate_multi_miller<D>(x, f, m, xps, yps, xq3s, yq3s);
  // the Tate Miller value can be 0 only on malformed input (point at
  // infinity slipped through); report it instead of dividing by zero
  bool zero = kh_is_zero<D>(x, f.c0) && kh_is_zero<D>(x, f.c1);
  if (zero) return 2;
  tate_final_exp<D>(x, out, f);
  const Fp *flat = (const Fp *)&out;
  for (int i = 0; i < 2 * D; i++)
    fp_to_std(x, out_gt + (size_t)i * x.nl, flat[i]);
  return 0;
}

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

static void read_fp(const Ctx &c, Fp &r, const u64 *&cur) {
  fp_from_std(c, r, cur);
  cur += c.nl;
}
static void read_fp2(const Ctx &c, Fp2 &r, const u64 *&cur) {
  read_fp(c, r.c0, cur);
  read_fp(c, r.c1, cur);
}

extern "C" {

// blob layout (all nl-limb LE standard-form values, in order):
//   p, r2, [n0inv as 1 limb],
//   nr (1), xi (2), b2_3 (2), frob_g (3*2), bn_g12,g13,g22,g23 (4*2),
//   ate_loop (1), hard_digits (ndig), flags: ate_neg, is_bn, twist_is_D,
//   ndig as 4 limbs.
void *g16_ctx_new(int nl, const u64 *blob) {
  if (nl < 1 || nl > MAXL) return nullptr;
  Ctx *c = new Ctx();
  memset(c, 0, sizeof(Ctx));
  c->nl = nl;
  const u64 *cur = blob;
  for (int i = 0; i < nl; i++) c->p[i] = cur[i];
  cur += nl;
  for (int i = 0; i < nl; i++) c->r2.v[i] = cur[i];
  cur += nl;
  c->n0inv = cur[0];
  cur += 1;
  // p - 2
  {
    u128 borrow = 2;
    for (int i = 0; i < nl; i++) {
      u128 v = (u128)c->p[i] - (u64)borrow;
      c->pm2[i] = (u64)v;
      borrow = (v >> 64) ? 1 : 0;
    }
  }
  // one = R mod p = mont(R2 as "standard R2" ... ) -> fp_from_std(1)
  {
    u64 tmp[MAXL] = {0};
    tmp[0] = 1;
    Fp t;
    for (int i = 0; i < nl; i++) t.v[i] = tmp[i];
    fp_mul(*c, c->one, t, c->r2);
  }
  read_fp(*c, c->nr, cur);
  read_fp2(*c, c->xi, cur);
  read_fp2(*c, c->b2_3, cur);
  for (int i = 0; i < 3; i++) read_fp2(*c, c->frob_g[i], cur);
  read_fp2(*c, c->bn_g12, cur);
  read_fp2(*c, c->bn_g13, cur);
  read_fp2(*c, c->bn_g22, cur);
  read_fp2(*c, c->bn_g23, cur);
  for (int i = 0; i < nl; i++) c->ate_loop[i] = cur[i];
  cur += nl;
  // flags tail (raw limbs, not field elements)
  int ndig = (int)cur[0];
  c->ate_neg = (int)cur[1];
  c->is_bn = (int)cur[2];
  c->twist_is_D = (int)cur[3];
  cur += 4;
  c->ndig = ndig > 4 ? 4 : ndig;
  for (int j = 0; j < c->ndig; j++) {
    for (int i = 0; i < nl; i++) c->hard_digits[j][i] = cur[i];
    cur += nl;
  }
  // ate loop bit length
  c->ate_bits = 0;
  for (int bit = nl * 64 - 1; bit >= 0; bit--) {
    if ((c->ate_loop[bit / 64] >> (bit % 64)) & 1) {
      c->ate_bits = bit + 1;
      break;
    }
  }
  // two_inv = (p + 1)/2 as Montgomery: inv of standard 2
  {
    u64 two[MAXL] = {0};
    two[0] = 2;
    Fp t;
    fp_from_std(*c, t, two);
    fp_inv(*c, c->two_inv, t);
  }
  return c;
}

void g16_ctx_free(void *ctx) { delete (Ctx *)ctx; }

// g1: n * 2*nl limbs (x,y); g2: n * 4*nl (x0,x1,y0,y1); inf: skip flags.
// out_gt: 12*nl standard-form limbs (Fp12 basis order
// c0.c0.c0, c0.c0.c1, c0.c1.c0, ..., c1.c2.c1 — tower order).
int g16_multi_pairing(void *ctx, int n, const u64 *g1, const u64 *g2,
                      const unsigned char *inf, u64 *out_gt) {
  Ctx &c = *(Ctx *)ctx;
  if (n < 1 || n > 8) return 1;
  Fp xps[8], yps[8];
  Fp2 xqs[8], yqs[8];
  TwistPt ts[8];
  int m = 0;
  for (int i = 0; i < n; i++) {
    if (inf && inf[i]) continue;
    const u64 *pg1 = g1 + (size_t)i * 2 * c.nl;
    fp_from_std(c, xps[m], pg1);
    fp_from_std(c, yps[m], pg1 + c.nl);
    const u64 *pg2 = g2 + (size_t)i * 4 * c.nl;
    fp_from_std(c, xqs[m].c0, pg2);
    fp_from_std(c, xqs[m].c1, pg2 + c.nl);
    fp_from_std(c, yqs[m].c0, pg2 + 2 * c.nl);
    fp_from_std(c, yqs[m].c1, pg2 + 3 * c.nl);
    m++;
  }
  Fp12 f, out;
  if (m == 0)
    fp12_one(c, f);
  else
    multi_miller(c, f, m, xps, yps, xqs, yqs, ts);
  final_exponentiation(c, out, f);
  const Fp *flat = (const Fp *)&out;
  for (int i = 0; i < 12; i++) fp_to_std(c, out_gt + (size_t)i * c.nl, flat[i]);
  return 0;
}

// Miller-only variant (for PVK pairing cross-checks / GT experiments).
int g16_multi_miller(void *ctx, int n, const u64 *g1, const u64 *g2,
                     const unsigned char *inf, u64 *out_f) {
  Ctx &c = *(Ctx *)ctx;
  if (n < 1 || n > 8) return 1;
  Fp xps[8], yps[8];
  Fp2 xqs[8], yqs[8];
  TwistPt ts[8];
  int m = 0;
  for (int i = 0; i < n; i++) {
    if (inf && inf[i]) continue;
    const u64 *pg1 = g1 + (size_t)i * 2 * c.nl;
    fp_from_std(c, xps[m], pg1);
    fp_from_std(c, yps[m], pg1 + c.nl);
    const u64 *pg2 = g2 + (size_t)i * 4 * c.nl;
    fp_from_std(c, xqs[m].c0, pg2);
    fp_from_std(c, xqs[m].c1, pg2 + c.nl);
    fp_from_std(c, yqs[m].c0, pg2 + 2 * c.nl);
    fp_from_std(c, yqs[m].c1, pg2 + 3 * c.nl);
    m++;
  }
  Fp12 f;
  if (m == 0)
    fp12_one(c, f);
  else
    multi_miller(c, f, m, xps, yps, xqs, yqs, ts);
  const Fp *flat = (const Fp *)&f;
  for (int i = 0; i < 12; i++) fp_to_std(c, out_f + (size_t)i * c.nl, flat[i]);
  return 0;
}

// Tate-engine context (BW6/MNT).  blob layout (nl-limb LE values):
//   p, r2, [n0inv 1 limb], nr (Fp), g1_a (Fp), r_loop (raw),
//   [ndig, d as 2 raw limbs], hard_digits (ndig * nl raw),
//   then per frobenius power k = 1..ndig-1: d Fp ucoefs + d Fp vcoef.
void *g16_tate_ctx_new(int nl, const u64 *blob) {
  if (nl < 1 || nl > MAXL) return nullptr;
  Ctx *c = new Ctx();
  memset(c, 0, sizeof(Ctx));
  c->nl = nl;
  const u64 *cur = blob;
  for (int i = 0; i < nl; i++) c->p[i] = cur[i];
  cur += nl;
  for (int i = 0; i < nl; i++) c->r2.v[i] = cur[i];
  cur += nl;
  c->n0inv = cur[0];
  cur += 1;
  {
    u128 borrow = 2;
    for (int i = 0; i < nl; i++) {
      u128 v = (u128)c->p[i] - (u64)borrow;
      c->pm2[i] = (u64)v;
      borrow = (v >> 64) ? 1 : 0;
    }
    u64 tmp[MAXL] = {0};
    tmp[0] = 1;
    Fp t;
    for (int i = 0; i < nl; i++) t.v[i] = tmp[i];
    fp_mul(*c, c->one, t, c->r2);
  }
  read_fp(*c, c->nr, cur);
  read_fp(*c, c->g1_a, cur);
  for (int i = 0; i < nl; i++) c->r_loop[i] = cur[i];
  cur += nl;
  int ndig = (int)cur[0];
  int d = (int)cur[1];
  cur += 2;
  if (d != 2 && d != 3) {
    delete c;
    return nullptr;
  }
  c->tate_d = d;
  c->ndig = ndig > 4 ? 4 : ndig;
  for (int j = 0; j < c->ndig; j++) {
    for (int i = 0; i < nl; i++) c->hard_digits[j][i] = cur[i];
    cur += nl;
  }
  for (int k = 1; k < c->ndig && k <= 3; k++) {
    for (int i = 0; i < d; i++) read_fp(*c, c->tate_ucoef[k - 1][i], cur);
    for (int i = 0; i < d; i++) read_fp(*c, c->tate_vcoef[k - 1][i], cur);
  }
  c->r_bits = 0;
  for (int bit = nl * 64 - 1; bit >= 0; bit--)
    if ((c->r_loop[bit / 64] >> (bit % 64)) & 1) {
      c->r_bits = bit + 1;
      break;
    }
  return c;
}

// q_kh: n * 2*d*nl limbs — the UNTWISTED Q coordinates (Kh elements,
// x then y), computed by the caller.  out_gt: 2*d*nl limbs.
int g16_tate_multi_pairing(void *ctx, int n, const u64 *g1, const u64 *q_kh,
                           const unsigned char *inf, u64 *out_gt) {
  Ctx &c = *(Ctx *)ctx;
  if (n < 1 || n > 8) return 1;
  if (c.tate_d == 2) return tate_pairing_impl<2>(c, n, g1, q_kh, inf, out_gt);
  if (c.tate_d == 3) return tate_pairing_impl<3>(c, n, g1, q_kh, inf, out_gt);
  return 1;
}

// Small variable-base MSM: out = sum_i scalars[i] * bases[i]
// (prepare_inputs' g_ic accumulation, verifier.rs:25-39).
// bases: n * 2*nl affine; scalars: n * nl limbs; out: 2*nl + inf flag.
int g16_g1_msm(void *ctx, int n, const u64 *bases, const unsigned char *inf,
               const u64 *scalars, u64 *out_xy, unsigned char *out_inf) {
  Ctx &c = *(Ctx *)ctx;
  G1J acc;
  memset(&acc, 0, sizeof(G1J));
  for (int i = 0; i < n; i++) {
    if (inf && inf[i]) continue;
    G1J b;
    fp_from_std(c, b.X, bases + (size_t)i * 2 * c.nl);
    fp_from_std(c, b.Y, bases + (size_t)i * 2 * c.nl + c.nl);
    b.Z = c.one;
    G1J term;
    g1_mul_limbs(c, term, b, scalars + (size_t)i * c.nl, c.nl);
    g1_add(c, acc, acc, term);
  }
  if (fp_is_zero(c, acc.Z)) {
    *out_inf = 1;
    memset(out_xy, 0, (size_t)2 * c.nl * sizeof(u64));
    return 0;
  }
  *out_inf = 0;
  Fp zinv, zinv2, zinv3, x, y;
  fp_inv(c, zinv, acc.Z);
  fp_sqr(c, zinv2, zinv);
  fp_mul(c, zinv3, zinv2, zinv);
  fp_mul(c, x, acc.X, zinv2);
  fp_mul(c, y, acc.Y, zinv3);
  fp_to_std(c, out_xy, x);
  fp_to_std(c, out_xy + c.nl, y);
  return 0;
}

// Batch G2 subgroup check over a degree-`deg` coordinate ring
// (1 = Fq e.g. BW6, 2 = Fp2, 3 = Fp3).  a2: deg*nl std-form limbs of
// the twist's a coefficient.  Returns the number of failing points.
int g16_g2_subgroup_check(void *ctx, int deg, const u64 *a2, int n,
                          const u64 *bases, const unsigned char *inf,
                          const u64 *scalar_r) {
  Ctx &c = *(Ctx *)ctx;
  if (deg == 1) {
    Fp a;
    fp_from_std(c, a, a2);
    return g2_check_impl<Fp>(c, a, fp_is_zero(c, a), n, 1, bases, inf, scalar_r);
  }
  if (deg == 2) {
    Kh<2> a;
    for (int j = 0; j < 2; j++) fp_from_std(c, a.c[j], a2 + (size_t)j * c.nl);
    return g2_check_impl<Kh<2>>(c, a, kh_is_zero<2>(c, a), n, 2, bases, inf,
                                scalar_r);
  }
  if (deg == 3) {
    Kh<3> a;
    for (int j = 0; j < 3; j++) fp_from_std(c, a.c[j], a2 + (size_t)j * c.nl);
    return g2_check_impl<Kh<3>>(c, a, kh_is_zero<3>(c, a), n, 3, bases, inf,
                                scalar_r);
  }
  return -1;
}

// Batch subgroup check: all bases must satisfy r * P == O.
// scalar_r: nl limbs (the group order). Returns the number of FAILING
// points (0 = all in subgroup); infinity rows pass.
int g16_g1_subgroup_check(void *ctx, int n, const u64 *bases,
                          const unsigned char *inf, const u64 *scalar_r) {
  Ctx &c = *(Ctx *)ctx;
  int bad = 0;
  for (int i = 0; i < n; i++) {
    if (inf && inf[i]) continue;
    G1J b;
    fp_from_std(c, b.X, bases + (size_t)i * 2 * c.nl);
    fp_from_std(c, b.Y, bases + (size_t)i * 2 * c.nl + c.nl);
    b.Z = c.one;
    G1J res;
    g1_mul_limbs(c, res, b, scalar_r, c.nl);
    if (!fp_is_zero(c, res.Z)) bad++;
  }
  return bad;
}

}  // extern "C"
