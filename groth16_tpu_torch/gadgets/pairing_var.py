"""In-circuit BLS12 pairing (Miller loop + final exponentiation).

Mirrors the exact engine's algorithm (groth16_tpu/ref/pairing.py:
RefPairing) over constraint variables: the Miller loop runs in affine
E(Fp12) coordinates with the D-twist untwist map, and the final
exponentiation uses the Frobenius easy part plus a polynomial-in-x hard
part.  Reference analog: the in-circuit `PairingVar` consumed at
arkworks-rs/groth16 src/constraints.rs:273-291.

Two structural choices make this circuit-sound (fixed constraint shape,
no witness-dependent branches):
  - Miller-loop steps ALWAYS use the generic tangent/chord formulas —
    valid because for prime-order inputs and the ate loop count the
    exceptional cases (T = +-Q, y_T = 0) never occur;
  - the hard-part exponent is scaled to the minimal integer multiple:
    H81(x) = 81*(p(x)^4 - p(x)^2 + 1)/r(x) is an INTEGER polynomial in
    the curve seed (p(x) carries a /3, so its 4th power needs 81;
    derived here by exact rational polynomial division and checked
    against the engine's integer exponent).  The gadget computes
    f -> f^(easy * 81*hard); gcd(81, r) = 1, and the scaling is applied
    consistently to BOTH sides of the Groth16 equation, so equality
    testing is unaffected (the standard trick for BLS-family hard
    parts).
"""

from __future__ import annotations

import functools
from fractions import Fraction
from typing import Tuple

from groth16_tpu_torch.curves.params import get_curve
from groth16_tpu_torch.gadgets.r1cs_std import (
    Fp2CtxVar,
    Fp6CtxVar,
    Fp12CtxVar,
    FpVar,
)
from groth16_tpu_torch.ref.field import towers


def _poly_mul(a, b):
    out = [Fraction(0)] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            out[i + j] += x * y
    return out


def _poly_sub(a, b):
    n = max(len(a), len(b))
    a = a + [Fraction(0)] * (n - len(a))
    b = b + [Fraction(0)] * (n - len(b))
    return [x - y for x, y in zip(a, b)]


def _poly_divmod(a, b):
    a = list(a)
    q = [Fraction(0)] * (len(a) - len(b) + 1)
    while len(a) >= len(b) and any(a):
        if a[-1] == 0:
            a.pop()
            continue
        d = len(a) - len(b)
        c = a[-1] / b[-1]
        q[d] = c
        a = _poly_sub(a, [Fraction(0)] * d + [c * x for x in b])
        while a and a[-1] == 0:
            a.pop()
    return q, a


@functools.lru_cache(maxsize=None)
def bls12_hard_part_coeffs(curve: str) -> Tuple[int, ...]:
    """Integer coefficients of H81(x) = 81*(p(x)^4 - p(x)^2 + 1)/r(x)
    for the BLS12 family, validated against the engine's exact
    exponent."""
    c = get_curve(curve)
    assert c.family == "bls12"
    F1 = Fraction(1)
    r = [F1, Fraction(0), -F1, Fraction(0), F1]  # x^4 - x^2 + 1
    xm1sq = [F1, Fraction(-2), F1]  # (x-1)^2
    p = _poly_mul(xm1sq, r)
    p = [x / 3 for x in p]
    p[1] += 1  # + x
    p2 = _poly_mul(p, p)
    p4 = _poly_mul(p2, p2)
    phi = _poly_sub(_poly_sub(p4, p2), [Fraction(-1)])
    h, rem = _poly_divmod(phi, r)
    assert not any(rem), "r(x) must divide phi12(p(x))"
    h81 = [x * 81 for x in h]
    assert all(x.denominator == 1 for x in h81), "H81 must be integral"
    coeffs = tuple(int(x) for x in h81)
    # numeric cross-check against the engine's exact integer exponent
    x0 = c.x_seed
    val = sum(co * x0**k for k, co in enumerate(coeffs))
    assert val == 81 * c.final_exp_hard, "hard-part polynomial mismatch"
    return coeffs


class BlsPairingVar:
    """In-circuit optimal-ate pairing for a BLS12 inner curve whose base
    field is the constraint system's native field."""

    def __init__(self, cs, curve: str):
        self.cs = cs
        self.c = get_curve(curve)
        assert self.c.family == "bls12" and self.c.twist_type == "D"
        assert cs.modulus == self.c.p, "native field must be the base field"
        self.ek2, self.ek6, self.ek12 = towers(curve)  # exact (witness calc)
        self.k2 = Fp2CtxVar(cs, self.c.fp2_nonresidue)
        self.k6 = Fp6CtxVar(self.k2, self.c.xi)
        self.k12 = Fp12CtxVar(self.k6)

    # -- embeddings ---------------------------------------------------------

    def _z2(self):
        return self.k2.zero()

    def embed_fp(self, a: FpVar):
        z = self._z2()
        return (((a, FpVar.constant(self.cs, 0)), z, z),
                (z, z, z))

    def untwist(self, q):
        """G2 affine var ((x0,x1),(y0,y1)) -> E(Fp12) affine (D-twist:
        x*w^2, y*w^3 — pure coefficient placement, no constraints)."""
        x, y = q
        z = self._z2()
        x12 = ((z, x, z), (z, z, z))  # x * w^2 = x * v slot
        y12 = ((z, z, z), (z, y, z))  # y * w^3 = (v in c1) slot
        return (x12, y12)

    # -- E(Fp12) affine steps (generic formulas only) -----------------------

    def _tangent(self, T):
        k12 = self.k12
        x1, y1 = T
        num = k12.mul(x1, x1)
        num = _scale12(num, 3)
        den = _add12(k12, y1, y1)
        return k12.mul(num, k12.inv_with(self.ek12, den))

    def _chord(self, T, Q):
        k12 = self.k12
        num = _sub12(k12, Q[1], T[1])
        den = _sub12(k12, Q[0], T[0])
        return k12.mul(num, k12.inv_with(self.ek12, den))

    def _line_and_move(self, T, Q, P12, lam):
        """f-factor of the line through T with slope lam evaluated at P,
        and the resulting point T' = T + Q (Q may be T for doubling)."""
        k12 = self.k12
        xp, yp = P12
        x1, y1 = T
        x2 = Q[0]
        line = _sub12(
            k12, _sub12(k12, yp, y1), k12.mul(lam, _sub12(k12, xp, x1))
        )
        x3 = _sub12(k12, _sub12(k12, k12.mul(lam, lam), x1), x2)
        y3 = _sub12(k12, k12.mul(lam, _sub12(k12, x1, x3)), y1)
        return line, (x3, y3)

    def miller_loop(self, p_var, q_var):
        """p_var: (FpVar, FpVar) G1 affine; q_var: (Fp2Var, Fp2Var) G2
        affine.  Returns the Miller value (Fp12Var)."""
        k12 = self.k12
        q12 = self.untwist(q_var)
        P12 = (self.embed_fp(p_var[0]), self.embed_fp(p_var[1]))
        T = q12
        f = k12.one()
        bits = bin(self.c.ate_loop_count)[3:]
        for bit in bits:
            lam = self._tangent(T)
            line, T = self._line_and_move(T, T, P12, lam)
            f = k12.mul(k12.mul(f, f), line)
            if bit == "1":
                lam = self._chord(T, q12)
                line, T = self._line_and_move(T, q12, P12, lam)
                f = k12.mul(f, line)
        if self.c.ate_loop_is_negative:
            f = k12.conj(f)
        return f

    # -- final exponentiation ------------------------------------------------

    def final_exp(self, f):
        """f^(easy * 81*hard) — see module docstring for the scaling."""
        k12 = self.k12
        # easy: f^(p^6-1) = conj(f) * f^-1; then ^(p^2+1) via Frobenius
        f1 = k12.mul(k12.conj(f), k12.inv_with(self.ek12, f))
        m = k12.mul(k12.frobenius(f1, 2, self.ek12), f1)
        # hard (cubed): prod_k (m^(x^k))^(c_k); cyclotomic inverse = conj
        coeffs = bls12_hard_part_coeffs(self.c.name)
        x = self.c.x_seed
        assert x > 0
        xb = bin(x)[3:]
        pow_k = m
        acc = None
        for k, co in enumerate(coeffs):
            if k > 0:
                # pow_k = pow_{k-1} ^ x
                t = pow_k
                for bit in xb:
                    t = k12.mul(t, t)
                    if bit == "1":
                        t = k12.mul(t, pow_k)
                pow_k = t
            if co == 0:
                continue
            term = self._pow_small(pow_k, abs(co))
            if co < 0:
                term = k12.conj(term)
            acc = term if acc is None else k12.mul(acc, term)
        return acc

    def _pow_small(self, a, e: int):
        k12 = self.k12
        assert e >= 1
        bits = bin(e)[3:]
        t = a
        for bit in bits:
            t = k12.mul(t, t)
            if bit == "1":
                t = k12.mul(t, a)
        return t


def _add12(k12, a, b):
    return (k12.k6.add(a[0], b[0]), k12.k6.add(a[1], b[1]))


def _sub12(k12, a, b):
    return (k12.k6.sub(a[0], b[0]), k12.k6.sub(a[1], b[1]))


def _scale12(a, k: int):
    return tuple(
        tuple((c0.scale(k), c1.scale(k)) for c0, c1 in c6) for c6 in a
    )


class TatePairingVar:
    """In-circuit Tate pairing for MNT4-style curves (GT = Fp4 =
    Fp2[v]/(v^2 - u)), mirroring the exact engine's RefPairingTate over
    constraint variables.  Used by the MNT4-inside-MNT6 instantiation of
    the verifier gadget — the reference's own test cycle
    (arkworks-rs/groth16 src/constraints.rs:452-589)."""

    def __init__(self, cs, curve: str):
        from groth16_tpu_torch.gadgets.r1cs_std import Fp2CtxVar, QuadOverHalfCtxVar
        from groth16_tpu_torch.ref.pairing import RefPairingTate

        self.cs = cs
        self.c = get_curve(curve)
        assert self.c.family == "mnt4" and cs.modulus == self.c.p
        self.exact = RefPairingTate(curve)
        nr = self.c.fp2_nonresidue
        self.kh = Fp2CtxVar(cs, nr)
        self.k12 = QuadOverHalfCtxVar(self.kh)  # GT ctx (Fp4)
        # u^-1, u^-2 constants in Fp2 (for the untwist)
        self.u_inv = self.exact.u_inv
        self.u_inv2 = self.exact.u_inv2
        self.final_exponent = self.exact.final_exp

    def _cmul(self, x, c):
        """Fp2Var times an Fp2 CONSTANT: linear."""
        nr = self.kh.nr
        return (
            x[0].scale(c[0]) + x[1].scale(nr * c[1]),
            x[0].scale(c[1]) + x[1].scale(c[0]),
        )

    def _embed(self, a: FpVar):
        return (a, FpVar.constant(self.cs, 0))

    def untwist(self, q_var):
        """E'(Fp2) var -> (x in Fp2Var, yh in Fp2Var  [times v])."""
        x2, y2 = q_var
        return self._cmul(x2, self.u_inv), self._cmul(y2, self.u_inv2)

    def miller_loop(self, p_var, q_var):
        """f_{r,P}(untwist(Q)) with verticals eliminated; affine G1
        steps over FpVar (generic tangent/chord only — exceptional cases
        cannot occur for prime-order inputs inside the r-loop)."""
        cs = self.cs
        kh, kgt = self.kh, self.k12
        A = self.c.a
        xq, yh = self.untwist(q_var)
        xp, yp = p_var
        xt, yt = p_var
        f = kgt.one()

        def line(xt_, yt_, lam):
            c0 = kh.sub(
                kh.mul_fpvar(kh.sub(xq, self._embed(xt_)), -lam),
                self._embed(yt_),
            )
            return (c0, yh)

        bits = bin(self.c.r)[3:]
        for i, b in enumerate(bits):
            lam = (xt.square().scale(3) + FpVar.constant(cs, A)).mul(
                (yt + yt).inverse()
            )
            f = kgt.mul(kgt.sqr(f), line(xt, yt, lam))
            x3 = lam.square() - xt - xt
            y3 = lam.mul(xt - x3) - yt
            xt, yt = x3, y3
            if b == "1":
                if i == len(bits) - 1:
                    # the FINAL addition of the r-loop is always the
                    # vertical P + (-P) (T = (r-1)P = -P here, r odd):
                    # its line is eliminated by the final exponentiation
                    # and T becomes O — skip it STRUCTURALLY, exactly as
                    # the exact engine does.  Intermediate prefixes of r
                    # are < r-1, so no other step can be vertical.
                    continue
                lam = (yp - yt).mul((xp - xt).inverse())
                f = kgt.mul(f, line(xt, yt, lam))
                x3 = lam.square() - xt - xp
                y3 = lam.mul(xt - x3) - yt
                xt, yt = x3, y3
        return f

    def final_exp(self, f):
        """f^((q^4-1)/r): plain square-and-multiply over the positive
        exponent (no inversion needed)."""
        kgt = self.k12
        bits = bin(self.final_exponent)[3:]
        t = f
        for b in bits:
            t = kgt.sqr(t)
            if b == "1":
                t = kgt.mul(t, f)
        return t
