"""Exact prime-field and tower arithmetic over Python ints.

Implements the behavior the reference consumes from `ark-ff`
(SURVEY.md §2.2 row 1): Fp add/sub/mul/inv/pow/sqrt, and the
Fp2/Fp6/Fp12 towers used by G2 and the pairing
(arkworks-rs/groth16/src/verifier.rs:49-64 consumes them via `Pairing`).

Representation: Fp = int in [0, p); Fp2 = (c0, c1) meaning c0 + c1*u with
u^2 = nonresidue; Fp6 = (a0, a1, a2) of Fp2 meaning a0 + a1*v + a2*v^2 with
v^3 = xi; Fp12 = (b0, b1) of Fp6 meaning b0 + b1*w with w^2 = v.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

Fp2El = Tuple[int, int]
Fp6El = Tuple[Fp2El, Fp2El, Fp2El]
Fp12El = Tuple[Fp6El, Fp6El]


# ---------------------------------------------------------------------------
# Fp
# ---------------------------------------------------------------------------


def inv(a: int, p: int) -> int:
    """a^-1 mod the prime p: the value of Fermat's a^(p-2), by Python's
    extended Euclid (~50x faster at 761 bits)."""
    if a % p == 0:
        raise ZeroDivisionError("inverse of zero")
    return pow(a, -1, p)


def legendre(a: int, p: int) -> int:
    """1 if QR, -1 if non-residue, 0 if zero."""
    a %= p
    if a == 0:
        return 0
    ls = pow(a, (p - 1) // 2, p)
    return 1 if ls == 1 else -1


def sqrt_fp(a: int, p: int) -> Optional[int]:
    """Tonelli-Shanks square root in Fp; None if non-residue."""
    a %= p
    if a == 0:
        return 0
    if legendre(a, p) != 1:
        return None
    # factor p-1 = q * 2^s
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    if s == 1:
        return pow(a, (p + 1) // 4, p)
    # find a non-residue z
    z = 2
    while legendre(z, p) != -1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        # find least i with t^(2^i) == 1
        i, t2i = 0, t
        while t2i != 1:
            t2i = t2i * t2i % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t = t * c % p
        r = r * b % p
    return r


# ---------------------------------------------------------------------------
# Fp2
# ---------------------------------------------------------------------------


class Fp2Ctx:
    """Arithmetic in Fp[u]/(u^2 - nr)."""

    def __init__(self, p: int, nonresidue: int):
        self.p = p
        self.nr = nonresidue % p

    def zero(self) -> Fp2El:
        return (0, 0)

    def one(self) -> Fp2El:
        return (1, 0)

    def add(self, a: Fp2El, b: Fp2El) -> Fp2El:
        p = self.p
        return ((a[0] + b[0]) % p, (a[1] + b[1]) % p)

    def sub(self, a: Fp2El, b: Fp2El) -> Fp2El:
        p = self.p
        return ((a[0] - b[0]) % p, (a[1] - b[1]) % p)

    def neg(self, a: Fp2El) -> Fp2El:
        p = self.p
        return ((-a[0]) % p, (-a[1]) % p)

    def mul(self, a: Fp2El, b: Fp2El) -> Fp2El:
        p, nr = self.p, self.nr
        t0 = a[0] * b[0] % p
        t1 = a[1] * b[1] % p
        c0 = (t0 + nr * t1) % p
        c1 = (a[0] * b[1] + a[1] * b[0]) % p
        return (c0, c1)

    def sqr(self, a: Fp2El) -> Fp2El:
        # (a0 + a1 u)^2 = (a0^2 + nr a1^2) + 2 a0 a1 u: 2 base muls
        p, nr = self.p, self.nr
        t = a[0] * a[1] % p
        return ((a[0] * a[0] + nr * a[1] * a[1]) % p, (t + t) % p)

    def mul_fp(self, a: Fp2El, k: int) -> Fp2El:
        p = self.p
        return (a[0] * k % p, a[1] * k % p)

    def conj(self, a: Fp2El) -> Fp2El:
        return (a[0], (-a[1]) % self.p)

    def mul_by_u(self, a: Fp2El) -> Fp2El:
        """a * u  (u^2 = nr)."""
        return (self.nr * a[1] % self.p, a[0])

    def norm(self, a: Fp2El) -> int:
        p = self.p
        return (a[0] * a[0] - self.nr * a[1] * a[1]) % p

    def inv(self, a: Fp2El) -> Fp2El:
        n = self.norm(a)
        ninv = inv(n, self.p)
        c = self.conj(a)
        return self.mul_fp(c, ninv)

    def pow(self, a: Fp2El, e: int) -> Fp2El:
        res, base = self.one(), a
        while e > 0:
            if e & 1:
                res = self.mul(res, base)
            base = self.sqr(base)
            e >>= 1
        return res

    def is_zero(self, a: Fp2El) -> bool:
        return a[0] % self.p == 0 and a[1] % self.p == 0

    def sqrt(self, a: Fp2El) -> Optional[Fp2El]:
        """Square root in Fp2 via the norm trick."""
        p = self.p
        if self.is_zero(a):
            return (0, 0)
        if a[1] % p == 0:
            r = sqrt_fp(a[0], p)
            if r is not None:
                return (r, 0)
            # a0 = nr * y^2 form: sqrt = y*u
            y2 = a[0] * inv(self.nr, p) % p
            y = sqrt_fp(y2, p)
            if y is None:
                return None
            return (0, y)
        # alpha = norm(a) must be a QR in Fp for a to be a square.
        alpha = self.norm(a)
        n = sqrt_fp(alpha, p)
        if n is None:
            return None
        # x0^2 = (a0 + n)/2 (try both signs of n)
        for nn in (n, (-n) % p):
            half = (a[0] + nn) * inv(2, p) % p
            x0 = sqrt_fp(half, p)
            if x0 is None:
                continue
            if x0 == 0:
                continue
            x1 = a[1] * inv(2 * x0, p) % p
            cand = (x0, x1)
            if self.sqr(cand) == (a[0] % p, a[1] % p):
                return cand
        return None


# ---------------------------------------------------------------------------
# Fp6 = Fp2[v]/(v^3 - xi)
# ---------------------------------------------------------------------------


class Fp6Ctx:
    def __init__(self, k2: Fp2Ctx, xi: Fp2El):
        self.k2 = k2
        self.xi = (xi[0] % k2.p, xi[1] % k2.p)

    def zero(self) -> Fp6El:
        z = self.k2.zero()
        return (z, z, z)

    def one(self) -> Fp6El:
        return (self.k2.one(), self.k2.zero(), self.k2.zero())

    def mul_by_xi(self, a: Fp2El) -> Fp2El:
        return self.k2.mul(a, self.xi)

    def add(self, a: Fp6El, b: Fp6El) -> Fp6El:
        k = self.k2
        return (k.add(a[0], b[0]), k.add(a[1], b[1]), k.add(a[2], b[2]))

    def sub(self, a: Fp6El, b: Fp6El) -> Fp6El:
        k = self.k2
        return (k.sub(a[0], b[0]), k.sub(a[1], b[1]), k.sub(a[2], b[2]))

    def neg(self, a: Fp6El) -> Fp6El:
        k = self.k2
        return (k.neg(a[0]), k.neg(a[1]), k.neg(a[2]))

    def mul(self, a: Fp6El, b: Fp6El) -> Fp6El:
        k = self.k2
        a0, a1, a2 = a
        b0, b1, b2 = b
        t0 = k.mul(a0, b0)
        t1 = k.mul(a1, b1)
        t2 = k.mul(a2, b2)
        c0 = k.add(t0, self.mul_by_xi(k.sub(k.mul(k.add(a1, a2), k.add(b1, b2)), k.add(t1, t2))))
        c1 = k.add(k.sub(k.mul(k.add(a0, a1), k.add(b0, b1)), k.add(t0, t1)), self.mul_by_xi(t2))
        c2 = k.add(k.sub(k.mul(k.add(a0, a2), k.add(b0, b2)), k.add(t0, t2)), t1)
        return (c0, c1, c2)

    def sqr(self, a: Fp6El) -> Fp6El:
        # CH-SQR3: 2 muls + 3 squarings in Fp2
        k = self.k2
        a0, a1, a2 = a
        s0 = k.sqr(a0)
        ab = k.mul(a0, a1)
        s1 = k.add(ab, ab)
        s2 = k.sqr(k.add(k.sub(a0, a1), a2))
        bc = k.mul(a1, a2)
        s3 = k.add(bc, bc)
        s4 = k.sqr(a2)
        return (
            k.add(s0, self.mul_by_xi(s3)),
            k.add(s1, self.mul_by_xi(s4)),
            k.sub(k.add(k.add(s1, s2), s3), k.add(s0, s4)),
        )

    def mul_by_01(self, a: Fp6El, b0: Fp2El, b1: Fp2El) -> Fp6El:
        """a * (b0 + b1 v) — sparse operand (6 Fp2 muls)."""
        k = self.k2
        a0, a1, a2 = a
        return (
            k.add(k.mul(a0, b0), self.mul_by_xi(k.mul(a2, b1))),
            k.add(k.mul(a0, b1), k.mul(a1, b0)),
            k.add(k.mul(a1, b1), k.mul(a2, b0)),
        )

    def mul_fp2(self, a: Fp6El, s: Fp2El) -> Fp6El:
        k = self.k2
        return (k.mul(a[0], s), k.mul(a[1], s), k.mul(a[2], s))

    def mul_by_v(self, a: Fp6El) -> Fp6El:
        """multiply by v: (a0,a1,a2) -> (xi*a2, a0, a1)."""
        return (self.mul_by_xi(a[2]), a[0], a[1])

    def inv(self, a: Fp6El) -> Fp6El:
        k = self.k2
        a0, a1, a2 = a
        t0 = k.sub(k.sqr(a0), self.mul_by_xi(k.mul(a1, a2)))
        t1 = k.sub(self.mul_by_xi(k.sqr(a2)), k.mul(a0, a1))
        t2 = k.sub(k.sqr(a1), k.mul(a0, a2))
        d = k.add(k.mul(a0, t0), self.mul_by_xi(k.add(k.mul(a2, t1), k.mul(a1, t2))))
        dinv = k.inv(d)
        return (k.mul(t0, dinv), k.mul(t1, dinv), k.mul(t2, dinv))

    def is_zero(self, a: Fp6El) -> bool:
        k = self.k2
        return k.is_zero(a[0]) and k.is_zero(a[1]) and k.is_zero(a[2])


# ---------------------------------------------------------------------------
# Fp12 = Fp6[w]/(w^2 - v)
# ---------------------------------------------------------------------------


class Fp12Ctx:
    def __init__(self, k6: Fp6Ctx):
        self.k6 = k6
        self.k2 = k6.k2
        self.p = k6.k2.p
        self._frob_coeffs = None

    def zero(self) -> Fp12El:
        return (self.k6.zero(), self.k6.zero())

    def one(self) -> Fp12El:
        return (self.k6.one(), self.k6.zero())

    def add(self, a: Fp12El, b: Fp12El) -> Fp12El:
        return (self.k6.add(a[0], b[0]), self.k6.add(a[1], b[1]))

    def sub(self, a: Fp12El, b: Fp12El) -> Fp12El:
        return (self.k6.sub(a[0], b[0]), self.k6.sub(a[1], b[1]))

    def mul(self, a: Fp12El, b: Fp12El) -> Fp12El:
        k6 = self.k6
        a0, a1 = a
        b0, b1 = b
        t0 = k6.mul(a0, b0)
        t1 = k6.mul(a1, b1)
        c0 = k6.add(t0, k6.mul_by_v(t1))
        c1 = k6.sub(k6.sub(k6.mul(k6.add(a0, a1), k6.add(b0, b1)), t0), t1)
        return (c0, c1)

    def sqr(self, a: Fp12El) -> Fp12El:
        # complex squaring: 2 Fp6 muls
        k6 = self.k6
        a0, a1 = a
        t = k6.mul(a0, a1)
        c0 = k6.sub(
            k6.mul(k6.add(a0, a1), k6.add(a0, k6.mul_by_v(a1))),
            k6.add(t, k6.mul_by_v(t)),
        )
        return (c0, k6.add(t, t))

    def mul_by_034(self, f: Fp12El, c0: Fp2El, c3: Fp2El, c4: Fp2El) -> Fp12El:
        """f * (c0 + c3 w + c4 v w) — the sparse line shape of the
        D-twist Miller loop (nonzero Fp2 slots 0, 3, 4 of the 6-slot
        Fp12 basis {1, v, v^2, w, vw, v^2w})."""
        k6 = self.k6
        f0, f1 = f
        t0 = k6.mul_fp2(f0, c0)
        t1 = k6.mul_by_01(f1, c3, c4)
        # Karatsuba cross term: (f0 + f1) * (c0 + c3 + c4 v)
        fs = k6.add(f0, f1)
        cross = k6.mul_by_01(fs, self.k2.add(c0, c3), c4)
        c1 = k6.sub(k6.sub(cross, t0), t1)
        return (k6.add(t0, k6.mul_by_v(t1)), c1)

    def mul_by_045(self, f: Fp12El, c0: Fp2El, c4: Fp2El, c5: Fp2El) -> Fp12El:
        """f * (c0 + c4 vw + c5 v^2 w) — the sparse line shape of the
        M-twist Miller loop (w^3 = vw and w^5 = v^2 w slots; the line
        c0 + cA w^3 + cB w^5 has no plain-w term)."""
        k2, k6 = self.k2, self.k6
        xi = k6.xi
        f0, f1 = f
        t0 = k6.mul_fp2(f0, c0)
        # f1 * (c4 v + c5 v^2)
        a0, a1, a2 = f1
        t1 = (
            k2.mul(xi, k2.add(k2.mul(a1, c5), k2.mul(a2, c4))),
            k2.add(k2.mul(a0, c4), k2.mul(xi, k2.mul(a2, c5))),
            k2.add(k2.mul(a0, c5), k2.mul(a1, c4)),
        )
        fs = k6.add(f0, f1)
        cross = k6.mul(fs, (c0, c4, c5))
        c1 = k6.sub(k6.sub(cross, t0), t1)
        return (k6.add(t0, k6.mul_by_v(t1)), c1)

    def cyclotomic_sqr(self, a: Fp12El) -> Fp12El:
        """Granger-Scott squaring — valid ONLY for elements of the
        cyclotomic subgroup (e.g. any output of the easy part of the
        final exponentiation).  Decomposes Fp12 = Fp4[w]/(w^3 - s) with
        Fp4 = Fp2[s]/(s^2 - xi): A=(g00,g11), B=(g10,g02), C=(g01,g12);
        A' = 3A^2 - 2conj(A), Bw' = 3 s C^2 + 2B, C' = 3B^2 - 2conj(C).
        Cross-checked against the generic `sqr` in tests."""
        k2 = self.k2
        xi = self.k6.xi
        (g00, g01, g02), (g10, g11, g12) = a

        def fp4_sqr(c0: Fp2El, c1: Fp2El):
            # (c0 + c1 s)^2 = (c0^2 + xi c1^2) + 2 c0 c1 s
            t0, t1 = k2.sqr(c0), k2.sqr(c1)
            m = k2.mul(c0, c1)
            return k2.add(t0, k2.mul(xi, t1)), k2.add(m, m)

        a0, a1 = fp4_sqr(g00, g11)
        b0, b1 = fp4_sqr(g10, g02)
        c0, c1 = fp4_sqr(g01, g12)

        def three_minus_two(t: Fp2El, g: Fp2El) -> Fp2El:
            d = k2.sub(t, g)
            return k2.add(k2.add(d, d), t)

        def three_plus_two(t: Fp2El, g: Fp2El) -> Fp2El:
            d = k2.add(t, g)
            return k2.add(k2.add(d, d), t)

        return (
            (
                three_minus_two(a0, g00),
                three_minus_two(b0, g01),
                three_minus_two(c0, g02),
            ),
            (
                three_plus_two(k2.mul(xi, c1), g10),
                three_plus_two(a1, g11),
                three_plus_two(b1, g12),
            ),
        )

    def conj(self, a: Fp12El) -> Fp12El:
        """conjugation = Frobenius^6: negate the w component."""
        return (a[0], self.k6.neg(a[1]))

    def neg(self, a: Fp12El) -> Fp12El:
        return (self.k6.neg(a[0]), self.k6.neg(a[1]))

    def inv(self, a: Fp12El) -> Fp12El:
        k6 = self.k6
        a0, a1 = a
        d = k6.sub(k6.sqr(a0), k6.mul_by_v(k6.sqr(a1)))
        dinv = k6.inv(d)
        return (k6.mul(a0, dinv), k6.neg(k6.mul(a1, dinv)))

    def pow(self, a: Fp12El, e: int) -> Fp12El:
        if e < 0:
            return self.pow(self.inv(a), -e)
        res, base = self.one(), a
        while e > 0:
            if e & 1:
                res = self.mul(res, base)
            base = self.sqr(base)
            e >>= 1
        return res

    def is_one(self, a: Fp12El) -> bool:
        return a == self.one()

    # -- Frobenius ---------------------------------------------------------

    def _frobenius_coeffs(self):
        """gamma_i = xi^((p^i - 1)/6) for i=1..11 (coefficients for w)."""
        if self._frob_coeffs is None:
            p, k2, xi = self.p, self.k2, self.k6.xi
            coeffs = {}
            for i in (1, 2, 3):
                coeffs[i] = k2.pow(xi, (pow(p, i) - 1) // 6)
            self._frob_coeffs = coeffs
        return self._frob_coeffs

    def _frob_fp2(self, a: Fp2El, power: int) -> Fp2El:
        return self.k2.conj(a) if power % 2 == 1 else a

    def frobenius(self, a: Fp12El, power: int = 1) -> Fp12El:
        """a^(p^power) for power in {1,2,3} (enough for pairing use)."""
        assert power in (1, 2, 3)
        k2, k6 = self.k2, self.k6
        g = self._frobenius_coeffs()[power]
        g2 = k2.mul(g, g)
        g3 = k2.mul(g2, g)
        g4 = k2.mul(g2, g2)
        g5 = k2.mul(g4, g)
        a0, a1 = a
        c00 = self._frob_fp2(a0[0], power)
        c01 = k2.mul(self._frob_fp2(a0[1], power), g2)
        c02 = k2.mul(self._frob_fp2(a0[2], power), g4)
        c10 = k2.mul(self._frob_fp2(a1[0], power), g)
        c11 = k2.mul(self._frob_fp2(a1[1], power), g3)
        c12 = k2.mul(self._frob_fp2(a1[2], power), g5)
        return ((c00, c01, c02), (c10, c11, c12))


@functools.lru_cache(maxsize=None)
def towers(curve_name: str):
    """Build (Fp2Ctx, Fp6Ctx, Fp12Ctx) for a registered curve."""
    from groth16_tpu_torch.curves.params import get_curve

    c = get_curve(curve_name)
    k2 = Fp2Ctx(c.p, c.fp2_nonresidue)
    k6 = Fp6Ctx(k2, c.xi)
    k12 = Fp12Ctx(k6)
    return k2, k6, k12


# ---------------------------------------------------------------------------
# Direct-sextic tower for BW6-style curves (embedding degree 6):
# Fp3 = Fp[u]/(u^3 - nr), Fp6 = Fp3[v]/(v^2 - u).
# Reference consumption: ark-bw6-761's Fq3/Fq6 configs via the Pairing
# trait (arkworks-rs/groth16/src/test.rs:135-149 instantiates BW6-761).
# ---------------------------------------------------------------------------

Fp3El = Tuple[int, int, int]
Fp6D3El = Tuple[Fp3El, Fp3El]


class Fp3Ctx:
    """Arithmetic in Fp[u]/(u^3 - nr)."""

    def __init__(self, p: int, nonresidue: int):
        self.p = p
        self.nr = nonresidue % p

    def zero(self) -> Fp3El:
        return (0, 0, 0)

    def one(self) -> Fp3El:
        return (1, 0, 0)

    def add(self, a: Fp3El, b: Fp3El) -> Fp3El:
        p = self.p
        return ((a[0] + b[0]) % p, (a[1] + b[1]) % p, (a[2] + b[2]) % p)

    def sub(self, a: Fp3El, b: Fp3El) -> Fp3El:
        p = self.p
        return ((a[0] - b[0]) % p, (a[1] - b[1]) % p, (a[2] - b[2]) % p)

    def neg(self, a: Fp3El) -> Fp3El:
        p = self.p
        return ((-a[0]) % p, (-a[1]) % p, (-a[2]) % p)

    def mul(self, a: Fp3El, b: Fp3El) -> Fp3El:
        p, nr = self.p, self.nr
        c0 = (a[0] * b[0] + nr * (a[1] * b[2] + a[2] * b[1])) % p
        c1 = (a[0] * b[1] + a[1] * b[0] + nr * a[2] * b[2]) % p
        c2 = (a[0] * b[2] + a[1] * b[1] + a[2] * b[0]) % p
        return (c0, c1, c2)

    def sqr(self, a: Fp3El) -> Fp3El:
        # CH-SQR3: 5 base muls
        p, nr = self.p, self.nr
        a0, a1, a2 = a
        s0 = a0 * a0 % p
        s1 = 2 * a0 * a1 % p
        s2 = (a0 - a1 + a2) ** 2 % p
        s3 = 2 * a1 * a2 % p
        s4 = a2 * a2 % p
        return (
            (s0 + nr * s3) % p,
            (s1 + nr * s4) % p,
            (s1 + s2 + s3 - s0 - s4) % p,
        )

    def mul_fp(self, a: Fp3El, k: int) -> Fp3El:
        p = self.p
        return (a[0] * k % p, a[1] * k % p, a[2] * k % p)

    def mul_by_u(self, a: Fp3El) -> Fp3El:
        """a * u  (u^3 = nr)."""
        p = self.p
        return (self.nr * a[2] % p, a[0], a[1])

    def inv(self, a: Fp3El) -> Fp3El:
        p, nr = self.p, self.nr
        a0, a1, a2 = a
        t0 = (a0 * a0 - nr * a1 * a2) % p
        t1 = (nr * a2 * a2 - a0 * a1) % p
        t2 = (a1 * a1 - a0 * a2) % p
        den = (a0 * t0 + nr * (a2 * t1 + a1 * t2)) % p
        dinv = inv(den, p)
        return (t0 * dinv % p, t1 * dinv % p, t2 * dinv % p)

    def eq(self, a: Fp3El, b: Fp3El) -> bool:
        p = self.p
        return all((x - y) % p == 0 for x, y in zip(a, b))

    def is_zero(self, a: Fp3El) -> bool:
        p = self.p
        return all(x % p == 0 for x in a)

    def pow(self, a: Fp3El, e: int) -> Fp3El:
        if e < 0:
            return self.pow(self.inv(a), -e)
        res, base = self.one(), a
        while e:
            if e & 1:
                res = self.mul(res, base)
            base = self.sqr(base)
            e >>= 1
        return res

    def sqrt(self, a: Fp3El):
        """Generic Tonelli-Shanks in the order-p^3 multiplicative group."""
        if self.is_zero(a):
            return self.zero()
        order = self.p**3 - 1
        if self.pow(a, order // 2) != self.one():
            return None
        q, s = order, 0
        while q % 2 == 0:
            q //= 2
            s += 1
        # find a quadratic non-residue deterministically
        z = None
        for c0 in range(2, 40):
            for cand in ((c0, 1, 0), (c0, 0, 1), (c0, 1, 1)):
                if self.pow(cand, order // 2) != self.one():
                    z = cand
                    break
            if z:
                break
        assert z is not None
        m, c, t, r = s, self.pow(z, q), self.pow(a, q), self.pow(a, (q + 1) // 2)
        while t != self.one():
            i, tt = 0, t
            while tt != self.one():
                tt = self.sqr(tt)
                i += 1
            b = c
            for _ in range(m - i - 1):
                b = self.sqr(b)
            m, c = i, self.sqr(b)
            t = self.mul(t, self.sqr(b))
            r = self.mul(r, b)
        return r


class Fp6Direct3Ctx:
    """Arithmetic in Fp6 = Fp3[v]/(v^2 - u) — the GT field of a
    BW6-style degree-6 pairing."""

    def __init__(self, k3: Fp3Ctx):
        self.k3 = k3
        self.p = k3.p
        self._frob_cache = {}

    def zero(self) -> Fp6D3El:
        return (self.k3.zero(), self.k3.zero())

    def one(self) -> Fp6D3El:
        return (self.k3.one(), self.k3.zero())

    def add(self, a, b):
        return (self.k3.add(a[0], b[0]), self.k3.add(a[1], b[1]))

    def sub(self, a, b):
        return (self.k3.sub(a[0], b[0]), self.k3.sub(a[1], b[1]))

    def neg(self, a):
        return (self.k3.neg(a[0]), self.k3.neg(a[1]))

    def mul(self, a, b):
        k3 = self.k3
        v00 = k3.mul(a[0], b[0])
        v11 = k3.mul(a[1], b[1])
        c0 = k3.add(v00, k3.mul_by_u(v11))  # v^2 = u
        c1 = k3.add(k3.mul(a[0], b[1]), k3.mul(a[1], b[0]))
        return (c0, c1)

    def sqr(self, a):
        # (a0 + a1 v)^2 = (a0^2 + u a1^2) + 2 a0 a1 v: 3 half-field muls
        k3 = self.k3
        m = k3.mul(a[0], a[1])
        return (
            k3.add(k3.sqr(a[0]), k3.mul_by_u(k3.sqr(a[1]))),
            k3.add(m, m),
        )

    def mul_fp(self, a, k: int):
        return (self.k3.mul_fp(a[0], k), self.k3.mul_fp(a[1], k))

    def conj(self, a):
        """v -> -v conjugation (the norm map to Fp3)."""
        return (a[0], self.k3.neg(a[1]))

    def frobenius(self, a, power: int = 1):
        """a^(q^power) in Kh[v]/(v^2 - u), Kh = Fq[u]/(u^d - nr):
        u^(q^k) = u * nr^((q^k - 1)/d) and v^(q^k) = v * u^((q^k - 1)/2),
        both precomputable (q = 1 mod d is guaranteed by u^d - nr being
        irreducible with d | q - 1)."""
        kh = self.k3
        if power not in self._frob_cache:
            q, nr = self.p, kh.nr
            d = len(kh.zero())
            qk = pow(q, power)
            assert (qk - 1) % d == 0
            ucoeffs = [pow(nr, i * ((qk - 1) // d), q) for i in range(d)]
            u = tuple([0, 1] + [0] * (d - 2))
            vcoef = kh.pow(u, (qk - 1) // 2)
            self._frob_cache[power] = (ucoeffs, vcoef)
        ucoeffs, vcoef = self._frob_cache[power]

        def fr(c):
            return tuple(ci * ui % self.p for ci, ui in zip(c, ucoeffs))

        return (fr(a[0]), self.k3.mul(fr(a[1]), vcoef))

    def inv(self, a):
        k3 = self.k3
        # norm = a0^2 - u * a1^2  in Fp3
        n = k3.sub(k3.sqr(a[0]), k3.mul_by_u(k3.sqr(a[1])))
        ninv = k3.inv(n)
        return (k3.mul(a[0], ninv), k3.neg(k3.mul(a[1], ninv)))

    def pow(self, a, e: int):
        if e < 0:
            return self.pow(self.inv(a), -e)
        res = self.one()
        base = a
        while e:
            if e & 1:
                res = self.mul(res, base)
            base = self.sqr(base)
            e >>= 1
        return res

    def eq(self, a, b) -> bool:
        return self.k3.eq(a[0], b[0]) and self.k3.eq(a[1], b[1])
