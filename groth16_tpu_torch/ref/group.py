"""Generic Jacobian-coordinate group ops for the reference engine.

Inversion-free point arithmetic so the exact engine can run whole protocol
fixtures in seconds (affine adds need a field inversion per add).  Generic
over a field context exposing add/sub/mul/sqr/neg/inv/is_zero/zero/one —
`FpCtx` (ints) for G1 and `Fp2Ctx` for G2.

Covers the `ark-ec` behavior consumed by the reference: scalar mul
(verifier.rs:35), variable-base MSM (prover.rs:66,74,262), fixed-base batch
mul with a shared window table (generator.rs:129-183), `into_affine` with
batch inversion (prover.rs:127-130).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


class FpCtx:
    """Int field context with the same op surface as Fp2Ctx."""

    def __init__(self, p: int):
        self.p = p

    def zero(self):
        return 0

    def one(self):
        return 1

    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def neg(self, a):
        return (-a) % self.p

    def mul(self, a, b):
        return a * b % self.p

    def sqr(self, a):
        return a * a % self.p

    def mul_fp(self, a, k: int):
        return a * k % self.p

    def inv(self, a):
        if a % self.p == 0:
            raise ZeroDivisionError
        return pow(a, -1, self.p)  # Fermat's a^(p-2), by extended Euclid

    def is_zero(self, a) -> bool:
        return a % self.p == 0


def g2_field_ctx(c):
    """Field context G2 coordinates live in: Fq for bw6-family curves,
    Fq3 for mnt6, Fq2 otherwise."""
    from groth16_tpu_torch.ref.field import Fp2Ctx, Fp3Ctx

    if c.g2_over_base:
        return FpCtx(c.p)
    if c.g2_field_degree == 3:
        return Fp3Ctx(c.p, c.fp2_nonresidue)
    return Fp2Ctx(c.p, c.fp2_nonresidue)


def g1_jacobian(c) -> "JacobianOps":
    return JacobianOps(FpCtx(c.p), A=(c.a % c.p) if c.a else None)


def g2_jacobian(c) -> "JacobianOps":
    A2 = getattr(c, "a2", None) if not c.g2_over_base else None
    return JacobianOps(g2_field_ctx(c), A=A2)


# A Jacobian point is (X, Y, Z); Z == zero() means infinity.
# Affine (x, y) <-> (x, y, 1);  x = X/Z^2, y = Y/Z^3.


class JacobianOps:
    def __init__(self, k, A=None):
        """k: field ctx; A: short-Weierstrass a-coefficient (None = 0,
        the BLS/BN/BW6 case; MNT curves pass their nonzero A)."""
        self.k = k
        self.A = A

    def infinity(self):
        k = self.k
        return (k.one(), k.one(), k.zero())

    def is_infinity(self, pt) -> bool:
        return self.k.is_zero(pt[2])

    def from_affine(self, aff) -> Tuple:
        if aff is None:
            return self.infinity()
        return (aff[0], aff[1], self.k.one())

    def to_affine(self, pt):
        k = self.k
        if self.is_infinity(pt):
            return None
        zinv = k.inv(pt[2])
        zinv2 = k.sqr(zinv)
        return (k.mul(pt[0], zinv2), k.mul(pt[1], k.mul(zinv2, zinv)))

    def neg(self, pt):
        return (pt[0], self.k.neg(pt[1]), pt[2])

    def double(self, pt):
        """dbl-2009-l (a = 0) / dbl-2007-bl-style a-term when A != 0."""
        k = self.k
        X1, Y1, Z1 = pt
        if self.is_infinity(pt) or k.is_zero(Y1):
            return self.infinity()
        A = k.sqr(X1)
        B = k.sqr(Y1)
        C = k.sqr(B)
        t = k.sub(k.sqr(k.add(X1, B)), k.add(A, C))
        D = k.add(t, t)
        E = k.mul_fp(A, 3) if hasattr(k, "mul_fp") else k.mul(A, 3)
        if self.A is not None:
            # + a * Z1^4
            E = k.add(E, k.mul(self.A, k.sqr(k.sqr(Z1))))
        F_ = k.sqr(E)
        X3 = k.sub(F_, k.add(D, D))
        Y3 = k.sub(k.mul(E, k.sub(D, X3)), k.mul_fp(C, 8))
        Z3 = k.mul(k.add(Y1, Y1), Z1)
        return (X3, Y3, Z3)

    def add(self, p1, p2):
        """add-2007-bl with doubling/infinity handling."""
        k = self.k
        if self.is_infinity(p1):
            return p2
        if self.is_infinity(p2):
            return p1
        X1, Y1, Z1 = p1
        X2, Y2, Z2 = p2
        Z1Z1 = k.sqr(Z1)
        Z2Z2 = k.sqr(Z2)
        U1 = k.mul(X1, Z2Z2)
        U2 = k.mul(X2, Z1Z1)
        S1 = k.mul(Y1, k.mul(Z2, Z2Z2))
        S2 = k.mul(Y2, k.mul(Z1, Z1Z1))
        if U1 == U2:
            if S1 == S2:
                return self.double(p1)
            return self.infinity()
        H = k.sub(U2, U1)
        I = k.sqr(k.add(H, H))
        J = k.mul(H, I)
        rr = k.mul_fp(k.sub(S2, S1), 2)
        V = k.mul(U1, I)
        X3 = k.sub(k.sub(k.sqr(rr), J), k.mul_fp(V, 2))
        Y3 = k.sub(k.mul(rr, k.sub(V, X3)), k.mul_fp(k.mul(S1, J), 2))
        Z3 = k.mul(k.mul_fp(k.mul(Z1, Z2), 2), H)
        return (X3, Y3, Z3)

    def add_affine(self, p1, aff):
        if aff is None:
            return p1
        return self.add(p1, self.from_affine(aff))

    def scalar_mul(self, pt, e: int):
        if e < 0:
            return self.scalar_mul(self.neg(pt), -e)
        res, base = self.infinity(), pt
        while e > 0:
            if e & 1:
                res = self.add(res, base)
            base = self.double(base)
            e >>= 1
        return res

    # -- fixed-base batch mul (generator.rs:129-183 analog) -----------------

    def batch_mul(self, base_aff, scalars: Sequence[int], bits: int, window: int = 8) -> List:
        """[s * base for s in scalars] via a shared window table; affine out."""
        base = self.from_affine(base_aff)
        n_windows = (bits + window - 1) // window
        # table[w][d] = d * 2^(window*w) * base
        table = []
        cur = base
        for _ in range(n_windows):
            row = [self.infinity()]
            for d in range(1, 1 << window):
                row.append(self.add(row[-1], cur))
            table.append(row)
            for _ in range(window):
                cur = self.double(cur)
        outs = []
        mask = (1 << window) - 1
        for s in scalars:
            acc = self.infinity()
            w = 0
            while s > 0 or w == 0:
                d = s & mask
                if d:
                    acc = self.add(acc, table[w][d])
                s >>= window
                w += 1
            outs.append(acc)
        return self.batch_to_affine(outs)

    # -- variable-base MSM (prover.rs:66,74,262 analog) ----------------------

    def msm(self, bases_aff: Sequence, scalars: Sequence[int], window: int = 8):
        """Pippenger over affine bases with standard-form int scalars.

        Zips to the shorter of the two sequences, matching arkworks'
        msm_bigint length-zip (SURVEY.md §2.2 MSM row: the h_query MSM
        relies on the trailing scalar being dropped).
        """
        n = min(len(bases_aff), len(scalars))
        bases = [self.from_affine(b) for b in bases_aff[:n]]
        scalars = [s for s in scalars[:n]]
        if n == 0:
            return self.infinity()
        bits = max(s.bit_length() for s in scalars) or 1
        n_windows = (bits + window - 1) // window
        mask = (1 << window) - 1
        window_sums = []
        for w in range(n_windows):
            buckets = [self.infinity() for _ in range(1 << window)]
            shift = w * window
            for b, s in zip(bases, scalars):
                d = (s >> shift) & mask
                if d:
                    buckets[d] = self.add(buckets[d], b)
            acc = self.infinity()
            total = self.infinity()
            for d in range((1 << window) - 1, 0, -1):
                acc = self.add(acc, buckets[d])
                total = self.add(total, acc)
            window_sums.append(total)
        res = self.infinity()
        for ws in reversed(window_sums):
            for _ in range(window):
                res = self.double(res)
            res = self.add(res, ws)
        return res

    def batch_to_affine(self, pts: Sequence) -> List:
        """Montgomery batch inversion of the Z coordinates."""
        k = self.k
        idxs = [i for i, pt in enumerate(pts) if not self.is_infinity(pt)]
        zs = [pts[i][2] for i in idxs]
        n = len(zs)
        prefix = [k.one()] * (n + 1)
        for i, z in enumerate(zs):
            prefix[i + 1] = k.mul(prefix[i], z)
        inv_all = k.inv(prefix[n]) if n else k.one()
        out = [None] * len(pts)
        for i in range(n - 1, -1, -1):
            zinv = k.mul(prefix[i], inv_all)
            inv_all = k.mul(inv_all, zs[i])
            pt = pts[idxs[i]]
            zinv2 = k.sqr(zinv)
            out[idxs[i]] = (k.mul(pt[0], zinv2), k.mul(pt[1], k.mul(zinv2, zinv)))
        return out
