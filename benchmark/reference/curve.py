"""Plain short-Weierstrass group arithmetic, y^2 = x^3 + A x + B, over a
field of `reference/field.py`, in Jacobian coordinates.

Affine points are (x, y) pairs of field elements, infinity is None.  The
formulas are the textbook ones for any A (the MNT curves have A != 0).
This file is the benchmark's own: it imports nothing of the program.
"""

from __future__ import annotations


class Curve:
    def __init__(self, k, A, B):
        self.k, self.A, self.B = k, k.element(A), k.element(B)
        self.a_zero = k.is_zero(self.A)

    def is_on_curve(self, pt) -> bool:
        if pt is None:
            return True
        k = self.k
        x, y = pt
        rhs = k.add(k.add(k.mul(k.mul(x, x), x), k.mul(self.A, x)), self.B)
        return k.sub(k.mul(y, y), rhs) == k.zero

    def _double(self, P):
        k = self.k
        X, Y, Z = P
        if k.is_zero(Y):
            return None
        XX, YY, ZZ = k.mul(X, X), k.mul(Y, Y), k.mul(Z, Z)
        S = k.mul_int(k.mul(X, YY), 4)
        M = k.mul_int(XX, 3)
        if not self.a_zero:
            M = k.add(M, k.mul(self.A, k.mul(ZZ, ZZ)))
        X3 = k.sub(k.mul(M, M), k.mul_int(S, 2))
        Y3 = k.sub(k.mul(M, k.sub(S, X3)), k.mul_int(k.mul(YY, YY), 8))
        Z3 = k.mul_int(k.mul(Y, Z), 2)
        return (X3, Y3, Z3)

    def _add_affine(self, P, q):
        """Jacobian P + affine q."""
        if q is None:
            return P
        k = self.k
        x2, y2 = q
        if P is None:
            return (x2, y2, k.one)
        X1, Y1, Z1 = P
        Z1Z1 = k.mul(Z1, Z1)
        U2 = k.mul(x2, Z1Z1)
        S2 = k.mul(y2, k.mul(Z1, Z1Z1))
        H = k.sub(U2, X1)
        R = k.sub(S2, Y1)
        if k.is_zero(H):
            return self._double(P) if k.is_zero(R) else None
        HH = k.mul(H, H)
        HHH = k.mul(H, HH)
        V = k.mul(X1, HH)
        X3 = k.sub(k.sub(k.mul(R, R), HHH), k.mul_int(V, 2))
        Y3 = k.sub(k.mul(R, k.sub(V, X3)), k.mul(Y1, HHH))
        Z3 = k.mul(Z1, H)
        return (X3, Y3, Z3)

    def _to_affine(self, P):
        if P is None:
            return None
        k = self.k
        X, Y, Z = P
        zi = k.inv(Z)
        zi2 = k.mul(zi, zi)
        return (k.mul(X, zi2), k.mul(Y, k.mul(zi, zi2)))

    def mul(self, pt, e: int):
        """e * pt for an affine pt and an int e >= 0 (double and add)."""
        if pt is None or e == 0:
            return None
        acc = None
        for bit in bin(e)[2:]:
            if acc is not None:
                acc = self._double(acc)
            if bit == "1":
                acc = self._add_affine(acc, pt)
        return self._to_affine(acc)
