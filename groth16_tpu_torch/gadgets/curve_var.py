"""In-circuit short-Weierstrass group ops (complete formulas).

Projective points with COMPLETE addition laws, so the circuit has no
witness-dependent branches: one fixed constraint structure covers
generic adds, doublings and the point at infinity (0:1:0).  a = 0
curves use the Renes-Costello-Batina law (the same formula the device
kernel uses, curves/point.py); a != 0 curves (MNT) use the general
bidegree-(2,2) law, validated exhaustively over all point pairs of
non-singular odd-order toy subgroups (tests/test_gadget_mnt.py).  Used
for the in-circuit g_ic input accumulation
(arkworks-rs/groth16 src/constraints.rs:255-271's scalar_mul_le analog).
"""

from __future__ import annotations

from typing import List, Tuple

from groth16_tpu_torch.gadgets.r1cs_std import Boolean, FpVar


class G1Var:
    """Projective (X, Y, Z) over FpVar; infinity = (0, 1, 0)."""

    __slots__ = ("cs", "X", "Y", "Z", "b3", "a")

    def __init__(self, cs, X: FpVar, Y: FpVar, Z: FpVar, b3: int, a: int = 0):
        self.cs = cs
        self.X, self.Y, self.Z = X, Y, Z
        self.b3 = b3 % cs.modulus
        self.a = a % cs.modulus

    @staticmethod
    def from_affine_var(cs, x: FpVar, y: FpVar, b3: int, a: int = 0) -> "G1Var":
        return G1Var(cs, x, y, FpVar.constant(cs, 1), b3, a)

    @staticmethod
    def identity(cs, b3: int, a: int = 0) -> "G1Var":
        return G1Var(
            cs, FpVar.constant(cs, 0), FpVar.constant(cs, 1),
            FpVar.constant(cs, 0), b3, a,
        )

    def add(self, o: "G1Var") -> "G1Var":
        """Complete addition (12 mul constraints; a-terms are linear)."""
        X1, Y1, Z1 = self.X, self.Y, self.Z
        X2, Y2, Z2 = o.X, o.Y, o.Z
        b3, a = self.b3, self.a
        t0 = X1.mul(X2)
        t1 = Y1.mul(Y2)
        t2 = Z1.mul(Z2)
        t3 = (X1 + Y1).mul(X2 + Y2) - t0 - t1
        t4 = (Y1 + Z1).mul(Y2 + Z2) - t1 - t2
        t5 = (X1 + Z1).mul(X2 + Z2) - t0 - t2
        if a == 0:
            # RCB a=0 specialization (matches the device kernel)
            t0t = t0 + t0 + t0
            t2b = t2.scale(b3)
            t5b = t5.scale(b3)
            Z3s = t1 + t2b
            t1m = t1 - t2b
            X3 = t3.mul(t1m) - t4.mul(t5b)
            Y3 = t1m.mul(Z3s) + t5b.mul(t0t)
            Z3 = Z3s.mul(t4) + t0t.mul(t3)
        else:
            # general-a bidegree-(2,2) complete law
            aw = t5.scale(a) + t2.scale(b3)
            u = t1 - aw
            v = t1 + aw
            w = t0.scale(a) + t5.scale(b3) - t2.scale(a * a)
            m = t0.scale(3) + t2.scale(a)
            X3 = t3.mul(u) - t4.mul(w)
            Y3 = v.mul(u) + m.mul(w)
            Z3 = t4.mul(v) + t3.mul(m)
        return G1Var(self.cs, X3, Y3, Z3, b3, a)

    def double(self) -> "G1Var":
        return self.add(self)

    def select(self, bit: Boolean, other: "G1Var") -> "G1Var":
        """bit ? self : other."""
        return G1Var(
            self.cs,
            bit.select(self.X, other.X),
            bit.select(self.Y, other.Y),
            bit.select(self.Z, other.Z),
            self.b3,
            self.a,
        )

    def scalar_mul_le(self, bits: List[Boolean]) -> "G1Var":
        """Double-and-add over little-endian Boolean bits (the in-circuit
        MSM step of constraints.rs:263)."""
        acc = G1Var.identity(self.cs, self.b3, self.a)
        base = self
        for b in bits:
            cand = acc.add(base)
            acc = cand.select(b, acc)
            base = base.double()
        return acc

    def to_affine(self) -> Tuple[FpVar, FpVar]:
        """(X/Z, Y/Z); enforces Z != 0 (honest non-infinity results)."""
        zinv = self.Z.inverse()
        return (self.X.mul(zinv), self.Y.mul(zinv))

    def value(self):
        """Exact affine value (PROVE mode), None-able."""
        if self.X.value is None:
            return None
        p = self.cs.modulus
        if self.Z.value % p == 0:
            return None
        zinv = pow(self.Z.value, p - 2, p)
        return (self.X.value * zinv % p, self.Y.value * zinv % p)
