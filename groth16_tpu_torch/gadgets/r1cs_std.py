"""Constraint-variable primitives: FpVar, Boolean, extension-field vars.

Analog of `ark-r1cs-std`'s FpVar/Boolean/QuadExt/CubicExt var types as
consumed by the reference gadget (arkworks-rs/groth16 src/constraints.rs:14-23).
An FpVar carries a symbolic linear combination over the constraint
system (so additions and constant multiples are FREE — no constraints)
plus its concrete value when the system is in PROVE mode; every
nonlinear op (mul, inverse) allocates one witness and one R1CS
constraint.

Extension fields mirror the exact-engine towers bit-for-bit
(groth16_tpu/ref/field.py): Fp2 = Fp[u]/(u^2 - nr),
Fp6 = Fp2[v]/(v^3 - xi), Fp12 = Fp6[w]/(w^2 - v), so in-circuit values
equal the exact pairing engine's values — the gadget tests assert this.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from groth16_tpu_torch.r1cs.system import (
    ConstraintSystem,
    LinearCombination,
    ONE,
)


class FpVar:
    """A native-field variable: symbolic LC + (in PROVE mode) its value."""

    __slots__ = ("cs", "lc", "value")

    def __init__(self, cs: ConstraintSystem, lc: LinearCombination,
                 value: Optional[int]):
        self.cs = cs
        self.lc = lc
        self.value = None if value is None else value % cs.modulus

    # -- constructors -------------------------------------------------------

    @staticmethod
    def constant(cs: ConstraintSystem, v: int) -> "FpVar":
        v %= cs.modulus
        return FpVar(cs, LinearCombination.from_var(ONE, v), v)

    @staticmethod
    def new_witness(cs: ConstraintSystem, value: Optional[int]) -> "FpVar":
        var = cs.new_witness_variable(
            None if value is None else (lambda v=value: v)
        )
        return FpVar(cs, LinearCombination.from_var(var), value)

    @staticmethod
    def new_input(cs: ConstraintSystem, value: Optional[int]) -> "FpVar":
        var = cs.new_input_variable(
            None if value is None else (lambda v=value: v)
        )
        return FpVar(cs, LinearCombination.from_var(var), value)

    def _is_constant(self) -> Optional[int]:
        """The constant value when the LC is c*ONE, else None."""
        t = self.lc.terms
        if not t:
            return 0
        if len(t) == 1 and ONE in t:
            return t[ONE] % self.cs.modulus
        return None

    # -- linear ops (free) --------------------------------------------------

    def __add__(self, other: "FpVar") -> "FpVar":
        v = None
        if self.value is not None and other.value is not None:
            v = self.value + other.value
        return FpVar(self.cs, self.lc + other.lc, v)

    def __sub__(self, other: "FpVar") -> "FpVar":
        v = None
        if self.value is not None and other.value is not None:
            v = self.value - other.value
        return FpVar(self.cs, self.lc - other.lc, v)

    def __neg__(self) -> "FpVar":
        return FpVar(
            self.cs, self.lc * (self.cs.modulus - 1),
            None if self.value is None else -self.value,
        )

    def scale(self, k: int) -> "FpVar":
        k %= self.cs.modulus
        return FpVar(
            self.cs, self.lc * k,
            None if self.value is None else self.value * k,
        )

    # -- nonlinear ops (1 constraint each) ----------------------------------

    def mul(self, other: "FpVar") -> "FpVar":
        ca, cb = self._is_constant(), other._is_constant()
        if ca is not None:
            return other.scale(ca)
        if cb is not None:
            return self.scale(cb)
        cs = self.cs
        v = None
        if self.value is not None and other.value is not None:
            v = self.value * other.value % cs.modulus
        out = FpVar.new_witness(cs, v)
        cs.enforce_constraint(self.lc, other.lc, out.lc)
        return out

    def square(self) -> "FpVar":
        return self.mul(self)

    def inverse(self) -> "FpVar":
        """Witness the inverse; enforces self * inv = 1 (so self != 0)."""
        cs = self.cs
        v = None
        if self.value is not None:
            v = pow(self.value, cs.modulus - 2, cs.modulus)
        out = FpVar.new_witness(cs, v)
        cs.enforce_constraint(self.lc, out.lc, LinearCombination.from_var(ONE))
        return out

    def enforce_equal(self, other: "FpVar") -> None:
        self.cs.enforce_constraint(
            self.lc - other.lc,
            LinearCombination.from_var(ONE),
            LinearCombination.zero(),
        )


class Boolean:
    """A bit variable: b * (1 - b) = 0."""

    __slots__ = ("var",)

    def __init__(self, var: FpVar):
        self.var = var

    @staticmethod
    def new_witness(cs: ConstraintSystem, value: Optional[bool]) -> "Boolean":
        fv = FpVar.new_witness(cs, None if value is None else int(bool(value)))
        one = FpVar.constant(cs, 1)
        cs.enforce_constraint(fv.lc, (one - fv).lc, LinearCombination.zero())
        return Boolean(fv)

    @staticmethod
    def constant(cs: ConstraintSystem, value: bool) -> "Boolean":
        return Boolean(FpVar.constant(cs, int(bool(value))))

    def select(self, t: FpVar, f: FpVar) -> FpVar:
        """b ? t : f  =  f + b*(t - f)   (1 constraint)."""
        return f + self.var.mul(t - f)


def bits_of(cs: ConstraintSystem, value: Optional[int], nbits: int) -> List[Boolean]:
    """Allocate a little-endian bit decomposition (each bit 1 constraint).
    The BooleanInputVar analog (constraints.rs:151)."""
    out = []
    for i in range(nbits):
        b = None if value is None else bool((value >> i) & 1)
        out.append(Boolean.new_witness(cs, b))
    return out


def to_bits_le(x: FpVar) -> List[Boolean]:
    """Canonical little-endian bit decomposition of a field variable
    (ark-r1cs-std `ToBitsGadget::to_bits_le` analog): allocates
    modulus-bit-length bit witnesses, enforces their weighted sum equals
    x, and enforces the bitstring <= p - 1 so the decomposition is the
    UNIQUE canonical representative (ark's `enforce_in_field_le`)."""
    cs = x.cs
    p = cs.modulus
    nbits = p.bit_length()
    bits = bits_of(cs, x.value, nbits)
    # recomposition: sum 2^i b_i == x  (one linear constraint)
    acc = FpVar.constant(cs, 0)
    for i, b in enumerate(bits):
        acc = acc + b.var.scale(1 << i)
    acc.enforce_equal(x)
    # canonicity: bits <= p - 1, walking from the MSB with an
    # "all-higher-bits-equal" indicator eq; where (p-1)'s bit is 0 an
    # eq-chain 1-bit would exceed p-1, so enforce eq * b = 0 there.
    c = p - 1
    eq = FpVar.constant(cs, 1)
    for i in range(nbits - 1, -1, -1):
        if (c >> i) & 1:
            eq = eq.mul(bits[i].var)
        else:
            cs.enforce_constraint(
                eq.lc, bits[i].var.lc, LinearCombination.zero()
            )
    return bits


def to_bytes_le(x: FpVar) -> List[FpVar]:
    """ark-r1cs-std `ToBytesGadget::to_bytes_le` analog: the canonical
    bits packed into byte variables (each byte a FREE linear combination
    of its 8 bits), little-endian, ceil(|p|/8) bytes."""
    cs = x.cs
    bits = to_bits_le(x)
    while len(bits) % 8:
        bits.append(Boolean.constant(cs, False))
    out = []
    for i in range(0, len(bits), 8):
        byte = FpVar.constant(cs, 0)
        for j in range(8):
            byte = byte + bits[i + j].var.scale(1 << j)
        out.append(byte)
    return out


# ---------------------------------------------------------------------------
# Extension-field variables (towers mirror groth16_tpu/ref/field.py exactly)
# ---------------------------------------------------------------------------

Fp2Var = Tuple[FpVar, FpVar]
Fp6Var = Tuple[Fp2Var, Fp2Var, Fp2Var]
Fp12Var = Tuple[Fp6Var, Fp6Var]


class Fp2CtxVar:
    """Fp[u]/(u^2 - nr) over FpVars (mirrors ref.field.Fp2Ctx)."""

    def __init__(self, cs: ConstraintSystem, nr: int):
        self.cs = cs
        self.nr = nr % cs.modulus

    def constant(self, a) -> Fp2Var:
        return (FpVar.constant(self.cs, a[0]), FpVar.constant(self.cs, a[1]))

    def new_witness(self, a) -> Fp2Var:
        a0 = None if a is None else a[0]
        a1 = None if a is None else a[1]
        return (FpVar.new_witness(self.cs, a0), FpVar.new_witness(self.cs, a1))

    def zero(self) -> Fp2Var:
        return self.constant((0, 0))

    def one(self) -> Fp2Var:
        return self.constant((1, 0))

    def add(self, a, b):
        return (a[0] + b[0], a[1] + b[1])

    def sub(self, a, b):
        return (a[0] - b[0], a[1] - b[1])

    def neg(self, a):
        return (-a[0], -a[1])

    def mul(self, a, b):
        # c0 = a0 b0 + nr a1 b1; c1 = (a0+a1)(b0+b1) - a0 b0 - a1 b1
        t0 = a[0].mul(b[0])
        t1 = a[1].mul(b[1])
        k = (a[0] + a[1]).mul(b[0] + b[1])
        return (t0 + t1.scale(self.nr), k - t0 - t1)

    def sqr(self, a):
        return self.mul(a, a)

    def mul_fp(self, a, k: int):
        return (a[0].scale(k), a[1].scale(k))

    def mul_fpvar(self, a, s: FpVar):
        return (a[0].mul(s), a[1].mul(s))

    def conj(self, a):
        return (a[0], -a[1])

    def mul_by_u(self, a):
        """a * u (u^2 = nr): linear."""
        return (a[1].scale(self.nr), a[0])

    def inv(self, a):
        """Witness the inverse, enforce a * ainv = 1 (2 constraints + mul)."""
        val = None
        if a[0].value is not None and a[1].value is not None:
            from groth16_tpu_torch.ref.field import Fp2Ctx

            val = Fp2Ctx(self.cs.modulus, self.nr).inv((a[0].value, a[1].value))
        out = self.new_witness(val)
        prod = self.mul(a, out)
        prod[0].enforce_equal(FpVar.constant(self.cs, 1))
        prod[1].enforce_equal(FpVar.constant(self.cs, 0))
        return out

    def enforce_equal(self, a, b):
        a[0].enforce_equal(b[0])
        a[1].enforce_equal(b[1])


class Fp6CtxVar:
    """Fp2[v]/(v^3 - xi) over Fp2Vars (mirrors ref.field.Fp6Ctx)."""

    def __init__(self, k2: Fp2CtxVar, xi):
        self.k2 = k2
        self.xi = (xi[0] % k2.cs.modulus, xi[1] % k2.cs.modulus)

    def zero(self):
        z = self.k2.zero()
        return (z, z, z)

    def one(self):
        return (self.k2.one(), self.k2.zero(), self.k2.zero())

    def constant(self, a):
        return tuple(self.k2.constant(c) for c in a)

    def new_witness(self, a):
        return tuple(
            self.k2.new_witness(None if a is None else a[i]) for i in range(3)
        )

    def mul_by_xi(self, a):
        # xi is a small constant Fp2 element: linear (free)
        x0, x1 = self.xi
        nr = self.k2.nr
        # (a0 + a1 u)(x0 + x1 u) = a0x0 + nr a1x1 + (a0x1 + a1x0) u
        return (
            a[0].scale(x0) + a[1].scale(nr * x1),
            a[0].scale(x1) + a[1].scale(x0),
        )

    def add(self, a, b):
        k = self.k2
        return (k.add(a[0], b[0]), k.add(a[1], b[1]), k.add(a[2], b[2]))

    def sub(self, a, b):
        k = self.k2
        return (k.sub(a[0], b[0]), k.sub(a[1], b[1]), k.sub(a[2], b[2]))

    def neg(self, a):
        k = self.k2
        return (k.neg(a[0]), k.neg(a[1]), k.neg(a[2]))

    def mul(self, a, b):
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

    def sqr(self, a):
        return self.mul(a, a)

    def mul_by_v(self, a):
        return (self.mul_by_xi(a[2]), a[0], a[1])

    def enforce_equal(self, a, b):
        for x, y in zip(a, b):
            self.k2.enforce_equal(x, y)


class Fp12CtxVar:
    """Fp6[w]/(w^2 - v) over Fp6Vars (mirrors ref.field.Fp12Ctx)."""

    def __init__(self, k6: Fp6CtxVar):
        self.k6 = k6
        self.k2 = k6.k2
        self.cs = k6.k2.cs

    def one(self):
        return (self.k6.one(), self.k6.zero())

    def constant(self, a):
        return (self.k6.constant(a[0]), self.k6.constant(a[1]))

    def new_witness(self, a):
        return (
            self.k6.new_witness(None if a is None else a[0]),
            self.k6.new_witness(None if a is None else a[1]),
        )

    def mul(self, a, b):
        k6 = self.k6
        t0 = k6.mul(a[0], b[0])
        t1 = k6.mul(a[1], b[1])
        c0 = k6.add(t0, k6.mul_by_v(t1))
        c1 = k6.sub(k6.sub(k6.mul(k6.add(a[0], a[1]), k6.add(b[0], b[1])), t0), t1)
        return (c0, c1)

    def sqr(self, a):
        return self.mul(a, a)

    def conj(self, a):
        return (a[0], self.k6.neg(a[1]))

    def inv(self, a):
        """Witness the Fp12 inverse; enforce a * ainv = 1."""
        val = None
        v = _value12(a)
        if v is not None:
            from groth16_tpu_torch.ref.field import towers

            val = None  # computed by caller-provided ctx; see inv_with
        raise NotImplementedError("use inv_with(exact_ctx, a)")

    def inv_with(self, exact_k12, a):
        v = _value12(a)
        val = exact_k12.inv(v) if v is not None else None
        out = self.new_witness(val)
        prod = self.mul(a, out)
        self.enforce_equal(prod, self.one())
        return out

    def enforce_equal(self, a, b):
        self.k6.enforce_equal(a[0], b[0])
        self.k6.enforce_equal(a[1], b[1])

    def frobenius(self, a, power: int, exact_k12):
        """a^(p^power), power in {1,2,3}: Fp2-conjugations + constant
        coefficient multiplies — entirely LINEAR (no constraints)."""
        k2 = self.k2
        g = exact_k12._frobenius_coeffs()[power]
        p = self.cs.modulus
        from groth16_tpu_torch.ref.field import Fp2Ctx

        ek2 = Fp2Ctx(p, k2.nr)
        g2 = ek2.mul(g, g)
        g3 = ek2.mul(g2, g)
        g4 = ek2.mul(g2, g2)
        g5 = ek2.mul(g4, g)

        def frob2(x):
            return k2.conj(x) if power % 2 == 1 else x

        def cmul(x, c):
            # x * (c0 + c1 u) with constant c: linear
            return (
                x[0].scale(c[0]) + x[1].scale(k2.nr * c[1]),
                x[0].scale(c[1]) + x[1].scale(c[0]),
            )

        a0, a1 = a
        c00 = frob2(a0[0])
        c01 = cmul(frob2(a0[1]), g2)
        c02 = cmul(frob2(a0[2]), g4)
        c10 = cmul(frob2(a1[0]), g)
        c11 = cmul(frob2(a1[1]), g3)
        c12 = cmul(frob2(a1[2]), g5)
        return ((c00, c01, c02), (c10, c11, c12))


def _value2(a: Fp2Var):
    if a[0].value is None or a[1].value is None:
        return None
    return (a[0].value, a[1].value)


def _value6(a: Fp6Var):
    vs = tuple(_value2(c) for c in a)
    return None if any(v is None for v in vs) else vs


def _value12(a: Fp12Var):
    v0, v1 = _value6(a[0]), _value6(a[1])
    return None if v0 is None or v1 is None else (v0, v1)


class QuadOverHalfCtxVar:
    """Kh[v]/(v^2 - u) over any half-field var ctx with mul_by_u — the
    GT field of the Tate pairing families (Fp4 for MNT4 over Fp2Var;
    mirrors ref.field.Fp6Direct3Ctx)."""

    def __init__(self, kh):
        self.kh = kh
        self.cs = kh.cs

    def one(self):
        return (self.kh.one(), self.kh.zero())

    def new_witness(self, a):
        return (
            self.kh.new_witness(None if a is None else a[0]),
            self.kh.new_witness(None if a is None else a[1]),
        )

    def add(self, a, b):
        return (self.kh.add(a[0], b[0]), self.kh.add(a[1], b[1]))

    def sub(self, a, b):
        return (self.kh.sub(a[0], b[0]), self.kh.sub(a[1], b[1]))

    def mul(self, a, b):
        kh = self.kh
        v00 = kh.mul(a[0], b[0])
        v11 = kh.mul(a[1], b[1])
        c0 = kh.add(v00, kh.mul_by_u(v11))
        c1 = kh.sub(kh.sub(kh.mul(kh.add(a[0], a[1]), kh.add(b[0], b[1])), v00), v11)
        return (c0, c1)

    def sqr(self, a):
        return self.mul(a, a)

    def enforce_equal(self, a, b):
        self.kh.enforce_equal(a[0], b[0])
        self.kh.enforce_equal(a[1], b[1])


def _value_kh(a):
    """Tuple-of-FpVar -> int tuple (None-able)."""
    vals = tuple(c.value for c in a)
    return None if any(v is None for v in vals) else vals


def _value_quad(a):
    v0, v1 = _value_kh(a[0]), _value_kh(a[1])
    return None if v0 is None or v1 is None else (v0, v1)
