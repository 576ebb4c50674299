"""Plain prime-field and extension-field arithmetic on Python ints.

Elements of Fp are ints in [0, p).  Elements of Fp^d (d = 2 or 3) are
d-tuples of ints: Fp2 = Fp[u]/(u^2 - nr), Fp3 = Fp[v]/(v^3 - nr).  This
file is the benchmark's own: it imports nothing of the program.
"""

from __future__ import annotations


class Fp:
    """The prime field, elements as ints."""

    deg = 1

    def __init__(self, p: int):
        self.p = p
        self.zero, self.one = 0, 1

    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def mul(self, a, b):
        return a * b % self.p

    def mul_int(self, a, k: int):
        return a * k % self.p

    def inv(self, a):
        if a % self.p == 0:
            raise ZeroDivisionError("inverse of 0")
        return pow(a, -1, self.p)

    def is_zero(self, a) -> bool:
        return a % self.p == 0

    def element(self, v):
        return int(v) % self.p


class FpExt:
    """Fp^deg = Fp[x]/(x^deg - nr), deg 2 or 3, elements as deg-tuples."""

    def __init__(self, p: int, deg: int, nr: int):
        if deg not in (2, 3):
            raise ValueError(f"extension degree {deg}: only 2 and 3")
        self.p, self.deg, self.nr = p, deg, nr % p
        self.zero = (0,) * deg
        self.one = (1,) + (0,) * (deg - 1)

    def add(self, a, b):
        p = self.p
        return tuple((x + y) % p for x, y in zip(a, b))

    def sub(self, a, b):
        p = self.p
        return tuple((x - y) % p for x, y in zip(a, b))

    def mul_int(self, a, k: int):
        p = self.p
        return tuple(x * k % p for x in a)

    def mul(self, a, b):
        p, nr = self.p, self.nr
        if self.deg == 2:
            a0, a1 = a
            b0, b1 = b
            return ((a0 * b0 + nr * a1 * b1) % p, (a0 * b1 + a1 * b0) % p)
        a0, a1, a2 = a
        b0, b1, b2 = b
        return (
            (a0 * b0 + nr * (a1 * b2 + a2 * b1)) % p,
            (a0 * b1 + a1 * b0 + nr * a2 * b2) % p,
            (a0 * b2 + a1 * b1 + a2 * b0) % p,
        )

    def inv(self, a):
        p, nr = self.p, self.nr
        if self.is_zero(a):
            raise ZeroDivisionError("inverse of 0")
        if self.deg == 2:
            a0, a1 = a
            n = pow((a0 * a0 - nr * a1 * a1) % p, -1, p)
            return (a0 * n % p, -a1 * n % p)
        # the adjugate of multiplication by a, over its norm
        a0, a1, a2 = a
        c0 = (a0 * a0 - nr * a1 * a2) % p
        c1 = (nr * a2 * a2 - a0 * a1) % p
        c2 = (a1 * a1 - a0 * a2) % p
        n = pow((a0 * c0 + nr * (a2 * c1 + a1 * c2)) % p, -1, p)
        return (c0 * n % p, c1 * n % p, c2 * n % p)

    def is_zero(self, a) -> bool:
        return all(x % self.p == 0 for x in a)

    def element(self, v):
        return tuple(int(x) % self.p for x in v)


def field(p: int, deg: int = 1, nr: int = 0):
    return Fp(p) if deg == 1 else FpExt(p, deg, nr)
