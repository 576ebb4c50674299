"""Point formulas as programs on base-field elements, and their plain
version.

A program is one point operation over Fq, Fq2 or Fq3 (D = 1, 2, 3)
written on base-field elements ("slots"; a tower element is D slots, one
a component) in rounds.  A round is a set of independent Montgomery
products (MUL d = a b R^-1) followed by levels of linear combinations
(LIN d = sum_i m_i x_i + k p with small integer m_i, the negative terms
subtracted after k p is added, then optionally the halving sequence of
conditional subtractions of fields/fp.py:reduce_to_2p from a bound); the
combinations of one level are independent.  Program tracks every
value's bound in multiples of p and checks, for the field it is built
for, that a product's operands keep a b < R p (so its result is < 2p)
and that a combination stays below R = 2^(15 L) and below 2^(32 W), the
kernels' W words.  Every MUL and LIN is one integer, whatever engine
computes it (the Montgomery product's T = (a b + M p) / R is unique), so
every engine that runs a program's steps in order returns the same
digits.

The programs:
  general_add   the generic-a complete addition (RCB 2015/1060 algorithm
                1, a != 0: MNT4-298, MNT6-298) in three product rounds (6
                tower products, 2 by b3, 6), the products by a and by
                the tower's nonresidue as small multiples;
  general_dbl   the generic-a doubling (algorithm 3): rounds of 6, 3, 4;
  a0_add        the a = 0 complete addition (algorithm 7) in the order of
                curves/cuda_point.py:add_plain (whose digits it returns);
  a0_dbl        the a = 0 doubling (algorithm 9): rounds of 4, 1, 4, or
                of 4 and 4 where b3 is a small integer (combinations).
A tower product of a round is its D^2 raw Fq products (component c takes
a_m b_((c - m) mod D), m < D, times the nonresidue where m + ((c - m) mod
D) >= D) and, for D > 1, one combination a component after them.

Who runs them: csrc/horner.cu interprets any program (the MSM's Horner
chain: c doublings and one addition a window; the proof assembly's
scalar multiplication: a window table of j P, then c doublings and an
addition of a non-zero digit's entry a window); csrc/general_add.cu is
general_add written out by hand for the capture scan's throughput, lane
c of a point computing component c of every slot in this order; run_plain
is the plain version of both, on 15-bit digits (fields/fp.py, any
device) or on Python ints (the CPU, few points): the same integers.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Sequence, Tuple

import torch

from groth16_tpu_torch.fields import fp
from groth16_tpu_torch.fields.cuda_fp import KERNEL_WORDS
from groth16_tpu_torch.fields.spec import LIMB_BITS, LIMB_MASK, FpSpec, int_to_limbs

# most terms of one combination (csrc/horner.cu: kTerms)
MAX_TERMS = 4


class Lin(NamedTuple):
    d: int
    terms: Tuple[Tuple[int, int], ...]  # (slot, small multiplier), negative: subtracted
    k: int  # k p added before the subtractions
    red: int  # reduce_to_2p from this bound (0: none)


class Round(NamedTuple):
    muls: List[Tuple[int, int, int]]  # (d, a, b)
    levels: List[List[Lin]]


def halving(bound: int) -> List[int]:
    """The multiples of p that reduce_to_2p(x, bound) subtracts where x
    is not below them, in order."""
    ks, k = [], bound
    while k > 2:
        k = (k + 1) // 2
        ks.append(k)
    return ks


class Program:
    """One point operation on D-component slots; `inputs` points of
    (X, Y, Z) at slots 0 .. 3D (and 3D .. 6D), the result written back
    to slots 0 .. 3D.  consts: slot -> Montgomery-form value (< p)."""

    def __init__(self, name: str, spec: FpSpec, D: int, inputs: int):
        self.name, self.spec, self.D = name, spec, D
        self.rounds: List[Round] = []
        self.bound: List[int] = []
        self.phase: List[int] = []  # phase that defines each slot (-1: input, const)
        self.consts = {}
        W = KERNEL_WORDS[spec.n_limbs]
        self.limit = min(1 << (LIMB_BITS * spec.n_limbs), 1 << (32 * W))
        self.points = [[self.elem_input() for _ in range(3)] for _ in range(inputs)]
        self._phases = 0  # phases so far: a round's products, then each level
        self._round_phase = 0

    # -- slots -------------------------------------------------------------

    def _slot(self, bound: int, phase: int) -> int:
        self.bound.append(bound)
        self.phase.append(phase)
        return len(self.bound) - 1

    def elem_input(self) -> List[int]:
        return [self._slot(2, -1) for _ in range(self.D)]

    def const(self, value: int) -> int:
        s = self._slot(1, -1)
        self.consts[s] = self.spec.to_mont_int(value % self.spec.modulus)
        return s

    @property
    def n_slots(self) -> int:
        return len(self.bound)

    @property
    def n_products(self) -> int:
        """Raw Fq products of one run."""
        return sum(len(r.muls) for r in self.rounds)

    # -- steps ---------------------------------------------------------------

    def next_round(self):
        self.rounds.append(Round([], []))
        self._phases += 1  # the round's products
        self._round_phase = self._phases

    def mul(self, a: int, b: int) -> int:
        rnd = self.rounds[-1]
        for s in (a, b):
            if self.phase[s] >= self._round_phase:
                raise ValueError(f"{self.name}: a product of round {len(self.rounds)} reads slot {s} of that round")
        if self.bound[a] * self.bound[b] * self.spec.modulus >= self.spec.R:
            raise ValueError(f"{self.name}: product operands {self.bound[a]}p x {self.bound[b]}p pass R")
        d = self._slot(2, self._round_phase)
        rnd.muls.append((d, a, b))
        return d

    def lin(self, terms: Sequence[Tuple[int, int]], k: int = 0, red: int = 0, out: int = None) -> int:
        """Append d = sum m s + k p (negative m subtracted) [reduced from
        `red`] at the first level of the current round whose inputs are
        ready; out: write an existing slot (a result over an input)."""
        terms = tuple((s, m) for s, m in terms if m)
        if not terms or len(terms) > MAX_TERMS:
            raise ValueError(f"{self.name}: a combination takes 1-{MAX_TERMS} terms, got {terms}")
        rnd = self.rounds[-1]
        level = max(0, max(self.phase[s] - self._round_phase for s, _ in terms))
        pos = sum(m * self.bound[s] for s, m in terms if m > 0) + k
        neg = sum(-m * self.bound[s] for s, m in terms if m < 0)
        if neg > k:
            raise ValueError(f"{self.name}: subtracted {neg}p past the {k}p added")
        if pos * self.spec.modulus >= self.limit:
            raise ValueError(f"{self.name}: a combination of {pos}p passes the operand limit")
        if red and pos > red:
            raise ValueError(f"{self.name}: {pos}p reduced from a bound of {red}p")
        bound = 2 if red else pos
        while len(rnd.levels) <= level:
            rnd.levels.append([])
        phase = self._round_phase + 1 + level
        self._phases = max(self._phases, phase)
        if out is None:
            d = self._slot(bound, phase)
        else:
            # no combination of this round at this level or later reads
            # the value it replaces (they run in parallel)
            if any(out in (s for s, _ in op.terms) for lv in rnd.levels[level:] for op in lv):
                raise ValueError(f"{self.name}: slot {out} is overwritten while read")
            d = out
            self.bound[d], self.phase[d] = bound, phase
        rnd.levels[level].append(Lin(d, terms, k, red))
        return d

    # -- tower steps (one list entry a component) -----------------------------

    def add(self, *xs, k: int = 0, red: int = 0, signs=None) -> List[int]:
        signs = signs or (1,) * len(xs)
        return [self.lin([(x[c], m) for x, m in zip(xs, signs)], k, red) for c in range(self.D)]

    def tmul_raw(self, a: List[int], b: List[int]) -> List[List[int]]:
        """The D^2 raw products of a tower product, by component."""
        D = self.D
        return [[self.mul(a[m], b[(c - m) % D]) for m in range(D)] for c in range(D)]

    def wraps(self, c: int, m: int) -> bool:
        return m + (c - m) % self.D >= self.D


def _split(pt, D: int) -> List[torch.Tensor]:
    """Coordinates [L, (D,) n] -> D slots [L, n]."""
    return [x for x in pt] if D == 1 else [x[:, c] for x in pt for c in range(D)]


# -- the programs --------------------------------------------------------------


def _monomial(v, D: int) -> Tuple[int, int]:
    """(j, value) of a tower constant with one nonzero component j (an
    int for D = 1)."""
    comps = v if isinstance(v, tuple) else (v,)
    comps = tuple(comps) + (0,) * (D - len(comps))
    nz = [j for j in range(D) if comps[j]]
    if len(nz) != 1:
        raise ValueError(f"not a monomial: {v}")
    return nz[0], comps[nz[0]]


def ga_lanes(p: int, D: int, nr: int, a_val, b3_val):
    """Per component c of the generic-a law: a's small multiplier and the
    component it reads, b3's constant (standard form) and the component
    it reads (a = s v^ja, b3 = beta v^jb: (a x)_c = s NR^[c < ja]
    x_(c - ja), and the same for b3)."""
    ja, s = _monomial(a_val, D)
    jb, beta = _monomial(b3_val, D)
    a_mult = [s * (nr if c < ja else 1) for c in range(D)]
    if not all(0 < m <= 64 for m in a_mult):
        raise ValueError(f"the generic-a law takes a small positive a, got {a_val}")
    a_src = [(c - ja) % D for c in range(D)]
    b_src = [(c - jb) % D for c in range(D)]
    b_vals = [beta * (nr if c < jb else 1) % p for c in range(D)]
    return a_mult, a_src, b_vals, b_src


def _ga_constants(P: Program, nr: int, a_val, b3_val):
    a_mult, a_src, b_vals, b_src = ga_lanes(P.spec.modulus, P.D, nr, a_val, b3_val)
    return a_mult, a_src, [P.const(v) for v in b_vals], b_src


def _ga_comb(P: Program, raws: List[List[int]], nr: int) -> List[int]:
    """The generic-a tower product's combination: component c = sum_m
    (NR where it wraps) r_m, each reduced from the largest component's
    bound (one reduction for every lane of the kernel)."""
    D = P.D
    if D == 1:
        return raws[0]
    mults = [[nr if P.wraps(c, m) else 1 for m in range(D)] for c in range(D)]
    red = max(2 * sum(ms) for ms in mults)
    return [P.lin([(raws[c][m], mults[c][m]) for m in range(D)], red=red) for c in range(D)]


def _fp2_comb(P: Program, raws: List[List[int]], nr: int) -> List[int]:
    """fields/ops.py Fp2Ops.mul_many's combination (FpOps: the product)."""
    if P.D == 1:
        return raws[0]
    (v00, v11), (v01, v10) = raws
    if nr < 0:
        c0 = P.lin([(v00, 1), (v11, nr)], k=-2 * nr, red=max(4, 2 - 2 * nr))
    else:
        c0 = P.lin([(v00, 1), (v11, nr)], red=max(4, 2 + 2 * nr))
    return [c0, P.lin([(v01, 1), (v10, 1)], red=4)]


def _by_a(P, x, a_mult, a_src, bound):
    return [P.lin([(x[a_src[c]], a_mult[c])], red=bound * max(a_mult)) for c in range(P.D)]


def _by_b3(P, x, b_const, b_src):
    return [P.mul(x[b_src[c]], b_const[c]) for c in range(P.D)]


def general_add(spec: FpSpec, D: int, nr: int, a_val, b3_val) -> Program:
    """RCB algorithm 1 (a != 0) on P1 + P2; coordinates < 2p in and out.
    Bounds (multiples of p): pre-adds < 4; tower products < 2; xy, yz,
    xz < 6; a x reduced to < 2; d, t2m, f < 4; X3t, Z3t < 6; e < 8;
    round-3 operands <= 48 p^2; outputs < 4 before the last reduction."""
    P = Program("general_add", spec, D, 2)
    (X1, Y1, Z1), (X2, Y2, Z2) = P.points
    a_mult, a_src, b_const, b_src = _ga_constants(P, nr, a_val, b3_val)
    P.next_round()  # the pre-adds
    pre = [P.add(u, v) for u, v in ((X1, Y1), (X2, Y2), (Y1, Z1), (Y2, Z2), (X1, Z1), (X2, Z2))]
    P.next_round()
    raws = [P.tmul_raw(u, v) for u, v in ((X1, X2), (Y1, Y2), (Z1, Z2), (pre[0], pre[1]),
                                           (pre[2], pre[3]), (pre[4], pre[5]))]
    t0, t1, t2, m3, m4, m5 = (_ga_comb(P, r, nr) for r in raws)
    xy = P.add(m3, t0, t1, k=4, signs=(1, -1, -1))
    yz = P.add(m4, t1, t2, k=4, signs=(1, -1, -1))
    xz = P.add(m5, t0, t2, k=4, signs=(1, -1, -1))
    P.next_round()
    b3z = _by_b3(P, t2, b_const, b_src)
    b3xz = _by_b3(P, xz, b_const, b_src)
    axz = _by_a(P, xz, a_mult, a_src, 6)
    at2 = _by_a(P, t2, a_mult, a_src, 2)
    d = P.add(axz, b3z)
    e = P.add(t0, at2, signs=(3, 1))
    t2m = P.add(t0, at2, k=2, signs=(1, -1))
    X3t = P.add(t1, d, k=4, signs=(1, -1))
    Z3t = P.add(t1, d)
    at2m = _by_a(P, t2m, a_mult, a_src, 4)
    f = P.add(b3xz, at2m)
    P.next_round()
    raws = [P.tmul_raw(u, v) for u, v in ((X3t, Z3t), (e, f), (yz, f), (xy, X3t), (xy, e), (yz, Z3t))]
    y3a, ef, w0, xyx3, xye, yzz3 = (_ga_comb(P, r, nr) for r in raws)
    for c in range(D):
        P.lin([(xyx3[c], 1), (w0[c], -1)], k=2, red=4, out=X1[c])
        P.lin([(y3a[c], 1), (ef[c], 1)], red=4, out=Y1[c])
        P.lin([(yzz3[c], 1), (xye[c], 1)], red=4, out=Z1[c])
    return P


def general_dbl(spec: FpSpec, D: int, nr: int, a_val, b3_val) -> Program:
    """RCB algorithm 3 (a != 0) on P; bounds as general_add's, round 3's
    operands <= 36 p^2."""
    P = Program("general_dbl", spec, D, 1)
    ((X, Y, Z),) = P.points
    a_mult, a_src, b_const, b_src = _ga_constants(P, nr, a_val, b3_val)
    P.next_round()
    raws = [P.tmul_raw(u, v) for u, v in ((X, X), (Y, Y), (Z, Z), (X, Y), (X, Z), (Y, Z))]
    tX, tY, tZ, xy, xz, yz = (_ga_comb(P, r, nr) for r in raws)
    xy2, xz2, yz2 = P.add(xy, xy), P.add(xz, xz), P.add(yz, yz)
    P.next_round()
    b3z = _by_b3(P, tZ, b_const, b_src)
    b3xz2 = _by_b3(P, xz2, b_const, b_src)
    z8 = _ga_comb(P, P.tmul_raw(yz2, tY), nr)
    axz2 = _by_a(P, xz2, a_mult, a_src, 4)
    at2 = _by_a(P, tZ, a_mult, a_src, 2)
    y3a = P.add(axz2, b3z)
    t0 = P.add(tX, at2, signs=(3, 1))
    t3a = P.add(tX, at2, k=2, signs=(1, -1))
    X3t = P.add(tY, y3a, k=4, signs=(1, -1))
    Y3t = P.add(tY, y3a)
    at3 = _by_a(P, t3a, a_mult, a_src, 4)
    t3 = P.add(at3, b3xz2)
    P.next_round()
    raws = [P.tmul_raw(u, v) for u, v in ((X3t, Y3t), (xy2, X3t), (t0, t3), (yz2, t3))]
    y3m, x3m, t0t3, t2t3 = (_ga_comb(P, r, nr) for r in raws)
    for c in range(D):
        P.lin([(x3m[c], 1), (t2t3[c], -1)], k=2, red=4, out=X[c])
        P.lin([(y3m[c], 1), (t0t3[c], 1)], red=4, out=Y[c])
        P.lin([(z8[c], 4)], red=8, out=Z[c])
    return P


def _tower_consts(P: Program, v) -> List[int]:
    comps = v if isinstance(v, tuple) else (v,)
    comps = tuple(comps) + (0,) * (P.D - len(comps))
    return [P.const(x) for x in comps]


def a0_add(spec: FpSpec, D: int, nr: int, b3_val) -> Program:
    """RCB algorithm 7 (a = 0) in the order and with the reductions of
    cuda_point.add_plain (Fp2Ops.mul_many's products), so its digits."""
    P = Program("a0_add", spec, D, 2)
    (X1, Y1, Z1), (X2, Y2, Z2) = P.points
    b3 = _tower_consts(P, b3_val)
    P.next_round()
    pre = [P.add(u, v) for u, v in ((X1, Y1), (X2, Y2), (Y1, Z1), (Y2, Z2), (X1, Z1), (X2, Z2))]
    P.next_round()
    raws = [P.tmul_raw(u, v) for u, v in ((X1, X2), (Y1, Y2), (Z1, Z2), (pre[0], pre[1]),
                                           (pre[2], pre[3]), (pre[4], pre[5]))]
    t0, t1, t2, m3, m4, m5 = (_fp2_comb(P, r, nr) for r in raws)
    t3 = P.add(m3, t0, t1, k=4, signs=(1, -1, -1))
    t4 = P.add(m4, t1, t2, k=4, signs=(1, -1, -1))
    t5 = P.add(m5, t0, t2, k=4, signs=(1, -1, -1))
    t0t = P.add(t0, signs=(3,))
    P.next_round()
    t2b, t5b = (_fp2_comb(P, P.tmul_raw(u, b3), nr) for u in (t2, t5))
    Z3s = P.add(t1, t2b)
    t1m = P.add(t1, t2b, k=2, signs=(1, -1))
    P.next_round()
    raws = [P.tmul_raw(u, v) for u, v in ((t4, t5b), (t3, t1m), (t5b, t0t), (t1m, Z3s), (t0t, t3), (Z3s, t4))]
    w0, w1, w2, w3, w4, w5 = (_fp2_comb(P, r, nr) for r in raws)
    for c in range(D):
        P.lin([(w1[c], 1), (w0[c], -1)], k=2, red=4, out=X1[c])
        P.lin([(w3[c], 1), (w2[c], 1)], red=4, out=Y1[c])
        P.lin([(w5[c], 1), (w4[c], 1)], red=4, out=Z1[c])
    return P


def _small_b3(b3_val, D: int, nr: int, p: int):
    """b3 as small integer coefficients, (b3 x)_c = sum_m coef[c][m] x_m,
    or None where a component passes 16 (a tower product then)."""
    comps = b3_val if isinstance(b3_val, tuple) else (b3_val,)
    comps = [v if v <= p // 2 else v - p for v in tuple(comps) + (0,) * (D - len(comps))]
    if any(abs(v) > 16 for v in comps):
        return None
    return [[comps[(c - m) % D] * (nr if m + (c - m) % D >= D else 1) for m in range(D)] for c in range(D)]


def _stages(g: int):
    """g as factors of at most 4 (each stage keeps a value below 8p), or
    None."""
    out = []
    for f in (4, 3, 2):
        while g % f == 0:
            out.append(f)
            g //= f
    return out if g == 1 else None


def _by_small(P: Program, x: List[int], coef) -> List[int]:
    """b3 x for small coefficients: per component the combination with the
    coefficients' gcd taken out, reduced, then times the gcd in stages of
    at most 4, each reduced (< 2p out)."""
    out = []
    for c in range(P.D):
        terms = [(x[m], v) for m, v in enumerate(coef[c]) if v]
        g = 0
        for _, v in terms:
            g = math.gcd(g, abs(v))
        k = sum(-v // g * P.bound[s] for s, v in terms if v < 0)
        if terms == [(terms[0][0], g)]:
            y = terms[0][0]
        else:
            pos = sum(v // g * P.bound[s] for s, v in terms if v > 0) + k
            y = P.lin([(s, v // g) for s, v in terms], k=k, red=max(4, pos))
        for f in _stages(g):
            y = P.lin([(y, f)], red=2 * f)
        out.append(y)
    return out


def a0_dbl(spec: FpSpec, D: int, nr: int, b3_val) -> Program:
    """RCB algorithm 9 (a = 0) on P.  Bounds: 4 t0 < 8 (every combination
    stays below 8p: BLS12-381's 12 words hold 9.8p), reduced, doubled:
    z8 < 4; t2b < 2; Y3a < 4; t0m = t0 - 3 t2b + 6p < 8; round-3
    operands <= 32 p^2.  Where b3 is small (bn254 G1 9, BLS12-381 12 and
    12 + 12u, BLS12-377 G1 3, BW6-761 -3 and 12) b3 t2 is a few
    combinations (_by_small) after the first round, not a round of
    products: two product rounds."""
    P = Program("a0_dbl", spec, D, 1)
    ((X, Y, Z),) = P.points
    small = _small_b3(b3_val, D, nr, spec.modulus)
    if small is not None and not all(_stages(abs(v)) is not None for row in small for v in row if v):
        small = None
    b3 = None if small is not None else _tower_consts(P, b3_val)
    P.next_round()
    raws = [P.tmul_raw(u, v) for u, v in ((Y, Y), (Y, Z), (Z, Z), (X, Y))]
    t0, t1, t2, xy = (_fp2_comb(P, r, nr) for r in raws)
    if small is not None:
        t2b = _by_small(P, t2, small)
    else:
        P.next_round()
        t2b = _fp2_comb(P, P.tmul_raw(t2, b3), nr)
    q = P.add(t0, signs=(4,), red=8)
    z8 = P.add(q, q)
    y3a = P.add(t0, t2b)
    t0m = P.add(t0, t2b, k=6, signs=(1, -3))
    P.next_round()
    raws = [P.tmul_raw(u, v) for u, v in ((t2b, z8), (t1, z8), (t0m, y3a), (t0m, xy))]
    x3a, z3, y3b, x3b = (_fp2_comb(P, r, nr) for r in raws)
    for c in range(D):
        P.lin([(x3b[c], 2)], red=4, out=X[c])
        P.lin([(x3a[c], 1), (y3b[c], 1)], red=4, out=Y[c])
        P.lin([(z3[c], 1)], out=Z[c])
    return P


@functools.lru_cache(maxsize=None)
def programs(spec: FpSpec, D: int, nr: int, a_val, b3_val) -> Tuple[Program, Program]:
    """(doubling, addition) of the curve group with these constants: the
    generic-a pair where a != 0, else the a = 0 pair."""
    nr = nr or 0
    if any(a_val) if isinstance(a_val, tuple) else a_val:
        return general_dbl(spec, D, nr, a_val, b3_val), general_add(spec, D, nr, a_val, b3_val)
    return a0_dbl(spec, D, nr, b3_val), a0_add(spec, D, nr, b3_val)


# -- the kernels' encoding ------------------------------------------------------------


def encode(prog: Program, remap=lambda s: s) -> List[int]:
    """int32 words csrc/horner.cu reads: rounds, then per round its
    product count, level count, (d, a, b) a product, and per level its
    combination count and 4 + 2 MAX_TERMS words a combination (d, red,
    k, terms, then (slot, multiplier) pairs); every slot
    through `remap`."""
    out = [len(prog.rounds)]
    for rnd in prog.rounds:
        out += [len(rnd.muls), len(rnd.levels)]
        for m in rnd.muls:
            out += [remap(s) for s in m]
        for level in rnd.levels:
            out.append(len(level))
            for op in level:
                pairs = [v for s, m in op.terms for v in (remap(s), m)]
                pairs += [0, 0] * (MAX_TERMS - len(op.terms))
                out += [remap(op.d), op.red, op.k, len(op.terms)] + pairs
    return out


def widest(prog: Program) -> int:
    """The most products or combinations of one step (threads a block)."""
    return max(max([len(r.muls)] + [len(lv) for lv in r.levels]) for r in prog.rounds)


# -- the plain version ---------------------------------------------------------------


# points at which run_plain takes Python ints on the CPU (fields/cuda_fp.py's
# PLAIN_INT_MAX_N for the same reason: tensor steps cost the same at any n)
PLAIN_INT_MAX_N = 64


def _mont_int(spec: FpSpec):
    p, bits = spec.modulus, LIMB_BITS * spec.n_limbs
    R = 1 << bits
    ninv = -pow(p, -1, R) % R

    def mont(a, b):
        t = a * b
        return (t + (t * ninv & (R - 1)) * p) >> bits

    return mont


def _run_ints(prog: Program, vals: list) -> list:
    spec = prog.spec
    p, mont = spec.modulus, _mont_int(spec)
    for rnd in prog.rounds:
        for d, a, b in rnd.muls:
            vals[d] = [mont(x, y) for x, y in zip(vals[a], vals[b])]
        for level in rnd.levels:
            new = []
            for op in level:
                n = len(vals[op.terms[0][0]])
                pos = [op.k * p] * n
                for s, m in op.terms:
                    pos = [x + m * y for x, y in zip(pos, vals[s])]
                for kk in halving(op.red) if op.red else ():
                    pos = [x - kk * p if x >= kk * p else x for x in pos]
                new.append((op.d, pos))
            for d, v in new:
                vals[d] = v
    return vals


def _digits_to_ints(t: torch.Tensor) -> List[int]:
    shifts = range(0, LIMB_BITS * t.shape[0], LIMB_BITS)
    return [sum(int(d) << s for d, s in zip(col, shifts)) for col in t.T.tolist()]


def _ints_to_digits(vals: List[int], L: int) -> torch.Tensor:
    return torch.tensor([[v >> (LIMB_BITS * j) & LIMB_MASK for j in range(L)] for v in vals],
                        dtype=torch.int32).reshape(-1, L).T.contiguous()


def _lin_tensors(spec: FpSpec, ops: List[Lin], vals: list) -> List[torch.Tensor]:
    """One level's combinations of the same shape (multipliers, k, red) as
    stacked digit operations: the same integers as _run_ints."""
    L = spec.n_limbs
    op0 = ops[0]
    stack = [torch.stack([vals[op.terms[i][0]] for op in ops], dim=1) for i in range(len(op0.terms))]
    pos = neg = None
    for x, (_, m) in zip(stack, op0.terms):
        if m > 0:
            pos = m * x if pos is None else pos + m * x
        else:
            neg = -m * x if neg is None else neg - m * x
    if neg is not None:
        if pos is None:
            pos = torch.zeros_like(neg)
        out = fp.sub(spec, pos, neg, k=op0.k)
    else:
        if op0.k:
            pos = pos + fp._col(int_to_limbs(op0.k * spec.modulus, L), pos.device, pos.dim())
        out = fp.rex(pos, L)
    if op0.red:
        out = fp.reduce_to_2p(spec, out, bound_k=op0.red)
    return list(out.unbind(1))


def _run_tensors(prog: Program, vals: list) -> list:
    spec = prog.spec
    for rnd in prog.rounds:
        if rnd.muls:
            a = torch.stack([vals[a] for _, a, _ in rnd.muls], dim=1)
            b = torch.stack([vals[b] for _, _, b in rnd.muls], dim=1)
            out = fp.mont_mul(spec, a, b, plain=True).unbind(1)
            for (d, _, _), v in zip(rnd.muls, out):
                vals[d] = v
        for level in rnd.levels:
            groups = {}
            for op in level:
                groups.setdefault((tuple(m for _, m in op.terms), op.k, op.red), []).append(op)
            new = []
            for ops in groups.values():
                new += zip((op.d for op in ops), _lin_tensors(spec, ops, vals))
            for d, v in new:
                vals[d] = v
    return vals


def run_plain(prog: Program, points: Sequence, ints=None):
    """The program on points ((X, Y, Z), ...) of coordinates [L, (D,) n]
    (< 2p, exact digits) -> the result (X3, Y3, Z3) in the same layout.
    ints: Python ints (default: on the CPU up to PLAIN_INT_MAX_N points)
    or stacked digit tensors (any device); the same digits."""
    D, L = prog.D, prog.spec.n_limbs
    X = points[0][0]
    n = X.shape[-1]
    dev = X.device
    if ints is None:
        ints = dev.type == "cpu" and n <= PLAIN_INT_MAX_N
    vals: list = [None] * prog.n_slots
    flat = [x for pt in points for x in _split(pt, D)]
    if ints:
        for i, x in enumerate(flat):
            vals[i] = _digits_to_ints(x)
        for s, v in prog.consts.items():
            vals[s] = [v] * n
        vals = _run_ints(prog, vals)
        outs = [_ints_to_digits(vals[s], L).to(dev) for s in range(3 * D)]
    else:
        for i, x in enumerate(flat):
            vals[i] = x
        for s, v in prog.consts.items():
            vals[s] = fp._col(int_to_limbs(v, L), dev, 2).expand(L, n)
        vals = _run_tensors(prog, vals)
        outs = vals[: 3 * D]
    if D == 1:
        return tuple(outs)
    return tuple(torch.stack(outs[i * D : (i + 1) * D], dim=1) for i in range(3))
