"""The plain Groth16 reference: the verifying key and the exact proof that
a prover must return, worked out from the toxic waste, the circuit, the
assignment and the proof's r and s by scalar arithmetic alone.

With the toxic waste known, every key point is a known multiple of the
generators, so the proof of (z, r, s) is (arkworks' prover.rs:54-132,
LibsnarkReduction's QAP, r1cs_to_qap.rs:128-170):

    A = (alpha + a(t) + r delta) P1
    B = (beta + b(t) + s delta) P2
    C = ((sum over witness columns i of z_i (beta u_i + alpha v_i + w_i)(t)
          + a(t) b(t) - c(t)) / delta + s A_s + r B_s - r s delta) P1

where a(t) = sum_j L_j(t) (A z)_j over the constraint rows plus the
input-consistency rows (row m + i of A holds z_i), b(t), c(t) likewise
with B and C, and a(t) b(t) - c(t) = h(t) Z(t) for a satisfying z.  The
domain is arkworks' radix-2 one: omega = g^((r - 1) / n) with g the
field's published multiplicative generator.  A proof is compared with
this one exactly: Groth16 with given r and s is deterministic, and affine
coordinates are unique.

A circuit is given as runs: (start, end, a_terms, b_terms, c_terms), the
rows start..end - 1 all holding the same terms [(coeff, column)], so a
circuit of a million equal rows costs as much as one of two rows.  This
file imports nothing of the program.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field as dc_field
from typing import List, Sequence, Tuple

from .curve import Curve
from .field import field


@dataclass
class CurveSpec:
    """The published parameters of one pairing curve that the reference
    needs, as the configuration's file gives them."""

    name: str
    p: int
    r: int
    a: int
    b: int
    g2_deg: int
    g2_nonresidue: int
    g2_a: tuple
    g2_b: tuple
    fr_generator: int
    g1_base: tuple
    g2_base: tuple

    @staticmethod
    def from_json(d: dict) -> "CurveSpec":
        def num(v):
            return int(v, 0) if isinstance(v, str) else int(v)

        def nums(v):
            return tuple(nums(x) for x in v) if isinstance(v, (list, tuple)) else num(v)

        return CurveSpec(
            name=d["name"], p=num(d["p"]), r=num(d["r"]), a=num(d["a"]), b=num(d["b"]),
            g2_deg=int(d["g2_degree"]), g2_nonresidue=num(d["g2_nonresidue"]),
            g2_a=nums(d["g2_a"]), g2_b=nums(d["g2_b"]), fr_generator=num(d["fr_generator"]),
            g1_base=nums(d["g1_base"]), g2_base=nums(d["g2_base"]),
        )

    def groups(self) -> Tuple[Curve, Curve]:
        g1 = Curve(field(self.p), self.a, self.b)
        k2 = field(self.p, self.g2_deg, self.g2_nonresidue)
        return g1, Curve(k2, self.g2_a, self.g2_b)


@dataclass
class ToxicWaste:
    alpha: int
    beta: int
    gamma: int
    delta: int
    t: int
    k1: int  # P1 = k1 * g1_base
    k2: int  # P2 = k2 * g2_base


@dataclass
class Circuit:
    """R1CS in runs of equal rows (see the module docstring)."""

    num_instance: int
    num_witness: int
    num_constraints: int
    runs: List[tuple] = dc_field(default_factory=list)


def circuit_from_rows(num_instance, num_witness, a_rows, b_rows, c_rows) -> Tuple[Circuit, str]:
    """A circuit given row by row (lists of [(coeff, column)]) as runs of
    one row each, and the SHA-256 of its rows (sizes, then each row of A,
    B and C in turn as its (coeff, column) pairs in decimal)."""
    m = len(a_rows)
    h = hashlib.sha256(f"{num_instance} {num_witness} {m}\n".encode())
    runs = []
    for j in range(m):
        a, b, c = a_rows[j], b_rows[j], c_rows[j]
        h.update(repr((a, b, c)).encode())
        runs.append((j, j + 1, a, b, c))
    return Circuit(num_instance, num_witness, m, runs), h.hexdigest()


class Reference:
    """The reference for one key: the curve, the toxic waste, the circuit."""

    def __init__(self, spec: CurveSpec, waste: ToxicWaste, circuit: Circuit):
        self.spec, self.w, self.circuit = spec, waste, circuit
        self.g1, self.g2 = spec.groups()
        r = spec.r
        self.P1 = self.g1.mul(spec.g1_base, waste.k1 % r)
        self.P2 = self.g2.mul(spec.g2_base, waste.k2 % r)
        m, ninp = circuit.num_constraints, circuit.num_instance
        n = 1
        while n < m + ninp:
            n *= 2
        if (r - 1) % n:
            raise ValueError(f"no radix-2 domain of {n} in Fr")
        self.n = n
        self.omega = pow(spec.fr_generator, (r - 1) // n, r)
        if pow(self.omega, n // 2, r) == 1:
            raise ValueError("fr_generator does not generate the 2-adic subgroup")
        zt = (pow(waste.t, n, r) - 1) % r
        if zt == 0:
            raise ValueError("t lies in the domain")
        self._zt_over_n = zt * pow(n, -1, r) % r
        self._lagrange_sums = self._run_lagrange_sums()

    # -- the QAP at t -----------------------------------------------------

    def _lagrange(self, rows: Sequence[int]) -> List[int]:
        """L_j(t) = Z(t) / n * omega^j / (t - omega^j) for each row j, with
        one batch inversion."""
        r, t = self.spec.r, self.w.t
        wj = [pow(self.omega, j, r) if i == 0 or rows[i] != rows[i - 1] + 1 else None
              for i, j in enumerate(rows)]
        for i in range(1, len(rows)):
            if wj[i] is None:
                wj[i] = wj[i - 1] * self.omega % r
        dens = [(t - x) % r for x in wj]
        prefix, acc = [], 1
        for d in dens:
            prefix.append(acc)
            acc = acc * d % r
        inv = pow(acc, -1, r)
        out = [0] * len(rows)
        for i in range(len(rows) - 1, -1, -1):
            out[i] = self._zt_over_n * wj[i] % r * (inv * prefix[i] % r) % r
            inv = inv * dens[i] % r
        return out

    def _run_lagrange_sums(self) -> List[int]:
        """sum of L_j(t) over each run's rows; a run of more than half the
        domain as 1 minus the rest (the L_j sum to 1 over the domain)."""
        r, n = self.spec.r, self.n
        runs = self.circuit.runs
        long_runs = [i for i, run in enumerate(runs) if run[1] - run[0] > n // 2]
        if len(long_runs) > 1:
            raise ValueError("two runs longer than half the domain")
        need = []
        for i, (s, e, *_) in enumerate(runs):
            if i not in long_runs:
                need.extend(range(s, e))
        if long_runs:
            s, e = runs[long_runs[0]][:2]
            need.extend(list(range(0, s)) + list(range(e, n)))
        need = sorted(set(need))
        lag = dict(zip(need, self._lagrange(need)))
        sums = []
        for i, (s, e, *_) in enumerate(runs):
            if i in long_runs:
                rest = sum(v for j, v in lag.items() if not s <= j < e)
                sums.append((1 - rest) % r)
            else:
                sums.append(sum(lag[j] for j in range(s, e)) % r)
        m, ninp = self.circuit.num_constraints, self.circuit.num_instance
        self._input_rows = [lag.get(m + i) for i in range(ninp)]
        if any(v is None for v in self._input_rows):
            self._input_rows = self._lagrange([m + i for i in range(ninp)])
        return sums

    def evaluate(self, z: Sequence[int]) -> dict:
        """a(t), b(t), c(t) of assignment z, each input column's u, v, w at
        t, and the rows that z leaves unsatisfied."""
        r = self.spec.r
        ninp = self.circuit.num_instance
        if len(z) != ninp + self.circuit.num_witness or z[0] % r != 1:
            raise ValueError("the assignment's length or its leading 1 is wrong")
        at = bt = ct = 0
        uvw = [[0, 0, 0] for _ in range(ninp)]
        bad = 0
        for (s, e, ta, tb, tc), lsum in zip(self.circuit.runs, self._lagrange_sums):
            vals = []
            for k, terms in enumerate((ta, tb, tc)):
                v = 0
                for coeff, col in terms:
                    v += coeff * z[col]
                    if col < ninp:
                        uvw[col][k] = (uvw[col][k] + coeff * lsum) % r
                vals.append(v % r)
            if vals[0] * vals[1] % r != vals[2]:
                bad += e - s
            at = (at + vals[0] * lsum) % r
            bt = (bt + vals[1] * lsum) % r
            ct = (ct + vals[2] * lsum) % r
        for i, li in enumerate(self._input_rows):
            uvw[i][0] = (uvw[i][0] + li) % r
            at = (at + z[i] * li) % r
        return {"a": at, "b": bt, "c": ct, "uvw": uvw, "unsatisfied_rows": bad}

    # -- keys and proofs --------------------------------------------------

    def verifying_key(self, ev: dict) -> dict:
        """alpha_g1, beta_g2, gamma_g2, delta_g2 and gamma_abc_g1 (whose
        scalars need only the input columns, any assignment's `ev`)."""
        w, r = self.w, self.spec.r
        ginv = pow(w.gamma, -1, r)
        return {
            "alpha_g1": self.g1.mul(self.P1, w.alpha),
            "beta_g2": self.g2.mul(self.P2, w.beta),
            "gamma_g2": self.g2.mul(self.P2, w.gamma),
            "delta_g2": self.g2.mul(self.P2, w.delta),
            "gamma_abc_g1": [self.g1.mul(self.P1, (w.beta * u + w.alpha * v + x) * ginv % r)
                             for u, v, x in ev["uvw"]],
        }

    def proof_scalars(self, ev: dict, z: Sequence[int], r_: int, s_: int) -> Tuple[int, int, int]:
        w, r = self.w, self.spec.r
        r_, s_ = r_ % r, s_ % r
        a_inp = sum(z[i] * u for i, (u, _, _) in enumerate(ev["uvw"]))
        b_inp = sum(z[i] * v for i, (_, v, _) in enumerate(ev["uvw"]))
        c_inp = sum(z[i] * x for i, (_, _, x) in enumerate(ev["uvw"]))
        a_s = (w.alpha + ev["a"] + r_ * w.delta) % r
        b_s = (w.beta + ev["b"] + s_ * w.delta) % r
        aux = w.beta * (ev["a"] - a_inp) + w.alpha * (ev["b"] - b_inp) + (ev["c"] - c_inp)
        hz = ev["a"] * ev["b"] - ev["c"]
        c_s = ((aux + hz) * pow(w.delta, -1, r) + s_ * a_s + r_ * b_s - r_ * s_ * w.delta) % r
        return a_s, b_s, c_s

    def proof(self, ev: dict, z: Sequence[int], r_: int, s_: int) -> Tuple:
        """The proof (A, B, C) as affine points, as the program gives them."""
        a_s, b_s, c_s = self.proof_scalars(ev, z, r_, s_)
        return (self.g1.mul(self.P1, a_s), self.g2.mul(self.P2, b_s), self.g1.mul(self.P1, c_s))
