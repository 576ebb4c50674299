"""arkworks-rs/groth16 v0.5.0 benches/bench.rs:22-64, DummyCircuit: the
public c = a b, `num_variables - 3` further witnesses, and
`num_constraints - 1` copies of the constraint a * b = c, then 0 * 0 = 0.

bench.rs sets every free witness to a; here each is drawn uniformly from
Fr by the seed (the configuration's `assumed`), so the MSMs see
full-width scalars as a real witness gives them.  The constraint system
is bench.rs's own.

Columns: [ONE, c | a, b, free...].  `synthesize` drives the program's
constraint system (any object with its allocation and enforce calls);
`assignment` gives the same full assignment directly, so the pool needs
one synthesis; `fresh` draws each job's own a, b and c = a b, so that no
two proves share a statement; `reference_circuit` is the circuit in the
reference's runs, built without the program.
"""

from __future__ import annotations

from benchmark.lib.draw import field_element
from benchmark.reference.groth16 import Circuit


def _sizes(cfg):
    return int(cfg["circuit"]["num_variables"]), int(cfg["circuit"]["num_constraints"])


def draw_values(cfg, rng, r: int, device=None) -> list:
    """[a, b, free...] of one assignment."""
    nv, _ = _sizes(cfg)
    return [field_element(rng, r) for _ in range(nv - 1)]


def assignment(cfg, values, r: int) -> list:
    a, b = values[0], values[1]
    return [1, a * b % r] + list(values)


def fresh(cfg, rng, r: int) -> tuple:
    """A job's own (column, value) pairs over its pooled assignment: c, a
    and b drawn anew, which changes h and every scalar the constrained
    columns give the MSMs; the free witnesses, which no row constrains,
    stay the pool's."""
    a, b = field_element(rng, r), field_element(rng, r)
    return (1, a * b % r), (2, a), (3, b)


def synthesize(cfg, cs, values=None) -> None:
    """bench.rs's synthesize(), on the program's constraint system; values
    None: the shape only (key generation)."""
    from groth16_tpu_torch.r1cs.system import LinearCombination

    nv, m = _sizes(cfg)
    p = cs.modulus

    def val(i):
        return None if values is None else (lambda v=values[i]: v)

    a = cs.new_witness_variable(val(0))
    b = cs.new_witness_variable(val(1))
    c = cs.new_input_variable(None if values is None else (lambda: values[0] * values[1] % p))
    for i in range(2, nv - 1):
        cs.new_witness_variable(val(i))
    la, lb, lc = LinearCombination.from_var(a), LinearCombination.from_var(b), LinearCombination.from_var(c)
    for _ in range(m - 1):
        cs.enforce_constraint(la, lb, lc)
    zero = LinearCombination.zero()
    cs.enforce_constraint(zero, zero, zero)


def reference_circuit(cfg, matrices=None):
    """-> (Circuit, None): rows 0..m-2 are a * b = c, row m-1 is empty."""
    nv, m = _sizes(cfg)
    runs = [(0, m - 1, [(1, 2)], [(1, 3)], [(1, 1)]), (m - 1, m, [], [], [])]
    return Circuit(num_instance=2, num_witness=nv - 1, num_constraints=m, runs=runs), None
