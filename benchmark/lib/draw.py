"""Everything a run draws from its seed, each from a stream of its own,
so that the same seed gives the same toxic waste, assignments and proof
randomness whatever the program does with them."""

from __future__ import annotations

import random

from benchmark.reference.groth16 import ToxicWaste


def stream(seed: int, what: str) -> random.Random:
    return random.Random(f"{int(seed)}:{what}")


def field_element(rng: random.Random, modulus: int, nonzero: bool = False) -> int:
    """Uniform in [0, modulus) (or [1, modulus)) by rejection."""
    bits = modulus.bit_length()
    while True:
        v = rng.getrandbits(bits)
        if v < modulus and (v or not nonzero):
            return v


def toxic_waste(seed: int, r: int, domain_size: int) -> ToxicWaste:
    """alpha, beta, gamma, delta, t (outside the domain) and the
    generators' multipliers, all non-zero."""
    g = stream(seed, "toxic_waste")
    alpha, beta, gamma, delta = (field_element(g, r, True) for _ in range(4))
    while True:
        t = field_element(g, r, True)
        if pow(t, domain_size, r) != 1:
            break
    k1, k2 = field_element(g, r, True), field_element(g, r, True)
    return ToxicWaste(alpha, beta, gamma, delta, t, k1, k2)


def config_waste(cfg: dict, seed: int, r: int) -> ToxicWaste:
    """The toxic waste of a configuration's circuit under the seed."""
    c = cfg["circuit"]
    return toxic_waste(seed, r, domain_size(int(c["num_constraints"]), int(c["num_instance"])))


def draw_job(cfg: dict, circuit, rng: random.Random, k: int, pool_size: int, r: int) -> tuple:
    """Job k: (pool index, r, s, fresh); fresh holds the (column, value)
    pairs that the circuit draws anew for this job over its pooled
    assignment (its `fresh`), or nothing where it has none."""
    rr, ss = field_element(rng, r), field_element(rng, r)
    fresh = getattr(circuit, "fresh", None)
    return k % pool_size, rr, ss, tuple(fresh(cfg, rng, r)) if fresh else ()


def job_assignment(pool: list, job: tuple) -> list:
    """The full assignment a job proves: its pooled one, with its fresh
    columns in a copy."""
    z = pool[job[0]]
    if job[3]:
        z = list(z)
        for col, v in job[3]:
            z[col] = v
    return z


def domain_size(num_constraints: int, num_instance: int) -> int:
    n = 1
    while n < num_constraints + num_instance:
        n *= 2
    return n


class FixedT:
    """The rng the program's key generation draws t from: it hands over
    the t the benchmark drew, once."""

    def __init__(self, t: int):
        self.t, self.calls = t, 0

    def field_element(self, modulus: int) -> int:
        self.calls += 1
        if self.calls > 1:
            raise RuntimeError("the key generation drew t twice: the benchmark's t lies in its domain")
        return self.t
