"""The control of `correct`: the reference put in the program's place,
breaking one guarantee the configurations state: r and s fresh for every
proof.  Every proof is the reference's exact proof for its assignment,
made with the first job's r and s; the comparison must call it wrong.

`readings` draws a cell's inputs from the seed as a run does (cell.draw_pool
and draw.draw_job: for the recursion circuit the program still makes the
inner proof and the synthesis, which the control needs for its
assignment) and returns the numbers the comparison gives the control's
proofs.
"""

from __future__ import annotations

from benchmark.lib import check
from benchmark.lib.cell import circuit_module, draw_pool
from benchmark.lib.draw import config_waste, draw_job, job_assignment, stream
from benchmark.reference.groth16 import CurveSpec, Reference


class ReusedRandomness:
    """An entry (program.Entry's interface) that returns the reference's
    proofs, each made with the r and s of the first job it saw."""

    def __init__(self, reference: Reference):
        self.ref, self.first, self.evs = reference, None, {}

    def _proof(self, z, r, s):
        if self.first is None:
            self.first = (r, s)
        key = hash(tuple(z))
        if key not in self.evs:
            self.evs[key] = self.ref.evaluate(z)
        return self.ref.proof(self.evs[key], z, *self.first)

    def single(self, z, r, s, timer=None):
        return self._proof(z, r, s)

    def stream(self, jobs):
        for z, r, s in jobs:
            yield self._proof(z, r, s)


def readings(cfg, traffic, seed: int, jobs: int, device="cuda") -> dict:
    """The comparison's numbers for `jobs` control proofs of one seed."""
    spec = CurveSpec.from_json(cfg["curve"])
    r = spec.r
    circ = circuit_module(cfg)
    waste = config_waste(cfg, seed, r)
    matrices, pool = draw_pool(cfg, circ, seed, r, device, int(traffic["pool"]))
    circuit, digest = circ.reference_circuit(cfg, matrices)
    ref = Reference(spec, waste, circuit)
    entry = ReusedRandomness(ref)
    job_rng = stream(seed, "jobs")
    todo = [draw_job(cfg, circ, job_rng, k, len(pool), r) for k in range(jobs)]
    proofs = [entry.single(job_assignment(pool, job), job[1], job[2]) for job in todo]
    vk = ref.verifying_key(ref.evaluate(pool[0]))
    return check.compare(cfg, spec, waste, circuit, digest, pool, todo, proofs, vk, rng=stream(seed, "sample"))
