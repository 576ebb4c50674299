"""Writes benchmark/tests/data/reference_fixture.json: proofs made by the
program (groth16_tpu_torch, on the CPU) for a 2^6 DummyCircuit on
bls12_381 (host assembly) and on mnt6_298 (device assembly), with
everything the reference needs to recompute them.  The reference's test
reads the file and imports nothing of the program.

    python3 benchmark/tests/make_reference_fixture.py
"""

from __future__ import annotations

import copy
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from benchmark.lib import check, spec  # noqa: E402
from benchmark.lib.cell import Run  # noqa: E402
from benchmark.lib.draw import job_assignment  # noqa: E402

CASES = (("bls12_381.bench_2p20", "host", 0xF1), ("mnt6_298.recursion", "device", 0xF2))


def strs(x):
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return [strs(v) for v in x]
    return str(x)


def case(config_name, assembly, seed):
    cell = spec.cell("mnt6_298.recursion.single")  # a template: its config and traffic are replaced
    cfg = copy.deepcopy(spec.load_json(os.path.join(spec.BENCH_DIR, "configs", config_name + ".json")))
    cfg["circuit"] = {"module": "bench_dummy", "num_constraints": 60, "num_variables": 60, "num_instance": 2}
    cell.config = cfg
    cell.traffic = {"entry": "single", "assembly": assembly, "pool": 1, "warmup_jobs": 1}
    run = Run(cell, seed, 0.0, False, device="cpu")
    run.setup()
    job, proof = run.jobs[0], run.proofs[0]
    return {"curve": cfg["curve"], "circuit": cfg["circuit"], "seed": seed,
            "waste": {k: str(v) for k, v in vars(run.waste).items()}, "z": strs(job_assignment(run.pool, job)),
            "r": str(job[1]), "s": str(job[2]),
            "proof": strs(proof), "vk": strs(check.vk_points(run.pk.vk))}


def main():
    out = [case(*c) for c in CASES]
    os.makedirs(os.path.join(HERE, "data"), exist_ok=True)
    with open(os.path.join(HERE, "data", "reference_fixture.json"), "w") as f:
        json.dump(out, f, indent=0)


if __name__ == "__main__":
    main()
