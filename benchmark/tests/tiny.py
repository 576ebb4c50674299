"""A tiny cell for the CPU tests: the bench's DummyCircuit at 30
constraints on bls12_381, with the given traffic; kept only here."""

from __future__ import annotations

import copy

from benchmark.lib import spec

TRAFFIC = {
    "stream": {"entry": "stream", "depth": 2, "pool": 2, "warmup_jobs": 1,
               "profiled_proofs": 1},
    "single": {"entry": "single", "assembly": "host", "pool": 2, "warmup_jobs": 1,
               "phase_timed_proofs": 1, "profiled_proofs": 1},
}


def tiny_cell(entry: str = "single", constraints: int = 30):
    """The stream or the single cell of BENCHMARK.json with a tiny
    bls12_381 configuration and traffic in place of its own."""
    name = "bls12_381.bench_2p20.stream" if entry == "stream" else "mnt6_298.recursion.single"
    cell = spec.cell(name)
    cfg = copy.deepcopy(spec.load_json(f"{spec.BENCH_DIR}/configs/bls12_381.bench_2p20.json"))
    cfg["circuit"].update(num_constraints=constraints, num_variables=constraints)
    cell.config, cell.traffic = cfg, dict(TRAFFIC[entry])
    return cell
