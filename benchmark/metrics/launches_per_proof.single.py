"""launches_per_proof.single: device kernels (copies and fills left out) in
the profiled stretch over its proofs; moves prove_s."""

from benchmark.lib.readers import traced


def read(ctx):
    t = traced(ctx, "single")
    return None if t is None else t["launches"] / t["proofs"]
