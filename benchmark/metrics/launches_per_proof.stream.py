"""launches_per_proof.stream: device kernels (copies and fills left out) in
the profiled stretch over its proofs; moves proofs_per_s."""

from benchmark.lib.readers import traced


def read(ctx):
    t = traced(ctx, "stream")
    return None if t is None else t["launches"] / t["proofs"]
