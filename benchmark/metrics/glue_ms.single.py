"""glue_ms.single: device milliseconds a proof of PyTorch's own kernels
(at::native, cub), copies and fills in the profiled stretch; moves
prove_s."""

from benchmark.lib.readers import traced


def read(ctx):
    t = traced(ctx, "single")
    return None if t is None else t["device_ms_by_kind"]["glue"] / t["proofs"]
