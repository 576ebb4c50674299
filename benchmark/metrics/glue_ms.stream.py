"""glue_ms.stream: device milliseconds a proof of PyTorch's own kernels
(at::native, cub), copies and fills in the profiled stretch; moves
proofs_per_s."""

from benchmark.lib.readers import traced


def read(ctx):
    t = traced(ctx, "stream")
    return None if t is None else t["device_ms_by_kind"]["glue"] / t["proofs"]
