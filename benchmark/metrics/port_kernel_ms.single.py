"""port_kernel_ms.single: device milliseconds a proof of the program's own
kernels (every kernel not PyTorch's or its libraries',
benchmark/lib/trace.kind) in the profiled stretch; moves prove_s."""

from benchmark.lib.readers import traced


def read(ctx):
    t = traced(ctx, "single")
    return None if t is None else t["device_ms_by_kind"]["port"] / t["proofs"]
