"""witness_map_roofline.single (%): the witness map's least time on the
card (benchmark/work/counts.py: 7 radix-2 NTTs, the nonzeros and 6
pointwise products an element, each an Fr Montgomery product in 32-bit
multiplies at the published int32 rate, or the bytes at the published
HBM rate, whichever is larger) over the device's busy time inside the
program's `witness_map` phase (the profiled phase-timed proves; host
dispatch gaps left out); moves prove_s."""

from benchmark.lib.readers import phase_device_mean, witness_map_bound_s


def read(ctx):
    t = phase_device_mean(ctx, "witness_map")
    if not t:
        return None
    return 100.0 * witness_map_bound_s(ctx["work"]) / t
