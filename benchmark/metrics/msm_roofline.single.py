"""msm_roofline.single (%): the five MSMs' least time on the card
(benchmark/work/counts.py: each MSM's live points, a key point at
infinity or a zero scalar needing no addition, at the window that
minimises its signed-digit Pippenger count, times the 32-bit multiplies
of one addition, at the published int32 rate; or the bytes, whichever is
larger) over the device's busy time inside the program's `msm_g1_x4` and
`msm_g2` phases (the profiled phase-timed proves; host dispatch gaps
left out); moves prove_s."""

from benchmark.lib.readers import msm_bound_s, phase_device_mean


def read(ctx):
    t = phase_device_mean(ctx, "msm_g1_x4", "msm_g2")
    if not t:
        return None
    return 100.0 * msm_bound_s(ctx["work"]) / t
