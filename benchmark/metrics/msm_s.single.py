"""msm_s.single: mean seconds of the program's `msm_g1_x4` and `msm_g2`
phases (the five MSMs) over the phase-timed proves; moves prove_s."""

from benchmark.lib.readers import phase_mean


def read(ctx):
    return phase_mean(ctx, "msm_g1_x4", "msm_g2")
