"""assembly_s.single: mean seconds of the program's `assembly` phase (the
accumulators fetched and the proof assembled on the host's exact
engine) over the phase-timed proves; moves prove_s."""

from benchmark.lib.readers import phase_mean


def read(ctx):
    return phase_mean(ctx, "assembly")
