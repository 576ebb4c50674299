"""witness_map_s.single: mean seconds of the program's `witness_map`
phase (PhaseTimer, fenced by syncs) over the phase-timed proves; moves
prove_s."""

from benchmark.lib.readers import phase_mean


def read(ctx):
    return phase_mean(ctx, "witness_map")
