"""device_idle.single (%): the share of the profiled stretch of consecutive
proves in which nothing ran on the card (1 - the union of its kernel and
copy intervals over the stretch's wall); moves prove_s."""

from benchmark.lib.readers import traced


def read(ctx):
    t = traced(ctx, "single")
    return None if t is None else 100.0 * (1.0 - t["busy_s"] / t["window_s"])
