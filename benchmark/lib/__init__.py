"""The benchmark's harness: general code that every cell shares.  What
belongs to one configuration, traffic mix or per-layer metric lives in
files of its own under benchmark/configs, traffic, circuits and metrics,
found by the names in BENCHMARK.json."""
