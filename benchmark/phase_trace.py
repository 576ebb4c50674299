"""A traced run of one cell, as `benchmark/run.py --trace 1` makes it, with
the program-span stretch of benchmark/lib/phases.py after it.

    python3 benchmark/phase_trace.py --workload <cell> --seed <n> [--cost N] [--device cuda]

Prints the run's line (the cell's per-layer metrics, `correct`, the
checks) with the readings of phases.METRICS for the cell added under
"metrics", and under "program_trace" the stretch's summary: the share of
the card's busy time that the program's spans hold and the largest
events they do not.  --cost N: N single proves with the program's span
recorder off and N with it on, in turns, after the stretch
("recorder_cost": seconds, median and quartiles of each side).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--cost", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    from benchmark import run
    from benchmark.lib import phases
    from benchmark.lib.spec import cell as load_cell

    run.caches(ROOT)
    cell = load_cell(args.workload, ROOT)
    r = phases.PhaseRun(cell, args.seed, args.seconds, True, device=args.device, t_start=T_START)
    r.cost_proofs = args.cost
    line = r.go()
    found = run.forbidden_modules()
    if found:
        print(f"error: the run loaded {found}", file=sys.stderr)
        return 3
    line["metrics"].update(phases.read_all(r.phase_ctx, cell.name))
    summary = r.phase_ctx["program_trace"]
    line["program_trace"] = None if summary is None else {
        k: summary[k] for k in ("attributed_share", "unattributed_ops", "busy_s", "window_s", "device_ms",
                                "launches", "host_ms", "idle_s", "h2d_bytes_per_job")}
    if "recorder_cost" in r.phase_ctx:
        line["recorder_cost"] = r.phase_ctx["recorder_cost"]
    line["checks"] = line.pop("checks")  # last, as run.py prints it
    run.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
