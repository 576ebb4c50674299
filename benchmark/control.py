"""Readings of the control of `correct` at a cell's own size: the
reference in the program's place with r and s reused (lib/control.py),
on several seeds.  Not part of a benchmark run.

    python3 benchmark/control.py --workload <cell> --jobs <n> --seeds <s1> <s2> <s3>

Prints one JSON line a seed: the comparison's numbers and whether the
control came out correct (it must not).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--jobs", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.lib import check, control, spec

    cell = spec.cell(args.workload, ROOT)
    bad = 0
    for seed in args.seeds:
        checks = control.readings(cell.config, cell.traffic, seed, args.jobs, device=args.device)
        ok = check.is_correct(checks)
        bad += ok
        print(json.dumps({"workload": cell.name, "seed": seed, "jobs": args.jobs, "control_correct": ok,
                          "checks": checks}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
