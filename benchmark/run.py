"""The benchmark of groth16_tpu_torch on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json on the card it is started on and prints
the result as the last line of standard output (one JSON object); the
numbers compared for `correct`, each beside its limit, are the last
lines of standard error.  See benchmark/README.md.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "groth16_tpu")


def caches(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    base = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def emit(line: dict) -> None:
    """The result: each number compared beside its limit as the last lines
    of standard error, then the line as the last line of standard output."""
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    caches(ROOT)
    sys.path.insert(0, ROOT)

    import torch

    from benchmark.lib import cell as cell_run
    from benchmark.lib.spec import cell as load_cell

    cell = load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"error: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    line = cell_run.Run(cell, args.seed, args.seconds, args.trace, device="cuda", t_start=T_START).go()
    found = forbidden_modules()
    if found:
        print(f"error: the run loaded {found}", file=sys.stderr)
        return 3
    emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
