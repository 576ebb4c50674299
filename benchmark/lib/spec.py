"""BENCHMARK.json and the files it names: loading, and the contract's
rules on names and units."""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list  # this cell's end-to-end metrics (entries of BENCHMARK.json)
    per_layer: list  # this cell's per-layer metrics


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: str = ROOT, bench: dict | None = None) -> Cell:
    """The workload `name` with its configuration, traffic and metrics."""
    bench = bench or benchmark(root)
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(wl)})")
    w = wl[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _listed(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(
        name=name, config_name=w["config"], traffic_name=w["traffic"],
        config=load_json(os.path.join(root, cfg["file"])),
        traffic=load_json(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json")),
        chips=int(w["chips"]), end_to_end=e2e, per_layer=per_layer,
    )
