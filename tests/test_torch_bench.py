"""The port's bench entry point (groth16_tpu_torch.bench) on the CPU at a
tiny size: its line carries every key `bench.py` can emit (read from
bench.py's source, so no JAX bench runs), plus the three it documents,
and its steady proof verifies.  The numbers of a CPU run are the plain
versions' times and are not checked.

Tolerance: exact (key sets; the proof verifies)."""

import ast
import json
import os

import torch

from groth16_tpu_torch.bench import run

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OWN_KEYS = {"card", "int32_mad_per_s", "int32_mad_per_s_source"}


def _bench_py_keys():
    """(top-level keys, extras keys, batch_prove keys) of bench.py's
    line: the keys of its `extras = {...}` literal and of every
    `extras["..."] = ...`, and of the dict stored under batch_prove."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    extras, batch, top = set(), set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "extras" and isinstance(node.value, ast.Dict):
                    extras |= {k.value for k in node.value.keys}
                if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name) and t.value.id == "extras":
                    extras.add(t.slice.value)
                    if t.slice.value == "batch_prove":
                        batch |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps":
            arg = node.args[0]
            if isinstance(arg, ast.Dict) and any(getattr(v, "id", None) == "extras" for v in arg.values):
                top |= {k.value for k in arg.keys}
    return top, extras, batch


def test_bench_line_has_bench_py_keys():
    top, extras, batch = _bench_py_keys()
    assert {"phases_s", "verify_engine", "batch_prove", "setup_s"} <= extras
    line = run("bn254", 5, device="cpu", steady=1, batch=1, verify_reps=2, nnz=(100,))
    json.dumps(line)
    assert set(line) == top
    assert line["metric"] == "prove_2p5_bn254_wall" and line["unit"] == "s"
    e = line["extras"]
    assert set(e) == extras | OWN_KEYS
    assert set(e["batch_prove"]) == batch
    assert set(e["phases_s"]) == {"witness_map", "msm_g1_x4", "msm_g2", "assembly"}
    assert e["verify_engine"] == "native"
    assert e["card"] is None and e["msm_g1_sol_frac"] is None and e["ntt_sol_frac"] is None
    assert set(e["evaluate_constraint_ms"]) == {"100"}
