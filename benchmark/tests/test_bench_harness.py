"""The harness on the CPU: BENCHMARK.json against the contract's rules,
the files it names, the kernel-name classifier, the modules a run loads,
and a tiny cell end to end."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from benchmark.lib import cell as cell_run
from benchmark.lib import readers, spec, trace
from benchmark.tests.tiny import tiny_cell

ROOT = spec.ROOT
BENCH = spec.benchmark()
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("group", sorted(ENTRY_KEYS))
def test_names_units_and_texts(group):
    entries = BENCH[group]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert set(e) <= ENTRY_KEYS[group], e["name"]
        assert spec.NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e and group != "end_to_end":
                assert TEXT.match(e[k]), (e["name"], k)
        if "unit" in e:
            assert spec.UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("config", "traffic"):
            if k in e:
                assert spec.NAME.match(e[k])
        for k in e.get("reduced", []):
            assert spec.NAME.match(k)


def test_metrics_sources_and_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_what_its_metrics_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        c = spec.cell(w["name"])
        reported = {m["name"] for m in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and c.per_layer, w["name"]
        assert w["chips"] in (1, 4)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for wl in m.get("workloads", cells):
            assert wl in cells
            assert m["moves"] in {x["name"] for x in spec.cell(wl).end_to_end}, (m["name"], wl)


def test_the_files_each_name_finds():
    for c in BENCH["configs"]:
        cfg = spec.load_json(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("benchmark/configs/") and cfg["name"] == c["name"]
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(spec.BENCH_DIR, "circuits", cfg["circuit"]["module"] + ".py"))
    for w in BENCH["workloads"]:
        assert os.path.exists(os.path.join(spec.BENCH_DIR, "traffic", w["traffic"] + ".json"))
    for m in BENCH["per_layer"]:
        assert callable(cell_run.metric_reader(m["name"]))


# device-op names of traced runs of both cells on the card, each with the
# kind it was read as (PyTorch's at::native, cub, copies and fills are
# glue; the anonymous-namespace kernels of csrc are the port's)
KERNEL_SAMPLE = [tuple(x) for x in json.load(open(os.path.join(os.path.dirname(__file__), "data",
                                                                "kernel_names.json")))["names"]]
LIBRARY_NAME = "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x128_8x4_nn_align1>(cutlass_80_simt_sgemm::Params)"


@pytest.mark.parametrize("name,want", KERNEL_SAMPLE + [(LIBRARY_NAME, "library")])
def test_kernel_classifier(name, want):
    assert trace.kind(name) == want


def test_busy_union_and_gaps():
    spans = trace.Spans([("encode", 100, 150)])
    ev = [("a", 0, 50), ("b", 40, 60), ("Memset (Device)", 200, 210)]
    s = trace.summarize(ev, 0, 300, 2, spans, "other")
    assert s["busy_s"] == pytest.approx(70e-9) and s["launches"] == 2
    assert s["idle_gaps"][0] == ["encode", pytest.approx(140e-9)]
    assert s["idle_gaps"][1] == ["other", pytest.approx(90e-9)]


def test_device_time_inside_a_phase():
    ev = [("a", 0, 50), ("b", 40, 60), ("c", 90, 120), ("d", 200, 210)]
    assert trace.busy_s(ev, 10, 100) == pytest.approx(60e-9)
    ctx = {"phase_device": [{"witness_map": 2.0, "msm_g1_x4": 1.0, "msm_g2": 0.5},
                            {"witness_map": 4.0, "msm_g1_x4": 3.0, "msm_g2": 0.5}]}
    assert readers.phase_device_mean(ctx, "witness_map") == 3.0
    assert readers.phase_device_mean(ctx, "msm_g1_x4", "msm_g2") == 2.5
    work = {"r": 2**255 - 19, "p": 2**381 - 1, "g2_deg": 2, "domain": 1 << 10, "nnz": 3000,
            "num_variables": 1000, "msm_g1_points": [10, 10, 1023, 10], "msm_g2_points": 10,
            "products": {"g1_add_products": 13, "g2_add_products": 52}}
    share = cell_run.metric_reader("msm_roofline.single")(dict(ctx, work=work))
    assert share == pytest.approx(100.0 * readers.msm_bound_s(work) / 2.5)


def test_fresh_jobs_change_the_statement_and_keep_the_pool():
    from benchmark.circuits import bench_dummy
    from benchmark.lib.draw import draw_job, job_assignment, stream

    cfg = tiny_cell("single").config
    r = int(cfg["curve"]["r"], 0)
    pool = [bench_dummy.assignment(cfg, list(range(1, cfg["circuit"]["num_variables"])), r)]
    rng = stream(5, "jobs")
    jobs = [draw_job(cfg, bench_dummy, rng, k, 1, r) for k in range(3)]
    zs = [job_assignment(pool, j) for j in jobs]
    assert pool[0] == bench_dummy.assignment(cfg, list(range(1, cfg["circuit"]["num_variables"])), r)
    assert len({tuple(z[1:4]) for z in zs}) == 3 and all(z[4:] == pool[0][4:] for z in zs)
    assert all(z[1] == z[2] * z[3] % r for z in zs)


def test_run_without_a_card_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", BENCH["workloads"][0]["name"],
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


TINY_RUN = r"""
import json, sys
sys.path.insert(0, %(root)r)
import torch
torch.set_num_threads(2)
from benchmark.lib.cell import Run
from benchmark.tests.tiny import tiny_cell
sys.path.insert(0, %(bench)r)
import run
line = Run(tiny_cell(%(entry)r), 2**32 + 7, 0.5, %(trace)d, device="cpu").go()
bad = run.forbidden_modules()
if bad:
    raise SystemExit(f"loaded {bad}")
run.emit(line)
"""


@pytest.mark.parametrize("entry,trace_on", [("stream", 0), ("single", 1)])
def test_tiny_cell_end_to_end_prints_one_contract_line(entry, trace_on):
    code = TINY_RUN % {"root": ROOT, "bench": spec.BENCH_DIR, "entry": entry, "trace": trace_on}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 2
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    want = {"stream": {"proofs_per_s", "setup_s"}}.get(entry) if not trace_on else {
        "keygen_s", "synthesis_s", "upload_s", "witness_map_s.single", "msm_s.single", "assembly_s.single"}
    assert want <= set(line["metrics"])
    # the rooflines divide by device time, which a run without a card has not
    assert not any(m.endswith("_roofline.single") for m in line["metrics"])
    tail = p.stderr.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") and " limit " in t for t in tail)


@pytest.mark.cuda
def test_tiny_cell_on_the_card_traces_the_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    line = cell_run.Run(tiny_cell("stream", constraints=1 << 10), 5, 1.0, 1, device="cuda").go()
    assert line["correct"] and line["device"]["busy_s"] > 0
    assert line["metrics"]["launches_per_proof.stream"]["value"] > 0


def test_readers_return_none_without_data():
    for m in BENCH["per_layer"]:
        if m["source"] in ("device_trace", "program_span"):
            assert cell_run.metric_reader(m["name"])({"spans": {}, "phases": [], "trace": None}) is None

