"""benchmark/lib/phases.py on synthetic traces: device events go to the
innermost program span open at their launch and count to the spans
around it; idle time counts to the spans the host was in; the coverage
share; the readers, None without a summary; the metrics' entries; and a
tiny stream cell's program-span stretch on the CPU."""

import pytest

from benchmark.lib import phases, spec
from benchmark.tests.tiny import tiny_cell

# (name, start_ns, end_ns, parent, proof) as utils/profiling records them
SPANS = [
    ("witness_map", 100, 200, None, 0),
    ("matvec", 110, 150, 0, 0),
    ("msm_g1_x4", 200, 300, None, 0),
    ("encode", 300, 400, None, 1),
    ("fetch", 420, 440, None, 0),
]
# (name, start, end, correlation) on the device; launches: correlation -> host start
DEVICE = [("k1", 500, 520, 1), ("k2", 520, 540, 2), ("k3", 540, 600, 3), ("k4", 600, 610, 4),
          ("Memcpy HtoD", 610, 615, 5), ("k5", 350, 380, 6)]
LAUNCHES = {1: 120, 2: 160, 3: 250, 4: 450, 6: 305}


def _summary(t0=0, t1=1000, proofs=2):
    return phases.summarize(SPANS, {"h2d_bytes": 3000}, DEVICE, LAUNCHES, t0, t1, proofs, True)


def test_a_kernel_counts_to_its_span_and_those_around_it():
    ms = _summary()["device_ms"]
    assert ms["matvec"] == pytest.approx(20e-6)
    assert ms["witness_map"] == pytest.approx(40e-6)
    assert ms["msm_g1_x4"] == pytest.approx(60e-6)
    assert ms["encode"] == pytest.approx(30e-6)
    assert "fetch" not in ms
    assert _summary()["launches"] == {"witness_map": 2, "matvec": 1, "msm_g1_x4": 1, "encode": 1}


def test_idle_time_counts_to_the_span_the_host_was_in():
    s = _summary()
    # encode [300, 400] with k5 busy over [350, 380]: 70 ns idle inside it
    assert s["idle_s"]["encode"] == pytest.approx(70e-9)
    assert s["idle_s"]["fetch"] == pytest.approx(20e-9)
    assert s["host_ms"]["encode"] == pytest.approx(100e-6)
    # a window that cuts the span clips it
    assert _summary(t0=320, t1=1000)["idle_s"]["encode"] == pytest.approx(50e-9)


def test_coverage_share():
    s = _summary()
    # k4 launched outside every span and the copy without a launch call
    assert s["busy_s"] == pytest.approx(145e-9)
    assert s["attributed_share"] == pytest.approx(130 / 145)
    assert [n for n, _ in s["unattributed_ops"]] == ["k4", "Memcpy HtoD"]
    assert s["h2d_bytes_per_job"] == 1500


def test_innermost_span_is_the_latest_open():
    bounds, owner = phases.innermost(SPANS)
    assert [phases.owner_at(bounds, owner, t) for t in (50, 100, 120, 150, 199, 200, 305, 410)] == \
        [-1, 0, 1, 0, 0, 2, 3, -1]


def test_readers_on_a_summary():
    ctx = {"program_trace": _summary(), "entry": "stream"}
    r = phases.READERS
    assert r["witness_map_device_ms.stream"](ctx) == pytest.approx(20e-6)
    assert r["msm_device_ms.stream"](ctx) == pytest.approx(30e-6)
    assert r["encode_ms.stream"](ctx) == pytest.approx(50e-6)
    assert r["fetch_wait_ms.stream"](ctx) == pytest.approx(10e-6)
    assert r["idle_in_encode.stream"](ctx) == pytest.approx(100.0 * 70 / 1000)
    assert r["h2d_mb_per_proof.stream"](ctx) == pytest.approx(1500 / 1e6)
    assert r["matvec_device_ms.single"](ctx) is None  # another entry's
    single = {"program_trace": _summary(), "entry": "single"}
    assert r["matvec_device_ms.single"](single) == pytest.approx(10e-6)


@pytest.mark.parametrize("ctx", [{}, {"spans": {}, "phases": [], "trace": None},
                                 {"program_trace": None, "entry": "stream"}])
def test_readers_return_none_without_a_summary(ctx):
    for name, read in phases.READERS.items():
        assert read(ctx) is None, name


def test_device_readers_need_a_device_trace():
    s = phases.summarize(SPANS, {"h2d_bytes": 3000}, [], {}, 0, 1000, 2, False)
    ctx = {"program_trace": s, "entry": "stream"}
    got = {n for n, r in phases.READERS.items() if r(ctx) is not None}
    assert got == {"encode_ms.stream", "fetch_wait_ms.stream", "h2d_mb_per_proof.stream"}


def test_metric_entries_follow_the_contract():
    bench = spec.benchmark()
    cells = {w["name"] for w in bench["workloads"]}
    layers = {m["layer"] for m in bench["per_layer"]}
    names = {m["name"] for m in bench["per_layer"]}
    assert set(phases.READERS) == {m["name"] for m in phases.METRICS}
    for m in phases.METRICS:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert spec.NAME.match(m["name"]) and spec.UNIT.match(m["unit"]) and m["name"] not in names
        assert m["source"] in ("device_trace", "program_span", "program_counter")
        assert 1 <= len(m["layer"]) <= 200 and (m["layer"] in layers or m["layer"] == phases.ENCODE)
        for wl in m["workloads"]:
            assert wl in cells and m["moves"] in {x["name"] for x in spec.cell(wl).end_to_end}


def test_a_program_without_the_recorder_gives_no_summary(monkeypatch):
    from groth16_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "tracing")
    assert phases.PhaseRun.program_stretch(None, 1) is None


def test_tiny_stream_stretch_on_the_cpu():
    run = phases.PhaseRun(tiny_cell("stream"), 2**32 + 7, 0.5, True, device="cpu")
    line = run.go()
    assert line["correct"]
    got = phases.read_all(run.phase_ctx, "bls12_381.bench_2p20.stream")
    assert set(got) == {"encode_ms.stream", "fetch_wait_ms.stream", "h2d_mb_per_proof.stream"}
    assert got["encode_ms.stream"]["value"] > 0 and got["h2d_mb_per_proof.stream"]["value"] > 0
    assert run.phase_ctx["program_trace"]["host_ms"]["witness_map"] > 0
