import ast
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from port_bench.harness import bench, bounds, guard, parts, stats
from port_bench.harness.trace import Reduced, reduce_events

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def test_percentiles_take_every_sample():
    x = [1.0] * 95 + [1000.0] * 5
    assert stats.percentile(x, 50) == 1.0
    # numpy's linear rule over all 100 samples; no outlier is dropped.
    assert stats.percentile(x, 95) == pytest.approx(np.percentile(x, 95))
    assert stats.percentile(x, 99) == pytest.approx(1000.0)
    assert stats.percentile([], 95) is None


def test_rate_over_the_whole_window():
    assert stats.rate(300, 30.0) == 10.0
    assert stats.rate(5, 0.0) is None
    assert stats.per_item(6.0, 3) == 2.0


def test_loader_finds_every_part_by_name():
    b = bench.benchmark()
    for w in b["workloads"]:
        _, _, cfg, tr = bench.cell_inputs(w["name"])
        loop = bench.loop(tr["loop"])
        assert callable(loop.run) and callable(loop.history)
        assert callable(bench.part("sensors", cfg["sensor"]["generator"]).directions)
        assert cfg["reduced"] == []
        assert bench.limits_file(w["name"]).exists()
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(bench.reader(m["name"]))
    for c in b["configs"]:
        assert (ROOT / c["file"]).exists()


def test_a_new_part_is_a_new_file(tmp_path, monkeypatch):
    (tmp_path / "loops").mkdir()
    (tmp_path / "loops" / "burst.py").write_text("POSTPROCESS = False\n")
    monkeypatch.setattr(parts, "BENCH_DIR", tmp_path)
    load = parts.part.__wrapped__
    assert load("loops", "burst").POSTPROCESS is False
    with pytest.raises(KeyError, match="no sensors 'sonar'"):
        load("sensors", "sonar")


def test_metrics_each_cell_reports():
    b = bench.benchmark()
    for w in b["workloads"]:
        e2e = {m["name"] for m in bench.metrics_for(b, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert bench.metrics_for(b, w["name"], True)


def test_copied_bounds_reproduce_the_recorded_bytes():
    assert bounds.k1_bytes(515, 2048) == 8_441_884
    assert bounds.k4_bytes(150 * 150, 1) == 202_528
    assert bounds.k4_bytes(484 * 484, 1) == 2_108_332
    ms, by = bounds.k4_lookup_bound(150 * 150, 1)
    assert by == "bytes" and ms == pytest.approx(202_528 / 3.35e12 * 1e3)


def test_import_guard_compares_top_level_names_whole():
    assert guard.forbidden_modules(["fastdem_tpu_torch", "fastdem_tpu_torch.ops", "jaxtyping",
                                    "numpy"]) == []
    assert guard.forbidden_modules(["jax", "jax.numpy", "jaxlib.xla", "flax", "fastdem_tpu.grid"]) \
        == ["fastdem_tpu.grid", "flax", "jax", "jax.numpy", "jaxlib.xla"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in ("fastdem_tpu_torch", "fastdem_tpu", "jax",
                                              "jaxlib", "flax", "port_bench"), (path, name)


def test_nothing_reads_the_jax_harness():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("fastdem_tpu", "jax", "jaxlib", "flax", "bench", "chip_smoke"), \
                (path, name)


class _Ev:
    def __init__(self, name, dev, s, d):
        from torch.autograd import DeviceType

        self._n, self._d = name, DeviceType.CUDA if dev else DeviceType.CPU
        self._s, self._dur = s, d

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._dur

    def is_user_annotation(self):
        return False


def test_trace_reduction_busy_and_gaps():
    evs = [
        _Ev("harness.traced", False, 0, 1000),
        _Ev("cudaGraphLaunch", False, 20, 60),
        _Ev("k_a", True, 100, 200),
        _Ev("k_b", True, 250, 100),  # overlaps k_a: busy is the union
        _Ev("aten::copy_", False, 400, 300),
        _Ev("k_a", True, 700, 100),
        _Ev("k_out", True, 2000, 50),  # outside the span
    ]
    r = reduce_events(evs)
    assert r.window_s == pytest.approx(1e-6)
    assert r.busy_s == pytest.approx(350e-9)
    assert r.kernels["k_a"] == (2, pytest.approx(300e-9))
    assert "k_out" not in r.kernels
    gaps = dict(r.idle_gaps)
    assert gaps["gap: aten::copy_"] == pytest.approx(350e-9)
    assert gaps["gap: cudaGraphLaunch"] == pytest.approx(100e-9)
    assert gaps["gap: no host op"] == pytest.approx(200e-9)


def test_benchmark_json_keys():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    chips = [w["chips"] for w in b["workloads"]]
    assert set(chips) <= {1, 4}
    assert chips.count(4) <= max(1, len(chips) // 4)
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])


def test_node_readers_split_the_median_latency():
    run = SimpleNamespace(samples={"enqueue_ms": [1.0, 2.0, 30.0],
                                   "enqueued_to_done_ms": [4.0, 5.0, 60.0]})
    ctx = SimpleNamespace(run=run, trace=None)
    assert bench.reader("node.enqueue_ms_p50")(ctx) == 2.0
    assert bench.reader("step.enqueued_to_done_ms_p50")(ctx) == 5.0


def test_idle_share_is_read_from_the_trace_alone():
    idle = bench.reader("device.idle_pct")
    t = Reduced(window_s=2.0, busy_s=0.5, kernels={}, device_ops=[], idle_gaps=[], scans=10)
    # No host rate enters: the traced span's own busy share.
    run = SimpleNamespace(counts={"untraced_scans_per_s": 1e6})
    assert idle(SimpleNamespace(trace=t, run=run)) == pytest.approx(75.0)
    assert idle(SimpleNamespace(trace=None, run=run)) is None
