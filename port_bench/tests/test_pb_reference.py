"""The reference agrees with the port on a small log on the CPU, run
through the harness's own loops; its control (the map kept in bfloat16)
and planted faults in the program come out not correct. The cells run as
they are, and with the P^2 estimator in place of Kalman."""

import time

import pytest
import torch

import fastdem_tpu_torch.mapping.p2 as port_p2
import fastdem_tpu_torch.mapping.pipeline as pipeline
from port_bench import control
from port_bench.harness import bench, check
from port_bench.tests.small import small

CELLS = ["local_vlp16.replay", "global_vlp16.replay", "local_vlp16.node_10hz",
         "global_vlp16.node_10hz"]
P2_CELLS = ["local_vlp16.replay", "local_vlp16.node_10hz"]
SECONDS = 1.5


def small_p2(cell):
    cfg, tr = small(cell)
    cfg["node"]["mapping"]["type"] = "p2_quantile"
    return cfg, tr


def _run(cell, seed=3_000_000_123, sizes=small):
    cfg, tr = sizes(cell)
    return bench.run_cell(cell, seed, SECONDS, False, "cpu", time.perf_counter(),
                          out=lambda *_: None, config=cfg, traffic=tr)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0
    assert all(c["value"] == 0.0 for c in r["checks"].values()), r["checks"]


@pytest.mark.parametrize("cell", P2_CELLS)
def test_p2_reference_agrees_with_the_port(cell):
    r = _run(cell, sizes=small_p2)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0
    assert all(c["value"] == 0.0 for c in r["checks"].values()), r["checks"]


def _control_correct(cell, sizes):
    cfg, tr = sizes(cell)
    numbers, _ = control.control_numbers(cell, 7, "cpu", SECONDS, cfg, tr)
    correct, _ = check.judge(numbers, bench.load_json(bench.limits_file(cell)))
    return correct, numbers


@pytest.mark.parametrize("cell", ["local_vlp16.replay", "global_vlp16.replay",
                                  "local_vlp16.node_10hz"])
def test_bfloat16_control_is_not_correct(cell):
    correct, numbers = _control_correct(cell, small)
    assert not correct, numbers


def test_p2_bfloat16_control_is_not_correct():
    correct, numbers = _control_correct("local_vlp16.replay", small_p2)
    assert not correct, numbers


def _wrap_step(monkeypatch, alter):
    build = pipeline.FastDEM._build_step

    def build_broken(self):
        step = build(self)

        def broken(state, *a):
            new, aux = step(state, *a)
            return alter(state, new), aux

        return broken

    monkeypatch.setattr(pipeline.FastDEM, "_build_step", build_broken)


@pytest.mark.parametrize("cell", ["local_vlp16.replay", "global_vlp16.node_10hz"])
def test_fault_state_unchanged(cell, monkeypatch):
    _wrap_step(monkeypatch, lambda old, new: old)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", ["local_vlp16.replay", "local_vlp16.node_10hz"])
def test_fault_half_the_scans_left_out(cell, monkeypatch):
    integrate = pipeline.FastDEM.integrate
    calls = [0]

    def half(self, cloud, *a, **k):
        calls[0] += 1
        return True if calls[0] % 2 else integrate(self, cloud, *a, **k)

    monkeypatch.setattr(pipeline.FastDEM, "integrate", half)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", ["global_vlp16.replay", "local_vlp16.node_10hz"])
def test_fault_an_answer_altered(cell, monkeypatch):
    def alter(old, new):
        e = new.layers["elevation"]
        new.layers["elevation"] = torch.where(torch.isfinite(e), e + 1e-3, e)
        return new

    _wrap_step(monkeypatch, alter)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", P2_CELLS)
def test_p2_fault_elevation_from_another_marker(cell, monkeypatch):
    """The program's elevation read from marker 2 (the median) in place of
    the configured marker 3."""
    monkeypatch.setattr(port_p2, "_elevation_marker", lambda cfg: 2)
    assert not _run(cell, sizes=small_p2)["correct"]
