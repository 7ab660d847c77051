"""The reference's P^2 estimator (``reference/p2.py``) equals the port's
``mapping/p2.py`` bit for bit on the CPU, and a variant that updates the
interior markers in parallel differs from it."""

import copy

import numpy as np
import pytest
import torch

import fastdem_tpu_torch.config as port_config
from fastdem_tpu_torch.grid.gridmap import GridMapState as PortState
from fastdem_tpu_torch.mapping import p2 as port_p2
from fastdem_tpu_torch.mapping import pipeline
from port_bench.harness import bench, runs
from port_bench.reference import config as ref_config
from port_bench.reference import p2 as ref_p2
from port_bench.reference import step as ref_step
from port_bench.reference.gridmap import GridMapState as RefState, layers

SHAPE = (150, 150)
SCANS = 40
LAYERS = [*layers.p2_q, *layers.p2_n, layers.n_points, layers.elevation, layers.variance,
          layers.upper_bound, layers.lower_bound]


def _initial(fills, state_cls):
    lyr = {k: torch.full(SHAPE, v, dtype=torch.float32) for k, v in fills.items()}
    lyr[layers.elevation] = torch.full(SHAPE, np.nan, dtype=torch.float32)
    return state_cls(layers=lyr, position=torch.zeros(2))


def _observations(seed: int, touched_share: float):
    """Per scan (z, z_var, touched): a seeded terrain with noise, a few
    outliers, and values repeated from scan to scan; NaN where untouched."""
    g = torch.Generator().manual_seed(seed)
    ground = torch.rand(SHAPE, generator=g) * 2.0 - 0.5
    for s in range(SCANS):
        noise = torch.randn(SHAPE, generator=g) * 0.03
        outlier = torch.rand(SHAPE, generator=g) < 0.05
        z = ground + torch.where(outlier, noise * 30.0, noise)
        if s % 7 == 3:
            z = torch.round(z * 20.0) / 20.0  # ties with the markers
        touched = torch.rand(SHAPE, generator=g) < touched_share
        z = torch.where(touched, z, np.nan)
        yield z, torch.full(SHAPE, 1e-3), touched


def _configs(max_sample_count: float, elevation_marker: int):
    return (port_config.P2Config(max_sample_count=max_sample_count,
                                 elevation_marker=elevation_marker),
            ref_config.P2Config(max_sample_count=max_sample_count,
                                elevation_marker=elevation_marker))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


def _run(module, state_cls, cfg, seed, touched_share):
    state = _initial(module.layer_fills(), state_cls)
    for z, z_var, touched in _observations(seed, touched_share):
        state = module.estimate(state, cfg, z, z_var, touched)
    return state


def _run_both(seed, touched_share, port_cfg, ref_cfg):
    return (_run(port_p2, PortState, port_cfg, seed, touched_share),
            _run(ref_p2, RefState, ref_cfg, seed, touched_share))


def _differing(port, ref):
    return [k for k in LAYERS if not np.array_equal(_bits(port.layers[k]), _bits(ref.layers[k]))]


@pytest.mark.parametrize("max_sample_count", [0.0, 8.0])
@pytest.mark.parametrize("elevation_marker", [3, 1])
def test_reference_p2_equals_the_port(max_sample_count, elevation_marker):
    port, ref = _run_both(20_261_019, 0.7, *_configs(max_sample_count, elevation_marker))
    assert set(port.layers) == set(ref.layers) and set(LAYERS) <= set(ref.layers)
    assert _differing(port, ref) == []
    # The run reached phase 2 and its interior updates.
    assert float(ref.layers[layers.n_points].max()) > 5.0
    assert bool(torch.isfinite(ref.layers[layers.variance]).any())


@pytest.mark.parametrize("cell", ["local_vlp16.replay", "global_vlp16.replay"])
def test_reference_p2_layers_are_the_ports(cell):
    _, _, config, _ = bench.cell_inputs(cell)
    node = copy.deepcopy(config["node"])
    node["mapping"]["type"] = "p2_quantile"
    ref = ref_step.initial_layer_fills(ref_config.parse_config(copy.deepcopy(node)))
    port = pipeline.initial_layer_fills(runs.program_config({"node": node}).pipeline)
    assert set(layers.p2_q) | set(layers.p2_n) <= set(ref)
    assert set(ref) == set(port)
    assert all(np.array_equal(ref[k], port[k], equal_nan=True) for k in ref)


def test_parallel_interior_markers_differ(monkeypatch):
    """The fault: markers 2 and 3 updated from the positions before marker
    1's (and 2's) update; every cell is touched on every scan."""
    _, cfg = _configs(0.0, 3)
    ref = _run(ref_p2, RefState, cfg, 7, 1.0)
    sequential = ref_p2._adjust_marker
    before = {}

    def parallel(qs, ns, i, *a):
        if i == 1:
            before["qs"], before["ns"] = list(qs), list(ns)
        return sequential(before["qs"], before["ns"], i, *a)

    monkeypatch.setattr(ref_p2, "_adjust_marker", parallel)
    variant = _run(ref_p2, RefState, cfg, 7, 1.0)
    assert set(_differing(variant, ref)) & {layers.elevation, layers.p2_q[2], layers.p2_n[2]}
