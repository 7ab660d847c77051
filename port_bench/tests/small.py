"""A cell's configuration and traffic at a size a CPU test can hold: a
coarser azimuth step, fewer boxes, a shorter log, and the GLOBAL map cut to
100 m (the windowed update still engages)."""

import copy

from port_bench.harness import bench


def small(cell: str):
    _, _, cfg, tr = bench.cell_inputs(cell)
    cfg, tr = copy.deepcopy(cfg), copy.deepcopy(tr)
    cfg["sensor"]["azimuth_step_deg"] = 2.0
    cfg["scene"]["boxes"] = 60
    tr["log_scans"] = 40
    tr["trace_s"], tr["trace_tail_s"] = 0.5, 0.2
    if cfg["node"]["map"]["width"] > 100:
        cfg["node"]["map"]["width"] = cfg["node"]["map"]["height"] = 100.0
        tr["motion"]["start_xy"] = [-5.0, 0.0]
    return cfg, tr
