"""What decides ``correct``: the plain reference recomputes the map from the
same log, poses and order of scans that the harness handed the program, and
the program's map (and post-processing result) is compared with it.

``History`` is the order in which scans reached the map: scan indices into
the log, and ``RESET`` where the map was cleared. The reference replays it:
the positions of every scan before the last reset (a LOCAL map's position
walks with the robot, and a reset keeps it), then the last reset, then every
scan after it through the plain step.

The numbers compared, each against its limit (``limits/<workload>.json``):

  state_err   over every layer of the map and its position: the largest
              gap between two finite cells over the largest magnitude of
              the reference array's finite cells (1 where that is 0), and
              1 where a layer is missing or a cell is finite in one map and
              not the other (or NaN in one and an infinity in the other);
  pp_err      the same of the post-processing result (node cells).

The counts behind them (layers missing, cells not finite alike) are
printed on a line of their own before the result.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

import numpy as np
import torch

from ..reference import config as ref_config
from ..reference import gridmap as ref_gridmap
from ..reference import postprocess as ref_pp
from ..reference.geometry import GridGeometry
from ..reference.gridmap import GridMapState, layers
from ..reference.step import build_step, create_map_state

RESET = -1
# Padding of a scan to its capacity: a masked point far outside any map.
PAD_XYZ = 1e9


def capacity_of(n: int) -> int:
    """The capacity a scan of ``n`` points is stepped at: the next power of
    two (the facade's rule, one compiled step per doubling)."""
    cap = 1
    while cap < n:
        cap *= 2
    return cap


def geometry(config: dict) -> GridGeometry:
    m = config["node"]["map"]
    return GridGeometry.from_length(float(m["width"]), float(m["height"]), float(m["resolution"]))


def padded(xyz: np.ndarray, device):
    n = xyz.shape[0]
    cap = capacity_of(n)
    buf = np.full((cap, 3), PAD_XYZ, dtype=np.float32)
    buf[:n] = xyz
    mask = np.zeros(cap, dtype=bool)
    mask[:n] = True
    return torch.as_tensor(buf, device=device), torch.as_tensor(mask, device=device)


def reference_map(config: dict, log, history: List[int], device,
                  dtype=torch.float32) -> GridMapState:
    """The map after ``history``, computed by the plain step on ``device``
    with its layers kept in ``dtype`` between scans."""
    geom = geometry(config)
    cfg = ref_config.parse_config(copy.deepcopy(config["node"]))
    step = build_step(geom, cfg, dtype=dtype)
    state = create_map_state(geom, cfg, device)
    T_bs = torch.as_tensor(log.T_bs, device=device)
    T_wb = torch.as_tensor(log.T_wb, device=device)
    last = max((i for i, h in enumerate(history) if h == RESET), default=-1)
    if last >= 0:
        position = state.position
        if cfg.mapping.mode == ref_config.MappingMode.LOCAL:
            for h in history[:last]:
                if h != RESET:
                    position = step.moved_position(position, T_wb[h][:2, 3])
        state = ref_gridmap.clear_all(GridMapState(layers=state.layers, position=position))
    for h in history[last + 1:]:
        xyz, mask = padded(log.xyz[h], device)
        state = step(state, xyz, mask, T_bs, T_wb[h])
    return state


def reference_postprocess(config: dict, state: GridMapState) -> Dict[str, torch.Tensor]:
    """One ``run_postprocess()`` with its default switches (uncertainty
    fusion, inpainting and features on) over the map's snapshot."""
    geom = geometry(config)
    ppcfg = ref_config.parse_postprocess(copy.deepcopy(config["node"]))
    ppcfg.uncertainty_fusion.enabled = True
    ppcfg.inpainting.enabled = True
    ppcfg.feature_extraction.enabled = True
    run = ref_pp.apply_postprocess_fn(geom, ppcfg)
    return run(*(state.layers[k].clone() for k in
                 (layers.elevation, layers.upper_bound, layers.lower_bound)))


def to_numpy(arrays) -> Dict[str, np.ndarray]:
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in arrays.items()}


def compare_arrays(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]):
    """(err, missing, nonfinite) of two dicts of same-named arrays."""
    missing = len(set(prog) ^ set(ref))
    nonfinite = 0
    rel = 0.0
    for k in sorted(set(prog) & set(ref)):
        a = np.asarray(prog[k], dtype=np.float64)
        b = np.asarray(ref[k], dtype=np.float64)
        if a.shape != b.shape:
            missing += 1
            continue
        fa, fb = np.isfinite(a), np.isfinite(b)
        same_special = (np.isnan(a) & np.isnan(b)) | (a == b)
        nonfinite += int(np.sum(fa != fb) + np.sum(~fa & ~fb & ~same_special))
        both = fa & fb
        if both.any():
            scale = float(np.max(np.abs(b[both])))
            rel = max(rel, float(np.max(np.abs(a[both] - b[both]))) / (scale if scale > 0 else 1.0))
    err = 1.0 if missing or nonfinite else rel
    return err, missing, nonfinite


def compare_maps(prog_layers, prog_position, ref_state: GridMapState,
                 prog_pp: Optional[dict] = None, ref_pp_out: Optional[dict] = None):
    """(numbers compared, counts behind them)."""
    prog = dict(to_numpy(prog_layers), position=np.asarray(prog_position))
    ref = dict(to_numpy(ref_state.layers), position=ref_state.position.detach().cpu().numpy())
    err, missing, nonfinite = compare_arrays(prog, ref)
    numbers = {"state_err": err}
    counts = {"state_missing": missing, "state_nonfinite": nonfinite}
    if ref_pp_out is not None:
        err, missing, nonfinite = compare_arrays(to_numpy(prog_pp or {}), to_numpy(ref_pp_out))
        numbers["pp_err"] = err
        counts.update(pp_missing=missing, pp_nonfinite=nonfinite)
    return numbers, counts


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]): every number within its limit; a
    number without a limit, or a limit without a number, is not correct."""
    rows = [(k, numbers.get(k, float("nan")), limits.get(k, float("nan")))
            for k in sorted(set(numbers) | set(limits))]
    ok = all(np.isfinite(v) and np.isfinite(lim) and v <= lim for _, v, lim in rows)
    return ok, rows
