"""Post-processing: uncertainty fusion, inpainting, features (frozen copy
of the port's ``postprocess/__init__.py``).

``apply_postprocess_fn`` is the reference node's asynchronous chain: on a
snapshot of {elevation, upper_bound, lower_bound} run uncertainty fusion,
then inpainting (in place), then feature extraction, and derive
uncertainty_range = upper - lower. It runs on the device of the tensors it
is given, as plain PyTorch ops.
"""

from __future__ import annotations

from typing import Dict

import torch

from .features import extract_features
from .inpainting import inpaint
from .uncertainty_fusion import fuse_bounds


def apply_postprocess_fn(geom, cfg):
    """Build the snapshot post-processing function for a
    ``PostProcessConfig``.

    Returns run(elevation, upper, lower) -> dict of output layers; feature
    layers are NaN where the feature guards fail.
    """

    def run(elevation, upper, lower) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        if cfg.uncertainty_fusion.enabled:
            upper, lower = fuse_bounds(
                upper, lower, cfg.uncertainty_fusion, geom.resolution
            )
        if cfg.inpainting.enabled:
            elevation = inpaint(
                elevation,
                cfg.inpainting.max_iterations,
                cfg.inpainting.min_valid_neighbors,
            )
        out["elevation"] = elevation
        out["upper_bound"] = upper
        out["lower_bound"] = lower
        out["uncertainty_range"] = upper - lower
        if cfg.feature_extraction.enabled:
            feats = extract_features(
                elevation, cfg.feature_extraction, geom.resolution
            )
            ok = feats.pop("ok")
            for k, v in feats.items():
                out[k] = torch.where(ok, v, float("nan"))
        return out

    return run
