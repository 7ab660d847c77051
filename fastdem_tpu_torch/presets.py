"""The node and library presets as Python dicts, so that the port needs no
PyYAML to use them.

Each entry equals ``yaml.safe_load`` of the same-named file under
``fastdem_tpu/config/presets/`` (``tests/test_torch_runtime.py`` holds them
to it). ``get(name)`` returns a fresh deep copy.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

PRESETS: Dict[str, Dict[str, Any]] = {
    "default": {
        "mapping": {
            "mode": "local",
            "type": "kalman_filter",
            "kalman": {
                "min_variance": 0.0001,
                "max_variance": 0.01,
                "process_noise": 0.0,
            },
            "p2": {
                "dn0": 0.01,
                "dn1": 0.16,
                "dn2": 0.5,
                "dn3": 0.84,
                "dn4": 0.99,
                "elevation_marker": 3,
                "max_sample_count": 0,
            },
        },
        "point_filter": {
            "z_min": -1.0,
            "z_max": 2.0,
            "range_min": 0.5,
            "range_max": 20.0,
        },
        "sensor_model": {
            "type": "lidar",
            "lidar": {
                "range_noise": 0.02,
                "angular_noise": 0.001,
            },
            "rgbd": {
                "normal_a": 0.001,
                "normal_b": 0.002,
                "normal_c": 0.4,
                "lateral_factor": 0.001,
            },
            "constant": {
                "uncertainty": 0.03,
            },
        },
        "raycasting": {
            "enabled": True,
            "height_conflict_threshold": 0.05,
            "log_odds_observed": 0.4,
            "log_odds_ghost": 0.2,
            "log_odds_max": 2.0,
            "clear_threshold": -1.0,
        },
    },
    "global_mapping": {
        "mapping": {
            "mode": "global",
            "type": "kalman_filter",
            "kalman": {
                "min_variance": 0.0001,
                "max_variance": 0.01,
                "process_noise": 0.0,
            },
            "p2": {
                "dn0": 0.01,
                "dn1": 0.16,
                "dn2": 0.5,
                "dn3": 0.84,
                "dn4": 0.99,
                "elevation_marker": 3,
                "max_sample_count": 0,
            },
        },
        "point_filter": {
            "z_min": -1.0,
            "z_max": 2.0,
            "range_min": 0.5,
            "range_max": 20.0,
        },
        "sensor_model": {
            "type": "lidar",
            "lidar": {
                "range_noise": 0.02,
                "angular_noise": 0.001,
            },
            "rgbd": {
                "normal_a": 0.001,
                "normal_b": 0.002,
                "normal_c": 0.4,
                "lateral_factor": 0.001,
            },
            "constant": {
                "uncertainty": 0.03,
            },
        },
        "raycasting": {
            "enabled": False,
            "height_conflict_threshold": 0.05,
            "log_odds_observed": 0.4,
            "log_odds_ghost": 0.2,
            "log_odds_max": 2.0,
            "clear_threshold": -1.0,
        },
    },
    "global_mapping_node": {
        "logger": {
            "level": "info",
        },
        "topics": {
            "input_scans": ["/points"],
            "publish_rate": 10.0,
            "global_publish_rate": 1.0,
            "post_process_rate": 2.0,
        },
        "tf": {
            "base_frame": "base_link",
            "map_frame": "map",
            "max_wait_time": 0.1,
            "max_stale_time": 0.1,
        },
        "map": {
            "width": 200.0,
            "height": 200.0,
            "resolution": 0.1,
        },
        "mapping": {
            "mode": "global",
            "type": "kalman_filter",
        },
        "point_filter": {
            "z_min": -1.0,
            "z_max": 2.0,
            "range_min": 0.5,
            "range_max": 20.0,
        },
        "sensor_model": {
            "type": "lidar",
        },
        "raycasting": {
            "enabled": False,
        },
        "inpainting": {
            "enabled": False,
            "max_iterations": 3,
            "min_valid_neighbors": 2,
        },
        "uncertainty_fusion": {
            "enabled": False,
        },
        "feature_extraction": {
            "enabled": False,
        },
        "visualization": {
            "feature_extraction": {
                "normals": {
                    "arrow_length": 0.15,
                    "stride": 2,
                },
            },
        },
    },
    "local_mapping": {
        "logger": {
            "level": "info",
        },
        "topics": {
            "input_scans": ["/points"],
            "publish_rate": 10.0,
            "global_publish_rate": 1.0,
            "post_process_rate": 2.0,
        },
        "tf": {
            "base_frame": "base_link",
            "map_frame": "map",
            "max_wait_time": 0.1,
            "max_stale_time": 0.1,
        },
        "map": {
            "width": 15.0,
            "height": 15.0,
            "resolution": 0.1,
        },
        "mapping": {
            "mode": "local",
            "type": "kalman_filter",
        },
        "point_filter": {
            "z_min": -1.0,
            "z_max": 2.0,
            "range_min": 0.5,
            "range_max": 20.0,
        },
        "sensor_model": {
            "type": "lidar",
        },
        "raycasting": {
            "enabled": True,
        },
        "inpainting": {
            "enabled": True,
            "max_iterations": 3,
            "min_valid_neighbors": 2,
        },
        "uncertainty_fusion": {
            "enabled": True,
        },
        "feature_extraction": {
            "enabled": True,
        },
        "visualization": {
            "feature_extraction": {
                "normals": {
                    "arrow_length": 0.15,
                    "stride": 2,
                },
            },
        },
    },
    "local_mapping_fast": {
        "logger": {
            "level": "info",
        },
        "topics": {
            "input_scans": ["/points"],
            "publish_rate": 10.0,
            "global_publish_rate": 1.0,
            "post_process_rate": 2.0,
        },
        "tf": {
            "base_frame": "base_link",
            "map_frame": "map",
            "max_wait_time": 0.1,
            "max_stale_time": 0.1,
        },
        "map": {
            "width": 15.0,
            "height": 15.0,
            "resolution": 0.1,
        },
        "mapping": {
            "mode": "local",
            "type": "kalman_filter",
        },
        "point_filter": {
            "z_min": -1.0,
            "z_max": 2.0,
            "range_min": 0.5,
            "range_max": 20.0,
        },
        "sensor_model": {
            "type": "lidar",
        },
        "raycasting": {
            "enabled": True,
            "voxel_count_mode": "span",
            "range_bin_factor": 0.5,
            "num_azimuth_bins": 1024,
        },
        "inpainting": {
            "enabled": True,
            "max_iterations": 3,
            "min_valid_neighbors": 2,
        },
        "uncertainty_fusion": {
            "enabled": True,
        },
        "feature_extraction": {
            "enabled": True,
        },
    },
    "postprocess": {
        "inpainting": {
            "enabled": False,
            "max_iterations": 3,
            "min_valid_neighbors": 2,
        },
        "uncertainty_fusion": {
            "enabled": True,
            "search_radius": 0.15,
            "spatial_sigma": 0.05,
            "quantile_lower": 0.01,
            "quantile_upper": 0.99,
            "min_valid_neighbors": 3,
        },
        "feature_extraction": {
            "enabled": False,
            "analysis_radius": 0.3,
            "min_valid_neighbors": 4,
            "step_lower_percentile": 0.05,
            "step_upper_percentile": 0.95,
        },
    },
}


def names():
    """The preset names, sorted."""
    return sorted(PRESETS)


def get(name: str) -> Dict[str, Any]:
    """A deep copy of the preset ``name`` (the file name without .yaml)."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; known: {', '.join(names())}")
    return copy.deepcopy(PRESETS[name])
