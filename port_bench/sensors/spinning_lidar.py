"""A spinning multi-beam LiDAR (a Velodyne VLP-16 in the configurations):
``beams`` beams at elevations ``elevation_min_deg + i * elevation_step_deg``,
fired every ``azimuth_step_deg`` of a revolution. Ranges carry Gaussian
noise of ``range_noise_m``; a ray that hits nothing within ``max_range_m``
returns nothing and is dropped, as a driver delivers it. Points are in the
sensor frame, azimuth-major, xyz only."""

import numpy as np
import torch


def directions(sensor: dict) -> np.ndarray:
    """Unit directions f64 [A * beams, 3] in the sensor frame, azimuth-major."""
    beams = int(sensor["beams"])
    el = np.radians(sensor["elevation_min_deg"] + sensor["elevation_step_deg"] * np.arange(beams))
    n_az = int(round(360.0 / float(sensor["azimuth_step_deg"])))
    az = np.radians(float(sensor["azimuth_step_deg"]) * np.arange(n_az))
    ce, se = np.cos(el)[None, :], np.sin(el)[None, :]
    d = np.stack(
        [ce * np.cos(az)[:, None], ce * np.sin(az)[:, None], np.broadcast_to(se, (n_az, beams))],
        axis=-1,
    )
    return d.reshape(-1, 3)


def returns(t: torch.Tensor, d: torch.Tensor, sensor: dict, gen: torch.Generator):
    """The points (f32 [c, M, 3], sensor frame) of rays whose first hit is
    ``t`` metres away (inf where none), and which rays return."""
    noise = torch.randn(t.shape, generator=gen, dtype=t.dtype, device=t.device)
    noise = noise * float(sensor["range_noise_m"])
    keep = t <= float(sensor["max_range_m"])
    return (t + noise)[..., None] * d[None], keep
