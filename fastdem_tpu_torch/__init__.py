"""fastdem_tpu_torch: the FastDEM elevation mapper on PyTorch and CUDA.

The PyTorch port of ``fastdem_tpu`` (which stays the reference it is
tested against). It imports ``torch`` and never JAX. It runs the
integrate path -- LOCAL and windowed GLOBAL maps, LiDAR / RGB-D /
constant noise models, the row-scatter rasterizer, the Kalman and P^2
estimators, and the polar raycast, whose dense field tail and per-cell
lookup are the hand-written CUDA kernels K1 (ops/polar_field.py) and K4
(ops/resample.py) on a CUDA device, or the sampled raycast -- and the
post-processing chain (``postprocess.apply_postprocess_fn``).

    import fastdem_tpu_torch as fd
    geom = fd.GridGeometry.from_length(15.0, 15.0, 0.1)
    cfg = fd.Config()
    cfg.raycasting.enabled = True
    mapper = fd.FastDEM(geom, cfg, device="cuda")
    mapper.integrate(fd.cloud.from_numpy(xyz, frame_id="lidar", device="cuda"), T_bs, T_wb)
"""

__version__ = "0.1.0"

from fastdem_tpu_torch import cloud  # noqa: F401
from fastdem_tpu_torch.cloud import pointcloud  # noqa: F401
from fastdem_tpu_torch.config import (  # noqa: F401
    Config,
    EstimationType,
    MappingMode,
    PostProcessConfig,
    SensorType,
    parse_config,
)
from fastdem_tpu_torch.grid import gridmap  # noqa: F401
from fastdem_tpu_torch.grid.geometry import GridGeometry  # noqa: F401
from fastdem_tpu_torch.grid.gridmap import GridMapState, layers  # noqa: F401
from fastdem_tpu_torch.interop import state_from_numpy, state_to_numpy  # noqa: F401
from fastdem_tpu_torch.mapping.pipeline import (  # noqa: F401
    FastDEM,
    build_integrate,
    create_map_state,
)
