"""Point clouds: the fixed-capacity container and SE(3) transforms."""

from fastdem_tpu_torch.cloud import pointcloud, transform  # noqa: F401
from fastdem_tpu_torch.cloud.pointcloud import (  # noqa: F401
    PointCloud,
    compact_to_bucket,
    from_numpy,
    ladder_capacity,
)
