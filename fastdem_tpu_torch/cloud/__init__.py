"""Point clouds: the fixed-capacity container, SE(3) transforms, neighbour
search, filters and depth images."""

from fastdem_tpu_torch.cloud import depth, filters, pointcloud, search, transform  # noqa: F401
from fastdem_tpu_torch.cloud.pointcloud import (  # noqa: F401
    PointCloud,
    compact_to_bucket,
    from_numpy,
    ladder_capacity,
)
