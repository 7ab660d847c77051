"""Point clouds: the fixed-capacity container, SE(3) transforms, neighbour
search, filters, depth images, normals, segmentation and registration."""

from fastdem_tpu_torch.cloud import (  # noqa: F401
    depth,
    filters,
    normals,
    pointcloud,
    registration,
    search,
    segmentation,
    transform,
)
from fastdem_tpu_torch.cloud.pointcloud import (  # noqa: F401
    PointCloud,
    compact_to_bucket,
    from_numpy,
    ladder_capacity,
)
