"""Runtime (port of ``fastdem_tpu/runtime``): providers, the streaming
driver, the node config, bridges and wire codecs."""

from fastdem_tpu_torch.runtime.driver import MappingDriver  # noqa: F401
from fastdem_tpu_torch.runtime.node_config import NodeConfig  # noqa: F401
from fastdem_tpu_torch.runtime.providers import (  # noqa: F401
    Calibration,
    Odometry,
    StaticCalibration,
    StaticOdometry,
    TransformBuffer,
)
