"""Configuration for the PyTorch port: the JAX package's config module itself.

``fastdem_tpu/config/config.py`` imports only the standard library, so the
port loads that one file by path instead of copying it. Importing it as
``fastdem_tpu.config.config`` would run ``fastdem_tpu/__init__.py``, which
imports JAX; loading by path never touches the JAX package's ``__init__``.

The classes defined here are therefore distinct objects from the JAX
package's ``Config`` and enums (``MappingMode.LOCAL`` of one package is not
equal to the other's): build one config per package, never hand one
package's ``Config`` to the other.
"""

from __future__ import annotations

import importlib.util
import os
import sys

_SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "fastdem_tpu",
    "config",
    "config.py",
)
_MODULE_NAME = "fastdem_tpu_torch._shared_config"


def _load_shared_config():
    mod = sys.modules.get(_MODULE_NAME)
    if mod is not None:
        return mod
    spec = importlib.util.spec_from_file_location(_MODULE_NAME, _SOURCE)
    mod = importlib.util.module_from_spec(spec)
    # dataclasses resolves annotations through sys.modules[cls.__module__].
    sys.modules[_MODULE_NAME] = mod
    spec.loader.exec_module(mod)
    return mod


_shared = _load_shared_config()

FLOAT_MAX = _shared.FLOAT_MAX
MappingMode = _shared.MappingMode
EstimationType = _shared.EstimationType
SensorType = _shared.SensorType
RasterMethod = _shared.RasterMethod
PointFilterConfig = _shared.PointFilterConfig
KalmanConfig = _shared.KalmanConfig
P2Config = _shared.P2Config
MappingConfig = _shared.MappingConfig
LiDARSensorConfig = _shared.LiDARSensorConfig
RGBDSensorConfig = _shared.RGBDSensorConfig
ConstantSensorConfig = _shared.ConstantSensorConfig
SensorModelConfig = _shared.SensorModelConfig
RaycastingConfig = _shared.RaycastingConfig
Config = _shared.Config
PostProcessConfig = _shared.PostProcessConfig
InpaintingConfig = _shared.InpaintingConfig
UncertaintyFusionConfig = _shared.UncertaintyFusionConfig
FeatureExtractionConfig = _shared.FeatureExtractionConfig
parse_config = _shared.parse_config
validate = _shared.validate
load_config = _shared.load_config
