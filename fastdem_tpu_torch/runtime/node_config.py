"""The node's configuration in one mapping (port of
``fastdem_tpu/runtime/node_config.py``).

The reference node's NodeConfig: topics, tf, map geometry, logger and
visualization, plus the embedded library and post-processing configs,
parsed with the same keys and the same node-level validation (it raises on
invalid geometry or rates). ``from_preset(name)`` reads one of the port's
presets (``fastdem_tpu_torch.presets``, no PyYAML); ``load(path)`` reads a
YAML file and needs PyYAML.
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping

from fastdem_tpu_torch import presets
from fastdem_tpu_torch.config import (
    Config,
    PostProcessConfig,
    parse_config,
    parse_postprocess,
    read_yaml,
)


@dataclasses.dataclass
class TopicsConfig:
    input_scans: List[str] = dataclasses.field(
        default_factory=lambda: ["/points"]
    )
    publish_rate: float = 10.0
    global_publish_rate: float = 1.0
    post_process_rate: float = 2.0


@dataclasses.dataclass
class TFConfig:
    base_frame: str = "base_link"
    map_frame: str = "map"
    max_wait_time: float = 0.1
    max_stale_time: float = 0.1


@dataclasses.dataclass
class MapGeomConfig:
    width: float = 15.0
    height: float = 15.0
    resolution: float = 0.1


@dataclasses.dataclass
class NormalsVizConfig:
    arrow_length: float = 0.15
    stride: int = 1


@dataclasses.dataclass
class NodeConfig:
    logger_level: str = "info"
    topics: TopicsConfig = dataclasses.field(default_factory=TopicsConfig)
    tf: TFConfig = dataclasses.field(default_factory=TFConfig)
    map: MapGeomConfig = dataclasses.field(default_factory=MapGeomConfig)
    pipeline: Config = dataclasses.field(default_factory=Config)
    postprocess: PostProcessConfig = dataclasses.field(
        default_factory=PostProcessConfig
    )
    normals_viz: NormalsVizConfig = dataclasses.field(
        default_factory=NormalsVizConfig
    )

    @staticmethod
    def parse(root: Mapping) -> "NodeConfig":
        cfg = NodeConfig()
        n = root.get("topics") or {}
        if "input_scans" in n:
            cfg.topics.input_scans = [str(s) for s in n["input_scans"]]
        for key in ("publish_rate", "global_publish_rate", "post_process_rate"):
            if key in n:
                setattr(cfg.topics, key, float(n[key]))
        n = root.get("tf") or {}
        for key, cast in (
            ("base_frame", str), ("map_frame", str),
            ("max_wait_time", float), ("max_stale_time", float),
        ):
            if key in n:
                setattr(cfg.tf, key, cast(n[key]))
        n = root.get("logger") or {}
        if "level" in n:
            cfg.logger_level = str(n["level"])
        n = root.get("map") or {}
        for key in ("width", "height", "resolution"):
            if key in n:
                setattr(cfg.map, key, float(n[key]))
        n = root.get("visualization") or {}
        nm = (n.get("feature_extraction") or {}).get("normals") or {}
        if "arrow_length" in nm:
            cfg.normals_viz.arrow_length = float(nm["arrow_length"])
        if "stride" in nm:
            cfg.normals_viz.stride = int(nm["stride"])

        cfg.pipeline = parse_config(root)
        cfg.postprocess = parse_postprocess(root)
        cfg.validate()
        return cfg

    @staticmethod
    def load(path: str) -> "NodeConfig":
        """Parse a YAML file (needs PyYAML)."""
        if not path:
            raise ValueError("config_file path is empty")
        return NodeConfig.parse(read_yaml(path) or {})

    @staticmethod
    def from_preset(name: str) -> "NodeConfig":
        """Parse the preset ``name`` (needs no PyYAML)."""
        return NodeConfig.parse(presets.get(name))

    def validate(self) -> None:
        """Node-level validation (raises, as the reference node does)."""
        if not self.topics.input_scans:
            raise ValueError("input_scans must not be empty")
        if (
            self.map.width <= 0
            or self.map.height <= 0
            or self.map.resolution <= 0
        ):
            raise ValueError(
                f"Invalid map geometry (all must be > 0): width="
                f"{self.map.width}, height={self.map.height}, resolution="
                f"{self.map.resolution}"
            )
        if self.topics.publish_rate <= 0:
            raise ValueError(
                f"Invalid publish_rate: {self.topics.publish_rate}"
            )
        if self.topics.global_publish_rate <= 0:
            raise ValueError(
                f"Invalid global_publish_rate: {self.topics.global_publish_rate}"
            )
        if self.tf.max_wait_time < 0:
            raise ValueError(f"Invalid max_wait_time: {self.tf.max_wait_time}")
        if self.tf.max_stale_time < 0:
            raise ValueError(
                f"Invalid max_stale_time: {self.tf.max_stale_time}"
            )

    def make_driver(self, *, device="cuda", **kwargs):
        """A MappingDriver from this config, on ``device``."""
        from fastdem_tpu_torch.grid.geometry import GridGeometry
        from fastdem_tpu_torch.runtime.driver import MappingDriver

        geom = GridGeometry.from_length(
            self.map.width, self.map.height, self.map.resolution
        )
        return MappingDriver(
            geom,
            self.pipeline,
            postprocess_cfg=self.postprocess,
            postprocess_rate=self.topics.post_process_rate,
            viz_rate=self.topics.publish_rate,
            global_rate=self.topics.global_publish_rate,
            global_window=(self.map.width, self.map.height),
            device=device,
            **kwargs,
        )
