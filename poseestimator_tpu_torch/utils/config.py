"""One dataclass configuration tree for the whole pipeline (counterpart of
``poseestimator_tpu/utils/config.py``): ``PipelineConfig`` loads from a
YAML file and dotted keyword overrides, and saves back to YAML, through
the port's own YAML reader and writer (``utils/yaml_subset.py``)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

from . import yaml_subset


@dataclass
class DetectorConfig:
    weights: str = "./data/best.pt"
    nc: int = 5
    scale: str = "n"
    imgsz: int = 640
    conf: float = 0.7
    iou: float = 0.7
    max_det: int = 32
    class_id: int = 0


@dataclass
class EstimatorConfig:
    cad_path: str = "./data/obj_000001.ply"
    pcd_path: str = "./data/lego_views/"
    target_points: int = 100
    voxel_size: float = 0.05


@dataclass
class TrackerConfig:
    target_pts: int = 100
    track_every: int = 1
    max_misses: int = 5
    warmup_frames: int = 10
    icp_dist: float = 0.01


@dataclass
class CameraConfig:
    source: str = "realsense"  # realsense | replay:<dir> | synthetic
    width: int = 640
    height: int = 480
    fps: int = 30
    filter_depth: bool = True


@dataclass
class PipelineConfig:
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    estimator: EstimatorConfig = field(default_factory=EstimatorConfig)
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    camera: CameraConfig = field(default_factory=CameraConfig)
    metrics_path: Optional[str] = None
    profile_dir: Optional[str] = None


_SECTIONS = {"detector": DetectorConfig, "estimator": EstimatorConfig,
             "tracker": TrackerConfig, "camera": CameraConfig}


def _from_dict(cls, data: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in data:
            v = data[f.name]
            kwargs[f.name] = _from_dict(_SECTIONS[f.name], v) if f.name in _SECTIONS and \
                cls is PipelineConfig else v
    return cls(**kwargs)


def load_config(path: Optional[str] = None, **overrides) -> PipelineConfig:
    """A ``PipelineConfig`` from a YAML file (defaults for what it omits),
    then flat dotted overrides, e.g. ``load_config(p,
    **{"tracker.icp_dist": 0.05})``; an unknown key raises ``KeyError``."""
    data = (yaml_subset.load(path) or {}) if path else {}
    cfg = _from_dict(PipelineConfig, data)
    for key, value in overrides.items():
        obj = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        if not hasattr(obj, parts[-1]):
            raise KeyError(f"unknown config key {key}")
        setattr(obj, parts[-1], value)
    return cfg


def save_config(cfg: PipelineConfig, path: str) -> None:
    """Write ``cfg`` as block YAML, fields in declaration order."""
    yaml_subset.dump(dataclasses.asdict(cfg), path)
