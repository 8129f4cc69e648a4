"""Structured per-frame metrics and run logging (the port's copy of
``poseestimator_tpu/utils/metrics_log.py``; plain Python and JSON): every
tracking frame produces a record; records stream to JSONL and summarise to
the console."""
from __future__ import annotations

import json
import os
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Optional

import numpy as np


@dataclass
class TemplateMetrics:
    """One template's registration counts, the shape the reference's
    registration helpers define."""

    template_idx: int
    num_correspondences: int
    num_inliers: int
    num_s_inliers: int
    num_t_inliers: int


@dataclass
class FrameMetrics:
    """One tracking-loop frame."""

    frame_id: int
    state: str  # init | track | lost
    timings_ms: dict[str, float] = field(default_factory=dict)
    icp_fitness: float = 0.0
    icp_rmse: float = 0.0
    pose: Optional[list] = None  # 4x4 row-major
    detected: bool = False
    # scalar summaries of the frame's 6x6 Gauss-Newton pose covariance
    # (FrameResult.sigma_*); 0.0 when the frame carried no covariance
    sigma_rot_deg: float = 0.0
    sigma_t_mm: float = 0.0
    extra: dict[str, Any] = field(default_factory=dict)


class MetricsLogger:
    """Append-only JSONL writer + console summaries."""

    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self.records: list[dict] = []
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a")

    def log(self, record) -> None:
        d = asdict(record) if hasattr(record, "__dataclass_fields__") else dict(record)
        d["ts"] = time.time()
        self.records.append(d)
        if self._fh:
            self._fh.write(json.dumps(d) + "\n")
            self._fh.flush()
        if self.echo:
            print(json.dumps(d))

    def summary(self) -> dict:
        """Aggregate timing statistics across logged frames."""
        out: dict[str, Any] = {"frames": len(self.records)}
        stages: dict[str, list] = {}
        for r in self.records:
            for k, v in (r.get("timings_ms") or {}).items():
                stages.setdefault(k, []).append(v)
        for k, vs in stages.items():
            out[f"{k}_ms_mean"] = float(np.mean(vs))
            out[f"{k}_ms_p50"] = float(np.percentile(vs, 50))
            out[f"{k}_ms_p95"] = float(np.percentile(vs, 95))
        states = [r.get("state") for r in self.records]
        for s in ("init", "track", "lost"):
            out[f"n_{s}"] = states.count(s)
        return out

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
