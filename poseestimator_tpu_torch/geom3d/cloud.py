"""Fixed-shape point cloud (counterpart of
``poseestimator_tpu/geom3d/cloud.py``): padded ``(N, 3)`` points plus a
validity mask. "Removing" points clears mask bits; "downsampling" gathers
into a smaller padded buffer, so every shape in the tracking step is static.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from .se3 import transform_points


@dataclass
class PointCloud:
    """``points[i]`` is meaningful iff ``valid[i]``; invalid rows stay finite."""

    points: torch.Tensor  # (N, 3) float32
    valid: torch.Tensor  # (N,) bool

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def count(self) -> torch.Tensor:
        """Number of valid points (0-d int tensor on the cloud's device)."""
        return self.valid.sum()

    def transform(self, T: torch.Tensor) -> "PointCloud":
        return replace(self, points=transform_points(T, self.points))

    def mask_where(self, keep: torch.Tensor) -> "PointCloud":
        """Intersect the validity mask with ``keep`` (no data movement)."""
        return replace(self, valid=self.valid & keep)
