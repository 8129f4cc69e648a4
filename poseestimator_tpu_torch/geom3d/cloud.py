"""Fixed-shape point cloud (counterpart of
``poseestimator_tpu/geom3d/cloud.py``): padded ``(N, 3)`` points plus a
validity mask. "Removing" points clears mask bits; "downsampling" gathers
into a smaller padded buffer, so every shape in the tracking step is static.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .se3 import transform_points


@dataclass
class PointCloud:
    """``points[i]`` is meaningful iff ``valid[i]``; invalid rows stay finite."""

    points: torch.Tensor  # (N, 3) float32
    valid: torch.Tensor  # (N,) bool
    normals: Optional[torch.Tensor] = None  # (N, 3) float32 unit, or None
    colors: Optional[torch.Tensor] = None  # (N, 3) float32 in [0, 1], or None

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def count(self) -> torch.Tensor:
        """Number of valid points (0-d int tensor on the cloud's device)."""
        return self.valid.sum()

    def centroid(self) -> torch.Tensor:
        """Mean of the valid points; zeros for an empty cloud."""
        return centroid(self.points, self.valid)

    def transform(self, T: torch.Tensor) -> "PointCloud":
        normals = None if self.normals is None else self.normals @ T[:3, :3].T
        return replace(self, points=transform_points(T, self.points), normals=normals)

    def mask_where(self, keep: torch.Tensor) -> "PointCloud":
        """Intersect the validity mask with ``keep`` (no data movement)."""
        return replace(self, valid=self.valid & keep)


def centroid(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean of the valid rows of ``points`` (..., N, 3) -> (..., 3)."""
    w = valid.to(points.dtype)
    n = torch.clamp(w.sum(-1), min=1.0)
    return (points * w[..., None]).sum(-2) / n[..., None]


def compact(cloud: PointCloud, capacity: int) -> PointCloud:
    """Gather the valid points, in order, to the front of a ``capacity``-row
    buffer; valid points beyond ``capacity`` are dropped."""
    order = torch.argsort((~cloud.valid).to(torch.uint8), stable=True)
    take_n = min(capacity, cloud.capacity)
    idx = order[:take_n]
    pad = capacity - take_n

    def take(a):
        if a is None:
            return None
        g = a[idx]
        if pad:
            g = torch.cat([g, g.new_zeros((pad,) + g.shape[1:])])
        return g

    n_valid = torch.clamp(cloud.count(), max=capacity)
    new_valid = torch.arange(capacity, device=cloud.points.device) < n_valid
    return PointCloud(points=take(cloud.points) * new_valid[:, None].to(cloud.points.dtype),
                      valid=new_valid, normals=take(cloud.normals), colors=take(cloud.colors))


def from_points(points, capacity: Optional[int] = None, colors=None, normals=None,
                device: str | torch.device = "cuda") -> PointCloud:
    """A cloud of the dense (n, 3) ``points`` padded to ``capacity`` rows
    (default n) on ``device``; ``colors`` and ``normals`` (n, 3) alike."""
    dev = resolve_device(device)

    def as_rows(a):
        return torch.as_tensor(np.asarray(a, np.float32) if not torch.is_tensor(a) else a,
                               dtype=torch.float32, device=dev).reshape(-1, 3)

    pts = as_rows(points)
    n = pts.shape[0]
    cap = n if capacity is None else int(capacity)
    if cap < n:
        raise ValueError(f"capacity {cap} < number of points {n}")

    def pad(a):
        if a is None:
            return None
        return torch.cat([as_rows(a), pts.new_zeros((cap - n, 3))])

    valid = torch.arange(cap, device=dev) < n
    return PointCloud(points=pad(pts), valid=valid, normals=pad(normals), colors=pad(colors))


def bounding_box(cloud: PointCloud):
    """``(min_bound, max_bound)`` (3,) over the valid points; zeros when
    there is none."""
    v = cloud.valid[:, None]
    big = torch.full_like(cloud.points, 1e30)
    lo = torch.where(v, cloud.points, big).amin(0)
    hi = torch.where(v, cloud.points, -big).amax(0)
    zero = torch.zeros_like(lo)
    any_valid = cloud.valid.any()
    return torch.where(any_valid, lo, zero), torch.where(any_valid, hi, zero)


def to_numpy(cloud: PointCloud) -> np.ndarray:
    """The valid points as a dense (n_valid, 3) numpy array."""
    return cloud.points[cloud.valid].cpu().numpy()
