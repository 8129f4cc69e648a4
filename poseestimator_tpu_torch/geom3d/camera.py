"""Pinhole camera model and depth back-projection (counterpart of
``poseestimator_tpu/geom3d/camera.py``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .cloud import PointCloud


@dataclass(frozen=True)
class Intrinsics:
    """Pinhole intrinsics (fx, fy, cx, cy in pixels; width, height)."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            np.float32,
        )

    @classmethod
    def from_K(cls, K, width: int, height: int) -> "Intrinsics":
        K = np.asarray(K).reshape(3, 3)
        return cls(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                   cy=float(K[1, 2]), width=int(width), height=int(height))

    @classmethod
    def from_fov(cls, fov_deg: float, width: int, height: int) -> "Intrinsics":
        """fx = fy = 0.5 W / tan(fov / 2), principal point at the centre."""
        f = 0.5 * width / np.tan(np.deg2rad(fov_deg) / 2.0)
        return cls(fx=f, fy=f, cx=width / 2.0, cy=height / 2.0,
                   width=width, height=height)

    def scaled(self, r: int) -> "Intrinsics":
        """The same camera at 1/r resolution (the tracking render view)."""
        return Intrinsics(fx=self.fx / r, fy=self.fy / r, cx=self.cx / r,
                          cy=self.cy / r, width=self.width // r,
                          height=self.height // r)


def backproject_depth(
    depth: torch.Tensor,
    intr: Intrinsics,
    mask: Optional[torch.Tensor] = None,
    depth_min: float = 1e-6,
    depth_max: float = float("inf"),
    origin: Optional[torch.Tensor] = None,
    color: Optional[torch.Tensor] = None,
) -> PointCloud:
    """Depth image (H, W) in metres -> camera-frame cloud of capacity H*W.

    ``x = (u - cx) z / fx, y = (v - cy) z / fy``; pixels outside
    (depth_min, depth_max) or with ``mask == 0`` are invalid (and zeroed).
    ``origin`` (2,) ``(ox, oy)``: ``depth`` is a window of the full image whose
    pixel (0, 0) sits at full-image pixel (ox, oy).
    """
    H, W = depth.shape
    dev = depth.device
    depth = depth.to(torch.float32)
    u = torch.arange(W, dtype=torch.float32, device=dev).expand(H, W)
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    if origin is not None:
        origin = origin.to(torch.float32)
        u = u + origin[0]
        v = v + origin[1]
    z = depth
    x = (u - intr.cx) * z / intr.fx
    y = (v - intr.cy) * z / intr.fy
    pts = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    valid = (depth > depth_min) & (depth < depth_max)
    if mask is not None:
        valid = valid & (mask != 0)
    valid = valid.reshape(-1)
    cols = None
    if color is not None:
        scale = 1.0 if color.is_floating_point() else 255.0
        cols = color.reshape(-1, 3).to(torch.float32) / scale
    return PointCloud(points=pts * valid[:, None], valid=valid, colors=cols)


def project_points(points: torch.Tensor, K: torch.Tensor, T_m2c: torch.Tensor):
    """Pixels of (N, 3) model points under one (4, 4) pose or a (..., 4, 4)
    stack: ``(uv (..., N, 2), in_front (..., N) bool)``. Points at z <= 0 in
    the camera frame are masked (their uv divide by 1), not dropped."""
    pc = points @ T_m2c[..., :3, :3].transpose(-1, -2) + T_m2c[..., None, :3, 3]
    z = pc[..., 2]
    in_front = z > 0
    zs = torch.where(in_front, z, torch.ones_like(z))
    u = K[0, 0] * pc[..., 0] / zs + K[0, 2]
    v = K[1, 1] * pc[..., 1] / zs + K[1, 2]
    return torch.stack([u, v], dim=-1), in_front


def project_points_distorted(points: torch.Tensor, K: torch.Tensor, D: torch.Tensor,
                             T: torch.Tensor):
    """Brown-Conrady projection of (N, 3) points under the (4, 4) pose
    ``T``, as ``cv2.projectPoints`` with a 4-, 5- or 8-term ``D`` (k1, k2,
    p1, p2[, k3[, k4, k5, k6]]): ``(uv (N, 2), in_front (N,) bool)``."""
    pc = points @ T[:3, :3].T + T[:3, 3]
    z = pc[:, 2]
    in_front = z > 0.0
    zs = torch.where(z.abs() > 1e-12, z, torch.ones_like(z))
    xp, yp = pc[:, 0] / zs, pc[:, 1] / zs
    d = torch.zeros(8, dtype=points.dtype, device=points.device)
    D = D.reshape(-1).to(points.dtype)[:8]
    d[:D.numel()] = D
    k1, k2, p1, p2, k3, k4, k5, k6 = d
    r2 = xp * xp + yp * yp
    r4, r6 = r2 * r2, r2 * r2 * r2
    radial = (1 + k1 * r2 + k2 * r4 + k3 * r6) / (1 + k4 * r2 + k5 * r4 + k6 * r6)
    x2 = xp * radial + 2 * p1 * xp * yp + p2 * (r2 + 2 * xp * xp)
    y2 = yp * radial + p1 * (r2 + 2 * yp * yp) + 2 * p2 * xp * yp
    return torch.stack([K[0, 0] * x2 + K[0, 2], K[1, 1] * y2 + K[1, 2]], dim=-1), in_front
