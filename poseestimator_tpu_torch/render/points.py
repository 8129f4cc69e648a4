"""Point-splat z-buffer depth rendering (counterpart of ``render_depth`` in
``poseestimator_tpu/render/points.py``): rigid transform, pinhole projection
rounded half to even (as ``jnp.round``), and a scatter-min z-buffer in which
each point covers a (2 splat + 1)^2 pixel square. The template search
renders the observed cloud with ``splat=0``: every sample claims only its
own pixel, which keeps the sparse observed depth unbiased."""
from __future__ import annotations

import torch

from ..geom3d.camera import Intrinsics
from ..geom3d.se3 import transform_points

_INF = 1e30


def render_depth(points: torch.Tensor, valid: torch.Tensor, T_m2c: torch.Tensor,
                 intr: Intrinsics, near: float = 0.001, far: float = 100.0,
                 splat: int = 1) -> torch.Tensor:
    """(H, W) linear depth of the valid points, 0 where nothing lands."""
    H, W = intr.height, intr.width
    cam = transform_points(T_m2c, points)
    z = cam[:, 2]
    ok = valid & (z > near) & (z < far)
    zs = torch.where(ok, z, torch.ones_like(z))
    # clamped before the integer cast: only the in-image test reads them
    u = torch.round(intr.fx * cam[:, 0] / zs + intr.cx).clamp(-W - splat - 1, 2 * W + splat)
    v = torch.round(intr.fy * cam[:, 1] / zs + intr.cy).clamp(-H - splat - 1, 2 * H + splat)
    u, v = u.to(torch.int64), v.to(torch.int64)
    zbuf = torch.full((H * W + 1,), _INF, dtype=torch.float32, device=points.device)
    for du in range(-splat, splat + 1):
        for dv in range(-splat, splat + 1):
            ui, vi = u + du, v + dv
            in_img = ok & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
            flat = torch.where(in_img, vi * W + ui, torch.full_like(ui, H * W))  # spill slot
            zbuf.scatter_reduce_(0, flat, torch.where(in_img, z, torch.full_like(z, _INF)), "amin")
    depth = zbuf[: H * W].reshape(H, W)
    return torch.where(depth >= _INF * 0.5, torch.zeros_like(depth), depth)
