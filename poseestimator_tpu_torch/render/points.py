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


def render_shaded(points: torch.Tensor, normals: torch.Tensor, valid: torch.Tensor,
                  T_m2c: torch.Tensor, intr: Intrinsics, base_color=(0.0, 0.0, 1.0),
                  near: float = 0.001, far: float = 100.0, splat: int = 1):
    """Depth plus a headlight Lambertian colour image: ``(depth (H, W), rgb
    (H, W, 3) float32 in [0, 1], white background)``. Points that won (or
    nearly won) the z-buffer shade their own pixel; where several do, the
    last of them by point index writes (a fixed rule: the JAX package
    leaves the winner among duplicate writes unspecified)."""
    H, W = intr.height, intr.width
    depth = render_depth(points, valid, T_m2c, intr, near, far, splat)
    cam = transform_points(T_m2c, points)
    z = cam[:, 2]
    ok = valid & (z > near) & (z < far)
    zs = torch.where(ok, z, torch.ones_like(z))
    u = torch.round(intr.fx * cam[:, 0] / zs + intr.cx).clamp(-1, W)
    v = torch.round(intr.fy * cam[:, 1] / zs + intr.cy).clamp(-1, H)
    u, v = u.to(torch.int64), v.to(torch.int64)
    in_img = ok & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    flat = torch.where(in_img, v * W + u, torch.full_like(u, H * W))
    won = in_img & (z <= depth.reshape(-1)[flat.clamp(max=H * W - 1)] + 1e-4)
    n_cam = normals @ T_m2c[:3, :3].T
    lambert = torch.clamp(-n_cam[:, 2], 0.15, 1.0)  # headlight along +z
    base = torch.as_tensor(base_color, dtype=torch.float32, device=points.device)
    # the last winning point by index owns each pixel
    slot = torch.where(won, flat, torch.full_like(flat, H * W))
    owner = torch.full((H * W + 1,), -1, dtype=torch.int64, device=points.device)
    owner.scatter_reduce_(0, slot, torch.arange(points.shape[0], device=points.device), "amax")
    owner = owner[: H * W]
    shade = lambert[owner.clamp(min=0)][:, None] * base[None, :]
    img = torch.where((owner >= 0)[:, None], shade, torch.ones_like(shade))
    return depth, img.reshape(H, W, 3)
