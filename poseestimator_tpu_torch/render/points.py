"""Point-splat z-buffer depth rendering (counterpart of ``render_depth``,
``vsd_metric``, ``vsd_multi_tau`` and ``render_shaded`` in
``poseestimator_tpu/render/points.py``): rigid transform, pinhole projection
rounded half to even (as ``jnp.round``), and a scatter-min z-buffer in which
each point covers a (2 splat + 1)^2 pixel square. The template search
renders the observed cloud with ``splat=0``: every sample claims only its
own pixel, which keeps the sparse observed depth unbiased. The BOP
evaluation's VSD renders the CAD's points at the two poses."""
from __future__ import annotations

from typing import Optional

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


def vsd_metric(T_est: torch.Tensor, T_gt: torch.Tensor, points: torch.Tensor,
               valid: torch.Tensor, intr: Intrinsics, tau: float = 0.02,
               scene_depth: Optional[torch.Tensor] = None, delta: float = 0.015,
               splat: int = 1, near: float = 0.001, far: float = 100.0) -> torch.Tensor:
    """VSD (visible surface discrepancy, BOP): the share of the union of
    the two renders' visible pixels where only one render is visible or
    their depths differ by more than ``tau``; 0 when neither is visible."""
    taus = torch.tensor([tau], dtype=torch.float32, device=points.device)
    return vsd_multi_tau(T_est, T_gt, points, valid, intr, taus, scene_depth, delta, splat,
                         near, far)[0]


def vsd_multi_tau(T_est: torch.Tensor, T_gt: torch.Tensor, points: torch.Tensor,
                  valid: torch.Tensor, intr: Intrinsics, taus: torch.Tensor,
                  scene_depth: Optional[torch.Tensor] = None, delta: float = 0.015,
                  splat: int = 1, near: float = 0.001, far: float = 100.0) -> torch.Tensor:
    """VSD at each tolerance of ``taus`` (T,) from one pair of renders ->
    (T,). With ``scene_depth`` (the measured depth, 0 where unmeasured) a
    pixel is visible only where the rendered surface lies within ``delta``
    of, or in front of, the measured one (BOP's occlusion test). ``near``,
    ``far``, ``taus`` and ``delta`` are in the caller's length unit."""
    d_e = render_depth(points, valid, T_est, intr, near=near, far=far, splat=splat)
    d_g = render_depth(points, valid, T_gt, intr, near=near, far=far, splat=splat)
    v_e, v_g = d_e > 0.0, d_g > 0.0
    if scene_depth is not None:
        measured = scene_depth > 0.0
        v_e = v_e & (~measured | (d_e <= scene_depth + delta))
        v_g = v_g & (~measured | (d_g <= scene_depth + delta))
    union, inter = v_e | v_g, v_e & v_g
    gap = (d_e - d_g).abs()[None]
    mismatch = torch.where(inter[None], (gap > taus[:, None, None]).to(torch.float32), 1.0)
    n = union.to(torch.float32).sum()
    total = torch.where(union[None], mismatch, 0.0).sum((1, 2))
    return torch.where(n > 0, total / torch.clamp(n, min=1.0), torch.zeros_like(total))


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
