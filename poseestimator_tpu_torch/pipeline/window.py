"""Object-window rasterization (counterpart of
``poseestimator_tpu/pipeline/window.py``): the tracking step renders and
samples only a fixed-size window around the projected object. The window's
size is static (chosen on the host); its origin follows the pose on the
device.
"""
from __future__ import annotations

import torch

from ..geom3d.camera import Intrinsics
from ..geom3d.se3 import transform_points

# default (H, W) window at the half-resolution render view
TRACK_WIN = (128, 128)


def window_dims(intr_r: Intrinsics, win_hw, default=TRACK_WIN):
    """Resolve the static window config against a render-resolution camera:
    ``(wh, ww)`` or ``None`` (full frame). ``"auto"`` windows only when the
    window is at most a quarter of the frame."""
    if win_hw is None:
        return None
    if win_hw == "auto":
        wh = min(default[0], intr_r.height)
        ww = min(default[1], intr_r.width)
        if intr_r.height * intr_r.width >= 4 * wh * ww:
            return (wh, ww)
        return None
    return (min(int(win_hw[0]), intr_r.height), min(int(win_hw[1]), intr_r.width))


def window_for_object(intr_r: Intrinsics, diag_m: float, z_m: float,
                      margin: float = 1.3, quantum: int = 64):
    """Static window bucket for an object of diameter ``diag_m`` at distance
    ``z_m``: ``margin * f * diag / z`` rounded up (height to ``quantum``,
    width to 128), or None when it would not save ~30% of the frame."""
    f = max(intr_r.fx, intr_r.fy)
    req = margin * f * float(diag_m) / max(float(z_m), 1e-3)
    h = int(min(-(-req // quantum) * quantum, intr_r.height))
    w = int(min(-(-req // 128) * 128, intr_r.width))
    h = max(h, 32)
    w = max(w, 128)
    if h * w >= 0.7 * intr_r.height * intr_r.width:
        return None
    return (h, w)


def window_origin(verts: torch.Tensor, T_m2c: torch.Tensor, intr_r: Intrinsics,
                  wh: int, ww: int) -> torch.Tensor:
    """Integer (2,) ``[ox, oy]`` origin at the render resolution: the
    projected vertex-bbox centre at ``T_m2c``, rounded half to even and
    clamped so the window lies inside the frame (frame centre when no vertex
    is in front of the camera). Stays on the device."""
    vc = transform_points(T_m2c, verts)
    z = vc[:, 2]
    ok = z > 1e-3
    zs = torch.where(ok, z, torch.ones_like(z))
    u = intr_r.fx * vc[:, 0] / zs + intr_r.cx
    v = intr_r.fy * vc[:, 1] / zs + intr_r.cy
    big = torch.full_like(u, 1e9)
    umin = torch.where(ok, u, big).min()
    umax = torch.where(ok, u, -big).max()
    vmin = torch.where(ok, v, big).min()
    vmax = torch.where(ok, v, -big).max()
    any_ok = ok.any()
    cu = torch.where(any_ok, 0.5 * (umin + umax), torch.full_like(umin, intr_r.cx))
    cv = torch.where(any_ok, 0.5 * (vmin + vmax), torch.full_like(vmin, intr_r.cy))
    ox = torch.clamp(torch.round(cu - ww / 2), 0, intr_r.width - ww)
    oy = torch.clamp(torch.round(cv - wh / 2), 0, intr_r.height - wh)
    return torch.stack([ox, oy]).to(torch.int32)
