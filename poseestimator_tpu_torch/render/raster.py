"""Triangle-mesh z-buffer depth rasterization (counterpart of
``poseestimator_tpu/render/raster.py``): kernel K2 (``csrc/raster.cu``), its
plain PyTorch version, the shared per-face setup and ``render_depth_mesh``.

Per-face barycentric edge functions are evaluated at integer pixel
coordinates and 1/z — affine in screen space over a planar face — is
interpolated exactly; each pixel keeps the max 1/z over the faces that cover
it. Faces with a vertex at z <= near are dropped whole. Pixel (u, v) samples
the ray through (u, v), the convention of ``backproject_depth``.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from ..geom3d.camera import Intrinsics
from ..geom3d.se3 import transform_points

# inside-test slack on normalized barycentrics: shared edges land exactly on
# both faces' boundaries and must not open cracks under rounding
EDGE_EPS = 1e-5


raster_stats = kernels.LaunchCounter()


def face_coeffs(vertices, faces, T_m2c, intr: Intrinsics, near: float = 0.001,
                origin: Optional[torch.Tensor] = None):
    """Per-face screen-space setup shared by the kernel and its plain version.

    Returns ``(coef (F, 12) f32, bbox (F, 4) f32)``, one row per face (the
    JAX package returns the transposes): the plane coefficients (a, b, c) of
    the three normalized barycentrics ``w_i = a x + b y + c``, then the 1/z
    plane; bbox = (xmin, xmax, ymin, ymax) in pixels. Degenerate or
    behind-near faces get ``c0 = -1e30`` and an empty bbox. ``origin`` (2,)
    shifts pixel coordinates so a window starting at (x0, y0) rasterizes in
    local coordinates.
    """
    vc = transform_points(T_m2c, vertices)
    tri = vc[faces.long()]  # (F, 3, 3)
    z = tri[..., 2]
    ok = (z > near).all(dim=1)
    zs = torch.where(z > near, z, torch.ones_like(z))
    if origin is None:
        px = intr.fx * tri[..., 0] / zs + intr.cx
        py = intr.fy * tri[..., 1] / zs + intr.cy
    else:
        origin = origin.to(torch.float32)
        px = intr.fx * tri[..., 0] / zs + (intr.cx - origin[0])
        py = intr.fy * tri[..., 1] / zs + (intr.cy - origin[1])
    iz = 1.0 / zs

    x0, x1, x2 = px[:, 0], px[:, 1], px[:, 2]
    y0, y1, y2 = py[:, 0], py[:, 1], py[:, 2]
    twoA = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    bad = ~ok | (twoA.abs() < 1e-9)
    den = torch.where(bad, torch.ones_like(twoA), twoA)
    a0, b0, c0 = (y1 - y2) / den, (x2 - x1) / den, (x1 * y2 - x2 * y1) / den
    a1, b1, c1 = (y2 - y0) / den, (x0 - x2) / den, (x2 * y0 - x0 * y2) / den
    a2, b2, c2 = (y0 - y1) / den, (x1 - x0) / den, (x0 * y1 - x1 * y0) / den
    az = a0 * iz[:, 0] + a1 * iz[:, 1] + a2 * iz[:, 2]
    bz = b0 * iz[:, 0] + b1 * iz[:, 1] + b2 * iz[:, 2]
    cz = c0 * iz[:, 0] + c1 * iz[:, 1] + c2 * iz[:, 2]
    c0 = torch.where(bad, torch.full_like(c0, -1e30), c0)
    coef = torch.stack([a0, b0, c0, a1, b1, c1, a2, b2, c2, az, bz, cz], dim=1)
    big = torch.full_like(x0, 1e9)
    bbox = torch.stack([
        torch.where(bad, big, px.amin(1)), torch.where(bad, -big, px.amax(1)),
        torch.where(bad, big, py.amin(1)), torch.where(bad, -big, py.amax(1)),
    ], dim=1)
    return coef.to(torch.float32).contiguous(), bbox.to(torch.float32).contiguous()


def raster_plain(coef: torch.Tensor, H: int, W: int, chunk: int = 8) -> torch.Tensor:
    """max-1/z over faces by (chunk, H, W) masked reductions — the mirror of
    the JAX package's ``_render_xla``; -1 where no face covers a pixel."""
    dev = coef.device
    X = torch.arange(W, dtype=torch.float32, device=dev).expand(H, W)
    Y = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    izmax = torch.full((H, W), -1.0, dtype=torch.float32, device=dev)
    for s in range(0, coef.shape[0], chunk):
        c = coef[s:s + chunk, :, None, None]  # (C, 12, 1, 1)
        w0 = (c[:, 0] * X + c[:, 1] * Y) + c[:, 2]
        w1 = (c[:, 3] * X + c[:, 4] * Y) + c[:, 5]
        w2 = (c[:, 6] * X + c[:, 7] * Y) + c[:, 8]
        inside = (w0 >= -EDGE_EPS) & (w1 >= -EDGE_EPS) & (w2 >= -EDGE_EPS)
        iz = (c[:, 9] * X + c[:, 10] * Y) + c[:, 11]
        izc = torch.where(inside, iz, torch.full_like(iz, -1.0)).amax(0)
        izmax = torch.maximum(izmax, izc)
    return izmax


def raster(coef: torch.Tensor, bbox: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """izmax (H, W): kernel K2 on CUDA tensors, the plain version on CPU
    tensors, an error on anything else."""
    if coef.dtype != torch.float32 or bbox.dtype != torch.float32:
        raise TypeError("coef and bbox must be float32")
    if coef.dim() != 2 or coef.shape[1] != 12 or bbox.shape != (coef.shape[0], 4):
        raise ValueError(f"coef must be (F, 12) and bbox (F, 4), got "
                         f"{tuple(coef.shape)}, {tuple(bbox.shape)}")
    if bbox.device != coef.device:
        raise ValueError("coef and bbox on different devices")
    if coef.device.type == "cpu":
        return raster_plain(coef, H, W)
    if coef.device.type != "cuda":
        raise RuntimeError(f"raster: unsupported device {coef.device}")
    coef, bbox = coef.contiguous(), bbox.contiguous()
    out = torch.empty((H, W), dtype=torch.float32, device=coef.device)
    kernels.launch("raster", coef.data_ptr(), bbox.data_ptr(), coef.shape[0],
                   H, W, out.data_ptr(), kernels.current_stream())
    raster_stats.launches += 1
    return out


def izmax_to_depth(izmax: torch.Tensor, near: float, far: float) -> torch.Tensor:
    """Linear depth from max 1/z; 0 where uncovered or outside [near, far)."""
    depth = torch.where(izmax > 1.0 / far, 1.0 / torch.clamp(izmax, min=1e-30),
                        torch.zeros_like(izmax))
    return torch.where(depth >= near, depth, torch.zeros_like(depth))


def render_depth_mesh(vertices, faces, T_m2c, intr: Intrinsics, near: float = 0.001,
                      far: float = 100.0, origin: Optional[torch.Tensor] = None,
                      out_hw: Optional[tuple[int, int]] = None) -> torch.Tensor:
    """Rasterize a triangle mesh to an (H, W) linear-depth image (0 where
    uncovered). ``origin`` (2,) (x0, y0) with ``out_hw`` renders a window of
    the full image plane. Launches K2 on the card; plain version on the CPU.
    """
    H, W = out_hw if out_hw is not None else (intr.height, intr.width)
    coef, bbox = face_coeffs(vertices, faces, T_m2c, intr, near=near, origin=origin)
    return izmax_to_depth(raster(coef, bbox, H, W), near, far)
