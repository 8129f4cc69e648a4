"""Triangle-mesh z-buffer depth rasterization (counterpart of
``poseestimator_tpu/render/raster.py``): kernel K2 (``csrc/raster.cu``), its
plain PyTorch version, the shared per-face setup and ``render_depth_mesh``,
each also over a leading batch of poses (one launch for B renders); and the
depth-only shading of the template images.

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
from ..utils.profiling import span

# inside-test slack on normalized barycentrics: shared edges land exactly on
# both faces' boundaries and must not open cracks under rounding
EDGE_EPS = 1e-5


raster_stats = kernels.LaunchCounter()
raster_batched_stats = kernels.LaunchCounter()


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

    Batched: ``T_m2c`` (B, 4, 4) and ``origin`` (B, 2), with the mesh shared
    ((V, 3) / (F, 3)) or per problem ((B, V, 3) / (B, F, 3), a gather of
    class rows) give (B, F, 12) and (B, F, 4). Each problem's rows are bit
    for bit its unbatched setup: the vertex transform, a small matrix
    product whose rounding may depend on the batch, runs per problem, and
    everything after it is elementwise.
    """
    if T_m2c.dim() == 3:
        B = T_m2c.shape[0]
        vs = vertices if vertices.dim() == 3 else vertices.expand(B, *vertices.shape)
        fs = faces.long() if faces.dim() == 3 else faces.long().expand(B, *faces.shape)
        vc = torch.stack([transform_points(T_m2c[b], vs[b]) for b in range(B)])
        tri = vc[torch.arange(B, device=vc.device)[:, None, None], fs]  # (B, F, 3, 3)
    else:
        tri = transform_points(T_m2c, vertices)[faces.long()]  # (F, 3, 3)
    z = tri[..., 2]
    ok = (z > near).all(dim=-1)
    zs = torch.where(z > near, z, torch.ones_like(z))
    if origin is None:
        px = intr.fx * tri[..., 0] / zs + intr.cx
        py = intr.fy * tri[..., 1] / zs + intr.cy
    else:
        o = origin.to(torch.float32)[..., None, None, :]  # broadcasts over (F, 3)
        px = intr.fx * tri[..., 0] / zs + (intr.cx - o[..., 0])
        py = intr.fy * tri[..., 1] / zs + (intr.cy - o[..., 1])
    iz = 1.0 / zs

    x0, x1, x2 = px[..., 0], px[..., 1], px[..., 2]
    y0, y1, y2 = py[..., 0], py[..., 1], py[..., 2]
    twoA = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    bad = ~ok | (twoA.abs() < 1e-9)
    den = torch.where(bad, torch.ones_like(twoA), twoA)
    a0, b0, c0 = (y1 - y2) / den, (x2 - x1) / den, (x1 * y2 - x2 * y1) / den
    a1, b1, c1 = (y2 - y0) / den, (x0 - x2) / den, (x2 * y0 - x0 * y2) / den
    a2, b2, c2 = (y0 - y1) / den, (x1 - x0) / den, (x0 * y1 - x1 * y0) / den
    iz0, iz1, iz2 = iz[..., 0], iz[..., 1], iz[..., 2]
    az = a0 * iz0 + a1 * iz1 + a2 * iz2
    bz = b0 * iz0 + b1 * iz1 + b2 * iz2
    cz = c0 * iz0 + c1 * iz1 + c2 * iz2
    c0 = torch.where(bad, torch.full_like(c0, -1e30), c0)
    coef = torch.stack([a0, b0, c0, a1, b1, c1, a2, b2, c2, az, bz, cz], dim=-1)
    big = torch.full_like(x0, 1e9)
    bbox = torch.stack([
        torch.where(bad, big, px.amin(-1)), torch.where(bad, -big, px.amax(-1)),
        torch.where(bad, big, py.amin(-1)), torch.where(bad, -big, py.amax(-1)),
    ], dim=-1)
    return coef.to(torch.float32).contiguous(), bbox.to(torch.float32).contiguous()


def raster_plain(coef: torch.Tensor, H: int, W: int, chunk: int = 8) -> torch.Tensor:
    """max-1/z over faces by (chunk, H, W) masked reductions — the mirror of
    the JAX package's ``_render_xla``; -1 where no face covers a pixel."""
    return raster_batched_plain(coef[None], H, W, chunk)[0]


def raster_batched_plain(coef: torch.Tensor, H: int, W: int, chunk: int = 8) -> torch.Tensor:
    """``raster_plain`` of B problems, (B, F, 12) -> (B, H, W); elementwise
    arithmetic and maxima only, so each problem rounds as it does alone.
    On the CPU, faces that cover no pixel in any problem (the degenerate
    ones, padding among them, whose first edge constant is -1e30) are
    skipped: a maximum does not depend on them, so nothing changes."""
    dev = coef.device
    if not coef.is_cuda:
        coef = coef[:, ~(coef[..., 2] == -1e30).all(0)]
    X = torch.arange(W, dtype=torch.float32, device=dev).expand(H, W)
    Y = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    izmax = torch.full((coef.shape[0], H, W), -1.0, dtype=torch.float32, device=dev)
    for s in range(0, coef.shape[1], chunk):
        c = coef[:, s:s + chunk, :, None, None]  # (B, C, 12, 1, 1)
        w0 = (c[:, :, 0] * X + c[:, :, 1] * Y) + c[:, :, 2]
        w1 = (c[:, :, 3] * X + c[:, :, 4] * Y) + c[:, :, 5]
        w2 = (c[:, :, 6] * X + c[:, :, 7] * Y) + c[:, :, 8]
        inside = (w0 >= -EDGE_EPS) & (w1 >= -EDGE_EPS) & (w2 >= -EDGE_EPS)
        iz = (c[:, :, 9] * X + c[:, :, 10] * Y) + c[:, :, 11]
        izc = torch.where(inside, iz, torch.full_like(iz, -1.0)).amax(1)
        izmax = torch.maximum(izmax, izc)
    return izmax


def _check(coef, bbox, batched: bool):
    if coef.dtype != torch.float32 or bbox.dtype != torch.float32:
        raise TypeError("coef and bbox must be float32")
    lead = coef.shape[:1] if batched else ()
    if (coef.dim() != 2 + len(lead) or coef.shape[-1] != 12
            or bbox.shape != (*coef.shape[:-1], 4)):
        form = "(B, F, 12) and (B, F, 4)" if batched else "(F, 12) and (F, 4)"
        raise ValueError(f"coef and bbox must be {form}, got "
                         f"{tuple(coef.shape)}, {tuple(bbox.shape)}")
    if bbox.device != coef.device:
        raise ValueError("coef and bbox on different devices")
    if coef.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"raster: unsupported device {coef.device}")


def raster(coef: torch.Tensor, bbox: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """izmax (H, W): kernel K2 on CUDA tensors, the plain version on CPU
    tensors, an error on anything else."""
    _check(coef, bbox, batched=False)
    if coef.device.type == "cpu":
        return raster_plain(coef, H, W)
    coef, bbox = kernels.aligned16(coef), kernels.aligned16(bbox)  # read as float4 rows
    out = torch.empty((H, W), dtype=torch.float32, device=coef.device)
    kernels.launch("raster_launch", coef.data_ptr(), bbox.data_ptr(), coef.shape[0],
                   H, W, out.data_ptr(), kernels.current_stream())
    raster_stats.launches += 1
    return out


def raster_batched(coef: torch.Tensor, bbox: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """izmax (B, H, W) of B problems (B, F, 12) / (B, F, 4): one launch of
    K2's batched entry on CUDA tensors, the batched plain version on CPU
    tensors; problem b is bit for bit ``raster`` of its rows."""
    _check(coef, bbox, batched=True)
    if coef.device.type == "cpu":
        return raster_batched_plain(coef, H, W)
    coef, bbox = kernels.aligned16(coef), kernels.aligned16(bbox)
    B, F = coef.shape[0], coef.shape[1]
    out = torch.empty((B, H, W), dtype=torch.float32, device=coef.device)
    kernels.launch("raster_batched_launch", coef.data_ptr(), bbox.data_ptr(), F, B,
                   H, W, out.data_ptr(), kernels.current_stream())
    raster_batched_stats.launches += 1
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
    with span("k2", 1, H, W):
        izmax = raster(coef, bbox, H, W)
    return izmax_to_depth(izmax, near, far)


def render_depth_mesh_batched(vertices, faces, T_m2c, intr: Intrinsics, near: float = 0.001,
                              far: float = 100.0, origin: Optional[torch.Tensor] = None,
                              out_hw: Optional[tuple[int, int]] = None) -> torch.Tensor:
    """``render_depth_mesh`` of B poses (B, 4, 4), with window origins
    (B, 2), of one mesh or of per-problem meshes (B, V, 3) / (B, F, 3):
    (B, H, W) depth from one batched K2 launch, each image bit for bit the
    unbatched render."""
    H, W = out_hw if out_hw is not None else (intr.height, intr.width)
    coef, bbox = face_coeffs(vertices, faces, T_m2c, intr, near=near, origin=origin)
    with span("k2", T_m2c.shape[0], H, W):
        izmax = raster_batched(coef, bbox, H, W)
    return izmax_to_depth(izmax, near, far)


def depth_lambert(depth: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    """Headlight Lambertian term from a depth image alone: normals from the
    gradients of the back-projected positions; pixels where the gradient
    spans a depth jump (a silhouette) take a flat 0.6."""
    H, W = depth.shape
    u = torch.arange(W, dtype=torch.float32, device=depth.device).expand(H, W)
    v = torch.arange(H, dtype=torch.float32, device=depth.device)[:, None].expand(H, W)
    P = torch.stack([(u - intr.cx) * depth / intr.fx, (v - intr.cy) * depth / intr.fy, depth],
                    dim=-1)
    du = torch.gradient(P, dim=1)[0]
    dv = torch.gradient(P, dim=0)[0]
    n = torch.linalg.cross(du, dv, dim=-1)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-12)
    n = torch.where(n[..., 2:3] > 0, -n, n)  # toward the camera
    lambert = torch.clamp(-n[..., 2], 0.15, 1.0)
    edge = ((torch.gradient(depth, dim=0)[0].abs() > 0.05)
            | (torch.gradient(depth, dim=1)[0].abs() > 0.05))
    return torch.where(edge, torch.full_like(lambert, 0.6), lambert)


def shade_depth_image(depth: torch.Tensor, intr: Intrinsics,
                      base_color=(0.0, 0.0, 1.0)) -> torch.Tensor:
    """(H, W, 3) headlight-shaded colour in [0, 1] of a depth image, white
    where the depth is 0."""
    lambert = depth_lambert(depth, intr)
    base = torch.as_tensor(base_color, dtype=torch.float32, device=depth.device)
    return torch.where((depth > 0)[..., None], lambert[..., None] * base,
                       torch.ones_like(lambert)[..., None])
