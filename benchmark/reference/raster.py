"""Plain PyTorch z-buffer raster and back-projection: the benchmark's own
renderer of its traffic and the reference's predicted views.

Pinhole camera with pixel centres at integer coordinates: a point (x, y, z)
in the camera frame lands at u = fx x / z + cx, v = fy y / z + cy, and pixel
(u, v) back-projects to ((u - cx) z / fx, (v - cy) z / fy, z). Each face is
rasterised over the integer pixels of its own bounding box, its inverse depth
interpolated linearly in the image (exact for a planar triangle), and the
nearest surface kept by a scatter of maxima of 1/z.
"""
from __future__ import annotations

import torch

MAX_PAIRS = 1 << 23  # (face, pixel) candidates evaluated per chunk


def camera(fx: float, fy: float, cx: float, cy: float, width: int, height: int) -> dict:
    return {"fx": float(fx), "fy": float(fy), "cx": float(cx), "cy": float(cy),
            "width": int(width), "height": int(height)}


def scaled(cam: dict, r: int) -> dict:
    """The same camera at 1/r resolution."""
    return camera(cam["fx"] / r, cam["fy"] / r, cam["cx"] / r, cam["cy"] / r,
                  cam["width"] // r, cam["height"] // r)


def transform(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Points (..., N, 3) under poses (..., 4, 4), written out per component
    (no matrix product, so no precision setting can change it)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    return (p[..., :, None, 0] * R[..., None, :, 0] + p[..., :, None, 1] * R[..., None, :, 1]
            + p[..., :, None, 2] * R[..., None, :, 2]) + t[..., None, :]


def render_inverse_depth(v_cam: torch.Tensor, faces: torch.Tensor, cam: dict,
                         near: float = 0.01) -> torch.Tensor:
    """(B, H, W) max 1/z of B vertex sets (B, V, 3) in the camera frame over
    shared faces (F, 3); 0 where no face covers a pixel."""
    B = v_cam.shape[0]
    H, W = cam["height"], cam["width"]
    dev = v_cam.device
    tri = v_cam[:, faces.long()]  # (B, F, 3, 3)
    z = tri[..., 2]
    ok = (z > near).all(-1)
    zs = torch.where(z > near, z, torch.ones_like(z))
    px = cam["fx"] * tri[..., 0] / zs + cam["cx"]
    py = cam["fy"] * tri[..., 1] / zs + cam["cy"]
    iz = 1.0 / zs
    x0, x1, x2 = px.unbind(-1)
    y0, y1, y2 = py.unbind(-1)
    twoA = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    ok = ok & (twoA.abs() > 1e-9)
    den = torch.where(ok, twoA, torch.ones_like(twoA))
    coef = torch.stack([
        (y1 - y2) / den, (x2 - x1) / den, (x1 * y2 - x2 * y1) / den,
        (y2 - y0) / den, (x0 - x2) / den, (x2 * y0 - x0 * y2) / den,
        (y0 - y1) / den, (x1 - x0) / den, (x0 * y1 - x1 * y0) / den], -1)  # (B, F, 9)
    a = coef[..., 0::3]
    b = coef[..., 1::3]
    c = coef[..., 2::3]
    az, bz, cz = (a * iz).sum(-1), (b * iz).sum(-1), (c * iz).sum(-1)
    xlo = torch.clamp(torch.ceil(px.amin(-1)), 0, W)
    xhi = torch.clamp(torch.floor(px.amax(-1)), -1, W - 1)
    ylo = torch.clamp(torch.ceil(py.amin(-1)), 0, H)
    yhi = torch.clamp(torch.floor(py.amax(-1)), -1, H - 1)
    ok = ok & (xhi >= xlo) & (yhi >= ylo)
    span = int(torch.where(ok, torch.maximum(xhi - xlo, yhi - ylo) + 1,
                           torch.zeros_like(xlo)).max().item()) if ok.any() else 0
    out = torch.zeros(B, H * W, dtype=torch.float32, device=dev)
    if span == 0:
        return out.view(B, H, W)
    off = torch.arange(span, dtype=torch.float32, device=dev)
    ox, oy = off.repeat(span), off.repeat_interleave(span)  # (span^2,)
    F = tri.shape[1]
    step = max(1, MAX_PAIRS // (span * span * B))
    for s in range(0, F, step):
        sl = slice(s, s + step)
        X = xlo[:, sl, None] + ox
        Y = ylo[:, sl, None] + oy
        inside = ok[:, sl, None] & (X <= xhi[:, sl, None]) & (Y <= yhi[:, sl, None])
        w = a[:, sl, None, :] * X[..., None] + b[:, sl, None, :] * Y[..., None] + c[:, sl, None, :]
        inside = inside & (w >= 0).all(-1)
        val = az[:, sl, None] * X + bz[:, sl, None] * Y + cz[:, sl, None]
        val = torch.where(inside, val, torch.zeros_like(val))
        idx = torch.where(inside, Y * W + X, torch.zeros_like(X)).long()
        out.scatter_reduce_(1, idx.reshape(B, -1), val.reshape(B, -1), "amax")
    return out.view(B, H, W)


def to_depth(iz: torch.Tensor, near: float = 0.01, far: float = 5.0) -> torch.Tensor:
    depth = torch.where(iz > 1.0 / far, 1.0 / torch.clamp(iz, min=1e-30), torch.zeros_like(iz))
    return torch.where(depth >= near, depth, torch.zeros_like(depth))


def render_depth(verts: torch.Tensor, faces: torch.Tensor, T: torch.Tensor, cam: dict,
                 near: float = 0.01, far: float = 5.0) -> torch.Tensor:
    """Depth (B, H, W) of one mesh (V, 3) at poses (B, 4, 4), or (H, W) at
    one pose (4, 4)."""
    one = T.dim() == 2
    Ts = T[None] if one else T
    d = to_depth(render_inverse_depth(transform(Ts, verts), faces, cam, near), near, far)
    return d[0] if one else d


def backproject(depth: torch.Tensor, cam: dict, mask=None) -> torch.Tensor:
    """(N, 3) camera-frame points of the pixels with depth > 0 (and mask)."""
    H, W = depth.shape
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=depth.device),
                          torch.arange(W, dtype=torch.float32, device=depth.device),
                          indexing="ij")
    keep = depth > 0
    if mask is not None:
        keep = keep & mask
    z = depth[keep]
    return torch.stack([(u[keep] - cam["cx"]) * z / cam["fx"],
                        (v[keep] - cam["cy"]) * z / cam["fy"], z], -1)
