"""Kernel K2's work: the triangle raster, a z-buffer over the pixels that
each face's bounding box covers.

Copied from ``chip_smoke.py::raster_pairs`` / ``raster_bound``: ~20 float32
operations per (pixel, face) pair that the bounding-box cull keeps (four
planes at two multiplies and two adds, three compares, a max), 64 B per face
read once and 4 B per pixel written once."""
from __future__ import annotations

KERNELS = ("raster_kernel",)
TARGETS = (("poseestimator_tpu_torch.render.raster", "raster"),
           ("poseestimator_tpu_torch.render.raster", "raster_batched"))


def capture(coef, bbox, H, W, *args, **kwargs):
    return bbox, int(H), int(W)


def pairs(bbox, H: int, W: int) -> float:
    """(pixel, face) pairs that the cull keeps; bbox (..., F, 4) as (xmin,
    xmax, ymin, ymax)."""
    import torch

    b = bbox.reshape(-1, 4).double()
    live = b[:, 0] <= b[:, 1]
    x0 = torch.clamp(torch.ceil(b[:, 0]), 0, W)
    x1 = torch.clamp(torch.floor(b[:, 1]) + 1, 0, W)
    y0 = torch.clamp(torch.ceil(b[:, 2]), 0, H)
    y1 = torch.clamp(torch.floor(b[:, 3]) + 1, 0, H)
    area = torch.clamp(x1 - x0, min=0) * torch.clamp(y1 - y0, min=0)
    return float(torch.where(live, area, torch.zeros_like(area)).sum())


def count(cap) -> tuple[float, float]:
    bbox, H, W = cap
    problems = bbox.numel() // (bbox.shape[-2] * 4)
    return 20.0 * pairs(bbox, H, W), 64.0 * bbox.numel() / 4 + 4.0 * H * W * problems
