"""Depth post-processing filters (counterpart of
``poseestimator_tpu/camera/filters.py``), elementwise torch on the depth's
device. They follow librealsense's public filter descriptions:

- spatial: iterative 1-D exponential smoothing along rows then columns,
  skipping edges where the neighbour step exceeds ``delta``;
- temporal: EMA blend with the previous frame where ``|d - prev| < delta``,
  holes keeping the previous value;
- hole filling: the farthest valid 4-neighbour fills a zero pixel.

Each takes a tensor (and runs on its device) or an array, which goes to
``device`` (default the card, an error when there is none).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def as_depth(depth, device=None) -> torch.Tensor:
    """``depth`` as a float32 tensor: a tensor stays on its device unless
    ``device`` is given; anything else goes to ``device`` or the card."""
    if torch.is_tensor(depth) and device is None:
        return depth.to(torch.float32)
    dev = resolve_device("cuda" if device is None else device)
    return torch.as_tensor(np.asarray(depth, np.float32) if not torch.is_tensor(depth)
                           else depth, dtype=torch.float32, device=dev)


def _no_wrap(shape, axis: int, shift: int, device) -> torch.Tensor:
    """False where a rolled neighbour wrapped around the image border."""
    n = shape[axis]
    idx = torch.arange(n, device=device)
    ok = idx >= shift if shift > 0 else idx < n + shift
    bshape = [1] * len(shape)
    bshape[axis] = n
    return ok.reshape(bshape)


def spatial_filter(depth, alpha: float = 0.5, delta: float = 0.02, iterations: int = 2,
                   device=None) -> torch.Tensor:
    """Edge-preserving smoothing. depth (H, W) metres, 0 = hole."""
    depth = as_depth(depth, device)

    def pass_dir(d, axis, shift):
        nb = torch.roll(d, shift, dims=axis)
        ok = (d > 0) & (nb > 0) & ((d - nb).abs() <= delta)
        ok = ok & _no_wrap(d.shape, axis, shift, d.device)
        return torch.where(ok, alpha * d + (1 - alpha) * nb, d)

    for _ in range(iterations):
        for axis in (1, 0):
            depth = pass_dir(depth, axis, 1)
            depth = pass_dir(depth, axis, -1)
    return depth


def temporal_filter(depth, prev, alpha: float = 0.4, delta: float = 0.02,
                    device=None) -> torch.Tensor:
    """EMA with the previous filtered frame; holes take the previous value.
    Returns the new filtered depth (also the next ``prev``)."""
    depth = as_depth(depth, device)
    prev = as_depth(prev, depth.device)
    both = (depth > 0) & (prev > 0)
    close = both & ((depth - prev).abs() <= delta)
    blended = torch.where(close, alpha * depth + (1 - alpha) * prev, depth)
    return torch.where(depth > 0, blended, prev)


def hole_filling_filter(depth, device=None) -> torch.Tensor:
    """Fill zero pixels from the farthest valid 4-neighbour (two sweeps)."""
    depth = as_depth(depth, device)

    def fill_once(d):
        cands = torch.stack([torch.roll(d, s, dims=a) * _no_wrap(d.shape, a, s, d.device)
                             for s, a in ((1, 1), (-1, 1), (1, 0), (-1, 0))])
        far = torch.where(cands > 0, cands, torch.zeros_like(cands)).amax(0)
        return torch.where(d > 0, d, far)

    return fill_once(fill_once(depth))
