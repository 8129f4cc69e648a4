"""Masked reductions over padded arrays (counterpart of
``poseestimator_tpu/geom3d/masked.py``)."""
from __future__ import annotations

import torch

BIG = 3.0e38


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None) -> torch.Tensor:
    w = mask.to(x.dtype)
    if dim is None:
        return (x * w).sum() / torch.clamp(w.sum(), min=1.0)
    return (x * w).sum(dim) / torch.clamp(w.sum(dim), min=1.0)


def masked_min(x: torch.Tensor, mask: torch.Tensor, dim=None, fill: float = BIG) -> torch.Tensor:
    y = torch.where(mask, x, torch.full_like(x, fill))
    return y.amin() if dim is None else y.amin(dim)


def masked_max(x: torch.Tensor, mask: torch.Tensor, dim=None) -> torch.Tensor:
    y = torch.where(mask, x, torch.full_like(x, -BIG))
    return y.amax() if dim is None else y.amax(dim)


def masked_std(x: torch.Tensor, mask: torch.Tensor, dim=None) -> torch.Tensor:
    m = masked_mean(x, mask, dim=dim)
    if dim is not None:
        m = m.unsqueeze(dim)
    v = masked_mean((x - m) ** 2, mask, dim=dim)
    return torch.sqrt(torch.clamp(v, min=0.0))


def masked_percentile(x: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """Percentile over the valid entries of the last axis: ``np.percentile(
    x[mask], q)`` (linear interpolation) for >= 1 valid entry, 0 for none."""
    xs = torch.sort(torch.where(mask, x, torch.full_like(x, BIG)), dim=-1).values
    n = mask.sum(-1)
    top = torch.clamp(n - 1, min=0)
    pos = (q / 100.0) * top.to(torch.float32)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.minimum(lo + 1, top)
    frac = pos - lo.to(torch.float32)
    val = (xs.gather(-1, lo[..., None])[..., 0] * (1.0 - frac)
           + xs.gather(-1, hi[..., None])[..., 0] * frac)
    return torch.where(n > 0, val, torch.zeros_like(val))


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return masked_percentile(x, mask, 50.0)
