"""Masked reductions over padded arrays (counterpart of
``poseestimator_tpu/geom3d/masked.py``)."""
from __future__ import annotations

import torch


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None) -> torch.Tensor:
    w = mask.to(x.dtype)
    if dim is None:
        return (x * w).sum() / torch.clamp(w.sum(), min=1.0)
    return (x * w).sum(dim) / torch.clamp(w.sum(dim), min=1.0)


def masked_std(x: torch.Tensor, mask: torch.Tensor, dim=None) -> torch.Tensor:
    m = masked_mean(x, mask, dim=dim)
    if dim is not None:
        m = m.unsqueeze(dim)
    v = masked_mean((x - m) ** 2, mask, dim=dim)
    return torch.sqrt(torch.clamp(v, min=0.0))
