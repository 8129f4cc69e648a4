"""Brute-force neighbour search (counterpart of
``poseestimator_tpu/geom3d/knn.py``).

``nearest_neighbor`` goes through kernel K1 on every CUDA call (the JAX
package's 8M-entry size gate is dropped: no plain path runs on the card) and
through K1's plain version on the CPU. ``knn`` (k > 1: the outlier filter,
normals and FPFH neighbourhoods) stays a dense distance matrix and a top-k,
as in the JAX package.
"""
from __future__ import annotations

import torch

from .fused_nn import fused_nn

BIG = 3.0e38


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances (..., N, D) x (M, D) -> (..., N, M): a float32
    matmul cross term (TF32 is off, see device.py) clamped at 0."""
    a2 = (a * a).sum(-1, keepdim=True)
    b2 = (b * b).sum(-1)
    return torch.clamp(a2 + b2[None, :] - 2.0 * (a @ b.T), min=0.0)


def masked_sqdist(a, a_valid, b, b_valid) -> torch.Tensor:
    """Pairwise squared distances with invalid rows/cols pushed to 3e38."""
    d2 = pairwise_sqdist(a, b)
    big = torch.full_like(d2, BIG)
    d2 = torch.where(b_valid, d2, big)
    return torch.where(a_valid[..., None], d2, big)


def knn(query, query_valid, data, data_valid, k: int, exclude_self: bool = False):
    """k nearest data points per query. Returns ``(dists, idx, nb_valid)``,
    each (N, k); distances of the selected pairs are recomputed exactly."""
    d2 = masked_sqdist(query, query_valid, data, data_valid)
    if exclude_self:
        n = d2.shape[0]
        eye = torch.eye(n, d2.shape[1], dtype=torch.bool, device=d2.device)
        d2 = d2.masked_fill(eye, BIG)
    neg, idx = torch.topk(-d2, k, dim=1)
    nb_valid = -neg < BIG * 0.5
    diff = query[:, None, :] - data[idx]
    d2k = (diff * diff).sum(-1)
    dists = torch.sqrt(torch.where(nb_valid, d2k, torch.zeros_like(d2k)))
    return dists, idx, nb_valid


def radius_knn(query, query_valid, data, data_valid, radius: float, max_nn: int,
               exclude_self: bool = False):
    """Hybrid radius + max_nn search (Open3D ``KDTreeSearchParamHybrid``):
    the ``max_nn`` nearest neighbours, keeping those within ``radius``."""
    dists, idx, nb_valid = knn(query, query_valid, data, data_valid, max_nn, exclude_self)
    return dists, idx, nb_valid & (dists <= radius)


def nearest_neighbor(query, query_valid, data, data_valid):
    """Single nearest valid data point per query: ``(dist, idx, found)``."""
    return fused_nn(query, query_valid, data, data_valid)
