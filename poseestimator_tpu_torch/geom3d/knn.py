"""Brute-force neighbour search (counterpart of
``poseestimator_tpu/geom3d/knn.py``).

``nearest_neighbor`` goes through kernel K1 on every CUDA call (the JAX
package's 8M-entry size gate is dropped: no plain path runs on the card) and
through K1's plain version on the CPU; ``nearest_neighbor_batched`` does
the same for B problems, each with its own data cloud, in one launch.
``knn`` (k > 1: the outlier filter, normals and FPFH neighbourhoods) stays a
dense distance matrix and a top-k, as in the JAX package; above 64M matrix
entries (256K on the CPU, where a block then stays in cache) it runs in
blocks of query rows, which bounds its memory and changes no result.
"""
from __future__ import annotations

import torch

from ..utils.profiling import span
from .fused_nn import fused_nn, fused_nn_batched

BIG = 3.0e38
BLOCK_ENTRIES = 64 * 1024 * 1024  # distance-matrix entries per knn block
BLOCK_ENTRIES_CPU = 256 * 1024


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
    each (N, k); distances of the selected pairs are recomputed exactly.
    ``exclude_self``: query i is data point i and is not its own neighbour."""
    block = BLOCK_ENTRIES if query.is_cuda else BLOCK_ENTRIES_CPU
    rows = max(block // max(data.shape[0], 1), 1)
    if query.shape[0] <= rows:
        return _knn_block(query, query_valid, data, data_valid, k, 0 if exclude_self else None)
    parts = [_knn_block(query[s:s + rows], query_valid[s:s + rows], data, data_valid, k,
                        s if exclude_self else None)
             for s in range(0, query.shape[0], rows)]
    return tuple(torch.cat(p) for p in zip(*parts))


def _knn_block(query, query_valid, data, data_valid, k: int, self_offset):
    """``knn`` of a block of query rows; ``self_offset``: the data index of
    the first query row when it is its own point, else None."""
    d2 = masked_sqdist(query, query_valid, data, data_valid)
    if self_offset is not None:
        dev = d2.device
        own = (torch.arange(d2.shape[0], device=dev)[:, None] + self_offset
               == torch.arange(d2.shape[1], device=dev)[None, :])
        d2 = d2.masked_fill(own, BIG)
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
    with span("k1", 1, query.shape[0], data.shape[0]):
        return fused_nn(query, query_valid, data, data_valid)


def nearest_neighbor_batched(query, query_valid, data, data_valid):
    """``nearest_neighbor`` of B problems: (B, N, 3) queries against their
    own (B, M, 3) data -> ``(dist, idx, found)``, each (B, N)."""
    with span("k1", query.shape[0], query.shape[1], data.shape[1]):
        return fused_nn_batched(query, query_valid, data, data_valid)
