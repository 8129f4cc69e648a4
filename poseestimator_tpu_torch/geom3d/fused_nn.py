"""K1: fused nearest neighbour — the CUDA kernel ``csrc/fused_nn.cu`` and
its plain PyTorch version (counterpart of
``poseestimator_tpu/geom3d/pallas_nn.py``).

Contract of ``nn_pallas``: for each query, the index of the nearest valid
data point by ``d2 = (q2 + b2) - 2 ((qx bx + qy by) + qz bz)`` in float32
(the lowest index on ties), evaluated with the 2 folded into the data as
``(q2 + b2) + ((qx bx' + qy by') + qz bz')``, ``b' = -2 b`` (a power-of-two
scale is exact, so the two forms agree bit for bit); invalid data has
``b2 = 3e38`` and never wins;
the winner's distance is recomputed exactly; ``found = query_valid &
d2 < 1.5e38 & any(data_valid)``. Returns ``(dist (N,) f32, idx (N,) i64,
found (N,) bool)``.

``fused_nn_batched`` is the same contract over a leading batch axis, B
problems each with its own queries and its own data cloud (the JAX
package's ``vmap`` of ``nn_pallas``): one launch of the kernel's batched
entry, and problem b's result is bit for bit that of ``fused_nn`` on it.
"""
from __future__ import annotations

import torch

from .. import kernels

BIG = 3.0e38
# elements of the plain version's (chunk, M) temporaries: on the card a
# bound on memory; on the CPU small enough to stay in cache (its elementwise
# passes otherwise run at memory speed, 4x slower)
_PLAIN_CHUNK_ELEMS = 16 * 1024 * 1024
_PLAIN_CHUNK_ELEMS_CPU = 256 * 1024


fused_nn_stats = kernels.LaunchCounter()
fused_nn_batched_stats = kernels.LaunchCounter()


def _sq3(x, y, z):
    return (x * x + y * y) + z * z


def fused_nn_plain(query, query_valid, data, data_valid):
    """The kernel's arithmetic, elementwise in the same order (no matmul,
    whose rounding differs), chunked over queries."""
    dist, idx, found = fused_nn_batched_plain(query[None], query_valid[None], data[None],
                                              data_valid[None])
    return dist[0], idx[0], found[0]


def fused_nn_batched_plain(query, query_valid, data, data_valid):
    """``fused_nn_plain`` over a leading batch axis: (B, N, 3) queries
    against (B, M, 3) data. Every operation is elementwise or a minimum,
    so each problem rounds exactly as it does alone."""
    B, N, M = query.shape[0], query.shape[1], data.shape[1]
    qx, qy, qz = (query[..., k, None] for k in range(3))  # (B, N, 1)
    bx, by, bz = (data[:, None, :, k] for k in range(3))  # (B, 1, M)
    b2 = torch.where(data_valid[:, None], _sq3(bx, by, bz), torch.full_like(bx, BIG))
    bx, by, bz = -2.0 * bx, -2.0 * by, -2.0 * bz
    q2 = _sq3(qx, qy, qz)
    elems = _PLAIN_CHUNK_ELEMS if query.is_cuda else _PLAIN_CHUNK_ELEMS_CPU
    chunk = max(1, elems // max(B * M, 1))
    best, bidx = [], []
    for s in range(0, N, chunk):
        e = min(N, s + chunk)
        cross = (qx[:, s:e] * bx + qy[:, s:e] * by) + qz[:, s:e] * bz
        d2 = (q2[:, s:e] + b2) + cross
        m, a = d2.min(dim=2)
        best.append(m)
        bidx.append(torch.where(m < BIG, a, torch.zeros_like(a)))
    best = torch.cat(best, dim=1)
    idx = torch.cat(bidx, dim=1)
    found = query_valid & (best < BIG * 0.5) & data_valid.any(dim=1, keepdim=True)
    diff = query - data.gather(1, idx[..., None].expand(B, N, 3))
    exact = _sq3(diff[..., 0], diff[..., 1], diff[..., 2])
    dist = torch.sqrt(torch.where(found, exact, torch.zeros_like(exact)))
    return dist, idx, found


def _check(query, query_valid, data, data_valid, batched: bool = False):
    for name, t, dt in (("query", query, torch.float32), ("data", data, torch.float32),
                        ("query_valid", query_valid, torch.bool),
                        ("data_valid", data_valid, torch.bool)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != query.device:
            raise ValueError(f"{name} is on {t.device}, query on {query.device}")
    lead = 1 if batched else 0
    if (query.dim() != 2 + lead or query.shape[-1] != 3 or data.dim() != 2 + lead
            or data.shape[-1] != 3 or query.shape[:lead] != data.shape[:lead]):
        form = "(B, N, 3)/(B, M, 3)" if batched else "(N, 3)/(M, 3)"
        raise ValueError(f"query/data must be {form}, got "
                         f"{tuple(query.shape)}/{tuple(data.shape)}")
    if query_valid.shape != query.shape[:-1] or data_valid.shape != data.shape[:-1]:
        raise ValueError("validity masks must match the point counts")
    if data.shape[-2] == 0:
        raise ValueError("data cloud is empty")


def fused_nn(query, query_valid, data, data_valid):
    """Nearest valid data point per query: the CUDA kernel on CUDA tensors,
    the plain version on CPU tensors, an error on anything else."""
    _check(query, query_valid, data, data_valid)
    if query.device.type == "cpu":
        return fused_nn_plain(query, query_valid, data, data_valid)
    if query.device.type != "cuda":
        raise RuntimeError(f"fused_nn: unsupported device {query.device}")
    query, query_valid = query.contiguous(), query_valid.contiguous()
    # the kernel reads the data in 16-byte words
    data, data_valid = kernels.aligned16(data), kernels.aligned16(data_valid)
    N, M = query.shape[0], data.shape[0]
    dist = torch.empty(N, dtype=torch.float32, device=query.device)
    idx = torch.empty(N, dtype=torch.int64, device=query.device)
    found = torch.empty(N, dtype=torch.bool, device=query.device)
    kernels.launch(
        "fused_nn_launch", query.data_ptr(), query_valid.data_ptr(), N,
        data.data_ptr(), data_valid.data_ptr(), M,
        dist.data_ptr(), idx.data_ptr(), found.data_ptr(),
        kernels.current_stream())
    fused_nn_stats.launches += 1
    return dist, idx, found


def fused_nn_batched(query, query_valid, data, data_valid):
    """``fused_nn`` of B problems, (B, N, 3) queries against (B, M, 3) data,
    in one launch on CUDA tensors; the batched plain version on CPU tensors,
    an error on anything else."""
    _check(query, query_valid, data, data_valid, batched=True)
    if query.device.type == "cpu":
        return fused_nn_batched_plain(query, query_valid, data, data_valid)
    if query.device.type != "cuda":
        raise RuntimeError(f"fused_nn_batched: unsupported device {query.device}")
    B, N, M = query.shape[0], query.shape[1], data.shape[1]
    pad = -M % 4  # each problem's data rows start on a 16-byte boundary
    if pad:
        data = torch.nn.functional.pad(data, (0, 0, 0, pad))
        data_valid = torch.nn.functional.pad(data_valid, (0, pad))
    query, query_valid = query.contiguous(), query_valid.contiguous()
    data, data_valid = kernels.aligned16(data), kernels.aligned16(data_valid)
    dist = torch.empty((B, N), dtype=torch.float32, device=query.device)
    idx = torch.empty((B, N), dtype=torch.int64, device=query.device)
    found = torch.empty((B, N), dtype=torch.bool, device=query.device)
    kernels.launch(
        "fused_nn_batched_launch", query.data_ptr(), query_valid.data_ptr(), N,
        data.data_ptr(), data_valid.data_ptr(), M + pad, B,
        dist.data_ptr(), idx.data_ptr(), found.data_ptr(),
        kernels.current_stream())
    fused_nn_batched_stats.launches += 1
    return dist, idx, found
