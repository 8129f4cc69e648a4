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
"""
from __future__ import annotations

import torch

from .. import kernels

BIG = 3.0e38
# query rows per chunk of the plain version: bounds its (chunk, M) temporaries
_PLAIN_CHUNK_ELEMS = 16 * 1024 * 1024


fused_nn_stats = kernels.LaunchCounter()


def _sq3(x, y, z):
    return (x * x + y * y) + z * z


def fused_nn_plain(query, query_valid, data, data_valid):
    """The kernel's arithmetic, elementwise in the same order (no matmul,
    whose rounding differs), chunked over queries."""
    N, M = query.shape[0], data.shape[0]
    qx, qy, qz = query[:, 0], query[:, 1], query[:, 2]
    bx, by, bz = data[:, 0], data[:, 1], data[:, 2]
    b2 = torch.where(data_valid, _sq3(bx, by, bz), torch.full_like(bx, BIG))
    bx, by, bz = -2.0 * bx, -2.0 * by, -2.0 * bz
    q2 = _sq3(qx, qy, qz)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // max(M, 1))
    best, bidx = [], []
    for s in range(0, N, chunk):
        e = min(N, s + chunk)
        cross = (qx[s:e, None] * bx + qy[s:e, None] * by) + qz[s:e, None] * bz
        d2 = (q2[s:e, None] + b2) + cross
        m, a = d2.min(dim=1)
        best.append(m)
        bidx.append(torch.where(m < BIG, a, torch.zeros_like(a)))
    best = torch.cat(best)
    idx = torch.cat(bidx)
    found = query_valid & (best < BIG * 0.5) & data_valid.any()
    diff = query - data[idx]
    exact = _sq3(diff[:, 0], diff[:, 1], diff[:, 2])
    dist = torch.sqrt(torch.where(found, exact, torch.zeros_like(exact)))
    return dist, idx, found


def _check(query, query_valid, data, data_valid):
    for name, t, dt in (("query", query, torch.float32), ("data", data, torch.float32),
                        ("query_valid", query_valid, torch.bool),
                        ("data_valid", data_valid, torch.bool)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != query.device:
            raise ValueError(f"{name} is on {t.device}, query on {query.device}")
    if query.dim() != 2 or query.shape[1] != 3 or data.dim() != 2 or data.shape[1] != 3:
        raise ValueError(f"query/data must be (N, 3)/(M, 3), got "
                         f"{tuple(query.shape)}/{tuple(data.shape)}")
    if query_valid.shape != query.shape[:1] or data_valid.shape != data.shape[:1]:
        raise ValueError("validity masks must match the point counts")
    if data.shape[0] == 0:
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
        "fused_nn", query.data_ptr(), query_valid.data_ptr(), N,
        data.data_ptr(), data_valid.data_ptr(), M,
        dist.data_ptr(), idx.data_ptr(), found.data_ptr(),
        kernels.current_stream())
    fused_nn_stats.launches += 1
    return dist, idx, found
