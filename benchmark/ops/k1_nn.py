"""Kernel K1's work: nearest-neighbour queries, one valid query point against
every valid data point.

Copied from ``chip_smoke.py::nn_bound``: 8 float32 operations and a compare
a pair; each input read once (points 12 B and a mask byte), for each query
an output of 4 + 8 + 1 B. The pairs are those of the valid points (what
these inputs need), the bytes those of the arrays as passed."""
from __future__ import annotations

KERNELS = ("fused_nn_kernel",)
TARGETS = (("poseestimator_tpu_torch.geom3d.knn", "fused_nn"),
           ("poseestimator_tpu_torch.geom3d.knn", "fused_nn_batched"))


def capture(query, query_valid, data, data_valid, *args, **kwargs):
    return query_valid, data_valid


def count(cap) -> tuple[float, float]:
    qv, dv = cap
    nq = qv.reshape(-1, qv.shape[-1]).sum(-1).double()
    nd = dv.reshape(-1, dv.shape[-1]).sum(-1).double()
    pairs = float((nq * nd).sum())
    n, m = qv.numel(), dv.numel()
    return 9.0 * pairs, 13.0 * (n + m) + 13.0 * n
