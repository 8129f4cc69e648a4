"""Sharded large-cloud Chamfer: the point-count scaling axis (counterpart
of ``poseestimator_tpu/parallel/bigcloud.py``).

Both clouds' query axes shard over the mesh: each rank takes the nearest
neighbour of its query slice against the all-gathered other cloud, in both
directions, through ``nearest_neighbor`` (K1 on the card), and the sums
and counts combine with ``all_reduce``.
"""
from __future__ import annotations

import torch

from ..geom3d.knn import nearest_neighbor
from .mesh import Mesh, check_divisible


def sharded_chamfer(mesh: Mesh, a_points: torch.Tensor, a_valid: torch.Tensor,
                    b_points: torch.Tensor, b_valid: torch.Tensor, axis: str = "dp"):
    """Symmetric mean Chamfer, mean NN(a -> b) + mean NN(b -> a), with both
    query axes sharded over ``axis``. Every rank passes the full clouds a
    (N, 3) and b (M, 3) (N and M divisible by the mesh size) and gets the
    full result, a float32 scalar on its device. The distances are K1's,
    recomputed exactly for each winner as in the single-device
    ``chamfer_distance``; the sums reduce in float64, so the result does not
    depend on the partition beyond its final float32 rounding."""
    check_divisible(a_points.shape[0], mesh.shape[axis], "N")
    check_divisible(b_points.shape[0], mesh.shape[axis], "M")
    dev = mesh.device
    a_points, a_valid = a_points.to(dev), a_valid.to(dev)
    b_points, b_valid = b_points.to(dev), b_valid.to(dev)
    sa, sb = mesh.slice_of(a_points.shape[0]), mesh.slice_of(b_points.shape[0])

    def one_direction(q, qv, d, dv):
        dist, _, found = nearest_neighbor(q, qv, d, dv)
        ok = qv & found
        local = torch.stack([torch.where(ok, dist, torch.zeros_like(dist)).sum(dtype=torch.float64),
                             ok.sum().to(torch.float64)])
        s, n = mesh.all_reduce(local)
        return s / torch.clamp(n, min=1.0)

    total = (one_direction(a_points[sa], a_valid[sa], b_points, b_valid)
             + one_direction(b_points[sb], b_valid[sb], a_points, a_valid))
    return total.to(torch.float32)
