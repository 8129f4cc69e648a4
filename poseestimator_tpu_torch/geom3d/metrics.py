"""Registration quality metrics (counterpart of ``nn_residuals`` and
``alignment_score`` in ``poseestimator_tpu/geom3d/metrics.py``). Source
clouds may carry a leading batch axis; the nearest-neighbour pass flattens
it into one query set, so a batch costs one K1 launch on the card."""
from __future__ import annotations

import torch

from .cloud import PointCloud
from .knn import nearest_neighbor
from .masked import masked_median, masked_percentile
from .sampling import voxel_coverage


def nn_residuals(src: PointCloud, dst: PointCloud):
    """Distance from each valid src point (..., N) to its nearest valid dst
    point: ``(dists, valid)``."""
    shape = src.valid.shape
    d, _, found = nearest_neighbor(src.points.reshape(-1, 3), src.valid.reshape(-1),
                                   dst.points, dst.valid)
    return d.reshape(shape), src.valid & found.reshape(shape)


def alignment_score(src_aligned: PointCloud, src_down: PointCloud, dst_down: PointCloud,
                    voxel_size) -> torch.Tensor:
    """median + 0.3 p90 of the NN residuals + 0.5 (1 - voxel-coverage
    ratio, clamped at 1); lower is better."""
    d, m = nn_residuals(src_aligned, dst_down)
    med = masked_median(d, m)
    p90 = masked_percentile(d, m, 90.0)
    cov_aligned = voxel_coverage(src_aligned.points, src_aligned.valid, voxel_size)
    cov_full = voxel_coverage(src_down.points, src_down.valid, voxel_size)
    cov_norm = cov_aligned.to(torch.float32) / torch.clamp(cov_full, min=1).to(torch.float32)
    # a rotation can scatter the template over more voxels than its rest
    # pose; coverage may only penalise
    cov_norm = torch.clamp(cov_norm, max=1.0)
    return med + 0.3 * p90 + 0.5 * (1.0 - cov_norm)
