"""Registration quality and pose accuracy metrics (counterpart of
``poseestimator_tpu/geom3d/metrics.py``): nearest-neighbour residuals, the
symmetric Chamfer distance, the search's ``alignment_score``, the cloud
resolution, and the pose metrics of the BOP evaluation (ADD, ADD-S, and
the symmetry-aware MSSD and MSPD of Hodan et al., ECCV 2020). Source clouds
may carry a leading batch axis; the nearest-neighbour pass flattens it into
one query set, so a batch costs one K1 launch on the card (and the Chamfer
distance's reverse pass one batched K1 launch)."""
from __future__ import annotations

import torch

from .camera import project_points
from .cloud import PointCloud
from .knn import knn, nearest_neighbor, nearest_neighbor_batched
from .masked import masked_max, masked_mean, masked_median, masked_percentile
from .sampling import voxel_coverage
from .se3 import transform_points


def nn_residuals(src: PointCloud, dst: PointCloud):
    """Distance from each valid src point (..., N) to its nearest valid dst
    point: ``(dists, valid)``."""
    shape = src.valid.shape
    d, _, found = nearest_neighbor(src.points.reshape(-1, 3), src.valid.reshape(-1),
                                   dst.points, dst.valid)
    return d.reshape(shape), src.valid & found.reshape(shape)


def chamfer_distance(a: PointCloud, b: PointCloud) -> torch.Tensor:
    """Symmetric mean Chamfer distance, mean NN(a -> b) + mean NN(b -> a);
    ``a`` may be a (B, N) batch of clouds against one ``b`` -> (B,)."""
    d_ab, m_ab = nn_residuals(a, b)
    if a.valid.dim() == 1:
        d_ba, m_ba = nn_residuals(b, a)
    else:
        B = a.valid.shape[0]
        d_ba, _, found = nearest_neighbor_batched(
            b.points.expand((B,) + b.points.shape), b.valid.expand((B,) + b.valid.shape),
            a.points, a.valid)
        m_ba = b.valid & found
    return masked_mean(d_ab, m_ab, dim=-1) + masked_mean(d_ba, m_ba, dim=-1)


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


def cloud_resolution(cloud: PointCloud, k: int = 8) -> torch.Tensor:
    """Median distance to the k nearest neighbours over the cloud; 0.005
    for fewer than 2 points."""
    dists, _, nb_valid = knn(cloud.points, cloud.valid, cloud.points, cloud.valid, k,
                             exclude_self=True)
    med = masked_median(dists.reshape(-1), nb_valid.reshape(-1))
    return torch.where(cloud.count() >= 2, med, torch.full_like(med, 0.005))


def add_metric(T_est: torch.Tensor, T_gt: torch.Tensor, model: PointCloud) -> torch.Tensor:
    """ADD: mean distance between the model points under the two poses."""
    pe = transform_points(T_est, model.points)
    pg = transform_points(T_gt, model.points)
    return masked_mean(torch.linalg.vector_norm(pe - pg, dim=1), model.valid)


def adds_metric(T_est: torch.Tensor, T_gt: torch.Tensor, model: PointCloud) -> torch.Tensor:
    """ADD-S: mean distance from each model point under the true pose to
    the nearest model point under the estimate (one K1 pass)."""
    d, m = nn_residuals(model.transform(T_gt), model.transform(T_est))
    return masked_mean(d, m)


def _sym_stack(symmetries, like: torch.Tensor) -> torch.Tensor:
    if symmetries is None:
        return torch.eye(4, dtype=like.dtype, device=like.device)[None]
    return symmetries


def mssd_metric(T_est: torch.Tensor, T_gt: torch.Tensor, model: PointCloud,
                symmetries=None) -> torch.Tensor:
    """MSSD: ``min over S of max over x of ||T_est x - T_gt S x||``, the
    symmetries (S, 4, 4) as one batched transform (identity when None)."""
    S = _sym_stack(symmetries, T_est)
    pe = transform_points(T_est, model.points)  # (N, 3)
    pg = transform_points(T_gt @ S, model.points)  # (S, N, 3)
    d = torch.linalg.vector_norm(pe - pg, dim=-1)
    return masked_max(d, model.valid, dim=-1).amin()


def mspd_metric(T_est: torch.Tensor, T_gt: torch.Tensor, K: torch.Tensor, model: PointCloud,
                symmetries=None) -> torch.Tensor:
    """MSPD: ``min over S of max over x of ||proj(T_est x) - proj(T_gt S
    x)||`` in pixels; points behind either camera are left out of the max."""
    S = _sym_stack(symmetries, T_est)
    uv_e, front_e = project_points(model.points, K, T_est)
    uv_g, front_g = project_points(model.points, K, T_gt @ S)
    d = torch.linalg.vector_norm(uv_e - uv_g, dim=-1)
    return masked_max(d, model.valid & front_e & front_g, dim=-1).amin()
