"""Statistical outlier removal (counterpart of
``poseestimator_tpu/geom3d/outliers.py``): mean distance to the k nearest
neighbours per point; keep points whose mean is <= global mean + std_ratio *
global std. The JAX hot path selects neighbours with ``lax.approx_min_k``
(a TPU partial-sort unit); the port selects the exact top k, which is what
``approx_min_k`` returns on the CPU as well."""
from __future__ import annotations

from .cloud import PointCloud
from .knn import knn
from .masked import masked_mean, masked_std


def remove_statistical_outlier(cloud: PointCloud, nb_neighbors: int = 20,
                               std_ratio: float = 1.0) -> PointCloud:
    """The cloud with outliers masked out (no data movement)."""
    dists, _, nb_valid = knn(cloud.points, cloud.valid, cloud.points, cloud.valid,
                             nb_neighbors, exclude_self=True)
    mean_d = masked_mean(dists, nb_valid, dim=1)
    mu = masked_mean(mean_d, cloud.valid)
    sigma = masked_std(mean_d, cloud.valid)
    return cloud.mask_where(mean_d <= mu + std_ratio * sigma)
