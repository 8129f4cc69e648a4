"""Normal estimation by local PCA (counterpart of
``poseestimator_tpu/geom3d/normals.py``): each point's normal is the
smallest-eigenvalue eigenvector of the covariance of its hybrid (radius,
max_nn) neighbourhood, from one batched 3x3 ``torch.linalg.eigh``."""
from __future__ import annotations

from dataclasses import replace

import torch

from .cloud import PointCloud
from .knn import radius_knn


def estimate_normals(cloud: PointCloud, radius: float = 0.05, max_nn: int = 30,
                     orient_towards=(0.0, 0.0, 0.0)) -> PointCloud:
    """The cloud with a ``normals`` field, each normal flipped to point
    toward the viewpoint ``orient_towards`` ((3,) or None to keep the
    eigensolver's sign, which may differ from LAPACK-through-XLA's).
    Invalid points get zero normals."""
    pts, valid = cloud.points, cloud.valid
    _, idx, nb_valid = radius_knn(pts, valid, pts, valid, radius=radius, max_nn=max_nn)
    nbrs = pts[idx]  # (N, K, 3)
    w = nb_valid.to(torch.float32)[..., None]
    n_nb = torch.clamp(w.sum(1), min=1.0)  # (N, 1)
    mean = (nbrs * w).sum(1) / n_nb
    centered = (nbrs - mean[:, None, :]) * w
    cov = torch.einsum("nki,nkj->nij", centered, centered) / n_nb[..., None]
    _, vecs = torch.linalg.eigh(cov)  # ascending eigenvalues
    normals = vecs[:, :, 0]
    if orient_towards is not None:
        view_dir = torch.as_tensor(orient_towards, dtype=torch.float32, device=pts.device) - pts
        sign = torch.where((normals * view_dir).sum(1, keepdim=True) < 0, -1.0, 1.0)
        normals = normals * sign
    normals = normals / torch.clamp(torch.linalg.vector_norm(normals, dim=1, keepdim=True),
                                    min=1e-12)
    return replace(cloud, normals=normals * valid[:, None].to(torch.float32))
