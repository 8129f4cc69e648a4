"""Feature-space correspondences (counterpart of
``poseestimator_tpu/registration/features.py``): each source point's nearest
destination point in FPFH space, from one dense distance matrix and an
argmin (the lowest index on ties)."""
from __future__ import annotations

import torch

from ..geom3d.knn import BIG, masked_sqdist


def match_features(feat_src, src_valid, feat_dst, dst_valid, mutual: bool = False):
    """Matches src (..., N, F) -> dst (M, F): ``(idx (..., N), ok (..., N))``.
    ``mutual`` also requires the destination's best source match to be the
    same pair (Open3D's ``mutual_filter``)."""
    d2 = masked_sqdist(feat_src, src_valid, feat_dst, dst_valid)
    best, idx = d2.min(dim=-1)
    ok = (best < BIG * 0.5) & src_valid
    if mutual:
        back = torch.argmin(d2, dim=-2)  # best src for each dst
        ok = ok & (back.gather(-1, idx) == torch.arange(d2.shape[-2], device=d2.device))
    return idx, ok
