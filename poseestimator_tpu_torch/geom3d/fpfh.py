"""Fast Point Feature Histograms, 33-dim, Open3D flavour (counterpart of
``poseestimator_tpu/geom3d/fpfh.py``).

1. Pair features in the PCL convention, source and target swapped so the
   source normal makes the smaller angle with the connecting line:
   theta = atan2(w.n2, n1.n2), alpha = v.n2, phi = u.d. On a swapped pair
   phi keeps +angle2 where PCL/Open3D take -angle2: the JAX package's
   documented deviation (a sign that flips across the swap boundary
   scatters features over bins), kept here.
2. SPFH: each angle histogrammed into 11 bins by ``floor(11 (x - lo) /
   (hi - lo))`` with increment 100 / neighbours.
3. FPFH_i = SPFH_i + the 1/d^2-weighted sum of the neighbours' SPFHs, each
   11-bin group renormalised to 100.
"""
from __future__ import annotations

import math

import torch

from .cloud import PointCloud
from .knn import radius_knn


def _pair_features(p1, n1, p2, n2):
    """(theta, alpha, phi, ok) of the pairs (p1, n1) -> (p2, n2), broadcast
    over leading dims; ``ok`` is False for degenerate pairs (zero distance,
    or a normal parallel to the connecting line)."""
    d = p2 - p1
    dist = torch.linalg.vector_norm(d, dim=-1)
    ok = dist > 1e-12
    du = d / torch.where(ok, dist, torch.ones_like(dist))[..., None]
    a1 = (n1 * du).sum(-1)
    a2 = (n2 * du).sum(-1)
    swap = (a1.abs() < a2.abs())[..., None]
    ns = torch.where(swap, n2, n1)
    nt = torch.where(swap, n1, n2)
    du = torch.where(swap, -du, du)
    phi = torch.where(swap[..., 0], a2, a1)
    v = torch.linalg.cross(du, ns, dim=-1)
    vn = torch.linalg.vector_norm(v, dim=-1)
    ok = ok & (vn > 1e-12)
    v = v / torch.where(vn > 1e-12, vn, torch.ones_like(vn))[..., None]
    w = torch.linalg.cross(ns, v, dim=-1)
    alpha = (v * nt).sum(-1)
    theta = torch.atan2((w * nt).sum(-1), (ns * nt).sum(-1))
    return theta, alpha, phi, ok


def _hist11(x, lo: float, hi: float, ok) -> torch.Tensor:
    """Per-point 11-bin histogram counts (N, 11) of (N, K) values."""
    b = torch.clamp(torch.floor(11.0 * (x - lo) / (hi - lo)).to(torch.int64), 0, 10)
    return (torch.nn.functional.one_hot(b, 11).to(torch.float32) * ok[..., None]).sum(1)


def compute_fpfh(cloud: PointCloud, radius: float, max_nn: int = 100):
    """FPFH features of every valid point: ``(features (N, 33), valid
    (N,))``; needs ``cloud.normals``. Points with no neighbour inside
    ``radius`` get a zero feature (as Open3D leaves them)."""
    if cloud.normals is None:
        raise ValueError("compute_fpfh requires normals; call estimate_normals first")
    pts, nrm, valid = cloud.points, cloud.normals, cloud.valid
    d, idx, nb_valid = radius_knn(pts, valid, pts, valid, radius=radius, max_nn=max_nn,
                                  exclude_self=True)
    d2 = d * d
    theta, alpha, phi, ok = _pair_features(pts[:, None], nrm[:, None], pts[idx], nrm[idx])
    ok = ok & nb_valid
    cnt = nb_valid.to(torch.float32).sum(1)
    hist_incr = 100.0 / torch.clamp(cnt, min=1.0)
    spfh = torch.cat([_hist11(theta, -math.pi, math.pi, ok),
                      _hist11(alpha, -1.0, 1.0, ok),
                      _hist11(phi, -1.0, 1.0, ok)], dim=1) * hist_incr[:, None]
    w = torch.where(nb_valid & (d2 > 0), 1.0 / torch.clamp(d2, min=1e-20), torch.zeros_like(d2))
    acc = torch.einsum("nk,nkf->nf", w, spfh[idx])
    g = acc.reshape(-1, 3, 11)
    gsum = g.sum(2, keepdim=True)
    g = torch.where(gsum > 0, 100.0 * g / torch.clamp(gsum, min=1e-20), torch.zeros_like(g))
    fpfh = spfh + g.reshape(-1, 33)
    return fpfh * valid[:, None].to(torch.float32), valid
