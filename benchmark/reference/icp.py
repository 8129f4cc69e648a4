"""Plain PyTorch point-to-point registration: the reference's tracking
update and its judge of a search's answer.

A tracking update renders the CAD at the last pose at half resolution over
the whole frame, back-projects every covered pixel (the predicted view),
back-projects every observed pixel inside the object's mask, drops the
statistical outliers of the observation (20 neighbours, 1.0 standard
deviation), and runs point-to-point ICP (exhaustive nearest neighbours,
pairs within the correspondence radius, Kabsch by SVD) to convergence. It
takes every point where the program samples 4096, and runs until the update
is below 1e-7 where the program stops at its own tolerances: it is the
optimum the program's step approximates.

Squared distances use the expanded form |q|^2 + |d|^2 - 2 q.d with the
cross term as a float32 matrix product, the plain way to write it; with
TF32 off it rounds at ~1% of a millimetre-scale distance 0.5 m out, with
TF32 on at tens of millimetres squared. So the reference computed in TF32,
the control, chooses other neighbours.
"""
from __future__ import annotations

import torch

from . import raster as rr

ROWS = 2048  # query rows a block of the distance matrix
MAX_ITERS = 100
TOL = 1e-7


def sqdist_nn(q: torch.Tensor, d: torch.Tensor, k: int = 1):
    """(k smallest squared distances (N, k), indices (N, k)) of each query
    among the data points, in blocks of query rows."""
    d2sum = (d * d).sum(1)
    out_v, out_i = [], []
    for s in range(0, q.shape[0], ROWS):
        qb = q[s:s + ROWS]
        m = torch.clamp((qb * qb).sum(1, keepdim=True) + d2sum[None, :] - 2.0 * (qb @ d.T),
                        min=0.0)
        v, i = torch.topk(m, k, dim=1, largest=False)
        out_v.append(v)
        out_i.append(i)
    return torch.cat(out_v), torch.cat(out_i)


def remove_outliers(pts: torch.Tensor, k: int = 20, std_ratio: float = 1.0) -> torch.Tensor:
    """Points whose mean distance to their k nearest others is at most the
    mean of those means plus ``std_ratio`` standard deviations."""
    if pts.shape[0] <= k + 1:
        return pts
    v, _ = sqdist_nn(pts, pts, k + 1)  # the point itself comes first
    mean_d = torch.sqrt(v[:, 1:]).mean(1)
    keep = mean_d <= mean_d.mean() + std_ratio * mean_d.std()
    return pts[keep]


def kabsch(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """(4, 4) rigid transform taking ``src`` onto ``dst`` (least squares)."""
    cs, cd = src.mean(0), dst.mean(0)
    S = (src - cs).T @ (dst - cd)
    U, _, Vh = torch.linalg.svd(S)
    D = torch.eye(3, dtype=src.dtype, device=src.device)
    D[2, 2] = torch.sign(torch.linalg.det(Vh.T @ U.T))
    R = Vh.T @ D @ U.T
    T = torch.eye(4, dtype=src.dtype, device=src.device)
    T[:3, :3] = R
    T[:3, 3] = cd - R @ cs
    return T


def icp(src: torch.Tensor, dst: torch.Tensor, max_corr: float) -> torch.Tensor:
    """(4, 4) update D with D src ~ dst, from the identity."""
    D = torch.eye(4, dtype=src.dtype, device=src.device)
    for _ in range(MAX_ITERS):
        moved = rr.transform(D, src)
        d2, idx = sqdist_nn(moved, dst)
        pair = d2[:, 0] <= max_corr * max_corr
        if int(pair.sum()) < 3:
            break
        step = kabsch(moved[pair], dst[idx[pair, 0]])
        D = step @ D
        rot = torch.linalg.norm(step[:3, :3] - torch.eye(3, device=src.device))
        if float(torch.linalg.norm(step[:3, 3])) < TOL and float(rot) < TOL:
            break
    return D


def predicted_view(verts, faces, T, cam: dict, downscale: int = 2) -> torch.Tensor:
    """Camera-frame points of the CAD rendered at ``T`` at 1/downscale."""
    cam_r = rr.scaled(cam, downscale)
    return rr.backproject(rr.render_depth(verts, faces, T, cam_r), cam_r)


def observed_cloud(depth: torch.Tensor, mask: torch.Tensor, cam: dict) -> torch.Tensor:
    return remove_outliers(rr.backproject(depth, cam, mask))


def track_update(verts, faces, T_prev: torch.Tensor, depth: torch.Tensor, mask: torch.Tensor,
                 cam: dict, max_corr: float = 0.01) -> torch.Tensor:
    """The reference's pose after one frame, from ``T_prev``."""
    src = predicted_view(verts, faces, T_prev, cam)
    dst = observed_cloud(depth, mask, cam)
    if src.shape[0] < 3 or dst.shape[0] < 3:
        return T_prev.clone()
    return icp(src, dst, max_corr) @ T_prev


def add_mm(T_a: torch.Tensor, T_b: torch.Tensor, pts: torch.Tensor) -> float:
    """ADD: the mean distance, in mm, between the model points under the two
    poses."""
    return float(torch.linalg.norm(rr.transform(T_a, pts) - rr.transform(T_b, pts), dim=-1)
                 .mean()) * 1e3


def adds_mm(T_est: torch.Tensor, T_gt: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """ADD-S of B poses (B, 4, 4) against their truths, in mm: for each model
    point under the estimate, the distance to the nearest model point under
    the truth, averaged. Differences written out, no matrix product."""
    a = rr.transform(T_est, pts)  # (B, N, 3)
    b = rr.transform(T_gt, pts)
    out = []
    for i in range(a.shape[0]):
        best = torch.full((a.shape[1],), float("inf"), device=a.device)
        for s in range(0, b.shape[1], 512):
            d = torch.linalg.norm(a[i][:, None, :] - b[i][None, s:s + 512, :], dim=-1)
            best = torch.minimum(best, d.min(1).values)
        out.append(best.mean())
    return torch.stack(out) * 1e3
