"""Point-to-point ICP (counterpart of ``icp_point_to_point`` in
``poseestimator_tpu/registration/icp.py``).

Each evaluation is one nearest-neighbour pass (kernel K1 on the card),
inlier gating at ``max_corr_dist`` and a weighted Horn alignment. The JAX
``lax.while_loop`` becomes a Python loop with the same exit test, evaluated
on the device and read back once per iteration (one host synchronisation per
iteration); ``n_iters`` counts loop bodies exactly as the JAX loop does, so
the kernel runs ``n_iters + 1`` times.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..geom3d.cloud import PointCloud
from ..geom3d.knn import nearest_neighbor
from ..geom3d.se3 import axis_angle_to_R, make_T
from .kabsch import kabsch


@dataclass
class ICPResult:
    T: torch.Tensor  # (4, 4) src -> dst
    fitness: torch.Tensor  # inlier fraction of valid src points
    inlier_rmse: torch.Tensor
    n_iters: int
    # (6, 6) Gauss-Newton covariance of the left twist (omega, t) in the dst
    # frame; None unless with_cov
    cov: Optional[torch.Tensor] = None


def _gn_covariance(J, r_sq, w, n_inl, res_dim):
    """``sigma^2 (J^T W J)^{-1}``, sigma^2 from the weighted residual sum over
    ``res_dim * n_inl - 6`` degrees of freedom; degenerate directions are
    floored at 1e-12 * trace so the inverse exists."""
    Jf = J.reshape(-1, 6)
    wf = w.repeat_interleave(J.shape[1])
    M = (Jf * wf[:, None]).T @ Jf
    dof = torch.clamp(res_dim * n_inl.to(torch.float32) - 6.0, min=1.0)
    sigma2 = (w * r_sq).sum() / dof
    floor = 1e-12 * torch.trace(M) + 1e-20
    A = M + floor * torch.eye(6, dtype=M.dtype, device=M.device)
    # inv_ex: no host synchronisation on the card for the error check
    return sigma2 * torch.linalg.inv_ex(A).inverse


def _skew(x):
    z = torch.zeros_like(x[..., 0])
    return torch.stack([
        torch.stack([z, -x[..., 2], x[..., 1]], dim=-1),
        torch.stack([x[..., 2], z, -x[..., 0]], dim=-1),
        torch.stack([-x[..., 1], x[..., 0], z], dim=-1),
    ], dim=-2)


def _robust_weights(d: torch.Tensor, kernel: str, scale) -> torch.Tensor:
    """IRLS weights: ``none`` 1; ``huber`` min(1, s/d); ``tukey``
    (1 - (d/s)^2)^2 inside s, 0 outside."""
    if kernel == "none":
        return torch.ones_like(d)
    if kernel == "huber":
        return torch.clamp(scale / torch.clamp(d, min=1e-12), max=1.0)
    if kernel == "tukey":
        r = torch.clamp(d / scale, 0.0, 1.0)
        return (1.0 - r * r) ** 2
    raise ValueError(f"unknown robust kernel {kernel!r}")


def icp_point_to_point(
    src: PointCloud,
    dst: PointCloud,
    max_corr_dist,
    init_T: Optional[torch.Tensor] = None,
    max_iterations: int = 30,
    relative_fitness: float = 1e-6,
    relative_rmse: float = 1e-6,
    robust: str = "none",
    with_cov: bool = False,
    accel: bool = False,
    accel_pose_tol: float = 2e-5,
) -> ICPResult:
    """Open3D-parity point-to-point ICP; ``robust`` selects an IRLS kernel
    (scale = max_corr_dist / 2); ``with_cov`` adds the 6x6 Gauss-Newton pose
    covariance; ``accel`` enables Besl-McKay step extrapolation with the
    raw-twist exit ``accel_pose_tol`` (see the JAX package for the
    derivation)."""
    dev = src.points.device
    f32 = torch.float32
    if init_T is None:
        init_T = torch.eye(4, dtype=f32, device=dev)
    max_corr_dist = torch.as_tensor(max_corr_dist, dtype=f32, device=dev)
    accel_pose_tol = torch.as_tensor(accel_pose_tol, dtype=f32, device=dev)
    n_src = torch.clamp(src.valid.sum(), min=1)
    robust_scale = max_corr_dist * 0.5

    def evaluate(T):
        moved = src.transform(T)
        d, idx, found = nearest_neighbor(moved.points, moved.valid, dst.points, dst.valid)
        inl = src.valid & found & (d <= max_corr_dist)
        n_inl = inl.sum()
        fitness = n_inl.to(f32) / n_src.to(f32)
        rmse = torch.sqrt(torch.where(inl, d * d, torch.zeros_like(d)).sum()
                          / torch.clamp(n_inl, min=1))
        return moved.points, idx, inl, fitness, rmse

    def keep_going(fitness, rmse, prev_fitness, prev_rmse, v_prev):
        keep = ((prev_fitness - fitness).abs() > relative_fitness) | (
            (prev_rmse - rmse).abs() > relative_rmse)
        if accel:
            # the rmse exit is blind to tangential slide; keep going while
            # the last raw twist exceeds the tolerance or the step
            # extrapolated (slot 6)
            keep = (keep | (v_prev[6] > 0.5)
                    | (torch.linalg.vector_norm(v_prev[:6]) > accel_pose_tol))
        return keep

    T = init_T
    pts, idx, inl, fitness, rmse = evaluate(T)
    prev_fitness, prev_rmse = fitness + 1.0, rmse + 1.0
    v_prev = torch.zeros(7, dtype=f32, device=dev)
    it = 0
    while it < max_iterations and bool(
            keep_going(fitness, rmse, prev_fitness, prev_rmse, v_prev)):
        w = inl.to(f32)
        q = dst.points[idx]
        if robust != "none":
            w = w * _robust_weights(torch.linalg.vector_norm(pts - q, dim=1),
                                    robust, robust_scale)
        R, t = kabsch(pts, q, w)
        D = make_T(R, t)
        if accel:
            wv = 0.5 * torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                                    R[1, 0] - R[0, 1]])
            v6 = torch.cat([wv, t])
            nv = torch.linalg.vector_norm(v6)
            npv = torch.linalg.vector_norm(v_prev[:6])
            cosang = (v6 * v_prev[:6]).sum() / torch.clamp(nv * npv, min=1e-30)
            ratio = nv / torch.clamp(npv, min=1e-30)
            # geometric-series extrapolation on an established near-parallel
            # contraction, clipped so a noisy ratio cannot catapult the pose
            engage = (cosang > 0.95) & (ratio < 0.999) & (npv > 1e-12)
            gamma = torch.clamp(1.0 / torch.clamp(1.0 - ratio, min=1e-3), 1.0, 8.0)
            g1 = torch.where(engage, gamma - 1.0, torch.zeros_like(gamma))
            axis = wv / torch.clamp(torch.linalg.vector_norm(wv), min=1e-30)
            R_e = axis_angle_to_R(axis, g1 * torch.linalg.vector_norm(wv))
            D = make_T(R_e, g1 * t) @ D
            v_prev = torch.cat([v6, engage.to(f32)[None]])
        T = D @ T
        prev_fitness, prev_rmse = fitness, rmse
        pts, idx, inl, fitness, rmse = evaluate(T)
        it += 1

    cov = None
    if with_cov:
        # residual r = x - q with x the final transformed src point; its
        # Jacobian wrt the left twist (omega, t) is [-[x]x, I]
        q = dst.points[idx]
        w = inl.to(f32)
        if robust != "none":
            w = w * _robust_weights(torch.linalg.vector_norm(pts - q, dim=1),
                                    robust, robust_scale)
        eye = torch.eye(3, dtype=f32, device=dev).expand(pts.shape[0], 3, 3)
        J = torch.cat([-_skew(pts), eye], dim=-1)  # (N, 3, 6)
        r_sq = ((pts - q) ** 2).sum(1)
        cov = _gn_covariance(J, r_sq, w, inl.sum(), 3)
    return ICPResult(T=T, fitness=fitness, inlier_rmse=rmse, n_iters=it, cov=cov)
