"""Point-to-point and point-to-plane ICP (counterparts of
``icp_point_to_point`` and ``icp_point_to_plane`` in
``poseestimator_tpu/registration/icp.py``).

Each evaluation is one nearest-neighbour pass (kernel K1 on the card),
inlier gating at ``max_corr_dist`` and a weighted Horn alignment. The JAX
``lax.while_loop`` becomes a Python loop with the same exit test, evaluated
on the device and read back once per iteration (one host synchronisation per
iteration); ``n_iters`` counts loop bodies exactly as the JAX loop does, so
the kernel runs ``n_iters + 1`` times.

``icp_point_to_point_program`` is the point-to-point loop as a program of
``chains``: ``icp_point_to_point`` runs one, and ``chains.run_batched``
runs many in lockstep, each with its own source and destination clouds and
its own radius (the multi-object step and the init rollout), with one K1
launch per evaluation for the whole batch and each chain's arithmetic that
of an unbatched call.

``icp_point_to_point_batched`` runs a batch of chains against one shared
destination cloud, as the JAX package's ``vmap`` over the loop does: the
loop runs while any chain continues, a chain that has stopped keeps its
state, and ``n_iters`` is counted per chain. Every evaluation flattens the
chains into one query set, so one K1 launch serves the whole batch; on the
CPU each chain rounds exactly as an unbatched call does, and on the card
each chain's sums over its points run in an order fixed by the point count
(``kabsch.batch_sum``), so a chain's result does not depend on how many
chains run beside it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .. import chains
from ..geom3d.cloud import PointCloud
from ..geom3d.knn import nearest_neighbor
from ..geom3d.se3 import axis_angle_to_R, make_T, transform_points
from ..utils.profiling import host_read, traced
from .kabsch import batch_sum, kabsch, kabsch_batched, matmul_small


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
    return chains.run(icp_point_to_point_program(
        src, dst, max_corr_dist, init_T, max_iterations, relative_fitness, relative_rmse,
        robust, with_cov, accel, accel_pose_tol))


@traced("icp")
def icp_point_to_point_program(src: PointCloud, dst: PointCloud, max_corr_dist,
                               init_T: Optional[torch.Tensor] = None,
                               max_iterations: int = 30, relative_fitness: float = 1e-6,
                               relative_rmse: float = 1e-6, robust: str = "none",
                               with_cov: bool = False, accel: bool = False,
                               accel_pose_tol: float = 2e-5):
    """``icp_point_to_point`` as a program of ``chains``: it yields an
    ``NNQuery`` per evaluation and a ``Continue`` per loop test, and returns
    the ``ICPResult``. ``chains.run_batched`` advances many of them, each
    with its own clouds and radius, with one K1 launch per evaluation."""
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
        d, idx, found = yield chains.NNQuery(moved.points, moved.valid, dst.points, dst.valid)
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
    pts, idx, inl, fitness, rmse = yield from evaluate(T)
    prev_fitness, prev_rmse = fitness + 1.0, rmse + 1.0
    v_prev = torch.zeros(7, dtype=f32, device=dev)
    it = 0
    while it < max_iterations and (yield chains.Continue(
            keep_going(fitness, rmse, prev_fitness, prev_rmse, v_prev))):
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
        pts, idx, inl, fitness, rmse = yield from evaluate(T)
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


@traced("icp")
def icp_point_to_plane(
    src: PointCloud,
    dst: PointCloud,
    max_corr_dist,
    init_T: Optional[torch.Tensor] = None,
    max_iterations: int = 30,
    relative_fitness: float = 1e-6,
    relative_rmse: float = 1e-6,
    robust: str = "none",
    with_cov: bool = False,
) -> ICPResult:
    """Point-to-plane ICP on ``dst.normals``: each iteration solves the
    6x6 small-angle system of ``sum w (n . (R p + t - q))^2`` for the twist
    (omega, t). ``robust`` weights the plane distances with the same IRLS
    kernels as ``icp_point_to_point``; the exit test is Open3D's, with no
    step extrapolation."""
    if dst.normals is None:
        raise ValueError("icp_point_to_plane requires dst.normals")
    dev = src.points.device
    f32 = torch.float32
    if init_T is None:
        init_T = torch.eye(4, dtype=f32, device=dev)
    max_corr_dist = torch.as_tensor(max_corr_dist, dtype=f32, device=dev)
    n_src = torch.clamp(src.valid.sum(), min=1)
    eye6 = torch.eye(6, dtype=f32, device=dev)
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=f32, device=dev)

    def evaluate(T):
        moved = src.transform(T)
        d, idx, found = nearest_neighbor(moved.points, moved.valid, dst.points, dst.valid)
        inl = src.valid & found & (d <= max_corr_dist)
        n_inl = inl.sum()
        fitness = n_inl.to(f32) / n_src.to(f32)
        rmse = torch.sqrt(torch.where(inl, d * d, torch.zeros_like(d)).sum()
                          / torch.clamp(n_inl, min=1))
        return moved.points, idx, inl, fitness, rmse

    T = init_T
    p, idx, inl, fitness, rmse = evaluate(T)
    prev_fitness, prev_rmse = fitness + 1.0, rmse + 1.0
    it = 0
    while it < max_iterations:
        keep = (((prev_fitness - fitness).abs() > relative_fitness)
                | ((prev_rmse - rmse).abs() > relative_rmse))
        with host_read():
            if not bool(keep):
                break
        q, n = dst.points[idx], dst.normals[idx]
        r = (n * (q - p)).sum(1)  # residual n . (q - p)
        w = inl.to(f32)
        if robust != "none":
            w = w * _robust_weights(r.abs(), robust, max_corr_dist * 0.5)
        J = torch.cat([torch.linalg.cross(p, n, dim=1), n], dim=1)  # rows [p x n, n]
        Jw = J * w[:, None]
        # solve_ex: no host synchronisation for the error check
        x = torch.linalg.solve_ex(Jw.T @ J + 1e-9 * eye6, Jw.T @ r).result  # (omega, t)
        angle = torch.linalg.vector_norm(x[:3])
        axis = torch.where(angle > 1e-12, x[:3] / torch.clamp(angle, min=1e-12), x_axis)
        T = make_T(axis_angle_to_R(axis, angle), x[3:]) @ T
        prev_fitness, prev_rmse = fitness, rmse
        p, idx, inl, fitness, rmse = evaluate(T)
        it += 1

    cov = None
    if with_cov:
        # scalar residual n . (x - q) at the final pose; its Jacobian wrt
        # the left twist is [x x n, n], the rows of the in-loop solve
        q, n = dst.points[idx], dst.normals[idx]
        r = (n * (p - q)).sum(1)
        w = inl.to(f32)
        if robust != "none":
            w = w * _robust_weights(r.abs(), robust, max_corr_dist * 0.5)
        J = torch.cat([torch.linalg.cross(p, n, dim=1), n], dim=1)[:, None, :]
        cov = _gn_covariance(J, r * r, w, inl.sum(), 1)
    return ICPResult(T=T, fitness=fitness, inlier_rmse=rmse, n_iters=it, cov=cov)


@dataclass
class BatchedICPResult:
    T: torch.Tensor  # (B, 4, 4) src -> dst per chain
    fitness: torch.Tensor  # (B,)
    inlier_rmse: torch.Tensor  # (B,)
    n_iters: torch.Tensor  # (B,) int64 loop bodies per chain
    n_evals: int  # batched evaluations: K1 launches on the card


@traced("icp")
def icp_point_to_point_batched(
    src_points: torch.Tensor,
    src_valid: torch.Tensor,
    dst: PointCloud,
    max_corr_dist,
    init_T: Optional[torch.Tensor] = None,
    max_iterations: int = 30,
    relative_fitness: float = 1e-6,
    relative_rmse: float = 1e-6,
) -> BatchedICPResult:
    """Open3D-parity point-to-point ICP of B chains ``src_points`` (B, N, 3)
    / ``src_valid`` (B, N) from ``init_T`` (B, 4, 4) onto one ``dst``."""
    B = src_points.shape[0]
    dev = src_points.device
    f32 = torch.float32
    if init_T is None:
        init_T = torch.eye(4, dtype=f32, device=dev).expand(B, 4, 4)
    max_corr_dist = torch.as_tensor(max_corr_dist, dtype=f32, device=dev)
    n_src = torch.clamp(src_valid.sum(-1), min=1)

    def evaluate(T):
        moved = transform_points(T, src_points)
        d, idx, found = nearest_neighbor(moved.reshape(-1, 3), src_valid.reshape(-1),
                                         dst.points, dst.valid)
        d, idx, found = d.view(src_valid.shape), idx.view(src_valid.shape), found.view(src_valid.shape)
        inl = src_valid & found & (d <= max_corr_dist)
        n_inl = inl.sum(-1)
        fitness = n_inl.to(f32) / n_src.to(f32)
        rmse = torch.sqrt(batch_sum(torch.where(inl, d * d, torch.zeros_like(d)), -1)
                          / torch.clamp(n_inl, min=1))
        return moved, idx, inl, fitness, rmse

    T = init_T
    pts, idx, inl, fitness, rmse = evaluate(T)
    n_evals = 1
    prev_fitness, prev_rmse = fitness + 1.0, rmse + 1.0
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    eye = torch.eye(4, dtype=f32, device=dev)
    while True:
        a = (it < max_iterations) & (((prev_fitness - fitness).abs() > relative_fitness)
                                     | ((prev_rmse - rmse).abs() > relative_rmse))
        go = a.any()
        with host_read():
            if not bool(go):
                break
        R, t = kabsch_batched(pts, dst.points[idx], inl.to(f32))
        D = eye.expand(B, 4, 4).clone()
        D[:, :3, :3] = R
        D[:, :3, 3] = t
        T_new = matmul_small(D, T)
        new = evaluate(T_new)
        n_evals += 1
        a1, a2, a3 = a[:, None], a[:, None, None], a
        T = torch.where(a2, T_new, T)
        pts = torch.where(a2, new[0], pts)
        idx = torch.where(a1, new[1], idx)
        inl = torch.where(a1, new[2], inl)
        prev_fitness = torch.where(a3, fitness, prev_fitness)
        prev_rmse = torch.where(a3, rmse, prev_rmse)
        fitness = torch.where(a3, new[3], fitness)
        rmse = torch.where(a3, new[4], rmse)
        it = it + a.to(torch.int64)
    return BatchedICPResult(T=T, fitness=fitness, inlier_rmse=rmse, n_iters=it, n_evals=n_evals)
