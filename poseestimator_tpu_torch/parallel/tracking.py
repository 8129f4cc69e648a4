"""Object-axis parallel tracking: the batched multi-object frame step with
the track axis sharded over a mesh (counterpart of
``poseestimator_tpu/parallel/tracking.py``).

Every rank renders and registers its slice of tracks against the frame,
which every rank holds whole, through ``pipeline.tracking.
track_step_batched`` (one batched K2 and one batched K1 per ICP evaluation
on each rank), and the poses, fitness, rmse and covariances are
all-gathered. A track's result does not depend on the batch it runs in
(``chains``), and each rank draws every track's random numbers in the
order the unsharded step draws them and keeps its own tracks', so the
result is bit for bit the unsharded step's whatever the partition.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..geom3d.camera import Intrinsics
from ..pipeline.tracking import RENDER_DOWNSCALE, step_draws, track_step_batched
from ..pipeline.window import window_dims
from .mesh import Mesh, check_divisible

TRACK_POSE_TOL = 5e-5  # track_step's accelerated-ICP pose tolerance


def sharded_multi_track(mesh: Mesh, mesh_v: torch.Tensor, mesh_f: torch.Tensor,
                        masks: torch.Tensor, depth: torch.Tensor, Ts: torch.Tensor,
                        intr: Intrinsics, target_pts: int, icp_dists, axis: str = "dp",
                        generator: Optional[torch.Generator] = None,
                        draws: Optional[list] = None):
    """One sharded multi-object frame step. Every rank passes the full
    inputs: ``mesh_v`` / ``mesh_f`` one mesh or one per track (B, V, 3) /
    (B, F, 3), ``masks`` (B, H, W) with B divisible by the mesh size, the
    shared frame ``depth`` (H, W), ``Ts`` (B, 4, 4), ``icp_dists`` (B,) or
    a scalar; ``draws``, a list of per-track ``track_step`` draws, is
    completed from ``generator`` track by track. The window and the ICP's
    pose tolerance are ``track_step``'s defaults, as the JAX package's
    sharded step runs them. Returns ``(T_new (B, 4, 4), fitness (B,), rmse
    (B,), cov (B, 6, 6))`` on every rank."""
    B = Ts.shape[0]
    check_divisible(B, mesh.shape[axis], "track count")
    dev = mesh.device
    win = window_dims(intr.scaled(RENDER_DOWNSCALE), "auto")
    draws = [step_draws(intr, win, target_pts, generator, dev, d) for d in (draws or [None] * B)]
    dists = torch.as_tensor(icp_dists, dtype=torch.float32, device=dev).expand(B)
    sl = mesh.slice_of(B)
    if mesh_v.dim() == 3:  # one mesh per track (a padded class stack)
        mesh_v, mesh_f = mesh_v[sl], mesh_f[sl]
    res = track_step_batched(mesh_v.to(dev), mesh_f.to(dev), masks[sl].to(dev), depth.to(dev),
                             Ts[sl].to(dev), intr, dists[sl], win_hw=win, target_pts=target_pts,
                             icp_pose_tol=TRACK_POSE_TOL, draws=draws[sl])
    return tuple(mesh.all_gather(x) for x in (res.T, res.fitness, res.rmse, res.cov))
