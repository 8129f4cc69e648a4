"""The per-frame tracking program (counterpart of ``_track_step`` and
``Tracker._build_fused_step`` in ``poseestimator_tpu/pipeline/tracking.py``).

``track_step`` renders the CAD at the last pose in an object window at half
resolution (kernel K2), back-projects the predicted and the observed depth,
samples both to 4096 points, removes statistical outliers from the
observation and runs point-to-point ICP (kernel K1 on every evaluation).
``FusedFrame`` puts detection in front of it: letterbox, YOLO11-seg, DFL
decode, NMS, one proto mask, then ``track_step``, and keeps the old pose
when nothing was detected. Shapes are static; the ICP and NMS loops read one
flag back per iteration.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..device import resolve_device
from ..geom3d.camera import Intrinsics, backproject_depth
from ..geom3d.outliers import remove_statistical_outlier
from ..geom3d.sampling import random_sample
from ..models.yolo.decode import decode_boxes
from ..models.yolo.masks import assemble_masks
from ..models.yolo.model import YOLO11Seg
from ..models.yolo.nms import nms
from ..models.yolo.preprocess import letterbox
from ..registration.icp import icp_point_to_point
from ..render.raster import render_depth_mesh
from .window import window_dims, window_gather, window_origin

SAMPLE_PTS = 4096  # points per cloud after sampling
RENDER_DOWNSCALE = 2  # the predicted view renders at half resolution


@dataclass
class TrackResult:
    T: torch.Tensor  # (4, 4) updated model-to-camera pose
    fitness: torch.Tensor
    rmse: torch.Tensor
    cov: torch.Tensor  # (6, 6) camera-frame twist covariance
    n_iters: int  # ICP loop bodies run (K1 launches = n_iters + 1)


def track_step(mesh_v: torch.Tensor, mesh_f: torch.Tensor, mask: torch.Tensor,
               depth: torch.Tensor, T_m2c: torch.Tensor, intr: Intrinsics,
               icp_dist=0.01, win_hw="auto", icp_pose_tol=5e-5,
               generator: Optional[torch.Generator] = None,
               draws: Optional[dict] = None) -> TrackResult:
    """One dense tracking update (ICP on the full 4096-point clouds, the
    JAX package's ``target_pts=0``) from pose ``T_m2c`` against the observed
    ``depth`` (H, W) under ``mask`` (H, W): mesh render, point-to-point ICP.

    ``win_hw``: "auto", None (full frame) or an explicit (h, w) window at
    render resolution. ``draws`` injects the samplers' random numbers,
    ``{"tpl": (gumbel, uniform), "obs": (gumbel, uniform)}``; a missing
    entry is drawn from ``generator``.
    """
    draws = draws or {}
    r = RENDER_DOWNSCALE
    intr_r = intr.scaled(r)
    win = window_dims(intr_r, win_hw)
    if win is not None:
        wh, ww = win
        orig_r = window_origin(mesh_v, T_m2c, intr_r, wh, ww)
        dtpl = render_depth_mesh(mesh_v, mesh_f, T_m2c, intr_r, near=0.01, far=5.0,
                                 origin=orig_r.to(torch.float32), out_hw=win)
        tpl = backproject_depth(dtpl, intr_r, depth_min=0.01, depth_max=5.0,
                                origin=orig_r)
    else:
        dtpl = render_depth_mesh(mesh_v, mesh_f, T_m2c, intr_r, near=0.01, far=5.0)
        tpl = backproject_depth(dtpl, intr_r, depth_min=0.01, depth_max=5.0)
    prev_down = random_sample(tpl, SAMPLE_PTS, generator, draws.get("tpl"))

    if win is not None:
        orig_f = orig_r.to(torch.int64) * r
        dwin = window_gather(depth, orig_f[1], orig_f[0], wh * r, ww * r)
        mwin = window_gather(mask, orig_f[1], orig_f[0], wh * r, ww * r)
        obs = backproject_depth(dwin, intr, mask=mwin, depth_min=1e-6, origin=orig_f)
    else:
        obs = backproject_depth(depth, intr, mask=mask, depth_min=1e-6)
    obs = random_sample(obs, SAMPLE_PTS, generator, draws.get("obs"))
    dst_down = remove_statistical_outlier(obs, 20, 1.0)

    # product resolutions (windowed) run Besl-McKay accelerated ICP; tiny
    # full-frame cameras keep the exact Open3D-parity sequence
    icp = icp_point_to_point(prev_down, dst_down, max_corr_dist=icp_dist,
                             max_iterations=30, with_cov=True,
                             accel=win is not None, accel_pose_tol=icp_pose_tol)
    return TrackResult(T=icp.T @ T_m2c, fitness=icp.fitness, rmse=icp.inlier_rmse,
                       cov=icp.cov, n_iters=icp.n_iters)


@dataclass
class FrameResult:
    T: torch.Tensor  # (4, 4) pose after the frame (the input pose if not ok)
    ok: torch.Tensor  # bool: a detection and a non-empty mask
    fitness: torch.Tensor
    rmse: torch.Tensor
    cov: torch.Tensor
    n_iters: int


class FusedFrame:
    """Detect + track for one object at camera rate.

    ``model`` is a YOLO11-seg module (moved to ``device`` and put in eval
    mode); ``mesh_v`` (V, 3) / ``mesh_f`` (F, 3) the CAD's raster assets;
    ``intr`` the full-resolution camera; ``win_hw`` the object-window bucket
    (``window_for_object``). ``device`` defaults to the card and raises when
    there is none; ``device="cpu"`` runs the plain versions of the kernels.
    """

    def __init__(self, model: YOLO11Seg, mesh_v, mesh_f, intr: Intrinsics,
                 win_hw="auto", imgsz: int = 640, max_det: int = 32,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.mesh_v = torch.as_tensor(mesh_v, dtype=torch.float32, device=self.device)
        self.mesh_f = torch.as_tensor(mesh_f, dtype=torch.int64, device=self.device)
        self.intr = intr
        self.win_hw = win_hw
        self.imgsz = imgsz
        self.max_det = max_det

    @torch.no_grad()
    def __call__(self, color_bgr: torch.Tensor, depth: torch.Tensor, T: torch.Tensor,
                 conf: float = 0.25, icp_dist: float = 0.01,
                 mask_union: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[dict] = None) -> FrameResult:
        """One frame: ``color_bgr`` (H, W, 3), ``depth`` (H, W) metres, ``T``
        the last pose. ``mask_union`` (H, W) bool is OR-ed into the detected
        mask (a benchmark keeps every detection op live this way while the
        track step sees the object's true silhouette)."""
        lb, meta = letterbox(color_bgr, self.imgsz)
        raw = self.model(lb.permute(2, 0, 1)[None])
        boxes, cls, mc = decode_boxes(raw)
        d = nms(boxes[0], cls[0], mc[0], conf_thres=conf, iou_thres=0.7,
                pre_nms=1024, max_det=self.max_det)
        # tracking consumes only the top detection's mask
        mask = assemble_masks(raw["proto"][0], d.coeffs[:1], d.boxes[:1], d.valid[:1],
                              meta, self.intr.height, self.intr.width)[0]
        if mask_union is not None:
            mask = mask | mask_union
        tr = track_step(self.mesh_v, self.mesh_f, mask, depth, T, self.intr, icp_dist,
                        win_hw=self.win_hw, generator=generator, draws=draws)
        ok = (d.count() > 0) & mask.any()
        return FrameResult(T=torch.where(ok, tr.T, T), ok=ok, fitness=tr.fitness,
                           rmse=tr.rmse, cov=tr.cov, n_iters=tr.n_iters)
