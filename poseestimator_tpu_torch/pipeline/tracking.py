"""The realtime tracking loop (counterpart of
``poseestimator_tpu/pipeline/tracking.py``): the per-frame program and the
INIT / TRACK / LOST state machine around it.

``track_step`` renders the CAD at the last pose in an object window at half
resolution (kernel K2), back-projects the predicted and the observed depth,
samples both to 4096 points, removes statistical outliers from the
observation, optionally samples both down to ``target_pts``, and runs ICP
(kernel K1 on every evaluation): point-to-point, accelerated in a window,
or point-to-plane on observed normals. ``track_step_batched`` advances B
tracks on one frame (the multi-object step and the init rollout) with one
K2 launch and one K1 launch per ICP evaluation for all of them; each track
runs the unbatched step's code (``track_program``, a program of
``chains``), so its result is bit for bit the unbatched step's, whatever
B is. ``FusedFrame`` puts detection in
front of it: letterbox, YOLO11-seg, DFL decode, NMS, one proto mask, then
``track_step``, and keeps the old pose when nothing was detected. Shapes are
static; the ICP and NMS loops read one flag back per iteration.

``Tracker`` is the host-side FSM a user drives with ``step()``: warm-up
detection, the global template search of ``PoseEstimator`` with the upright
snap, then one tracked frame per step (through ``FusedFrame`` when the
detector carries its model, else detection and ``track_step`` as two
calls), LOST on detection misses, re-initialisation, the ranked-candidate
fallback, the low-fitness re-init and the multi-frame init rollout (on
the batched step). The
pose filter and the constant-velocity predictor are host numpy, as in the
JAX package.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import chains
from ..device import resolve_device
from ..geom3d.camera import Intrinsics, backproject_depth
from ..geom3d.normals import estimate_normals
from ..geom3d.outliers import remove_statistical_outlier
from ..geom3d.sampling import make_draws, random_sample
from ..geom3d.se3 import enforce_upright_pose_y_up
from ..models.yolo.decode import decode_boxes
from ..models.yolo.masks import assemble_masks
from ..models.yolo.model import YOLO11Seg
from ..models.yolo.nms import nms
from ..models.yolo.preprocess import letterbox
from ..registration.icp import icp_point_to_plane, icp_point_to_point_program
from ..utils.profiling import host_read, span, traced
from .window import window_dims, window_for_object, window_gather, window_origin

SAMPLE_PTS = 4096  # points per cloud after sampling
RENDER_DOWNSCALE = 2  # the predicted view renders at half resolution
INIT_RADIUS = 0.05  # ICP radius of the rollout and the first post-init rung


def _so3_log(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle vector (numpy, host-side filter math)."""
    cos = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    ang = float(np.arccos(cos))
    if ang < 1e-8:
        return np.zeros(3)
    if ang > np.pi - 1e-5:
        # near pi: the axis from the symmetric part (R + I has rank-1
        # column space), signs fixed from the off-diagonals
        A = (R + np.eye(3)) * 0.5
        axis = np.sqrt(np.maximum(np.diag(A), 0.0))
        if axis[0] > 0:
            axis[1] = np.copysign(axis[1], A[0, 1])
            axis[2] = np.copysign(axis[2], A[0, 2])
        elif axis[1] > 0:
            axis[2] = np.copysign(axis[2], A[1, 2])
        n = np.linalg.norm(axis)
        return axis / max(n, 1e-12) * ang
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return w * (ang / (2.0 * np.sin(ang)))


def _so3_exp(w: np.ndarray) -> np.ndarray:
    """Axis-angle vector -> rotation matrix (numpy)."""
    ang = float(np.linalg.norm(w))
    if ang < 1e-12:
        return np.eye(3)
    k = w / ang
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(ang) * K + (1.0 - np.cos(ang)) * (K @ K)


class PoseFilter:
    """SE(3) alpha-beta output filter on the host: a constant-velocity
    predictor in the error-twist domain (rotation by so3 log/exp,
    translation linear) blends the measurement in with gain ``alpha``; the
    velocity absorbs ``beta`` of the innovation, so steady motion passes
    without the lag of a plain EMA. ``alpha = 1`` passes the measurement
    through. Reset on misses, re-inits and candidate jumps."""

    def __init__(self, alpha: float = 0.5, beta: float = 0.3):
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.reset()

    def reset(self) -> None:
        self._T: Optional[np.ndarray] = None
        self._w = np.zeros(3)  # rotational velocity (axis-angle / frame)
        self._v = np.zeros(3)  # translational velocity (m / frame)

    def __call__(self, T_meas: np.ndarray) -> np.ndarray:
        T_meas = np.asarray(T_meas, np.float64)
        if self.alpha >= 1.0:
            return T_meas.astype(np.float32)
        if self._T is None:
            self._T = T_meas.copy()
            return T_meas.astype(np.float32)
        R_pred = _so3_exp(self._w) @ self._T[:3, :3]
        t_pred = self._T[:3, 3] + self._v
        e_w = _so3_log(T_meas[:3, :3] @ R_pred.T)
        e_t = T_meas[:3, 3] - t_pred
        R_new = _so3_exp(self.alpha * e_w) @ R_pred
        t_new = t_pred + self.alpha * e_t
        # first-order composition on SO(3): per-frame angles are small
        self._w = _so3_log(_so3_exp(self.beta * e_w) @ _so3_exp(self._w))
        self._v = self._v + self.beta * e_t
        T = np.eye(4)
        T[:3, :3] = R_new
        T[:3, 3] = t_new
        self._T = T
        return T.astype(np.float32)


def predict_pose_cv(T_cur: np.ndarray, T_prev: np.ndarray) -> np.ndarray:
    """Constant-velocity prediction: the camera-frame delta of the last
    tracked step, ``D = T_cur inv(T_prev)``, applied once more."""
    D = T_cur @ np.linalg.inv(T_prev)
    return (D @ T_cur).astype(np.float32)


@dataclass
class FrameResult:
    """One ``Tracker.step()``."""

    color: np.ndarray
    T_m2c: Optional[np.ndarray]
    state: str  # "init" | "track" | "lost"
    timings: dict = field(default_factory=dict)
    icp_fitness: float = 0.0
    icp_rmse: float = 0.0
    detected: bool = False
    # (6, 6) Gauss-Newton covariance of the pose's camera-frame left twist
    # (omega, t) from the frame's ICP; None on init and lost frames
    pose_cov: Optional[np.ndarray] = None
    sigma_rot_deg: float = 0.0
    sigma_t_mm: float = 0.0
    # init frames: render-score margin between the chosen init pose and the
    # best other basin after the rollout (0.0 without a rollout)
    init_margin: float = 0.0


def _cov_sigmas(cov: np.ndarray) -> tuple[float, float]:
    """Total rotation (degrees) and translation (mm) standard deviations of
    a 6x6 twist covariance: sqrt of the 3x3 block traces."""
    s_rot = float(np.sqrt(max(np.trace(cov[:3, :3]), 0.0)))
    s_t = float(np.sqrt(max(np.trace(cov[3:, 3:]), 0.0)))
    return np.degrees(s_rot), s_t * 1000.0


@dataclass
class TrackResult:
    T: torch.Tensor  # (4, 4) updated model-to-camera pose
    fitness: torch.Tensor
    rmse: torch.Tensor
    cov: torch.Tensor  # (6, 6) camera-frame twist covariance
    n_iters: int  # ICP loop bodies run (K1 launches = n_iters + 1)


def step_draws(intr: Intrinsics, win, target_pts: int, generator, device,
               draws: Optional[dict] = None) -> dict:
    """The samplers' random numbers of one track step, ``draws`` completed
    from ``generator`` in the order the step samples: ``"tpl"`` (the
    rendered cloud), ``"obs"`` (the observed cloud), then with
    ``target_pts`` ``"tpl_target"`` and ``"obs_target"``."""
    r = RENDER_DOWNSCALE
    intr_r = intr.scaled(r)
    if win is None:
        cap_tpl, cap_obs = intr_r.height * intr_r.width, intr.height * intr.width
    else:
        cap_tpl, cap_obs = win[0] * win[1], win[0] * r * win[1] * r
    n_tpl, n_obs = min(SAMPLE_PTS, cap_tpl), min(SAMPLE_PTS, cap_obs)
    plan = [("tpl", cap_tpl, SAMPLE_PTS), ("obs", cap_obs, SAMPLE_PTS)]
    if target_pts:
        plan += [("tpl_target", n_tpl, target_pts), ("obs_target", n_obs, target_pts)]
    out = dict(draws or {})
    for name, cap, n in plan:
        if name not in out:
            out[name] = make_draws(cap, min(n, cap), generator, device)
    return out


@traced("track")
def track_program(mesh_v: torch.Tensor, mesh_f: torch.Tensor, mask: torch.Tensor,
                  depth: torch.Tensor, T_m2c: torch.Tensor, intr: Intrinsics, icp_dist, win,
                  icp_pose_tol, target_pts: int, icp_variant: str, icp_kernel: str,
                  draws: dict, stages: int = 6):
    """``track_step`` as a program of ``chains`` (it yields a ``Render``,
    then the ICP's requests) for a resolved window ``win`` and complete
    ``draws``; returns the ``TrackResult``.

    ``stages`` < 6 runs only the step's first stages and returns the last
    one's output (a profile's prefix, ``apps/profile_stages.py``): 1 the
    rendered depth, 2 the sampled rendered cloud, 3 the observed cloud, 4
    its sample, 5 the outlier-free sample; 6 (the step) adds the ICP."""
    r = RENDER_DOWNSCALE
    intr_r = intr.scaled(r)
    if win is not None:
        wh, ww = win
        with span("track.render"):
            orig_r = window_origin(mesh_v, T_m2c, intr_r, wh, ww)
            dtpl = yield chains.Render(mesh_v, mesh_f, T_m2c, intr_r, 0.01, 5.0,
                                       orig_r.to(torch.float32), win)
        with span("track.backproject"):
            tpl = backproject_depth(dtpl, intr_r, depth_min=0.01, depth_max=5.0,
                                    origin=orig_r)
    else:
        with span("track.render"):
            dtpl = yield chains.Render(mesh_v, mesh_f, T_m2c, intr_r, 0.01, 5.0, None, None)
        with span("track.backproject"):
            tpl = backproject_depth(dtpl, intr_r, depth_min=0.01, depth_max=5.0)
    if stages == 1:
        return dtpl
    with span("track.sample"):
        prev_down = random_sample(tpl, SAMPLE_PTS, draws=draws["tpl"])
    if stages == 2:
        return prev_down

    with span("track.backproject"):
        if win is not None:
            orig_f = orig_r.to(torch.int64) * r
            dwin = window_gather(depth, orig_f[1], orig_f[0], wh * r, ww * r)
            mwin = window_gather(mask, orig_f[1], orig_f[0], wh * r, ww * r)
            obs = backproject_depth(dwin, intr, mask=mwin, depth_min=1e-6, origin=orig_f)
        else:
            obs = backproject_depth(depth, intr, mask=mask, depth_min=1e-6)
    if stages == 3:
        return obs
    with span("track.sample"):
        obs = random_sample(obs, SAMPLE_PTS, draws=draws["obs"])
    if stages == 4:
        return obs
    with span("track.outliers"):
        dst_down = remove_statistical_outlier(obs, 20, 1.0)
    if stages == 5:
        return dst_down

    if target_pts:
        with span("track.sample"):
            prev_down = random_sample(prev_down, target_pts, draws=draws["tpl_target"])
            dst_down = random_sample(dst_down, target_pts, draws=draws["obs_target"])

    with span("track.icp"):
        if icp_variant == "p2l":
            dst_down = estimate_normals(dst_down, radius=0.025, max_nn=16,
                                        orient_towards=(0.0, 0.0, 0.0))
            icp = icp_point_to_plane(prev_down, dst_down, max_corr_dist=icp_dist,
                                     max_iterations=30, robust=icp_kernel, with_cov=True)
        else:
            # product resolutions (windowed) run Besl-McKay accelerated ICP;
            # tiny full-frame cameras keep the exact Open3D-parity sequence
            icp = yield from icp_point_to_point_program(
                prev_down, dst_down, max_corr_dist=icp_dist, max_iterations=30,
                robust=icp_kernel, with_cov=True, accel=win is not None,
                accel_pose_tol=icp_pose_tol)
    return TrackResult(T=icp.T @ T_m2c, fitness=icp.fitness, rmse=icp.inlier_rmse,
                       cov=icp.cov, n_iters=icp.n_iters)


def track_step(mesh_v: torch.Tensor, mesh_f: torch.Tensor, mask: torch.Tensor,
               depth: torch.Tensor, T_m2c: torch.Tensor, intr: Intrinsics,
               icp_dist=0.01, win_hw="auto", icp_pose_tol=5e-5, target_pts: int = 0,
               icp_variant: str = "p2p", icp_kernel: str = "none",
               generator: Optional[torch.Generator] = None,
               draws: Optional[dict] = None) -> TrackResult:
    """One tracking update from pose ``T_m2c`` against the observed
    ``depth`` (H, W) under ``mask`` (H, W).

    ``target_pts``: 0 runs ICP on the full 4096-point clouds (dense mode);
    otherwise both clouds are sampled down to that many points.
    ``icp_variant``: "p2p" or "p2l" (point-to-plane on observed normals);
    ``icp_kernel``: the IRLS kernel "none" | "huber" | "tukey".
    ``win_hw``: "auto", None (full frame) or an explicit (h, w) window at
    render resolution. ``draws`` injects the samplers' random numbers by
    sampler, ``"tpl"``, ``"obs"``, ``"tpl_target"``, ``"obs_target"``, each
    ``(gumbel, uniform)``; a missing entry is drawn from ``generator``.
    """
    if icp_variant not in ("p2p", "p2l"):
        raise ValueError(f"unknown icp_variant {icp_variant!r}")
    win = window_dims(intr.scaled(RENDER_DOWNSCALE), win_hw)
    draws = step_draws(intr, win, target_pts, generator, depth.device, draws)
    return chains.run(track_program(mesh_v, mesh_f, mask, depth, T_m2c, intr, icp_dist, win,
                                    icp_pose_tol, target_pts, icp_variant, icp_kernel, draws))


@dataclass
class BatchedTrackResult:
    T: torch.Tensor  # (B, 4, 4) updated poses
    fitness: torch.Tensor  # (B,)
    rmse: torch.Tensor  # (B,)
    cov: torch.Tensor  # (B, 6, 6)
    n_iters: list  # ICP loop bodies per track (K1 launches: max + 1)


def track_step_batched(mesh_v: torch.Tensor, mesh_f: torch.Tensor, masks: torch.Tensor,
                       depth: torch.Tensor, Ts: torch.Tensor, intr: Intrinsics, icp_dists,
                       win_hw="auto", target_pts: int = 0, icp_pose_tol=1e-4,
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[list] = None) -> BatchedTrackResult:
    """``track_step`` (point-to-point) of B tracks on one frame: the
    counterpart of the JAX package's ``_batched_track`` and
    ``_batched_track_multi``. One K2 launch renders every track, and each
    ICP evaluation is one K1 launch for the whole batch; the loop runs
    until every track has exited, each keeping its own ``n_iters``.

    ``mesh_v`` / ``mesh_f``: one mesh (V, 3) / (F, 3), or one per track
    (B, V, 3) / (B, F, 3) (rows of a padded class stack). ``masks``: (B, H,
    W), or one (H, W) mask for every track (the init rollout). ``Ts`` (B,
    4, 4); ``icp_dists``: the ICP radius per track, (B,) or a scalar;
    ``win_hw``: one window for the batch (``window.merge_windows``);
    ``draws``: a list of per-track ``track_step`` draws, completed from
    ``generator`` track by track. Track i's result is bit for bit that of
    ``track_step`` on its inputs, whatever B is (see ``chains``).
    """
    B = Ts.shape[0]
    dev = depth.device
    win = window_dims(intr.scaled(RENDER_DOWNSCALE), win_hw)
    dists = torch.as_tensor(icp_dists, dtype=torch.float32, device=dev).expand(B)
    draws = draws or [None] * B
    draws = [step_draws(intr, win, target_pts, generator, dev, d) for d in draws]
    per_track = mesh_v.dim() == 3
    out = chains.run_batched([
        track_program(mesh_v[i] if per_track else mesh_v, mesh_f[i] if per_track else mesh_f,
                      masks[i] if masks.dim() == 3 else masks, depth, Ts[i], intr, dists[i],
                      win, icp_pose_tol, target_pts, "p2p", "none", draws[i])
        for i in range(B)])
    return BatchedTrackResult(T=torch.stack([r.T for r in out]),
                              fitness=torch.stack([r.fitness for r in out]),
                              rmse=torch.stack([r.rmse for r in out]),
                              cov=torch.stack([r.cov for r in out]),
                              n_iters=[r.n_iters for r in out])


@dataclass
class FusedResult:
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
    (``window_for_object``); ``target_pts``, ``icp_variant`` and
    ``icp_kernel`` as in ``track_step``. ``device`` defaults to the card and
    raises when there is none; ``device="cpu"`` runs the plain versions of
    the kernels.
    """

    def __init__(self, model: YOLO11Seg, mesh_v, mesh_f, intr: Intrinsics,
                 win_hw="auto", imgsz: int = 640, max_det: int = 32, target_pts: int = 0,
                 icp_variant: str = "p2p", icp_kernel: str = "none",
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.mesh_v = torch.as_tensor(mesh_v, dtype=torch.float32, device=self.device)
        self.mesh_f = torch.as_tensor(mesh_f, dtype=torch.int64, device=self.device)
        self.intr = intr
        self.win_hw = win_hw
        self.imgsz = imgsz
        self.max_det = max_det
        self.target_pts = target_pts
        self.icp_variant = icp_variant
        self.icp_kernel = icp_kernel

    @torch.no_grad()
    @traced("frame")
    def __call__(self, color_bgr: torch.Tensor, depth: torch.Tensor, T: torch.Tensor,
                 conf: float = 0.25, icp_dist: float = 0.01,
                 mask_union: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[dict] = None) -> FusedResult:
        """One frame: ``color_bgr`` (H, W, 3), ``depth`` (H, W) metres, ``T``
        the last pose. ``mask_union`` (H, W) bool is OR-ed into the detected
        mask (a benchmark keeps every detection op live this way while the
        track step sees the object's true silhouette)."""
        with span("detect"):
            *_, (d, mask) = self.detect_stages(color_bgr, conf)
        if mask_union is not None:
            mask = mask | mask_union
        tr = track_step(self.mesh_v, self.mesh_f, mask, depth, T, self.intr, icp_dist,
                        win_hw=self.win_hw, target_pts=self.target_pts,
                        icp_variant=self.icp_variant, icp_kernel=self.icp_kernel,
                        generator=generator, draws=draws)
        ok = (d.count() > 0) & mask.any()
        return FusedResult(T=torch.where(ok, tr.T, T), ok=ok, fitness=tr.fitness,
                           rmse=tr.rmse, cov=tr.cov, n_iters=tr.n_iters)

    def detect_stages(self, color_bgr: torch.Tensor, conf: float = 0.25):
        """The frame's detection, one stage per item: the letterboxed image,
        the network's raw outputs, the detections after DFL decode and NMS,
        then ``(detections, mask)`` with the top detection's (H, W) mask.
        A profile's prefix stops the generator after its stage."""
        with span("detect.letterbox"):
            lb, meta = letterbox(color_bgr, self.imgsz)
        yield lb
        with span("detect.forward"):
            raw = self.model(lb.permute(2, 0, 1)[None])
        yield raw
        with span("detect.decode"):
            boxes, cls, mc = decode_boxes(raw)
        with span("detect.nms"):
            d = nms(boxes[0], cls[0], mc[0], conf_thres=conf, iou_thres=0.7,
                    pre_nms=1024, max_det=self.max_det)
        yield d
        # tracking consumes only the top detection's mask
        with span("detect.masks"):
            m = assemble_masks(raw["proto"][0], d.coeffs[:1], d.boxes[:1], d.valid[:1],
                               meta, self.intr.height, self.intr.width)[0]
        yield d, m


def _seen(mask: torch.Tensor) -> bool:
    """Whether a mask on the device has a pixel set: one host read."""
    hit = mask.any()
    with host_read():
        return bool(hit)


def _upright(T) -> np.ndarray:
    """``enforce_upright_pose_y_up`` of a host pose, as float32 numpy."""
    return enforce_upright_pose_y_up(torch.as_tensor(np.asarray(T, np.float32))).numpy()


class Tracker:
    """Host-side FSM driving the per-frame program.

    ``camera``: a camera source (``get_rgbd``, ``depth`` on the device,
    ``get_pcd_from_rgbd``); ``estimator``: a ``PoseEstimator``;
    ``detector``: a ``Detector`` or any callable with its return shape. The
    frame fuses detection and tracking when the detector exposes ``model``
    and ``variables``. ``device`` defaults to the card and raises when
    there is none; ``device="cpu"`` runs the kernels' plain versions.
    """

    def __init__(
        self,
        camera,
        estimator,
        detector,
        target_pts: int = 100,
        track_every: int = 1,
        conf: float = 0.7,
        class_id: int = 0,
        max_misses: int = 5,
        warmup_frames: int = 10,
        max_init_frames: int = 200,
        icp_dist: float = 0.01,
        icp_variant: str = "p2p",
        icp_kernel: str = "none",
        min_fitness: float = 0.0,
        fitness_patience: int = 3,
        reinit_fitness: float = 0.0,
        reinit_patience: int = 8,
        motion_model: str = "none",
        smooth_alpha: float = 1.0,
        smooth_beta: float = 0.3,
        init_rollout: int = 0,
        init_topk: int = 3,
        seed: int = 0,
        metrics=None,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.camera = camera
        self.estimator = estimator
        self.detector = detector
        self.target_pts = target_pts
        self.track_every = track_every
        self.conf = conf
        self.class_id = class_id
        self.max_misses = max_misses
        self.icp_dist = icp_dist
        self.icp_variant = icp_variant
        self.icp_kernel = icp_kernel
        # ranked-candidate fallback: fitness below min_fitness for
        # fitness_patience tracked frames moves to the next init candidate
        # (0.0 disables)
        self.min_fitness = min_fitness
        self.fitness_patience = fitness_patience
        # global failure detection: fitness below reinit_fitness for
        # reinit_patience tracked frames drops the FSM back to INIT
        # (0.0 disables: re-init on detection misses only)
        self.reinit_fitness = reinit_fitness
        self.reinit_patience = reinit_patience
        self._low_fitness_reinit = 0
        if motion_model not in ("none", "constant_velocity"):
            raise ValueError(f"unknown motion_model {motion_model!r}")
        self.motion_model = motion_model
        # multi-frame init: track the top-k distinct candidate basins through
        # init_rollout extra frames and keep the best render score (0 off)
        self.init_rollout = init_rollout
        self.init_topk = init_topk
        # output-only smoothing; the render-predict state keeps the raw chain
        self._filter = PoseFilter(smooth_alpha, smooth_beta) if smooth_alpha < 1.0 else None
        self._T_prev: Optional[np.ndarray] = None  # previous tracked pose
        self._candidates: list = []
        self._candidate_idx = 0
        self._low_fitness = 0
        self.warmup_frames = warmup_frames
        self.max_init_frames = max_init_frames
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

        self.metrics = metrics  # optional utils.metrics_log.MetricsLogger

        self.initialized = False
        self.errorcounter = 0
        self.frame_id = 0
        self.T_m2c: Optional[np.ndarray] = None
        self.history: list[FrameResult] = []
        # object-window bucket: chosen at init from the CAD diameter and the
        # object's distance, re-chosen when the distance drifts > 25%;
        # "auto" until the first init
        self._diag = float(np.linalg.norm(estimator.mesh.extent))
        self._win_hw = "auto"
        self._win_z: Optional[float] = None
        # post-init radius ladder: the first tracked frames after an init
        # run at 0.05 then 0.02 (floored at icp_dist)
        self._post_init = 0

        # detect + track in one call per frame when the detector carries its
        # model (stub detectors take the two-call path); one FusedFrame per
        # window bucket
        self._can_fuse = hasattr(detector, "model") and hasattr(detector, "variables")
        self._fused_progs: dict = {}

    @property
    def _fused(self):
        if not self._can_fuse:
            return None
        key = self._win_hw
        if key not in self._fused_progs:
            self._fused_progs[key] = self._build_fused_step(key)
        return self._fused_progs[key]

    def _intr_r(self) -> Intrinsics:
        return self.estimator.intr.scaled(2)

    def _select_window(self, z: float) -> None:
        """The window bucket for the object distance ``z`` (at init, re-init
        and > 25% distance drift; never per frame)."""
        self._win_hw = window_for_object(self._intr_r(), self._diag, z)
        self._win_z = float(z)

    def _build_fused_step(self, win_hw) -> FusedFrame:
        det = self.detector
        est = self.estimator
        return FusedFrame(det.model, est._mesh_v, est._mesh_f, est.intr, win_hw=win_hw,
                          imgsz=det.imgsz, max_det=det.max_det, target_pts=self.target_pts,
                          icp_variant=self.icp_variant, icp_kernel=self.icp_kernel,
                          device=self.device)

    def _record(self, res: FrameResult) -> FrameResult:
        self.history.append(res)
        if self.metrics is not None:
            from ..utils.metrics_log import FrameMetrics

            self.metrics.log(FrameMetrics(
                frame_id=self.frame_id, state=res.state,
                timings_ms={k: v * 1000 for k, v in res.timings.items()},
                icp_fitness=res.icp_fitness, icp_rmse=res.icp_rmse,
                pose=None if res.T_m2c is None else np.asarray(res.T_m2c).tolist(),
                detected=res.detected,
                sigma_rot_deg=res.sigma_rot_deg, sigma_t_mm=res.sigma_t_mm))
        return res

    def _maybe_fallback(self, fitness: float) -> None:
        """Advance to the next ranked init candidate after sustained low ICP
        fitness (disabled when min_fitness == 0)."""
        if self.min_fitness <= 0 or not self._candidates:
            return
        if fitness >= self.min_fitness:
            self._low_fitness = 0
            return
        self._low_fitness += 1
        if (self._low_fitness >= self.fitness_patience
                and self._candidate_idx + 1 < len(self._candidates)):
            self._candidate_idx += 1
            if self._filter is not None:
                self._filter.reset()  # pose jump: the filter state is stale
            _, T, _ = self._candidates[self._candidate_idx]
            self.T_m2c = _upright(T)
            self._low_fitness = 0
            self._post_init = 2  # re-arm the init-refinement radius ladder
            self._T_prev = None  # velocity is meaningless across a pose jump

    def _maybe_reinit(self, fitness: float) -> bool:
        """Sustained fitness below ``reinit_fitness`` drops the FSM back to
        INIT; True when triggered (the frame is reported "lost")."""
        if self.reinit_fitness <= 0:
            return False
        if fitness >= self.reinit_fitness:
            self._low_fitness_reinit = 0
            return False
        self._low_fitness_reinit += 1
        if self._low_fitness_reinit < self.reinit_patience:
            return False
        self._low_fitness_reinit = 0
        self.initialized = False
        self._T_prev = None
        if self._filter is not None:
            self._filter.reset()
        self.errorcounter = 0
        return True

    def _detect(self, color):
        """One detection pass: the top detection's (H, W) bool mask, or None."""
        det, masks, _ = self.detector(color, conf=self.conf)
        n = det.count()
        with host_read():
            n = int(n)
        if n == 0:
            return None
        return masks[0]

    def _initialize(self) -> Optional[FrameResult]:
        """Warm-up detection, then the global pose."""
        consecutive = 0
        mask = None
        color = None
        for _ in range(self.max_init_frames):
            color = self.camera.get_rgbd()
            if color is None:
                return None
            m = self._detect(color)
            if m is None or not _seen(m):
                consecutive = 0
                continue
            mask = m
            consecutive += 1
            if consecutive >= self.warmup_frames:
                break
        if mask is None or consecutive < self.warmup_frames:
            return None

        t0 = time.perf_counter()
        dst_cloud = self.camera.get_pcd_from_rgbd(mask)
        H, _, candidates = self.estimator.find_best_template_candidates(dst_cloud, mask=mask)
        H = _upright(H)
        self._candidates = candidates
        self._select_window(float(H[2, 3]))
        init_margin = 0.0
        if self.init_rollout > 0 and len(candidates) > 1:
            H, init_margin = self._rollout_init(H, candidates)
        self.T_m2c = H
        self._candidate_idx = 0
        self._low_fitness = 0
        self._post_init = 2
        self._T_prev = None
        if self._filter is not None:
            self._filter.reset()
        self._low_fitness_reinit = 0
        self.initialized = True
        self.errorcounter = 0
        return FrameResult(color=color, T_m2c=H, state="init",
                           timings={"global_registration": time.perf_counter() - t0},
                           detected=True, init_margin=init_margin)

    def _distinct_basins(self, candidates) -> list:
        """The first ``init_topk`` candidates, best first, that differ from
        every one kept before by more than 0.17 rad or 5% of the CAD's
        diagonal."""
        diag = float(np.linalg.norm(self.estimator.mesh.extent))
        kept: list = []
        for s, T, i in candidates:
            Tn = np.asarray(T)
            dup = False
            for _, Tk, _ in kept:
                R = Tn[:3, :3] @ Tk[:3, :3].T
                ang = np.arccos(np.clip((np.trace(R) - 1.0) / 2, -1.0, 1.0))
                if ang < 0.17 and np.linalg.norm(Tn[:3, 3] - Tk[:3, 3]) < 0.05 * diag:
                    dup = True
                    break
            if not dup:
                kept.append((s, Tn, i))
            if len(kept) >= self.init_topk:
                break
        return kept

    def _rollout_init(self, H: np.ndarray, candidates) -> tuple:
        """Multi-frame init: track the top-k distinct candidate basins
        through ``init_rollout`` more frames at the init radius and keep the
        best render score on the last one. Returns ``(T_winner, margin)``,
        the margin being the score gap to the best other basin; ``(H, 0.0)``
        with fewer than two basins or no usable frame. The fallback list is
        reordered so that the winner's template leads.

        All candidates advance in one ``track_step_batched`` per frame, as
        the JAX package vmaps ``_track_step`` over them: they share the
        frame's mask and depth, and each renders its own window and so has
        its own observed cloud. As there, the rollout runs point-to-point
        ICP with no robust kernel whatever ``icp_variant`` and
        ``icp_kernel`` say, at the single-object exit tolerance."""
        from .pose_estimator import score_pose_candidates

        est = self.estimator
        kept = self._distinct_basins(candidates)
        if len(kept) < 2:
            return H, 0.0
        Ts = torch.stack([torch.as_tensor(_upright(T), device=self.device)
                          for _, T, _ in kept])
        last = None
        for _ in range(self.init_rollout):
            color = self.camera.get_rgbd()
            if color is None:
                break
            m = self._detect(color)
            if m is None or not _seen(m):
                continue
            Ts = track_step_batched(est._mesh_v, est._mesh_f, m, self.camera.depth, Ts,
                                    est.intr, INIT_RADIUS, win_hw=self._win_hw,
                                    target_pts=self.target_pts, icp_pose_tol=5e-5,
                                    generator=self._gen).T
            last = (self.camera.depth, m)
        if last is None:
            return H, 0.0
        scores = score_pose_candidates(est._mesh_v, est._mesh_f, Ts, last[0],
                                       last[1], est.intr, win_hw=self._win_hw)
        with host_read():
            scores = scores.cpu().numpy()
        order = np.argsort(scores)
        w = int(order[0])
        margin = float(scores[order[1]] - scores[order[0]])
        win_idx = kept[w][2]
        # stable reorder: the winner's template candidate leads the fallback
        # ladder, everything else keeps its search ranking
        self._candidates = sorted(self._candidates, key=lambda c: 0 if c[2] == win_idx else 1)
        with host_read():
            T_w = Ts[w].cpu().numpy()
        return T_w, margin

    def _lost(self, color, timings) -> FrameResult:
        """A detection miss: count it, and drop to INIT past ``max_misses``."""
        self.errorcounter += 1
        self._T_prev = None
        if self._filter is not None:
            self._filter.reset()
        if self.errorcounter > self.max_misses:
            self.initialized = False
        return self._record(FrameResult(color=color, T_m2c=self.T_m2c, state="lost",
                                        timings=timings))

    def _tracked(self, color, timings, T_new, fitness, rmse, cov) -> FrameResult:
        T_rep = self._filter(T_new) if self._filter is not None else T_new
        self._maybe_fallback(fitness)
        state = "lost" if self._maybe_reinit(fitness) else "track"
        s_rot, s_t = _cov_sigmas(cov)
        return self._record(FrameResult(
            color=color, T_m2c=T_rep, state=state, timings=timings, icp_fitness=fitness,
            icp_rmse=rmse, detected=True, pose_cov=cov, sigma_rot_deg=s_rot, sigma_t_mm=s_t))

    @torch.no_grad()
    @traced("tracker.step")
    def step(self) -> Optional[FrameResult]:
        """One loop iteration. Returns None when the stream ends. Its
        ``timings`` (s, on ``time.perf_counter``): ``frame`` (the fused
        frame), or ``detect`` and ``track_step``; ``global_registration``
        on an init."""
        if not self.initialized:
            res = self._initialize()
            if res is not None:
                self._record(res)
            return res

        color = self.camera.get_rgbd()
        if color is None:
            return None
        timings = {}
        self.frame_id += 1
        if self.frame_id % self.track_every != 0:
            self._T_prev = None  # velocity spans an untracked gap
            return self._record(FrameResult(color=color, T_m2c=self.T_m2c, state="track"))

        # the post-init radius ladder (0.05 then 0.02, floored at icp_dist)
        # advances only on frames that track: a miss does not use up a rung
        if self._post_init:
            eff_dist = max((INIT_RADIUS, 0.02)[2 - self._post_init], self.icp_dist)
        else:
            eff_dist = self.icp_dist

        # render at the last estimate, or at the constant-velocity prediction
        T_cur = np.asarray(self.T_m2c)
        if self._win_z is not None:
            z = float(T_cur[2, 3])
            if abs(z - self._win_z) > 0.25 * max(self._win_z, 1e-3):
                self._select_window(z)
        if self.motion_model == "constant_velocity" and self._T_prev is not None:
            T_render = predict_pose_cv(T_cur, self._T_prev)
        else:
            T_render = T_cur
        T_render = torch.as_tensor(np.asarray(T_render, np.float32), device=self.device)

        fused = self._fused
        if fused is not None:
            t0 = time.perf_counter()
            res = fused(torch.as_tensor(np.asarray(color), device=self.device),
                        self.camera.depth, T_render, conf=self.conf, icp_dist=eff_dist,
                        generator=self._gen)
            with host_read():
                ok = bool(res.ok)
            if not ok:
                timings["frame"] = time.perf_counter() - t0
                return self._lost(color, timings)
            self.errorcounter = 0
            if self._post_init:
                self._post_init -= 1
            self._T_prev = T_cur
            with host_read():
                self.T_m2c = res.T.cpu().numpy()
            timings["frame"] = time.perf_counter() - t0
            return self._tracked(color, timings, self.T_m2c, *self._fit(res))

        t0 = time.perf_counter()
        mask = self._detect(color)
        timings["detect"] = time.perf_counter() - t0
        if mask is None or not _seen(mask):
            return self._lost(color, timings)
        self.errorcounter = 0
        if self._post_init:
            self._post_init -= 1

        t0 = time.perf_counter()
        est = self.estimator
        tr = track_step(est._mesh_v, est._mesh_f, mask, self.camera.depth, T_render,
                        est.intr, icp_dist=eff_dist, win_hw=self._win_hw,
                        target_pts=self.target_pts, icp_variant=self.icp_variant,
                        icp_kernel=self.icp_kernel, generator=self._gen)
        with host_read():
            T_new = tr.T.cpu().numpy()
        timings["track_step"] = time.perf_counter() - t0
        self._T_prev = T_cur
        self.T_m2c = T_new
        return self._tracked(color, timings, T_new, *self._fit(tr))

    @staticmethod
    def _fit(res) -> tuple:
        """``(fitness, rmse, cov)`` of a frame's result on the host, three
        reads."""
        with host_read():
            fitness = float(res.fitness)
        with host_read():
            rmse = float(res.rmse)
        with host_read():
            cov = res.cov.cpu().numpy()
        return fitness, rmse, cov
