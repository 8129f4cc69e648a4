"""Multi-object tracking (counterpart of
``poseestimator_tpu/pipeline/multi_tracking.py``): per-instance 6D poses at
camera rate, every tracked instance advanced by one batched track step per
frame (``tracking.track_step_batched``: one K2 launch for all the tracks'
renders, one K1 launch per ICP evaluation for all their clouds).

Association is greedy best-IoU, within a class, between the detection boxes
and the projected bounding box of each track's CAD at its current pose.
Unmatched tracks count misses and are retired past ``max_misses``;
unmatched detections spawn at most one track per frame through the global
template search. The host state is numpy, as in the JAX package; the
randomness of the track steps comes from a ``torch.Generator`` seeded with
``seed``.

As in the JAX package, a track's window bucket is chosen at spawn from its
class's CAD diameter and distance and is never chosen again; the batch runs
the merge of its tracks' buckets.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..utils.profiling import host_read, span, traced
from .tracking import PoseFilter, _upright, track_step_batched
from .window import merge_windows, window_for_object

# the batched step's raw-twist exit: the JAX package's multi-object profile
# (the single-object step runs 5e-5)
BATCH_POSE_TOL = 1e-4


@dataclass
class TrackedObject:
    track_id: int
    class_id: int
    T_m2c: np.ndarray
    misses: int = 0
    age: int = 0
    icp_fitness: float = 0.0
    # reported (output-filtered) pose; T_m2c, the raw chain, drives the
    # association boxes and the render prediction
    T_out: Optional[np.ndarray] = None
    filter: Optional[PoseFilter] = None
    # (6, 6) camera-frame twist covariance of the last update
    pose_cov: Optional[np.ndarray] = None
    # post-init radius ladder 2 -> 1 -> 0: a fresh track's first updates
    # run at 0.05 then 0.02 m (floored at icp_dist)
    post_init: int = 2
    # window bucket chosen at spawn (window_for_object); "auto" until then
    win: object = "auto"


@dataclass
class MultiFrameResult:
    color: np.ndarray
    tracks: list[TrackedObject]
    n_detections: int
    timings: dict = field(default_factory=dict)


def stack_class_meshes(meshes: list) -> tuple[np.ndarray, np.ndarray]:
    """Per-class raster meshes [(vertices (V_c, 3), faces (F_c, 3)), ...]
    stacked to the largest counts: vertices padded by repeating the last
    one, faces by degenerate (0, 0, 0) triples, which cover no pixel."""
    v_max = max(len(v) for v, _ in meshes)
    f_max = max(len(f) for _, f in meshes)
    vs = np.stack([np.pad(v, ((0, v_max - len(v)), (0, 0)), mode="edge") for v, _ in meshes])
    fs = np.stack([np.pad(f, ((0, f_max - len(f)), (0, 0))) for _, f in meshes])
    return vs.astype(np.float32), fs.astype(np.int64)


def _mesh_corners(est) -> np.ndarray:
    """The 8 corners of the CAD's axis-aligned bounding box, float32."""
    lo, hi = est.mesh.vertices.min(0), est.mesh.vertices.max(0)
    return np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                     for z in (lo[2], hi[2])], np.float32)


class MultiTracker:
    """Tracks up to ``max_objects`` instances.

    ``estimator``: one ``PoseEstimator`` (every detection registers against
    its CAD) or ``{class_id: PoseEstimator}`` (each track renders and
    registers its class's CAD; the classes' raster meshes are stacked on
    the device, padded to common sizes, and each frame gathers the matched
    tracks' rows). ``detector(color, conf=)`` returns ``(Detections, masks
    (D, H, W), boxes (D, 4))``. ``device`` defaults to the card and raises
    when there is none; ``device="cpu"`` runs the kernels' plain versions.
    """

    def __init__(self, camera, estimator, detector, max_objects: int = 8,
                 target_pts: int = 100, conf: float = 0.7, max_misses: int = 5,
                 icp_dist: float = 0.01, iou_match: float = 0.2, smooth_alpha: float = 1.0,
                 smooth_beta: float = 0.3, seed: int = 0, metrics=None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.camera = camera
        if isinstance(estimator, dict):
            self.estimators = {int(c): e for c, e in estimator.items()}
            if not self.estimators:
                raise ValueError("empty estimator dict")
            self.estimator = next(iter(self.estimators.values()))
            for e in self.estimators.values():
                if e.intr != self.estimator.intr:
                    raise ValueError("all per-class estimators must share the camera "
                                     "intrinsics (one physical camera)")
        else:
            self.estimators = None
            self.estimator = estimator
        self.detector = detector
        self.max_objects = max_objects
        self.target_pts = target_pts
        self.conf = conf
        self.max_misses = max_misses
        self.icp_dist = icp_dist
        self.iou_match = iou_match
        self.smooth_alpha = smooth_alpha
        self.smooth_beta = smooth_beta
        self.metrics = metrics
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._next_id = 0
        self.tracks: list[TrackedObject] = []

        if self.estimators is None:
            self._corners = _mesh_corners(self.estimator)
        else:
            self._corners_by_cls = {c: _mesh_corners(e) for c, e in self.estimators.items()}
            # the classes' raster meshes, stacked once on the device
            rows = sorted(self.estimators)
            self._cls_row = {c: i for i, c in enumerate(rows)}
            vs, fs = stack_class_meshes([(self.estimators[c]._mesh_v.cpu().numpy(),
                                          self.estimators[c]._mesh_f.cpu().numpy())
                                         for c in rows])
            self._mesh_v_stack = torch.from_numpy(vs).to(self.device)
            self._mesh_f_stack = torch.from_numpy(fs).to(self.device)

    def _predicted_box(self, T: np.ndarray, class_id: int = 0) -> np.ndarray:
        """(x0, y0, x1, y1) of the projected CAD bounding box at ``T``."""
        corners = (self._corners if self.estimators is None
                   else self._corners_by_cls[class_id])
        T = np.asarray(T, np.float32)
        K = np.asarray(self.estimator.K, np.float32)
        pc = corners @ T[:3, :3].T + T[:3, 3]
        zs = np.where(pc[:, 2] > 0, pc[:, 2], np.float32(1.0))
        u = K[0, 0] * pc[:, 0] / zs + K[0, 2]
        v = K[1, 1] * pc[:, 1] / zs + K[1, 2]
        return np.array([u.min(), v.min(), u.max(), v.max()])

    @staticmethod
    def _iou(a, b) -> float:
        x1, y1 = max(a[0], b[0]), max(a[1], b[1])
        x2, y2 = min(a[2], b[2]), min(a[3], b[3])
        inter = max(x2 - x1, 0) * max(y2 - y1, 0)
        ar_a = max(a[2] - a[0], 0) * max(a[3] - a[1], 0)
        ar_b = max(b[2] - b[0], 0) * max(b[3] - b[1], 0)
        return inter / max(ar_a + ar_b - inter, 1e-9)

    def _radius(self, tr: TrackedObject) -> float:
        """The post-init ladder (0.05 then 0.02, floored at icp_dist)."""
        if tr.post_init:
            return max((0.05, 0.02)[2 - tr.post_init], self.icp_dist)
        return self.icp_dist

    def _associate(self, det_boxes, det_classes, n_det) -> tuple[list, set]:
        """Greedy best-IoU matching of tracks (in order) to detections of
        their class; unmatched tracks count a miss and reset their filter."""
        assigned: set = set()
        matched: list = []
        for tr in self.tracks:
            best_j, best_iou = -1, self.iou_match
            pbox = self._predicted_box(tr.T_m2c, tr.class_id)
            for j in range(n_det):
                if j in assigned or det_classes[j] != tr.class_id:
                    continue
                iou = self._iou(pbox, det_boxes[j])
                if iou > best_iou:
                    best_iou, best_j = iou, j
            if best_j >= 0:
                assigned.add(best_j)
                matched.append((tr, best_j))
            else:
                tr.misses += 1
                if tr.filter is not None:
                    tr.filter.reset()
        return matched, assigned

    def _update(self, matched: list, masks) -> None:
        """One batched track step for every matched track."""
        Ts = torch.from_numpy(np.stack([tr.T_m2c for tr, _ in matched]).astype(np.float32))
        dists = torch.tensor([self._radius(tr) for tr, _ in matched], dtype=torch.float32)
        win = merge_windows([tr.win for tr, _ in matched])
        if self.estimators is None:
            mesh_v, mesh_f = self.estimator._mesh_v, self.estimator._mesh_f
        else:
            rows = torch.tensor([self._cls_row[tr.class_id] for tr, _ in matched],
                                device=self.device)
            mesh_v, mesh_f = self._mesh_v_stack[rows], self._mesh_f_stack[rows]
        res = track_step_batched(
            mesh_v, mesh_f, torch.stack([masks[j] for _, j in matched]).to(self.device),
            self.camera.depth, Ts.to(self.device), self.estimator.intr, dists.to(self.device),
            win_hw=win, target_pts=self.target_pts, icp_pose_tol=BATCH_POSE_TOL,
            generator=self._gen)
        with host_read():
            T_new = res.T.cpu().numpy()
        with host_read():
            fits = res.fitness.cpu().numpy()
        with host_read():
            covs = res.cov.cpu().numpy()
        for i, (tr, _) in enumerate(matched):
            tr.T_m2c = T_new[i]
            tr.T_out = np.asarray(tr.filter(T_new[i])) if tr.filter is not None else T_new[i]
            tr.misses = 0
            tr.age += 1
            tr.icp_fitness = float(fits[i])
            tr.pose_cov = covs[i]
            if tr.post_init:
                tr.post_init -= 1

    def _spawn(self, j: int, masks, det_classes) -> bool:
        """A new track for detection ``j`` through the global search; False
        when its class has no CAD."""
        cls = int(det_classes[j])
        est = self.estimator if self.estimators is None else self.estimators.get(cls)
        if est is None:
            return False
        dst_cloud = self.camera.get_pcd_from_rgbd(masks[j])
        H, _ = est.find_best_template_teaser(dst_cloud, mask=masks[j])
        H = _upright(H)
        diag_c = float(np.linalg.norm(est.mesh.extent))
        self.tracks.append(TrackedObject(
            track_id=self._next_id, class_id=cls, T_m2c=H, T_out=H,
            filter=(PoseFilter(self.smooth_alpha, self.smooth_beta)
                    if self.smooth_alpha < 1.0 else None),
            win=window_for_object(self.estimator.intr.scaled(2), diag_c, float(H[2, 3]))))
        self._next_id += 1
        return True

    @torch.no_grad()
    @traced("multi.step")
    def step(self) -> Optional[MultiFrameResult]:
        """One frame: detect, associate, update the matched tracks in one
        batched step, retire, spawn at most one. None when the stream ends.
        Its ``timings`` (s, on ``time.perf_counter``): ``detect``,
        ``associate``, ``track_batch`` and, on a spawn, ``init``."""
        color = self.camera.get_rgbd()
        if color is None:
            return None
        timings = {}

        t0 = time.perf_counter()
        det, masks, boxes_orig = self.detector(color, conf=self.conf)
        n_det = det.count()
        with host_read():
            n_det = int(n_det)
        timings["detect"] = time.perf_counter() - t0
        with host_read():
            det_boxes = np.asarray(torch.as_tensor(boxes_orig[:n_det]).cpu())
        with host_read():
            det_classes = np.asarray(torch.as_tensor(det.classes[:n_det]).cpu())

        t0 = time.perf_counter()
        with span("multi.associate"):
            matched, assigned = self._associate(det_boxes, det_classes, n_det)
        timings["associate"] = time.perf_counter() - t0

        if matched:
            t0 = time.perf_counter()
            with span("multi.update", len(matched)):
                self._update(matched, masks)
            timings["track_batch"] = time.perf_counter() - t0

        self.tracks = [t for t in self.tracks if t.misses <= self.max_misses]

        if len(self.tracks) < self.max_objects:
            for j in range(n_det):
                if j in assigned:
                    continue
                t0 = time.perf_counter()
                with span("multi.spawn"):
                    spawned = self._spawn(j, masks, det_classes)
                if spawned:
                    timings["init"] = time.perf_counter() - t0
                    break

        res = MultiFrameResult(color=color, tracks=list(self.tracks), n_detections=n_det,
                               timings=timings)
        if self.metrics is not None:
            self.metrics.log({"frame": "multi", "n_tracks": len(self.tracks),
                              "n_detections": n_det,
                              "timings_ms": {k: v * 1000 for k, v in timings.items()}})
        return res
