"""Driver of ``MultiTracker.step()``: several known objects tracked at once,
one camera frame a request, every track advanced by one batched step.

Set-up writes each object's CAD as a PLY and builds its ``PoseEstimator``
(the class's template database), the port's ``Detector`` on the benchmark's
weights, renders the stream into a ``ReplayCamera`` in playback order, and
steps the tracker until every object has been spawned by its search, then
a few frames more. The spawn searches see the same frames and draw from the
configuration's ``search_seed`` in every run, so every seed starts its
window from the same tracks. The detector adapter runs the port's ``Detector`` on
every frame (forward, decode, NMS, masks) and hands the tracker the true
instances (class, box and mask of each object's visible pixels).

Checked: the detector's raw outputs on tapped frames against
``reference/yolo.py``, and each updated track's pose on sampled frames
against the reference's update from its pose one frame earlier; and
``missed_updates``, the tracks that a frame of the window left without an
update (a miss of the association, or a track left out of the batched
step), held to 0: every object is in view in every frame, so a track that
is not stepped is an answer that never came.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from benchmark.drivers.fused_frame import camera_of, intrinsics_of, placement
from benchmark.harness import checks as ck
from benchmark.reference import icp as ref_icp
from benchmark.traffic import cad as tcad
from benchmark.traffic import scenes


class TruthDetector:
    """The tracker's detector: the port's ``Detector`` runs, the frame's true
    instances are returned."""

    def __init__(self, det, frames, device):
        self.det, self.frames, self.device = det, frames, device
        self.k = None

    def __call__(self, color, conf: float = 0.25):
        from poseestimator_tpu_torch.models.yolo.nms import Detections

        self.det(color, conf=conf)
        masks = torch.from_numpy(self.frames.masks[self.k]).to(self.device)  # (K, H, W)
        K = masks.shape[0]
        ys = masks.any(2)
        xs = masks.any(1)
        ar_y = torch.arange(ys.shape[1], device=self.device, dtype=torch.float32)
        ar_x = torch.arange(xs.shape[1], device=self.device, dtype=torch.float32)
        big = torch.tensor(1e9, device=self.device)
        boxes = torch.stack([torch.where(xs, ar_x, big).amin(1),
                             torch.where(ys, ar_y, big).amin(1),
                             torch.where(xs, ar_x, -big).amax(1) + 1,
                             torch.where(ys, ar_y, -big).amax(1) + 1], 1)
        valid = masks.flatten(1).any(1)
        det = Detections(boxes=boxes, scores=valid.float(),
                         classes=torch.where(valid, torch.arange(K, device=self.device), -1),
                         coeffs=torch.zeros((K, 32), device=self.device), valid=valid)
        return det, masks, boxes


class Driver:
    UNIT = "frame"

    def __init__(self, cfg: dict, wl: dict, seed: int, device, work: str):
        self.cfg, self.wl, self.seed, self.work = cfg, wl, int(seed), work
        self.device = torch.device(device)
        self.trace_steps = int(wl["trace_steps"])
        self.p = dict(cfg.get("tracking", {}), **wl.get("program", {}))

    def setup(self) -> None:
        from poseestimator_tpu_torch.camera.source import ReplayCamera
        from poseestimator_tpu_torch.pipeline.detector import Detector
        from poseestimator_tpu_torch.pipeline.multi_tracking import MultiTracker
        from poseestimator_tpu_torch.pipeline.pose_estimator import PoseEstimator

        from benchmark.harness.weights import yolo_state_dict

        dev = self.device
        self.cam = camera_of(self.cfg)
        intr = intrinsics_of(self.cam)
        sub = int(self.cfg["cad"]["subdivisions"])
        self.meshes, ests = [], {}
        for c, obj in enumerate(self.cfg["objects"]):
            v, f = tcad.make_cad(int(obj["shape_seed"]), float(obj["diameter_mm"]), sub)
            self.meshes.append((v, f))
            ply = os.path.join(self.work, f"obj_{c}.ply")
            tcad.write_ply(ply, v, f)
            ests[c] = PoseEstimator(ply, os.path.join(self.work, f"views_{c}"), intr, intr.K,
                                    int(self.p["target_points"]), view_set=self.p["view_set"],
                                    seed=int(self.p["search_seed"]) + c, device=dev)
        det = self.cfg["detector"]
        self.sd = yolo_state_dict(int(det["nc"]), det["scale"], self.seed, dev)
        detector = Detector(self.sd, nc=int(det["nc"]), scale=det["scale"],
                            imgsz=int(det["imgsz"]), max_det=int(det["max_det"]), device=dev)
        self.tap = ck.OutputTap(detector.model)
        P = np.stack([placement(o) for o in self.cfg["objects"]])
        self.frames = scenes.stream(self.wl["traffic"], self.meshes, P, self.cam,
                                    float(self.cfg["sensor"]["noise_coef"]), self.seed, dev)
        fr = self.frames
        self.camera = ReplayCamera([(fr.color[k], fr.depth[k]) for k in fr.order], intr,
                                   filter_depth=False, loop=True, device=dev)
        self.adapter = TruthDetector(detector, fr, dev)
        self.mt = MultiTracker(self.camera, ests, self.adapter,
                               max_objects=int(self.p["max_objects"]),
                               target_pts=int(self.p["target_pts"]), conf=float(self.p["conf"]),
                               icp_dist=float(self.p["icp_dist"]), seed=self.seed, device=dev)
        self.n = 0
        self.K = len(self.cfg["objects"])
        extra = int(self.wl["warmup_steps"])
        for _ in range(int(self.wl["max_spawn_steps"])):
            self._step()
            if len(self.mt.tracks) >= self.K:
                break
        for _ in range(extra):
            self._step()
        self.records, self.iters = [], []
        self._count_iters()

    def _count_iters(self) -> None:
        """Keep the batched step's ``n_iters`` (its own return, which
        ``MultiTracker`` drops): the largest of each step's tracks."""
        import poseestimator_tpu_torch.pipeline.multi_tracking as mtm

        self._orig = orig = mtm.track_step_batched

        def counted(*args, **kwargs):
            res = orig(*args, **kwargs)
            self.iters.append(max(res.n_iters))
            return res

        mtm.track_step_batched = counted

    def _step(self):
        fr = self.frames
        k = int(fr.order[self.n % len(fr.order)])
        self.n += 1
        self.adapter.k = k
        before = {t.track_id: (t.class_id, t.T_m2c, t.age) for t in self.mt.tracks}
        res = self.mt.step()
        return k, before, res

    def step(self, i: int) -> None:
        self.tap.key = i if ck.tapped(i, int(self.wl["check"]["tap_every"]), self.seed) else None
        k, before, res = self._step()
        upd = [(t.class_id, before[t.track_id][1], np.array(t.T_m2c, np.float32))
               for t in res.tracks
               if t.track_id in before and t.age == before[t.track_id][2] + 1]
        self.records.append((k, upd))

    def counters(self) -> dict:
        return {"icp_iters": list(self.iters)}

    def end_to_end(self, r) -> dict:
        dev = self.device
        vals = []
        for c, (v, f) in enumerate(self.meshes):
            pts = torch.as_tensor(tcad.surface_points(v, f, 1000, 0), device=dev)
            est, gt = [], []
            for k, upd in self.records[:r.before_steps]:
                for cls, _, T in upd:
                    if cls == c:
                        est.append(T)
                        gt.append(self.frames.poses[k, c])
            if est:
                vals.append(ref_icp.adds_mm(torch.as_tensor(np.stack(est), device=dev),
                                            torch.as_tensor(np.stack(gt), device=dev), pts))
        return {"adds_mm": float(torch.cat(vals).mean()) if vals else float("inf")}

    def failed(self) -> int:
        return int(sum(len(upd) < self.K for _, upd in self.records))

    def free(self) -> None:
        import poseestimator_tpu_torch.pipeline.multi_tracking as mtm

        mtm.track_step_batched = self._orig
        self.tap.close()
        del self.mt, self.adapter, self.camera

    def check(self, control) -> list[dict]:
        lim = self.wl["limits"]
        dev = self.device
        gap = ck.det_gap(self.tap, self.sd,
                         lambda i: torch.from_numpy(self.frames.color[self.records[i][0]]).to(dev),
                         int(self.cfg["detector"]["imgsz"]), control)
        out = [ck.gap_line("det_gap", gap, lim["det_gap"])]
        meshes = [(torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev))
                  for v, f in self.meshes]
        pts = [torch.as_tensor(tcad.surface_points(v, f, 1000, 0), device=dev)
               for v, f in self.meshes]
        dist = float(self.p["icp_dist"])
        worst = 0.0 if self.records else float("inf")
        for i in ck.sample(len(self.records), int(self.wl["check"]["samples"]), self.seed):
            k, upd = self.records[i]
            depth = torch.from_numpy(self.frames.depth[k]).to(dev)
            for cls, T_prev, T in upd:
                mask = torch.from_numpy(self.frames.masks[k, cls]).to(dev)
                T_prev = torch.as_tensor(np.asarray(T_prev, np.float32), device=dev)
                args = (*meshes[cls], T_prev, depth, mask, self.cam, dist)
                with ck.precision(None):
                    T_ref = ref_icp.track_update(*args)
                T_out = torch.as_tensor(T, device=dev)
                if control:
                    with ck.precision(control):
                        T_out = ref_icp.track_update(*args)
                gap = ref_icp.add_mm(T_out, T_ref, pts[cls])
                worst = max(worst, gap)
                ck.detail(f"frame {i} object {cls}: gap {gap:.4f} mm, step"
                          f" {ref_icp.add_mm(T_prev, T_ref, pts[cls]):.4f} mm")
        out.append(ck.gap_line("pose_gap_mm", worst, lim["pose_gap_mm"]))
        missed = sum(self.K - len(upd) for _, upd in self.records)
        out.append(ck.gap_line("missed_updates", missed, lim["missed_updates"]))
        return out
