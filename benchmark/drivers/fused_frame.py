"""Driver of ``FusedFrame.__call__``: live tracking of one known object, one
camera frame a request.

Set-up writes the configuration's CAD as a PLY, loads it through the port's
``TriangleMesh`` and ``raster_assets`` (decimated to its face cap), builds
YOLO11n-seg on the benchmark's weights and the ``FusedFrame``, renders the
stream, and plays its first frames through the same call. Each request
uploads the next frame (colour, depth, the true silhouette OR-ed into the
detected mask) and tracks from the last pose the program returned.

Checked: the detector's raw outputs on tapped frames against
``reference/yolo.py``, and the pose of sampled frames against the
reference's update from the program's pose one frame earlier.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from benchmark.harness import checks as ck
from benchmark.reference import icp as ref_icp
from benchmark.reference import raster as rr
from benchmark.traffic import cad as tcad
from benchmark.traffic import scenes


def camera_of(cfg: dict) -> dict:
    c = cfg["camera"]
    if "fov_deg" in c:
        f = 0.5 * c["width"] / np.tan(np.deg2rad(c["fov_deg"]) / 2.0)
        return rr.camera(f, f, c["width"] / 2.0, c["height"] / 2.0, c["width"], c["height"])
    return rr.camera(c["fx"], c["fy"], c["cx"], c["cy"], c["width"], c["height"])


def intrinsics_of(cam: dict):
    from poseestimator_tpu_torch.geom3d.camera import Intrinsics

    return Intrinsics(fx=cam["fx"], fy=cam["fy"], cx=cam["cx"], cy=cam["cy"],
                      width=cam["width"], height=cam["height"])


def placement(obj: dict) -> np.ndarray:
    """The object's pose at the middle of the stream's arc."""
    return scenes.pose(scenes.rot_from(int(obj["pose_seed"])), obj["position_m"])


class Driver:
    UNIT = "frame"

    def __init__(self, cfg: dict, wl: dict, seed: int, device, work: str):
        self.cfg, self.wl, self.seed, self.work = cfg, wl, int(seed), work
        self.device = torch.device(device)
        self.trace_steps = int(wl["trace_steps"])
        self.p = dict(cfg.get("tracking", {}), **wl.get("program", {}))

    def setup(self) -> None:
        from poseestimator_tpu_torch.models.yolo.model import YOLO11Seg
        from poseestimator_tpu_torch.pipeline.pose_estimator import raster_assets
        from poseestimator_tpu_torch.pipeline.tracking import FusedFrame
        from poseestimator_tpu_torch.pipeline.window import window_for_object
        from poseestimator_tpu_torch.render.mesh import TriangleMesh

        from benchmark.harness.weights import yolo_state_dict

        dev = self.device
        self.cam = camera_of(self.cfg)
        intr = intrinsics_of(self.cam)
        obj = self.cfg["objects"][0]
        self.v, self.f = tcad.make_cad(int(obj["shape_seed"]), float(obj["diameter_mm"]),
                                       int(self.cfg["cad"]["subdivisions"]))
        ply = os.path.join(self.work, "obj.ply")
        tcad.write_ply(ply, self.v, self.f)
        mesh = TriangleMesh.load(ply)
        mesh_v, mesh_f = raster_assets(mesh, device=dev)
        det = self.cfg["detector"]
        self.sd = yolo_state_dict(int(det["nc"]), det["scale"], self.seed, dev)
        model = YOLO11Seg(nc=int(det["nc"]), scale=det["scale"])
        model.load_state_dict(self.sd)
        P = placement(obj)
        win = window_for_object(intr.scaled(2), float(np.linalg.norm(mesh.extent)),
                                float(P[2, 3]))
        self.frame = FusedFrame(model, mesh_v, mesh_f, intr, win_hw=win,
                                imgsz=int(det["imgsz"]), max_det=int(det["max_det"]),
                                target_pts=int(self.p.get("target_pts", 0)), device=dev)
        self.tap = ck.OutputTap(self.frame.model)
        self.frames = scenes.stream(self.wl["traffic"], [(self.v, self.f)], P[None], self.cam,
                                    float(self.cfg["sensor"]["noise_coef"]), self.seed, dev)
        self.gen = torch.Generator(device=dev).manual_seed(self.seed)
        self.warm = int(self.wl["warmup_steps"])
        k0 = int(self.frames.order[0])
        self.T = torch.as_tensor(self.frames.poses[k0, 0], device=dev)
        self.prevs, self.poses, self.iters, self.oks, self.ks = [], [], [], [], []
        for j in range(self.warm):
            self._frame(j)

    def _frame(self, j: int):
        k = int(self.frames.order[j % len(self.frames.order)])
        dev = self.device
        color = torch.from_numpy(self.frames.color[k]).to(dev)
        depth = torch.from_numpy(self.frames.depth[k]).to(dev)
        sil = torch.from_numpy(self.frames.masks[k, 0]).to(dev)
        res = self.frame(color, depth, self.T, conf=float(self.p["conf"]),
                         icp_dist=float(self.p["icp_dist"]), mask_union=sil, generator=self.gen)
        self.T = res.T
        return k, res

    def step(self, i: int) -> None:
        self.tap.key = i if ck.tapped(i, int(self.wl["check"]["tap_every"]), self.seed) else None
        self.prevs.append(self.T)
        k, res = self._frame(self.warm + i)
        self.poses.append(res.T)
        self.iters.append(res.n_iters)
        self.oks.append(res.ok)
        self.ks.append(k)

    def counters(self) -> dict:
        return {"icp_iters": list(self.iters)}

    def end_to_end(self, r) -> dict:
        pts = torch.as_tensor(tcad.surface_points(self.v, self.f, 1000, 0), device=self.device)
        T = torch.stack(self.poses[:r.before_steps])
        gt = torch.as_tensor(self.frames.poses[self.ks[:r.before_steps], 0], device=self.device)
        return {"adds_mm": float(ref_icp.adds_mm(T, gt, pts).mean())}

    def failed(self) -> int:
        return int(sum(int(not bool(o)) for o in self.oks))

    def free(self) -> None:
        self.tap.close()
        self.poses = [T.detach() for T in self.poses]
        del self.frame

    def check(self, control) -> list[dict]:
        chk = self.wl["check"]
        lim = self.wl["limits"]
        dev = self.device
        gap = ck.det_gap(self.tap, self.sd,
                         lambda i: torch.from_numpy(self.frames.color[self.ks[i]]).to(dev),
                         int(self.cfg["detector"]["imgsz"]), control)
        out = [ck.gap_line("det_gap", gap, lim["det_gap"])]
        vt, ft = torch.as_tensor(self.v, device=dev), torch.as_tensor(self.f, device=dev)
        pts = torch.as_tensor(tcad.surface_points(self.v, self.f, 1000, 0), device=dev)
        worst = 0.0 if self.poses else float("inf")
        for i in ck.sample(len(self.poses), int(chk["samples"]), self.seed):
            k, T_prev = self.ks[i], self.prevs[i]
            depth = torch.from_numpy(self.frames.depth[k]).to(dev)
            mask = torch.from_numpy(self.frames.masks[k, 0]).to(dev)
            args = (vt, ft, T_prev, depth, mask, self.cam, float(self.p["icp_dist"]))
            with ck.precision(None):
                T_ref = ref_icp.track_update(*args)
            T_out = self.poses[i]
            if control:
                with ck.precision(control):
                    T_out = ref_icp.track_update(*args)
            gap = ref_icp.add_mm(T_out, T_ref, pts)
            worst = max(worst, gap)
            gt = torch.as_tensor(self.frames.poses[k, 0], device=dev)
            ck.detail(f"frame {i}: gap {gap:.4f} mm, step {ref_icp.add_mm(T_prev, T_ref, pts):.4f}"
                      f" mm, program to truth {ref_icp.add_mm(T_out, gt, pts):.4f} mm, reference"
                      f" to truth {ref_icp.add_mm(T_ref, gt, pts):.4f} mm")
        out.append(ck.gap_line("pose_gap_mm", worst, lim["pose_gap_mm"]))
        return out
