"""Driver of ``PoseEstimator.find_best_template_candidates`` (the search
under ``find_best_template_teaser``, which returns its winner and drops the
scores): time to first pose, one pose search a request.

Set-up writes the configuration's CAD as a PLY and builds the port's
``PoseEstimator`` over its template database (rendered into the run's
temporary directory), renders the observation pool, and puts it in a
``ReplayCamera`` in the run's order. Each request reads the next frame,
takes the masked back-projection of the true silhouette
(``get_pcd_from_rgbd``, as the port's trackers do before a search) and runs
the search with that mask.

Checked on sampled answers, each against the reference on the same
observation: ``pose_gap_mm``, the answer against the reference's
registration started from it (a converged answer stays in place);
``fit_excess_mm``, how much farther the observed points lie from the CAD at
the answer than at the rendered truth (a wrong basin fits worse; a pose that
the observation cannot tell from the truth does not); ``score_gap``, the
winner's score as the search returns it against the reference's score of
the truth (``reference/score.py``).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from benchmark.drivers.fused_frame import camera_of, intrinsics_of
from benchmark.harness import checks as ck
from benchmark.reference import icp as ref_icp
from benchmark.reference import score as ref_score
from benchmark.traffic import cad as tcad
from benchmark.traffic import scenes


class Driver:
    UNIT = "init"

    def __init__(self, cfg: dict, wl: dict, seed: int, device, work: str):
        self.cfg, self.wl, self.seed, self.work = cfg, wl, int(seed), work
        self.device = torch.device(device)
        self.trace_steps = int(wl["trace_steps"])
        self.p = dict(cfg.get("search", {}), **wl.get("program", {}))

    def setup(self) -> None:
        from poseestimator_tpu_torch.camera.source import ReplayCamera
        from poseestimator_tpu_torch.pipeline.pose_estimator import PoseEstimator

        dev = self.device
        self.cam = camera_of(self.cfg)
        intr = intrinsics_of(self.cam)
        obj = self.cfg["objects"][0]
        self.v, self.f = tcad.make_cad(int(obj["shape_seed"]), float(obj["diameter_mm"]),
                                       int(self.cfg["cad"]["subdivisions"]))
        ply = os.path.join(self.work, "obj.ply")
        tcad.write_ply(ply, self.v, self.f)
        self.est = PoseEstimator(ply, os.path.join(self.work, "views"), intr, intr.K,
                                 int(self.p["target_points"]), view_set=self.p["view_set"],
                                 seed=self.seed, device=dev)
        self.frames = scenes.pool(self.wl["traffic"], (self.v, self.f), self.cam,
                                  float(self.cfg["sensor"]["noise_coef"]), self.seed, dev)
        fr = self.frames
        self.camera = ReplayCamera([(fr.color[k], fr.depth[k]) for k in fr.order], intr,
                                   filter_depth=False, loop=True, device=dev)
        self.answers, self.scores, self.ks = [], [], []
        self.n = 0
        for _ in range(int(self.wl["warmup_steps"])):
            self._search()

    def _search(self):
        fr = self.frames
        k = int(fr.order[self.n % len(fr.order)])
        self.n += 1
        self.camera.get_rgbd()
        mask = fr.masks[k, 0]
        H, _, cands = self.est.find_best_template_candidates(
            self.camera.get_pcd_from_rgbd(mask), mask=mask)
        return k, H, cands[0][0]

    def step(self, i: int) -> None:
        k, H, score = self._search()
        self.answers.append(np.asarray(H, np.float32))
        self.scores.append(float(score))
        self.ks.append(k)

    def counters(self) -> dict:
        return {}

    def end_to_end(self, r) -> dict:
        return {}

    def failed(self) -> int:
        return int(sum(not (np.isfinite(H).all() and np.isfinite(s))
                       for H, s in zip(self.answers, self.scores)))

    def free(self) -> None:
        del self.est, self.camera

    def check(self, control) -> list[dict]:
        lim = self.wl["limits"]
        dev = self.device
        vt, ft = torch.as_tensor(self.v, device=dev), torch.as_tensor(self.f, device=dev)
        pts = torch.as_tensor(tcad.surface_points(self.v, self.f, 1000, 0), device=dev)
        surf = torch.as_tensor(tcad.surface_points(self.v, self.f, int(self.wl["check"]["surface"]),
                                                    1), device=dev)
        dist = float(self.p["check_icp_dist"])
        inf = float("inf")
        worst = dict.fromkeys(("pose_gap_mm", "fit_excess_mm", "score_gap"),
                              0.0 if self.answers else inf)
        for i in ck.sample(len(self.answers), int(self.wl["check"]["samples"]), self.seed):
            k = self.ks[i]
            depth = torch.from_numpy(self.frames.depth[k]).to(dev)
            mask = torch.from_numpy(self.frames.masks[k, 0]).to(dev)
            gt = torch.as_tensor(self.frames.poses[k, 0], device=dev)
            T_out = torch.as_tensor(self.answers[i], device=dev)
            s_out = self.scores[i]
            if control:
                with ck.precision(control):
                    T_out = ref_icp.track_update(vt, ft, T_out, depth, mask, self.cam, dist)
                    s_out = ref_score.view_score(vt, ft, T_out, depth, mask, self.cam)
            with ck.precision(None):
                T_ref = ref_icp.track_update(vt, ft, T_out, depth, mask, self.cam, dist)
                obs = ref_icp.observed_cloud(depth, mask, self.cam)
                fit_out = ref_score.surface_gap_mm(obs, surf, T_out)
                fit_gt = ref_score.surface_gap_mm(obs, surf, gt)
                s_own = ref_score.view_score(vt, ft, T_out, depth, mask, self.cam)
                s_gt = ref_score.view_score(vt, ft, gt, depth, mask, self.cam)
            got = {"pose_gap_mm": ref_icp.add_mm(T_out, T_ref, pts),
                   "fit_excess_mm": fit_out - fit_gt, "score_gap": abs(s_out - s_gt)}
            for key, v in got.items():
                worst[key] = max(worst[key], v if np.isfinite(v) else inf)
            adds = float(ref_icp.adds_mm(T_out[None], gt[None], pts)[0])
            ck.detail(f"search {i}: gap {got['pose_gap_mm']:.4f} mm, fit {fit_out:.4f} mm"
                      f" (truth {fit_gt:.4f}), score {s_out:.5f} (reference's of it {s_own:.5f},"
                      f" of the truth {s_gt:.5f}), ADD to truth"
                      f" {ref_icp.add_mm(T_out, gt, pts):.4f} mm, ADD-S {adds:.4f} mm")
        return [ck.gap_line(key, v, lim[key]) for key, v in worst.items()]
