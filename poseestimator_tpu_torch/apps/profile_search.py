"""Per-stage profile of the template search (counterpart of
``tools/profile_search.py``): cumulative prefixes of the search, each timed
over ``reps`` searches; the difference of consecutive prefixes is a stage's
marginal cost.

The prefixes call the search's own stages (``pipeline/pose_estimator.py``):
``_prep_dst``; ``_hypotheses`` (feature matching, ``ransac_registration``,
``teaser_solve``, ``_pca_hypotheses``; ``--hyp-split`` stops it after each);
the batched coarse ICP (``_coarse``); the render-ICP polish stages
(``polish``, ``predicted_views``) and the view scores (``_final_polish``,
``view_scores``). Every search draws its random numbers with
``_search_draws`` from a generator seeded with the search's index, so the
full prefix is ``search_templates`` bit for bit on the same draws
(``check_full``). The final stage polishes the estimator's
``search_final_topk`` best chains (all of them below that count).

Eager PyTorch has no fused program: a marginal time here is the stage's
host time and its device time together. After the timing, one search of
each prefix is traced with ``torch.profiler`` on the card: each stage's
marginal count of device kernels and device-busy ms, beside its K1 and K2
launches (single and batched). A trace with no device time on a card
(CUPTI failed) is an error. On the CPU the device columns are null.

Inputs: the random worst-case clouds of the JAX tool (5 templates x 1024
points, 4096 observation points, the point-splat instrument over 20 000
CAD samples), which never converge and run every early-exit loop to its
cap; or ``--realistic``, ``apps/_scene.py``'s bench scene (the 5-view
database, ``--view-set full`` the 26-view one, the exact raster).

    python -m poseestimator_tpu_torch.apps.profile_search 10 --realistic
    python -m poseestimator_tpu_torch.apps.profile_search 1 --device cpu

Prints a line per prefix, then one JSON line: each label's cumulative ms
(the JAX tool's keys), with ``kernels``, ``device_ms`` and the launches by
label.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import sys
import tempfile

import numpy as np
import torch

from ..device import resolve_device

# (stages, hypotheses level): 1 prep, 2 + hypotheses, 3 + coarse, 4-6 + the
# polish stages, 7 + the view scores and the winner
LADDER = (((1, 4), "prep (sample+voxel+FPFH dst, obs render)"),
          ((2, 4), "+hypotheses (match+RANSAC2048+TEASER x5)"),
          ((3, 4), "+coarse ICP (25 chains, 30 it)"),
          ((4, 4), "+fine polish stage 1 (q-res, r=1.0v)"),
          ((5, 4), "+fine polish stage 2 (q-res, r=0.3v)"),
          ((6, 4), "+fine polish stage 3 (h-res, r=0.1v)"),
          ((7, 4), "+score+argmin (FULL)"))
HYP_SPLIT = (((1, 4), "prep (sample+voxel+FPFH dst, obs render)"),
             ((2, 1), "+match (mutual-NN FPFH x5)"),
             ((2, 2), "+RANSAC 2048 x5"),
             ((2, 3), "+TEASER x5"),
             ((2, 4), "+PCA hypotheses (full block)"))
RANDOM_CAD_SAMPLES = 20_000  # the splat instrument's CAD samples (the JAX search's)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("reps", nargs="?", type=int, default=10)
    p.add_argument("--realistic", action="store_true",
                   help="profile on the bench scene (rendered template database, observation "
                   "one motion delta away) instead of worst-case random clouds, which never "
                   "converge and run every early-exit loop to its cap")
    p.add_argument("--hyp-split", action="store_true",
                   help="sub-profile the hypotheses block only: prefixes at match / +RANSAC / "
                   "+TEASER / +PCA instead of the full stage ladder")
    p.add_argument("--view-set", default="reduced", choices=["reduced", "full"],
                   help="with --realistic: template coverage (full = the 26-view sphere)")
    p.add_argument("--no-window", action="store_true",
                   help="render the predicted views over the full frame, not in object windows")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    p.add_argument("--res", default="640x480", help="camera WxH")
    return p


class SearchProfile:
    """The profiled search's inputs on ``device``."""

    def __init__(self, device="cuda", realistic: bool = False, view_set: str = "reduced",
                 window: bool = True, res=(640, 480)):
        from ..geom3d.camera import Intrinsics
        from ..pipeline import pose_estimator as pe

        self.device = dev = resolve_device(device)
        self.intr = Intrinsics.from_fov(60.0, *res)
        self.win_hw = "auto" if window else None
        rng = np.random.default_rng(0)
        cad_full = rng.normal(size=(40_000, 3)).astype(np.float32) * 0.05
        if realistic:
            from ._scene import make_scene

            # the estimators hold their databases once built: the files go
            with tempfile.TemporaryDirectory() as work:
                scene = make_scene(self.intr, rng, dev, work)
                est = scene.estimator
                if view_set == "full":
                    est = pe.PoseEstimator(scene.cad_ply, os.path.join(work, "views26"),
                                           self.intr, view_set="full", device=dev)
            self.tpl = (est._tpl_points, est._tpl_valid, est._tpl_fpfh)
            self.dst_cap = est._search_cap  # the product's adaptive working cap
            self.dst = (scene.dst_cloud.points, scene.dst_cloud.valid)
            self.sil = scene.obj_sil
            # the product's predicted-view instrument: the exact raster
            self.render = ("mesh", est._mesh_v, est._mesh_f)
            self.voxel = est.voxel_size
            self.n_final = est.search_final_topk
        else:
            box = rng.uniform(-0.5, 0.5, (5, 1024, 3)).astype(np.float32)
            box[..., 2] = np.sign(box[..., 2]) * 0.5
            as_t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
            self.tpl = (as_t(box), torch.ones((5, 1024), dtype=torch.bool, device=dev),
                        as_t(rng.random((5, 1024, 33)).astype(np.float32)))
            self.dst = (as_t(rng.uniform(-0.5, 0.5, (4096, 3)).astype(np.float32)),
                        torch.ones(4096, dtype=torch.bool, device=dev))
            self.sil = torch.ones((self.intr.height, self.intr.width), dtype=torch.bool,
                                  device=dev)
            # a point-cloud-only CAD: the point-splat instrument
            cad = as_t(cad_full[:RANDOM_CAD_SAMPLES])
            self.render = ("points", cad, torch.ones(cad.shape[0], dtype=torch.bool, device=dev))
            self.voxel = 0.05
            self.dst_cap = 1024
            self.n_final = inspect.signature(pe.PoseEstimator).parameters[
                "search_final_topk"].default

    def draws(self, i: int):
        """``(generator, draws)`` of search ``i``: every random number of
        the search from a generator seeded ``i``."""
        from ..pipeline import pose_estimator as pe

        gen = torch.Generator(device=self.device).manual_seed(i)
        return gen, pe._search_draws(gen, self.dst[0].shape[0], self.tpl[0].shape[0], 1,
                                     self.intr, self.win_hw, 2, False, self.render[0],
                                     self.device, None)

    @torch.no_grad()
    def prefix(self, n_stages: int, level: int = 4, i: int = 0):
        """The search's stages 1..n_stages (stage 2 stopped at hypotheses
        ``level``) of search ``i``; returns the last stage's output (7:
        ``search_templates``' tuple)."""
        from ..pipeline import pose_estimator as pe

        gen, draws = self.draws(i)
        voxel = pe._f32(self.voxel)
        tpl_pts, tpl_valid, tpl_fpfh = self.tpl
        kind, ra, rb = self.render
        prep = pe._prep_dst(*self.dst, self.intr, self.sil, True, voxel, gen, draws,
                            score_res=2, dst_cap=self.dst_cap)
        if n_stages == 1:
            return prep
        hyps = pe._hypotheses(prep, tpl_pts, tpl_valid, tpl_fpfh, voxel, gen, draws,
                              level=level if n_stages == 2 else 4)
        if n_stages == 2:
            return hyps
        use_half = pe._use_half(self.intr, False)
        flat_T0, T_c, top = pe._coarse(prep, hyps, tpl_pts, tpl_valid, voxel, use_half)
        if n_stages == 3:
            return T_c
        sc = pe._scoring(prep, ra, rb, self.intr, True, gen, draws, self.win_hw, 2, kind)
        early, final = pe._polish_ladder(sc, prep, use_half)
        T12 = pe.polish(sc, T_c[top], list(range(top.shape[0])), early[: n_stages - 3], 0,
                        voxel)
        if n_stages <= 5:
            return T12
        T_f, scores = pe._final_polish(sc, T12, final, voxel, self.n_final,
                                       score=n_stages >= 7)
        if n_stages == 6:
            return T_f
        best = torch.argmin(scores)
        return flat_T0[top][best], T_f[best], best, scores, T_f

    def check_full(self, i: int = 0) -> dict:
        """The full prefix of search ``i`` against ``search_templates`` on
        the same draws: winners, and max abs differences of the winner's
        pose and of the scores."""
        from ..pipeline import pose_estimator as pe

        got = self.prefix(7, 4, i)
        gen, draws = self.draws(i)
        kind, ra, rb = self.render
        ref = pe.search_templates(*self.dst, *self.tpl, ra, rb, self.intr, self.sil, True,
                                  self.voxel, gen, win_hw=self.win_hw, score_res=2,
                                  n_final=self.n_final, dst_cap=self.dst_cap, draws=draws,
                                  render_kind=kind)
        return {"winner": [int(got[2]), int(ref[2])],
                "pose_max_abs": float((got[1] - ref[1]).abs().max()),
                "scores_max_abs": float((got[3] - ref[3]).abs().max())}


def run(args, prof: SearchProfile | None = None) -> dict:
    """Time every prefix, then trace it on the card; returns the JSON
    line's dict (each label's cumulative ms), with ``marginal_ms``,
    ``kernels``, ``device_ms`` and the launches by label, and the full
    prefix held against ``search_templates`` on search 0 (``check_full``;
    not with ``--hyp-split``). ``prof``: the search to profile (default:
    built from ``args``)."""
    from ..geom3d import fused_nn as fnn
    from ..render import raster as rs
    from ..utils.profiling import device_activity, time_calls

    if prof is None:
        W, H = (int(v) for v in args.res.lower().split("x"))
        prof = SearchProfile(args.device, args.realistic, args.view_set, not args.no_window,
                             (W, H))
    dev = prof.device
    on_card = dev.type == "cuda"
    print(f"device: {torch.cuda.get_device_name(dev) if on_card else 'cpu'}", flush=True)
    counters = {"k1": fnn.fused_nn_stats, "k1_batched": fnn.fused_nn_batched_stats,
                "k2": rs.raster_stats, "k2_batched": rs.raster_batched_stats}

    def reset():
        for c in counters.values():
            c.launches = 0

    cum, launches, kernels, busy, prev = {}, {}, {}, {}, 0.0
    for (n, level), label in (HYP_SPLIT if args.hyp_split else LADDER):
        fn = lambda i: prof.prefix(n, level, i)  # noqa: E731
        per = time_calls(fn, args.reps, dev, after_warm=reset)
        cum[label] = per
        launches[label] = {k: c.launches / args.reps for k, c in counters.items()}
        kernels[label], busy[label] = device_activity(fn, 1) if on_card else (None, None)
        print(f"{label:48s} cum {per:9.2f} ms   marginal {per - prev:9.2f} ms   launches "
              + " ".join(f"{k} {v:g}" for k, v in launches[label].items()), flush=True)
        prev = per
    last = list(cum)[-1]
    if on_card and not busy[last] > 0.0:
        raise SystemExit("profile_search: torch.profiler recorded no device time on the card "
                         "(CUPTI tracing failed); no device figures to report")

    def marginal(d):
        out, before = {}, None
        for k, v in d.items():
            out[k] = None if v is None else (v if before is None else v - before)
            before = v
        return out

    m_k, m_busy = marginal(kernels), marginal(busy)
    m_launch = {label: {k: v - (launches[p][k] if p else 0.0) for k, v in launches[label].items()}
                for p, label in zip([None] + list(launches)[:-1], launches)}
    if on_card:
        print("\nmarginal kernels and device-busy ms a search (torch.profiler):")
        for label in cum:
            print(f"  {label:48s} kernels {m_k[label]:9.1f}   device {m_busy[label]:9.4f} ms")
    r = lambda x: None if x is None else round(x, 4)  # noqa: E731
    return {**{k: round(v, 2) for k, v in cum.items()},
            "marginal_ms": {k: r(v) for k, v in marginal(cum).items()},
            "kernels": {k: r(v) for k, v in m_k.items()},
            "device_ms": {k: r(v) for k, v in m_busy.items()},
            "launches": m_launch, "prefix_launches": launches,
            "device": torch.cuda.get_device_name(dev) if on_card else "cpu", "reps": args.reps,
            "realistic": args.realistic, "view_set": args.view_set,
            "templates": int(prof.tpl[0].shape[0]),
            "full_vs_search_templates": None if args.hyp_split else prof.check_full(0)}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    print(json.dumps(run(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
