"""Global pose initialisation by template search (counterpart of
``poseestimator_tpu/pipeline/pose_estimator.py``).

``PoseEstimator`` loads the CAD and its template database (rendering it when
missing), voxel-downsamples every template and computes its FPFH features
once. ``find_best_template_candidates`` then registers an observed cloud
against every template:

1. the observation is sampled (4096 and 2048 points), voxel-downsampled with
   FPFH features, and splatted (``splat=0``) into the scoring view;
2. per template, 5 hypotheses: the 4 sign choices of a PCA pre-alignment and
   FPFH matching -> RANSAC -> TEASER;
3. all template x hypothesis chains run one batched coarse ICP against the
   voxel cloud (one K1 launch per batched evaluation) and are scored by the
   residual/coverage ``alignment_score``;
4. the coarse-best chain of each template is polished by render-ICP: the CAD
   is rendered at the chain's pose (K2, one launch per chain and stage), the
   predicted view is registered to the observed cloud with a shrinking
   correspondence radius (1.0, 0.3 voxel at quarter resolution, 0.1 at the
   scoring resolution), and the result is scored by rendering once more and
   comparing depth and silhouette with the observation.

The lowest score wins. Camera resolutions whose quarter-resolution view has
at least 4096 pixels run the relaxed early-exit regime of the JAX package
(half-size clouds and looser tolerances in the early stages); smaller
cameras, or ``strict=True``, keep the 1e-6 tolerances everywhere.

Randomness comes from a ``torch.Generator``; ``draws`` injects the samplers'
draws (``"dense"``, ``"half"``, ``"views"`` keyed by (stage, chain)) and
RANSAC's uniforms (``"ransac"``, (templates, 2048, 3)).

The template-axis sharded search (``_search_templates_sharded``, behind
``PoseEstimator(mesh_devices=)``) runs the same ``_score_templates`` on each
rank's slice of templates. Every rank first draws the whole search's random
numbers from the generator in the order the single-device search draws
them (``_search_draws``) and takes its templates' and chains' share, so the
result does not depend on the partition and a mesh of one is the
single-device search bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..geom3d.camera import Intrinsics, backproject_depth
from ..geom3d.cloud import PointCloud, centroid
from ..geom3d.fpfh import compute_fpfh
from ..geom3d.metrics import alignment_score
from ..geom3d.normals import estimate_normals
from ..geom3d.sampling import make_draws, random_sample, voxel_down_sample
from ..geom3d.se3 import pca_axes, transform_points
from ..registration.features import match_features
from ..registration.icp import icp_point_to_point_batched
from ..registration.kabsch import batch_sum, matmul_small
from ..registration.ransac import ransac_registration
from ..registration.teaser import TeaserParams, teaser_solve
from ..render.mesh import TriangleMesh, decimate_to_faces, pad_faces
from ..render.points import render_depth
from ..render.raster import render_depth_mesh, render_depth_mesh_batched
from ..templates.db import load_templates
from ..utils.profiling import host_read, span, traced
from .window import window_dims, window_for_object, window_gather_batched, window_origin

SEARCH_CAP = 1024  # per-cloud point budget after the voxel downsample
# face budget of the predicted-view raster; larger CADs are decimated once
RASTER_FACE_CAP = 4096
RANSAC_ITERS = 2048
# the 4 det = +1 sign choices of a PCA frame's axes
_PCA_SIGNS = ((1.0, 1.0, 1.0), (1.0, -1.0, -1.0), (-1.0, 1.0, -1.0), (-1.0, -1.0, 1.0))


def _f32(x) -> float:
    """``x`` rounded to float32, as the JAX package's traced scalars are."""
    return float(np.float32(x))


def raster_assets(mesh: TriangleMesh, cap: int = RASTER_FACE_CAP, device="cuda"):
    """``(vertices (V, 3) f32, faces (F, 3) i64)`` for the predicted-view
    raster: decimated to ``cap`` faces, padded to a multiple of 256."""
    m = decimate_to_faces(mesh, cap)
    f = pad_faces(m.faces, -(-max(len(m.faces), 1) // 256) * 256)
    return (torch.from_numpy(np.asarray(m.vertices, np.float32)).to(device),
            torch.from_numpy(f.astype(np.int64)).to(device))


def _extract_fpfh(cloud: PointCloud, voxel_size, outward: bool = False):
    """Normals (radius = voxel, 30 neighbours) and FPFH (radius = 5 voxel,
    100 neighbours). Normals point away from the object: toward the camera
    origin for camera-frame clouds, away from the centroid for model-frame
    templates (``outward=True``)."""
    if outward:
        c = estimate_normals(cloud, radius=voxel_size, max_nn=30,
                             orient_towards=cloud.centroid())
        c = replace(c, normals=-c.normals)
    else:
        c = estimate_normals(cloud, radius=voxel_size, max_nn=30)
    feats, _ = compute_fpfh(c, radius=_f32(np.float32(voxel_size) * np.float32(5.0)), max_nn=100)
    return c, feats


def _as_intrinsics(intr, K) -> Intrinsics:
    if isinstance(intr, Intrinsics):
        return intr
    if hasattr(intr, "ppx"):  # a RealSense-style intrinsics object
        return Intrinsics(fx=float(intr.fx), fy=float(intr.fy), cx=float(intr.ppx),
                          cy=float(intr.ppy), width=int(intr.width), height=int(intr.height))
    raise TypeError(f"cannot interpret intrinsics {type(intr)}")


class PoseEstimator:
    """Template-search pose initialisation for one CAD model.

    ``device`` defaults to the card and raises when there is none;
    ``device="cpu"`` runs the kernels' plain versions. ``mesh_devices``, a
    ``parallel.Mesh``, shards the template axis of the search over the
    mesh's ``shard_axis`` (the estimator then runs on the mesh's device).
    The sharded search is SPMD: every rank builds the estimator and calls
    it with the same observation, and every rank gets the full result.
    It polishes every chain (``search_final_topk`` does not apply, as in
    the JAX package), so it equals the single-device search with
    ``search_final_topk=0``. A ``Tracker`` on a sharded estimator runs on
    every rank, each stepping the same frames.
    """

    def __init__(self, cad_path: str, pcd_path: str, intr, K: Optional[np.ndarray] = None,
                 target_points: int = 200, voxel_size: float = 0.05, seed: int = 0,
                 view_set: str = "reduced", mesh_devices=None, shard_axis: str = "tp",
                 search_window="auto", search_score_res: int = 2, search_polish: int = 1,
                 search_final_topk: int = 6, device: str | torch.device = "cuda"):
        mesh = TriangleMesh.load(cad_path)
        if np.max(mesh.extent) >= 1.0:  # millimetres -> metres
            mesh = mesh.scale(0.001, center=np.zeros(3))
        self._setup(mesh, intr, K, target_points, voxel_size, seed, search_window,
                    search_score_res, search_polish, search_final_topk, device,
                    mesh_devices, shard_axis)
        self.templates = load_templates(pcd_path, cad_path, view_set=view_set, device=self.device)
        self._prepare_templates()

    @classmethod
    def from_prepared(cls, mesh: TriangleMesh, intr, tpl_points, tpl_valid, tpl_fpfh,
                      K: Optional[np.ndarray] = None, target_points: int = 200,
                      voxel_size: float = 0.05, seed: int = 0, search_window="auto",
                      search_score_res: int = 2, search_polish: int = 1,
                      search_final_topk: int = 6, device: str | torch.device = "cuda"):
        """An estimator on already prepared templates: the voxel clouds
        (T, C, 3) / (T, C) and their FPFH features (T, C, 33), e.g. the JAX
        package's ``_tpl_points``, ``_tpl_valid``, ``_tpl_fpfh`` as numpy.
        ``mesh`` is the CAD in metres."""
        self = cls.__new__(cls)
        self._setup(mesh, intr, K, target_points, voxel_size, seed, search_window,
                    search_score_res, search_polish, search_final_topk, device)
        self.templates = None
        as_t = lambda a: torch.as_tensor(np.array(a), device=self.device)  # noqa: E731
        self._tpl_points = as_t(tpl_points).to(torch.float32)
        self._tpl_valid = as_t(tpl_valid).to(torch.bool)
        self._tpl_fpfh = as_t(tpl_fpfh).to(torch.float32)
        self._search_cap = int(min(SEARCH_CAP, max(512, 4 * self._tpl_points.shape[1])))
        return self

    def _setup(self, mesh, intr, K, target_points, voxel_size, seed, search_window,
               search_score_res, search_polish, search_final_topk, device,
               mesh_devices=None, shard_axis: str = "tp"):
        # the template axis shards over this parallel.Mesh (None: one device)
        self.device_mesh, self.shard_axis = mesh_devices, shard_axis
        self.device = resolve_device(device if mesh_devices is None else mesh_devices.device)
        self.intr = _as_intrinsics(intr, K)
        self.K = self.intr.K if K is None else np.asarray(K).reshape(3, 3)
        self.target_points = target_points
        self.voxel_size = float(voxel_size)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # "auto" | None | (h, w) window of the scoring view (window.py)
        self.search_window = search_window
        self.search_score_res = int(search_score_res)  # 2: half-resolution scoring
        self.search_polish = int(search_polish)  # polished hypotheses per template
        # the final polish stage runs on this many best chains (None: all)
        self.search_final_topk = int(search_final_topk) if search_final_topk else None
        self.mesh = mesh
        self._mesh_v, self._mesh_f = raster_assets(mesh, device=self.device)

    @torch.no_grad()
    def _prepare_templates(self):
        """Voxel downsample + FPFH of every template, stacked. The template
        axis is sized to the largest voxel count (a 128 multiple): every
        search cost scales with the padded capacity, and the observation's
        voxel set gets 4x that."""
        downs, feats = [], []
        for i in range(self.templates.count):
            down = voxel_down_sample(self.templates.cloud(i), self.voxel_size, capacity=SEARCH_CAP)
            down, f = _extract_fpfh(down, self.voxel_size, outward=True)
            downs.append(down)
            feats.append(f)
        n_max = max(int(d.valid.sum()) for d in downs)
        tpl_cap = min(SEARCH_CAP, max(128, -(-n_max // 128) * 128))
        self._tpl_points = torch.stack([d.points[:tpl_cap] for d in downs])
        self._tpl_valid = torch.stack([d.valid[:tpl_cap] for d in downs])
        self._tpl_fpfh = torch.stack(feats)[:, :tpl_cap]
        self._search_cap = int(min(SEARCH_CAP, max(512, 4 * tpl_cap)))

    def find_best_template_teaser(self, dst_cloud: PointCloud, keep_pre_icp: bool = False,
                                  mask=None, draws: Optional[dict] = None):
        """``(T (4, 4) np.ndarray, src_down PointCloud)`` of the best
        template."""
        H, src_down, _ = self.find_best_template_candidates(dst_cloud, keep_pre_icp, mask, draws)
        return H, src_down

    @torch.no_grad()
    @traced("search")
    def find_best_template_candidates(self, dst_cloud: PointCloud, keep_pre_icp: bool = False,
                                      mask=None, draws: Optional[dict] = None):
        """Search every template: ``(T, src_down, candidates)`` with the
        candidates ``[(score, T, template_index), ...]`` best first. ``mask``
        (H, W): the detection mask, scored as a dense observed silhouette.
        ``keep_pre_icp`` returns the winner's pre-polish hypothesis."""
        dev = self.device
        if mask is not None:
            obs_sil, have_mask = torch.as_tensor(mask, device=dev).to(torch.bool), True
        else:
            obs_sil = torch.zeros((self.intr.height, self.intr.width), dtype=torch.bool, device=dev)
            have_mask = False
        win = self.search_window
        if win == "auto":
            # the window bucket sized to this observation's distance
            with host_read():
                pts = dst_cloud.points.cpu().numpy()
            with host_read():
                val = dst_cloud.valid.cpu().numpy()
            z = float(np.median(pts[val, 2])) if val.any() else 1.0
            win = window_for_object(self.intr.scaled(self.search_score_res),
                                    float(np.linalg.norm(self.mesh.extent)), z)
        dst_pts, dst_valid = dst_cloud.points.to(dev), dst_cloud.valid.to(dev)
        if self.device_mesh is not None:
            tp, tv, tf, n_real = self._padded_templates()
            Hp_all, Hr_all, scores = _search_templates_sharded(
                self.device_mesh, dst_pts, dst_valid, tp, tv, tf, "mesh", self._mesh_v,
                self._mesh_f, self.intr, obs_sil, have_mask, self.voxel_size, self.generator,
                axis=self.shard_axis, win_hw=win, score_res=self.search_score_res,
                n_polish=self.search_polish, dst_cap=self._search_cap, draws=draws)
            # drop the pad copies; the winner is picked over the real ones
            scores, Ts_all = scores[:n_real], Hr_all[:n_real]
            best = torch.argmin(scores)
            with host_read():
                i = int(best)
            with host_read():
                H = (Hp_all[i] if keep_pre_icp else Ts_all[i]).cpu().numpy()
        else:
            H_pre, H_ref, best, scores, Ts_all = search_templates(
                dst_pts, dst_valid, self._tpl_points, self._tpl_valid, self._tpl_fpfh,
                self._mesh_v, self._mesh_f, self.intr, obs_sil, have_mask, self.voxel_size,
                self.generator, win_hw=win, score_res=self.search_score_res,
                n_polish=self.search_polish, n_final=self.search_final_topk,
                dst_cap=self._search_cap, draws=draws)
            with host_read():
                H = (H_pre if keep_pre_icp else H_ref).cpu().numpy()
            with host_read():
                i = int(best)
        with host_read():
            scores = scores.cpu().numpy()
        with host_read():
            Ts_all = Ts_all.cpu().numpy()
        src_down = PointCloud(points=self._tpl_points[i], valid=self._tpl_valid[i])
        candidates = [(float(scores[j]), Ts_all[j], int(j)) for j in np.argsort(scores, kind="stable")]
        return H, src_down, candidates

    def _padded_templates(self):
        """The template stacks padded by repetition to a multiple of the
        shard axis's size: ``(points, valid, fpfh, n_real)``. Whole copies
        are repeated, then sliced, so a pad larger than the template count
        (5 templates on a 16-way axis) pads fully."""
        n = self._tpl_points.shape[0]
        pad = (-n) % self.device_mesh.shape[self.shard_axis]
        if pad == 0:
            return self._tpl_points, self._tpl_valid, self._tpl_fpfh, n
        reps = -(-(n + pad) // n)
        rep = lambda a: torch.cat([a] * reps)[: n + pad]  # noqa: E731
        return rep(self._tpl_points), rep(self._tpl_valid), rep(self._tpl_fpfh), n

    @torch.no_grad()
    def create_template_from_H(self, T_m2c, target_points: Optional[int] = None) -> PointCloud:
        """The CAD rendered at ``T_m2c`` over the full frame, back-projected
        and sampled to ``target_points`` camera-frame points."""
        n = int(target_points or self.target_points)
        T = torch.as_tensor(np.asarray(T_m2c), dtype=torch.float32, device=self.device)
        depth = render_depth_mesh(self._mesh_v, self._mesh_f, T, self.intr, near=0.01, far=5.0)
        cloud = backproject_depth(depth, self.intr, depth_min=0.01, depth_max=5.0)
        return random_sample(cloud, n, self.generator)


def _pca_hypotheses(src_pts, src_valid, dst: PointCloud) -> torch.Tensor:
    """(T, 4, 4, 4) rigid hypotheses aligning each src's centroid and PCA
    axes to dst's under the 4 right-handed sign choices. The set does not
    depend on the eigensolver's column signs; its order does. Each
    template's statistics are its own unbatched ones: the card's batched
    sums and eigensolver round a template apart by how many run beside
    it."""
    c_s = torch.stack([centroid(p, v) for p, v in zip(src_pts, src_valid)])
    R_s = torch.stack([pca_axes(p, v)[0] for p, v in zip(src_pts, src_valid)])
    c_d = dst.centroid()
    R_d, _ = pca_axes(dst.points, dst.valid)
    signs = torch.tensor(_PCA_SIGNS, dtype=torch.float32, device=src_pts.device)
    R0 = R_d @ (R_s[:, None] * signs[None, :, None, :]).transpose(-1, -2)  # R_d diag(s) R_s^T
    t0 = c_d - (R0 @ c_s[:, None, :, None])[..., 0]
    T = torch.eye(4, dtype=torch.float32, device=src_pts.device).expand(R0.shape[:2] + (4, 4))
    T = T.clone()
    T[..., :3, :3] = R0
    T[..., :3, 3] = t0
    return T


@traced("search.prep")
def _prep_dst(dst_pts, dst_valid, intr: Intrinsics, mask_sil, have_mask, voxel, gen, draws,
              score_res: int = 2, dst_cap: int = SEARCH_CAP):
    """The observation side, once per search: dense (4096) and half (2048)
    working sets sampled uniformly, the voxel + FPFH set, and the observed
    depth splatted with ``splat=0`` into the scoring view (each sample
    claims only its own pixel: sparse but unbiased)."""
    dst = PointCloud(points=dst_pts, valid=dst_valid)
    dst_dense = random_sample(dst, 4096, gen, draws.get("dense"))
    dst_half = random_sample(dst, 2048, gen, draws.get("half"))
    dst_down = voxel_down_sample(dst, voxel, capacity=dst_cap)
    dst_down, dst_feats = _extract_fpfh(dst_down, voxel)
    intr_r = intr.scaled(score_res)
    eye = torch.eye(4, dtype=torch.float32, device=dst_pts.device)
    obs_depth = render_depth(dst_dense.points, dst_dense.valid, eye, intr_r, near=0.01, far=5.0,
                             splat=0)
    Hr, Wr, sr = intr_r.height, intr_r.width, score_res
    if have_mask:  # the detection mask any-pooled to the scoring resolution
        mask_sil_r = mask_sil[: Hr * sr, : Wr * sr].reshape(Hr, sr, Wr, sr).any(3).any(1)
    else:
        mask_sil_r = obs_depth > 0
    return dst_dense, dst_half, dst_down, dst_feats, obs_depth, mask_sil_r


def _search_windows(intr: Intrinsics, win_hw, score_res: int, render_kind: str = "mesh"):
    """``(intr_r, intr_q, win_r, win_q)``: the scoring view (1 / score_res),
    the early polish stages' quarter-resolution view, and their object
    windows (None: full frame; the point splat always renders full frame)."""
    intr_r = intr.scaled(score_res)
    intr_q = intr.scaled(4)  # the early polish stages' resolution
    win_r = (window_dims(intr_r, win_hw, default=(256 // score_res, 256 // score_res))
             if render_kind == "mesh" else None)
    win_q = (None if win_r is None else window_dims(
        intr_q, (max(win_r[0] * score_res // 4, 16), max(win_r[1] * score_res // 4, 128))))
    return intr_r, intr_q, win_r, win_q


def _use_half(intr: Intrinsics, strict: bool) -> bool:
    """The relaxed regime's resolution gate (see the module docstring)."""
    intr_q = intr.scaled(4)
    return (not strict) and intr_q.width * intr_q.height >= 4096


def _search_draws(gen: torch.Generator, dst_capacity: int, n_tpl: int, n_polish: int,
                  intr: Intrinsics, win_hw, score_res: int, strict: bool, render_kind: str,
                  device, draws: Optional[dict]) -> dict:
    """Every random number of a search that polishes all its chains, drawn
    from ``gen`` in the order the single-device search draws them: the
    dense and half samples, RANSAC's uniforms (n_tpl, 2048, 3), then the
    predicted views stage by stage, chain by chain. Entries of ``draws``
    are kept and not drawn, as the single-device search does."""
    out = dict(draws or {})
    for name, n in (("dense", 4096), ("half", 2048)):
        if name not in out:
            out[name] = make_draws(dst_capacity, min(n, dst_capacity), gen, device)
    if "ransac" not in out:
        out["ransac"] = torch.rand((n_tpl, RANSAC_ITERS, 3), generator=gen, device=device)
    intr_r, intr_q, win_r, win_q = _search_windows(intr, win_hw, score_res, render_kind)
    early_n = 1024 if _use_half(intr, strict) else 2048
    views = dict(out.get("views", {}))
    for s, (ri, win, n) in enumerate(((intr_q, win_q, early_n), (intr_q, win_q, early_n),
                                      (intr_r, win_r, 2048))):
        cap = ri.height * ri.width if win is None else win[0] * win[1]
        for c in range(n_tpl * n_polish):
            if (s, c) not in views:
                views[(s, c)] = make_draws(cap, min(n, cap), gen, device)
    out["views"] = views
    return out


@dataclass
class _Scoring:
    """What a search's predicted views and view scores share: the
    instrument (``"mesh"``: ``mesh_v``, ``mesh_f`` through the exact raster,
    windowed; ``"points"``: a point cloud's points and valid through the
    splat, full frame), the views' intrinsics and windows, the prepared
    observation, and the generator with the predicted views' draws."""

    mesh_v: torch.Tensor
    mesh_f: torch.Tensor
    render_kind: str
    intr_r: Intrinsics
    intr_q: Intrinsics
    win_r: Optional[tuple]
    win_q: Optional[tuple]
    obs_depth: torch.Tensor
    mask_sil_r: torch.Tensor
    n_obs_total: torch.Tensor
    n_mask_total: torch.Tensor
    have_mask: bool
    gen: Optional[torch.Generator]
    view_draws: dict


def _scoring(prep, mesh_v, mesh_f, intr: Intrinsics, have_mask, gen, draws, win_hw="auto",
             score_res: int = 2, render_kind: str = "mesh") -> _Scoring:
    """The ``_Scoring`` of a prepared observation. Object windows: every
    predicted view and view score renders only a window around the
    hypothesis's projected object; the window score equals the full-frame
    score whenever the window covers the predicted silhouette (pixels
    outside enter through their full-frame totals)."""
    obs_depth, mask_sil_r = prep[4], prep[5]
    intr_r, intr_q, win_r, win_q = _search_windows(intr, win_hw, score_res, render_kind)
    return _Scoring(mesh_v, mesh_f, render_kind, intr_r, intr_q, win_r, win_q, obs_depth,
                    mask_sil_r, torch.clamp((obs_depth > 0).sum(), min=1), mask_sil_r.sum(),
                    have_mask, gen, draws.get("views", {}))


def _render_full(sc: _Scoring, T, ri):
    if sc.render_kind == "points":
        return render_depth(sc.mesh_v, sc.mesh_f, T, ri, near=0.01, far=5.0)
    return render_depth_mesh(sc.mesh_v, sc.mesh_f, T, ri, near=0.01, far=5.0)


def predicted_views(sc: _Scoring, Ts, chains, ri, n, win, s):
    """The sampled predicted views of polish stage ``s`` at poses ``Ts``:
    one render for the stage; each chain then samples its own window with
    its own draws, in chain order."""
    if sc.render_kind == "points":
        deps, o = [_render_full(sc, T, ri) for T in Ts], None
    else:
        deps, o = render_windows(sc.mesh_v, sc.mesh_f, Ts, ri, win)
    return [random_sample(backproject_depth(d, ri, depth_min=0.01, depth_max=5.0,
                                            origin=None if o is None else o[i]),
                          n, sc.gen, sc.view_draws.get((s, c)))
            for i, (d, c) in enumerate(zip(deps, chains))]


@traced("search.scores")
def view_scores(sc: _Scoring, Ts):
    """Render-and-compare scores (B,) of poses ``Ts`` at the scoring view."""
    if sc.render_kind == "points":
        dep, o = torch.stack([_render_full(sc, T, sc.intr_r) for T in Ts]), None
    else:
        dep, o = render_windows(sc.mesh_v, sc.mesh_f, Ts, sc.intr_r, sc.win_r)
    if o is None:
        obs_d, msk, out_mask, out_obs = sc.obs_depth, sc.mask_sil_r, 0, 0
    else:
        obs_d = window_gather_batched(sc.obs_depth, o, *sc.win_r)
        msk = window_gather_batched(sc.mask_sil_r, o, *sc.win_r)
        out_mask = sc.n_mask_total - msk.sum((1, 2))
        out_obs = sc.n_obs_total - (obs_d > 0).sum((1, 2))
    if sc.have_mask:
        return window_scores(dep, obs_d, msk, out_mask)
    return window_scores(dep, obs_d, None, 0, out_obs, sc.n_obs_total)


def polish(sc: _Scoring, Ts, chains, stages, s0, voxel):
    """Render-ICP polish of the chains ``chains`` from poses ``Ts`` through
    the ladder rungs ``stages`` (numbered from ``s0``)."""
    vox = np.float32(voxel)
    for s, (dist, iters, ri, n_view, dst_s, tol_s, win_s) in enumerate(stages, s0):
        with span("search.polish", s, len(chains)):  # one span a rung: 0, 1 early, 2 final
            views = predicted_views(sc, Ts, chains, ri, n_view, win_s, s)
            d = icp_point_to_point_batched(
                torch.stack([v.points for v in views]), torch.stack([v.valid for v in views]),
                dst_s, _f32(np.float32(dist) * vox), max_iterations=iters,
                relative_fitness=tol_s, relative_rmse=tol_s)
            Ts = matmul_small(d.T, Ts)
    return Ts


def _polish_ladder(sc: _Scoring, prep, use_half: bool):
    """``(early, final)`` rungs of the render-ICP ladder: the early stages at
    quarter resolution (half-size clouds in the relaxed regime), the final
    sub-cm stage at the scoring view."""
    dst_dense, dst_half = prep[0], prep[1]
    early_n = 1024 if use_half else 2048
    early_dst = dst_half if use_half else dst_dense
    early_tol = 1e-4 if use_half else 1e-6
    final_tol = 1e-5 if use_half else 1e-6
    return (((1.0, 60, sc.intr_q, early_n, early_dst, early_tol, sc.win_q),
             (0.3, 60, sc.intr_q, early_n, early_dst, early_tol, sc.win_q)),
            ((0.1, 40, sc.intr_r, 2048, dst_dense, final_tol, sc.win_r),))


def _teaser_constants(voxel):
    """``(correspondence threshold, TeaserParams)`` of a voxel size."""
    noise_bound = np.float32(voxel) * np.float32(1.5)
    return _f32(noise_bound * np.float32(1.5)), TeaserParams(noise_bound=float(noise_bound))


@traced("search.hypotheses")
def _hypotheses(prep, tpl_pts, tpl_valid, tpl_fpfh, voxel, gen, draws, level: int = 4):
    """(T, 5, 4, 4): 5 hypotheses per template, the 4 PCA sign alignments
    and FPFH matching -> RANSAC -> TEASER. ``level`` < 4 stops early and
    returns that step's output (a profile's prefix, ``apps/profile_search.py``):
    1 the matches, 2 RANSAC's result, 3 TEASER's."""
    dst_down, dst_feats = prep[2], prep[3]
    corr_thresh, params = _teaser_constants(voxel)
    midx, mok = match_features(tpl_fpfh, tpl_valid, dst_feats, dst_down.valid)
    if level == 1:
        return midx, mok
    r = ransac_registration(tpl_pts, dst_down.points, midx, mok, corr_thresh,
                            n_iters=RANSAC_ITERS, generator=gen, uniforms=draws.get("ransac"))
    if level == 2:
        return r
    sol = teaser_solve(tpl_pts, dst_down.points[midx], r.corr_mask, params)
    if level == 3:
        return sol
    return torch.cat([_pca_hypotheses(tpl_pts, tpl_valid, dst_down), sol.T[:, None]], dim=1)


@traced("search.coarse")
def _coarse(prep, hyps, tpl_pts, tpl_valid, voxel, use_half: bool, n_polish: int = 1):
    """Every (template, hypothesis) chain in one batched ICP against the
    voxel cloud, scored by ``alignment_score``: ``(flat_T0 (T * 5, 4, 4),
    T_c (T * 5, 4, 4), top)`` with ``top`` the chains of each template's
    ``n_polish`` coarse-best hypotheses (lowest index first on ties). The
    relaxed regime exits at 1e-4 (the batch runs to its slowest chain and
    the polish re-registers the winner anyway)."""
    dst_down = prep[2]
    n_tpl, n_hyp = hyps.shape[:2]
    flat_T0 = hyps.reshape(n_tpl * n_hyp, 4, 4)
    flat_pts = tpl_pts.repeat_interleave(n_hyp, dim=0)
    flat_val = tpl_valid.repeat_interleave(n_hyp, dim=0)
    tol = 1e-4 if use_half else 1e-6
    coarse = icp_point_to_point_batched(flat_pts, flat_val, dst_down,
                                        _f32(np.float32(3.0) * np.float32(voxel)), flat_T0,
                                        max_iterations=30, relative_fitness=tol,
                                        relative_rmse=tol)
    T_c = coarse.T
    s_c = alignment_score(PointCloud(transform_points(T_c, flat_pts), flat_val),
                          PointCloud(flat_pts, flat_val), dst_down, voxel)
    bh = torch.sort(s_c.reshape(n_tpl, n_hyp), dim=1, stable=True).indices[:, :n_polish]
    top = (torch.arange(n_tpl, device=hyps.device)[:, None] * n_hyp + bh).reshape(-1)
    return flat_T0, T_c, top


def _final_polish(sc: _Scoring, T12, ladder_final, voxel, n_final=None, score: bool = True):
    """The final polish stage, then the view scores (``score``): on every
    chain, or on the ``n_final`` best after a re-score, the rest keeping
    their early-polish pose and score. ``(T_f, scores)``; scores None when
    not ``score`` and every chain is polished."""
    chains = list(range(T12.shape[0]))
    if n_final is None or n_final >= len(chains):
        T_f = polish(sc, T12, chains, ladder_final, 2, voxel)
        return T_f, (view_scores(sc, T_f) if score else None)
    s12 = view_scores(sc, T12)
    sel = torch.sort(s12, stable=True).indices[:n_final]
    with host_read():
        picked = sel.tolist()
    T3 = polish(sc, T12[sel], picked, ladder_final, 2, voxel)
    T_f, scores = T12.clone(), s12.clone()
    T_f[sel] = T3
    if score:
        scores[sel] = view_scores(sc, T3)
    return T_f, scores


def _score_templates(prep, tpl_pts, tpl_valid, tpl_fpfh, mesh_v, mesh_f, intr: Intrinsics,
                     have_mask, voxel, gen, draws, win_hw="auto", score_res: int = 2,
                     n_polish: int = 1, n_final=None, strict: bool = False,
                     render_kind: str = "mesh"):
    """Score every template against the prepared observation: ``(H_pre (T,
    4, 4), H_ref (T, 4, 4), scores (T,))``. ``render_kind``: the predicted
    views' instrument, ``"mesh"`` (``mesh_v``, ``mesh_f``: the exact raster,
    windowed) or ``"points"`` (``mesh_v``, ``mesh_f`` = points, valid: the
    point splat over the full frame, for point-cloud CADs)."""
    sc = _scoring(prep, mesh_v, mesh_f, intr, have_mask, gen, draws, win_hw, score_res,
                  render_kind)
    n_tpl = tpl_pts.shape[0]
    use_half = _use_half(intr, strict)
    hyps = _hypotheses(prep, tpl_pts, tpl_valid, tpl_fpfh, voxel, gen, draws)
    flat_T0, T_c, top = _coarse(prep, hyps, tpl_pts, tpl_valid, voxel, use_half, n_polish)
    ladder_early, ladder_final = _polish_ladder(sc, prep, use_half)
    T12 = polish(sc, T_c[top], list(range(top.shape[0])), ladder_early, 0, voxel)
    T_f, scores = _final_polish(sc, T12, ladder_final, voxel, n_final)
    if n_polish == 1:
        return flat_T0[top], T_f, scores
    sc_t = scores.reshape(n_tpl, n_polish)
    pick = torch.argmin(sc_t, dim=1)
    rows = torch.arange(n_tpl, device=tpl_pts.device)
    H_pre = flat_T0[top].reshape(n_tpl, n_polish, 4, 4)[rows, pick]
    return H_pre, T_f.reshape(n_tpl, n_polish, 4, 4)[rows, pick], sc_t[rows, pick]


@torch.no_grad()
@traced("search", only_root=True)
def search_templates(dst_pts, dst_valid, tpl_pts, tpl_valid, tpl_fpfh, mesh_v, mesh_f,
                     intr: Intrinsics, mask_sil, have_mask: bool, voxel, gen: torch.Generator,
                     win_hw="auto", score_res: int = 2, n_polish: int = 1, n_final=None,
                     dst_cap: int = SEARCH_CAP, strict: bool = False,
                     draws: Optional[dict] = None, render_kind: str = "mesh"):
    """The single-device template search: observation prep, every
    template's score, the winner. Returns ``(H_pre (4, 4), H_ref (4, 4),
    best (), scores (T,), H_ref_all (T, 4, 4))``. ``render_kind="points"``
    takes ``mesh_v``, ``mesh_f`` as a point cloud's points and valid."""
    draws = draws or {}
    voxel = _f32(voxel)
    prep = _prep_dst(dst_pts, dst_valid, intr, mask_sil, have_mask, voxel, gen, draws,
                     score_res=score_res, dst_cap=dst_cap)
    H_pre, H_ref, scores = _score_templates(
        prep, tpl_pts, tpl_valid, tpl_fpfh, mesh_v, mesh_f, intr, have_mask, voxel, gen, draws,
        win_hw=win_hw, score_res=score_res, n_polish=n_polish, n_final=n_final, strict=strict,
        render_kind=render_kind)
    best = torch.argmin(scores)
    return H_pre[best], H_ref[best], best, scores, H_ref


@torch.no_grad()
def _search_templates_sharded(mesh, dst_pts, dst_valid, tpl_pts, tpl_valid, tpl_fpfh,
                              render_kind: str, ra, rb, intr: Intrinsics, mask_sil,
                              have_mask: bool, voxel, gen: torch.Generator, axis: str = "tp",
                              win_hw="auto", score_res: int = 2, n_polish: int = 1,
                              dst_cap: int = SEARCH_CAP, strict: bool = False,
                              draws: Optional[dict] = None):
    """The template-axis sharded search on a ``parallel.Mesh``. Every rank
    passes the full inputs (T divisible by the mesh size; ``PoseEstimator``
    pads by repetition). The observation is prepared on every rank and
    replicated from rank 0; each rank scores its slice of templates with
    ``_score_templates`` on its share of the search's draws (drawn whole
    from ``gen``, so ``gen`` ends where the single-device search leaves it),
    polishing every chain; the slices are all-gathered. Returns the full
    ``(H_pre (T, 4, 4), H_ref (T, 4, 4), scores (T,))`` on every rank."""
    from ..parallel.mesh import check_divisible, replicate

    n_tpl = tpl_pts.shape[0]
    check_divisible(n_tpl, mesh.shape[axis], "template count")
    dev = mesh.device
    voxel = _f32(voxel)
    draws = _search_draws(gen, dst_pts.shape[0], n_tpl, n_polish, intr, win_hw, score_res,
                         strict, render_kind, dev, draws)
    dst_dense, dst_half, dst_down, feats, obs_depth, mask_sil_r = _prep_dst(
        dst_pts.to(dev), dst_valid.to(dev), intr, mask_sil.to(dev), have_mask, voxel, gen,
        draws, score_res=score_res, dst_cap=dst_cap)
    clouds = [replicate(mesh, [c.points, c.valid]) for c in (dst_dense, dst_half)]
    down = replicate(mesh, [dst_down.points, dst_down.valid, dst_down.normals])
    prep = (PointCloud(*clouds[0]), PointCloud(*clouds[1]),
            PointCloud(points=down[0], valid=down[1], normals=down[2]),
            *replicate(mesh, [feats, obs_depth, mask_sil_r]))
    sl = mesh.slice_of(n_tpl)
    c0, nc = sl.start * n_polish, (sl.stop - sl.start) * n_polish
    mine = {"ransac": draws["ransac"][sl],
            "views": {(st, c - c0): d for (st, c), d in draws["views"].items()
                      if c0 <= c < c0 + nc}}
    H_pre, H_ref, scores = _score_templates(
        prep, tpl_pts[sl].to(dev), tpl_valid[sl].to(dev), tpl_fpfh[sl].to(dev), ra.to(dev),
        rb.to(dev), intr, have_mask, voxel, gen, mine, win_hw=win_hw, score_res=score_res,
        n_polish=n_polish, n_final=None, strict=strict, render_kind=render_kind)
    return mesh.all_gather(H_pre), mesh.all_gather(H_ref), mesh.all_gather(scores)


@torch.no_grad()
def score_pose_candidates(mesh_v, mesh_f, Ts, depth, mask, intr: Intrinsics, win_hw="auto"):
    """Render-and-compare scores (K,) of candidate poses ``Ts`` (K, 4, 4)
    against one observed frame's depth and detection mask, lower is better:
    the search's depth + silhouette-IoU score at half resolution (depth
    point-sampled at stride 2, mask 2x2 any-pooled)."""
    intr_r = intr.scaled(2)
    Hr, Wr = intr_r.height, intr_r.width
    d_s = depth[: Hr * 2: 2, : Wr * 2: 2]
    m_s = mask[: Hr * 2: 2, : Wr * 2: 2]
    obs_d = torch.where(m_s & (d_s > 0), d_s, torch.zeros_like(d_s)).to(torch.float32)
    mask_r = mask[: Hr * 2, : Wr * 2].reshape(Hr, 2, Wr, 2).any(3).any(1)
    n_mask_total = mask_r.sum()
    win = window_dims(intr_r, win_hw)
    dep, o = render_windows(mesh_v, mesh_f, Ts, intr_r, win)
    if o is None:
        return window_scores(dep, obs_d, mask_r, 0)
    msk = window_gather_batched(mask_r, o, *win)
    return window_scores(dep, window_gather_batched(obs_d, o, *win), msk,
                         n_mask_total - msk.sum((1, 2)))


def render_windows(mesh_v, mesh_f, Ts, ri: Intrinsics, win):
    """(B, h, w) depth of B poses (B, 4, 4) from one batched K2 launch, each
    in the window ``win`` around its projected object (or over the full
    frame when ``win`` is None), and the (B, 2) window origins (None)."""
    if win is None:
        return render_depth_mesh_batched(mesh_v, mesh_f, Ts, ri, near=0.01, far=5.0), None
    o = torch.stack([window_origin(mesh_v, T, ri, win[0], win[1]) for T in Ts])
    d = render_depth_mesh_batched(mesh_v, mesh_f, Ts, ri, near=0.01, far=5.0,
                                  origin=o.to(torch.float32), out_hw=win)
    return d, o


def window_scores(dep, obs_d, msk, out_mask, out_obs=0, n_obs_total=1):
    """Render-and-compare scores (B,) of B predicted windows ``dep`` (B, h,
    w) against the observed depth ``obs_d`` and detection mask ``msk``
    windows ((B, h, w), or (h, w) over the full frame), lower is better:
    the mean depth gap over pixels both see, plus 1 - silhouette IoU, with
    ``out_mask`` mask pixels outside each window in the union. Without a
    mask (``msk`` None) the share of observed pixels the prediction misses
    (``out_obs`` outside the window, of ``n_obs_total``) weighs 0.25. Counts
    are exact integers and each window's depth sum runs in
    ``kabsch.batch_sum``'s order, so a score does not depend on B."""
    sil = dep > 0
    obs_s = obs_d > 0
    both = sil & obs_s
    n_both = torch.clamp(both.sum((1, 2)), min=1)
    gap = torch.where(both, (dep - obs_d).abs(), torch.zeros_like(dep))
    dz = batch_sum(gap.flatten(1), 1) / n_both
    if msk is not None:
        # dense silhouette IoU: sees the tangential slides that depth
        # residuals on smooth faces cannot
        inter = (sil & msk).sum((1, 2))
        union = torch.clamp((sil | msk).sum((1, 2)) + out_mask, min=1)
        return dz + 1.0 * (1.0 - inter / union)
    # the splat=0 observed silhouette is sparse: only observed pixels the
    # prediction misses are penalised
    miss = ((obs_s & ~sil).sum((1, 2)) + out_obs) / n_obs_total
    return dz + 0.25 * miss
