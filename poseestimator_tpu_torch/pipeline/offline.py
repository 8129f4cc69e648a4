"""Offline single-frame template search (counterpart of
``poseestimator_tpu/pipeline/offline.py``), the flavour a one-image app and
the BOP scene sweep run: per template, a centroid + PCA pre-alignment,
farthest-point sampling to ``target_points``, normals and FPFH at the fixed
0.05 / 0.125 m radii, FPFH matching, RANSAC with the >= 20 correspondence
gate, TEASER with the noise bound 1.5 x the observation's resolution, and a
Chamfer ranking of the TEASER pose against the four PCA sign alignments on
the downsampled observation; the winner is scored by Chamfer on the full
clouds, and the lowest score over the templates wins.

``PMC_EXACT`` is honoured literally: when the native exact clique solver
loads (``registration/native.py``) and the sample fits its size cap, the
certified maximum clique of the consistency graph, built on the host in
numpy from the same float32 points as the JAX package builds it, is
applied through the correspondence mask and TEASER runs with ``NONE``; a
degenerate clique (< 3) falls back to the greedy in-solve selection. Each
template's metrics dict names the clique that ran.

Randomness comes from a ``torch.Generator`` (by default one on the host
seeded with ``seed``: the draws are made there and moved to the clouds'
device, so a run on the card draws what a run on the CPU draws), or is
injected through ``draws``: ``{"dst": gumbel (N_dst,), "templates":
[(gumbel (N_i,), uniforms (4096, 3)), ...]}``, the farthest-point starts
and the RANSAC sample draws, in the order the JAX package splits its key.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional, Sequence

import numpy as np
import torch

from ..geom3d.cloud import PointCloud
from ..geom3d.fpfh import compute_fpfh
from ..geom3d.metrics import chamfer_distance, cloud_resolution
from ..geom3d.normals import estimate_normals
from ..geom3d.sampling import farthest_point_sampling, make_draws
from ..geom3d.se3 import initial_align_centroid_pca, transform_points
from ..registration import native
from ..registration.features import match_features
from ..registration.ransac import ransac_registration
from ..registration.teaser import InlierSelectionMode, TeaserParams, teaser_solve
from .pose_estimator import _pca_hypotheses

# the exact clique is exponential in the worst case: the largest sample it
# is handed (the operating point, target_points = 100..400, is below it)
EXACT_CLIQUE_MAX_K = 512
RANSAC_ITERS = 4096
_FPFH_NORMAL_RADIUS = 0.05
_FPFH_RADIUS = 0.125  # 2.5 x the normal radius


def _gumbel(cloud: PointCloud, generator: torch.Generator) -> torch.Tensor:
    """Farthest-point start scores drawn on the generator's device, moved
    to the cloud's."""
    g, _ = make_draws(cloud.capacity, cloud.capacity, generator, generator.device)
    return g.to(cloud.points.device)


def _preprocess(cloud: PointCloud, n: int, gumbel: torch.Tensor):
    """Farthest-point sample of ``n`` points, outward normals (away from the
    sample's centroid) and FPFH features."""
    down = farthest_point_sampling(cloud, n, gumbel=gumbel)
    down = estimate_normals(down, radius=_FPFH_NORMAL_RADIUS, max_nn=30,
                            orient_towards=down.centroid())
    down = replace(down, normals=-down.normals)
    feats, _ = compute_fpfh(down, radius=_FPFH_RADIUS, max_nn=100)
    return down, feats


def _pca_sign_candidates(src: PointCloud, dst: PointCloud) -> torch.Tensor:
    """(4, 4, 4): the four det = +1 sign choices of the centroid + PCA
    alignment of ``src`` onto ``dst``. The set does not depend on the
    eigensolver's column signs; its order may."""
    return _pca_hypotheses(src.points[None], src.valid[None], dst)[0]


def _transform_batch(cloud: PointCloud, Ts: torch.Tensor) -> PointCloud:
    """The cloud under each of (B, 4, 4) poses, as a (B, N) batch."""
    return PointCloud(points=transform_points(Ts, cloud.points),
                      valid=cloud.valid.expand((Ts.shape[0],) + cloud.valid.shape))


@torch.no_grad()
def find_best_template_teaser(dst_cloud: PointCloud, src_clouds: Sequence[PointCloud],
                              target_points: int = 100, seed: int = 0,
                              min_correspondences: int = 20,
                              inlier_selection_mode: int = int(InlierSelectionMode.PMC_EXACT),
                              generator: Optional[torch.Generator] = None,
                              draws: Optional[dict] = None):
    """Register the observed ``dst_cloud`` against every full template
    cloud: ``(best_idx, T (4, 4) np.ndarray, best_score, all_metrics)``,
    one metrics dict per template (``template_idx``, ``num_corr``,
    ``num_inliers``, ``inlier_ratio``, ``geom``, ``score``, and ``clique``
    or ``note="few_corr"``). ``generator`` defaults to a host generator
    seeded with ``seed``."""
    dev = dst_cloud.points.device
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    cap = max(target_points, 64)
    n = min(target_points, cap)
    g_dst = draws["dst"] if draws else _gumbel(dst_cloud, generator)
    dst_down, dst_feats = _preprocess(dst_cloud, n, g_dst)

    res = float(cloud_resolution(dst_down))
    noise_bound = 1.5 * res
    match_max_dist = 4.0 * res
    use_exact = (inlier_selection_mode == int(InlierSelectionMode.PMC_EXACT)
                 and native.available() and cap <= EXACT_CLIQUE_MAX_K)
    # with the host's exact clique, the solve's own selection is off and the
    # clique arrives through the correspondence mask
    params = TeaserParams(noise_bound=noise_bound, cbar2=1.0, inlier_selection_mode=(
        int(InlierSelectionMode.NONE) if use_exact else inlier_selection_mode))
    d_np = dst_down.points.cpu().numpy()

    best = {"idx": -1, "T": np.eye(4), "score": np.inf}
    all_metrics = []
    for idx, src_cloud in enumerate(src_clouds):
        if draws:
            gumbel, uniforms = draws["templates"][idx]
        else:
            gumbel = _gumbel(src_cloud, generator)
            uniforms = torch.rand((RANSAC_ITERS, 3), generator=generator,
                                  device=generator.device).to(dev)
        T0 = initial_align_centroid_pca(src_cloud, dst_cloud)
        src_down, src_feats = _preprocess(src_cloud.transform(T0), n, gumbel)
        midx, mok = match_features(src_feats, src_down.valid, dst_feats, dst_down.valid)
        r = ransac_registration(src_down.points, dst_down.points, midx, mok, match_max_dist,
                                n_iters=RANSAC_ITERS, uniforms=uniforms)
        n_corr = int(r.n_inliers)
        if n_corr < min_correspondences:
            all_metrics.append({"template_idx": idx, "num_corr": n_corr, "num_inliers": 0,
                                "inlier_ratio": 0.0, "geom": float("inf"),
                                "score": float("inf"), "note": "few_corr"})
            continue

        solve_mask, solve_params, clique_kind = r.corr_mask, params, "greedy"
        if use_exact:
            # the consistency graph |‖dst_i - dst_j‖ - ‖src_i - src_j‖| <= 2 nb
            # in numpy from the float32 points, as the JAX package builds it
            s_np = src_down.points.cpu().numpy()
            m_np = d_np[midx.cpu().numpy()]
            sn = np.linalg.norm(s_np[:, None] - s_np[None, :], axis=-1)
            dn = np.linalg.norm(m_np[:, None] - m_np[None, :], axis=-1)
            adj = np.abs(dn - sn) <= 2.0 * noise_bound
            cmask, csize = native.max_clique_exact(adj, r.corr_mask.cpu().numpy())
            if csize >= 3:
                solve_mask = r.corr_mask & torch.from_numpy(cmask).to(dev)
                clique_kind = "exact"
            else:
                # a collapsed clique is where selection matters most: the
                # greedy in-solve selection, not none at all
                solve_params = replace(params,
                                       inlier_selection_mode=int(InlierSelectionMode.PMC_EXACT))

        sol = teaser_solve(src_down.points, dst_down.points[midx], solve_mask, solve_params)
        n_inl = int(sol.rotation_inliers.sum())
        T_full = sol.T @ T0

        # rank the TEASER pose and the four PCA alignments on the
        # downsampled observation (one batched Chamfer), then score the
        # winner on the full clouds
        cands = torch.cat([T_full[None], _pca_sign_candidates(src_cloud, dst_cloud)])
        down_geoms = chamfer_distance(_transform_batch(src_cloud, cands), dst_down)
        T_best = cands[int(torch.argmin(down_geoms))]
        score = float(chamfer_distance(src_cloud.transform(T_best), dst_cloud))

        all_metrics.append({"template_idx": idx, "num_corr": n_corr, "num_inliers": n_inl,
                            "inlier_ratio": n_inl / max(1, n_corr), "geom": score,
                            "score": score, "clique": clique_kind})
        if score < best["score"]:
            best.update(idx=idx, T=T_best.cpu().numpy(), score=score)

    return best["idx"], best["T"], best["score"], all_metrics
