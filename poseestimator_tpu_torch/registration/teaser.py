"""TEASER-class robust registration (counterpart of ``teaser_solve`` in
``poseestimator_tpu/registration/teaser.py``), with every option the JAX
package offers:

1. scale: fixed at 1, or (``estimate_scaling``) a truncated least-squares
   vote over the ratios of the complete graph's measurement norms;
2. inliers: the maximum clique of the pairwise-consistency graph (the greedy
   clique of ``maxclique.py`` for PMC_EXACT and PMC_HEU), its maximum k-core
   (KCORE_HEU), or every valid correspondence (NONE);
3. rotation over the translation-invariant measurements of the CHAIN or
   the COMPLETE graph: graduated non-convexity over a truncated
   least-squares cost (GNC_TLS), over the Geman-McClure cost (FGR), or
   GNC_TLS restricted to rotations about +z (QUATRO);
4. translation by component-wise adaptive voting, then a refit on the
   translation inliers (Horn; yaw-only for QUATRO).

Every function takes a leading batch of problems. The while loops run as
JAX runs them under ``vmap``: while any member continues, and a member that
has stopped keeps its state.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch

from ..geom3d.se3 import make_T, quat_to_R
from ..utils.profiling import host_read
from .kabsch import _davenport, _quest_q_batched, kabsch_batched
from .maxclique import max_clique_greedy, max_kcore


class RotationEstimationAlgorithm(enum.IntEnum):
    GNC_TLS = 0
    FGR = 1
    QUATRO = 2


class InlierSelectionMode(enum.IntEnum):
    PMC_EXACT = 0
    PMC_HEU = 1
    KCORE_HEU = 2
    NONE = 3


class InlierGraphFormulation(enum.IntEnum):
    CHAIN = 0
    COMPLETE = 1


@dataclass(frozen=True)
class TeaserParams:
    """The knobs of ``teaserpp_python.RobustRegistrationSolver.Params`` that
    the JAX package reads, with its defaults."""

    noise_bound: float = 0.01
    cbar2: float = 1.0
    estimate_scaling: bool = False
    rotation_estimation_algorithm: int = int(RotationEstimationAlgorithm.GNC_TLS)
    rotation_gnc_factor: float = 1.4
    rotation_max_iterations: int = 100
    rotation_cost_threshold: float = 1e-12
    rotation_tim_graph: int = int(InlierGraphFormulation.CHAIN)
    inlier_selection_mode: int = int(InlierSelectionMode.PMC_EXACT)
    refit: bool = True  # Horn refit on the translation inliers


@dataclass
class TeaserSolution:
    rotation: torch.Tensor  # (..., 3, 3)
    translation: torch.Tensor  # (..., 3)
    scale: torch.Tensor  # (...,): 1 unless estimate_scaling
    valid: torch.Tensor  # bool: at least 3 valid correspondences
    clique_mask: torch.Tensor  # (..., K) bool: max-clique inliers
    rotation_inliers: torch.Tensor  # (..., K) bool
    translation_inliers: torch.Tensor  # (..., K) bool

    @property
    def T(self) -> torch.Tensor:
        if self.rotation.dim() == 2:
            return make_T(self.rotation, self.translation)
        T = torch.eye(4, dtype=self.rotation.dtype, device=self.rotation.device).expand(
            self.rotation.shape[:-2] + (4, 4)).clone()
        T[..., :3, :3] = self.rotation
        T[..., :3, 3] = self.translation
        return T


def _horn_rotation_only(src, dst, w):
    """R maximizing sum_i w_i dst_i . (R src_i) for (..., K, 3) measurements
    (translation-invariant, no centroids)."""
    S = (src * w[..., None]).transpose(-1, -2) @ dst
    return quat_to_R(_quest_q_batched(_davenport(S)))


def _yaw_rotation_only(src, dst, w):
    """R about +z maximizing sum_i w_i dst_i . (R src_i) for (..., K, 3)
    measurements: theta = atan2(sum w (sx dy - sy dx), sum w (sx dx + sy
    dy)), the z components drop out."""
    c = (w * (src[..., 0] * dst[..., 0] + src[..., 1] * dst[..., 1])).sum(-1)
    s = (w * (src[..., 0] * dst[..., 1] - src[..., 1] * dst[..., 0])).sum(-1)
    norm = torch.sqrt(c * c + s * s)
    ok = norm > 1e-12
    cos = torch.where(ok, c / torch.clamp(norm, min=1e-12), torch.ones_like(c))
    sin = torch.where(ok, s / torch.clamp(norm, min=1e-12), torch.zeros_like(s))
    zero, one = torch.zeros_like(cos), torch.ones_like(cos)
    return torch.stack([torch.stack([cos, -sin, zero], -1), torch.stack([sin, cos, zero], -1),
                        torch.stack([zero, zero, one], -1)], -2)


def _f32(x) -> float:
    """``x`` rounded to float32 (the JAX package's params are float32)."""
    return float(np.float32(x))


def _eps2(params: TeaserParams) -> float:
    """(2 noise_bound)^2 cbar2, in float32 products as the JAX package's
    float32 parameters give it."""
    e = np.float32(2.0) * np.float32(params.noise_bound)
    return float(e * e * np.float32(params.cbar2))


def _residual2(src_tims, dst_tims, R):
    diff = dst_tims - src_tims @ R.transpose(-1, -2)
    return (diff * diff).sum(-1)


def _gnc_tls_rotation(src_tims, dst_tims, tim_valid, params: TeaserParams,
                      solve_fn=_horn_rotation_only):
    """Graduated non-convexity with a truncated least-squares cost: at most
    ``rotation_max_iterations`` weighted Wahba solves (``solve_fn``: Horn
    over SO(3), or yaw-only for QUATRO), stopping when the cost stops
    changing by more than ``rotation_cost_threshold``."""
    eps2 = _eps2(params)
    w0 = tim_valid.to(torch.float32)
    R0 = solve_fn(src_tims, dst_tims, w0)
    r2_0 = _residual2(src_tims, dst_tims, R0)
    r2_max = torch.where(tim_valid, r2_0, torch.zeros_like(r2_0)).amax(-1)
    mu0 = torch.clamp(eps2 / torch.clamp(2.0 * r2_max - eps2, min=1e-12), min=1e-6)
    cost0 = torch.where(tim_valid, torch.clamp(r2_0, max=eps2), torch.zeros_like(r2_0)).sum(-1)

    R, w, mu, cost, prev_cost = R0, w0, mu0, cost0, cost0 + 1.0
    it = torch.zeros_like(mu0, dtype=torch.int64)
    while True:
        active = (it < params.rotation_max_iterations) & (
            (cost - prev_cost).abs() > params.rotation_cost_threshold)
        go = active.any()
        with host_read():
            if not bool(go):
                break
        r2 = _residual2(src_tims, dst_tims, R)
        th1 = ((mu + 1.0) / mu * eps2)[..., None]  # above: weight 0
        th2 = (mu / (mu + 1.0) * eps2)[..., None]  # below: weight 1
        mid = torch.sqrt((eps2 * mu * (mu + 1.0))[..., None] / torch.clamp(r2, min=1e-20)) \
            - mu[..., None]
        w_new = torch.where(r2 >= th1, 0.0, torch.where(r2 <= th2, 1.0, mid))
        w_new = torch.clamp(w_new, 0.0, 1.0) * tim_valid.to(torch.float32)
        R_new = solve_fn(src_tims, dst_tims, w_new)
        new_cost = (w_new * torch.clamp(_residual2(src_tims, dst_tims, R_new), max=eps2)).sum(-1)
        a = active
        R = torch.where(a[..., None, None], R_new, R)
        w = torch.where(a[..., None], w_new, w)
        prev_cost = torch.where(a, cost, prev_cost)
        cost = torch.where(a, new_cost, cost)
        mu = torch.where(a, mu * params.rotation_gnc_factor, mu)
        it = it + a.to(torch.int64)
    return R, (w > 0.5) & tim_valid


def _gnc_fgr_rotation(src_tims, dst_tims, tim_valid, params: TeaserParams):
    """Graduated non-convexity with the Geman-McClure cost (the FGR
    back-end, Zhou et al. ECCV 2016): line-process weights ``(mu c^2 / (r^2
    + mu c^2))^2``, ``mu`` annealed down by ``rotation_gnc_factor`` a step
    from a convex start to 1, then iterated while the cost moves by more
    than ``rotation_cost_threshold``, at most ``rotation_max_iterations``
    steps. Inliers: weight >= 0.25, i.e. r^2 <= c^2 at mu = 1."""
    eps2 = _eps2(params)
    w0 = tim_valid.to(torch.float32)
    valid_f = tim_valid.to(torch.float32)

    def gm_cost(r2, mu):
        m = (mu * eps2)[..., None]
        return torch.where(tim_valid, m * r2 / (m + r2), torch.zeros_like(r2)).sum(-1)

    R0 = _horn_rotation_only(src_tims, dst_tims, w0)
    r2_0 = _residual2(src_tims, dst_tims, R0)
    r2_max = torch.where(tim_valid, r2_0, torch.zeros_like(r2_0)).amax(-1)
    mu0 = torch.clamp(r2_max / max(eps2, 1e-20), min=1.0)
    cost0 = gm_cost(r2_0, mu0)

    R, w, mu, cost, prev_cost = R0, w0, mu0, cost0, cost0 + 1.0
    it = torch.zeros_like(mu0, dtype=torch.int64)
    while True:
        active = (it < params.rotation_max_iterations) & (
            (mu > 1.0) | ((cost - prev_cost).abs() > params.rotation_cost_threshold))
        go = active.any()
        with host_read():
            if not bool(go):
                break
        r2 = _residual2(src_tims, dst_tims, R)
        m = (mu * eps2)[..., None]
        w_new = (m / (r2 + m)) ** 2 * valid_f
        R_new = _horn_rotation_only(src_tims, dst_tims, w_new)
        mu_new = torch.clamp(mu / params.rotation_gnc_factor, min=1.0)
        new_cost = gm_cost(_residual2(src_tims, dst_tims, R_new), mu_new)
        a = active
        R = torch.where(a[..., None, None], R_new, R)
        w = torch.where(a[..., None], w_new, w)
        prev_cost = torch.where(a, cost, prev_cost)
        cost = torch.where(a, new_cost, cost)
        mu = torch.where(a, mu_new, mu)
        it = it + a.to(torch.int64)
    return R, (w >= 0.25) & tim_valid


def _vote(values, bounds, valid, slack: float):
    """Adaptive voting over intervals [v - b, v + b] of (..., K) values:
    the mask of the largest set sharing a point (the candidates are the
    interval ends, widened by ``slack``) and the mean of its values."""
    lo, hi = values - bounds, values + bounds
    cands = torch.cat([lo, hi], dim=-1)
    cand_valid = torch.cat([valid, valid], dim=-1)
    member = ((cands[..., :, None] >= lo[..., None, :] - slack)
              & (cands[..., :, None] <= hi[..., None, :] + slack)
              & valid[..., None, :] & cand_valid[..., :, None])
    best = torch.argmax(member.sum(-1), dim=-1)
    inliers = member.gather(-2, best[..., None, None].expand(
        best.shape + (1, values.shape[-1])))[..., 0, :]
    n = torch.clamp(inliers.to(torch.float32).sum(-1), min=1.0)
    est = torch.where(inliers, values, torch.zeros_like(values)).sum(-1) / n
    return est, inliers


def _tls_scale(src_tims, dst_tims, tim_valid, params: TeaserParams):
    """Scale by voting over the measurement norm ratios ||dst|| / ||src||,
    each with the bound 2 noise_bound / ||src|| (TEASER step 1)."""
    sn = torch.linalg.vector_norm(src_tims, dim=-1)
    dn = torch.linalg.vector_norm(dst_tims, dim=-1)
    ok = tim_valid & (sn > 1e-9)
    sn_c = torch.clamp(sn, min=1e-9)
    bound = float(np.float32(2.0) * np.float32(params.noise_bound))
    return _vote(dn / sn_c, bound / sn_c, ok, 1e-12)


def _component_tls(values, valid, noise_bound):
    """1-D truncated least squares by adaptive voting over (..., K) values:
    the mean of the largest set of intervals [v - b, v + b] sharing a point."""
    return _vote(values, noise_bound, valid, 1e-9)


def _chain_tims(src, dst, mask):
    """Translation-invariant measurements over the CHAIN graph of the masked
    points, both sides: ``v_i = p_next(i) - p_i`` over the masked points
    moved to the front (in index order), cyclic. Returns (src_tims, dst_tims,
    tim_valid, order)."""
    K = src.shape[-2]
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
    n = mask.sum(-1, keepdim=True)
    slot = torch.arange(K, device=src.device)
    nxt = torch.where(slot + 1 < n, slot + 1, torch.zeros_like(slot))
    g = lambda x, i: x.gather(-2, i[..., None].expand(i.shape + (3,)))  # noqa: E731
    ps, pd = g(src, order), g(dst, order)
    tims_s = g(ps, nxt.expand(order.shape)) - ps
    tims_d = g(pd, nxt.expand(order.shape)) - pd
    tim_valid = (slot < n) & (n >= 2)
    return tims_s, tims_d, tim_valid, order


def teaser_solve(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
                 params: TeaserParams = TeaserParams()) -> TeaserSolution:
    """Robust registration of padded correspondences src (..., K, 3) ->
    dst (..., K, 3) under ``valid`` (..., K). Fewer than 3 valid
    correspondences give the identity with ``valid=False``."""
    algo = RotationEstimationAlgorithm(params.rotation_estimation_algorithm)
    K = src.shape[-2]
    n_valid = valid.sum(-1)
    dev = src.device

    # pairwise-consistency graph over the complete TIM graph
    ds = src[..., :, None, :] - src[..., None, :, :]
    dd = dst[..., :, None, :] - dst[..., None, :, :]
    sn = torch.sqrt((ds * ds).sum(-1))
    dn = torch.sqrt((dd * dd).sum(-1))
    iu = torch.triu_indices(K, K, offset=1, device=dev)
    if params.estimate_scaling:
        pair_valid = (valid[..., :, None] & valid[..., None, :])[..., iu[0], iu[1]]
        scale, _ = _tls_scale(ds[..., iu[0], iu[1], :], dd[..., iu[0], iu[1], :],
                              pair_valid, params)
    else:
        scale = torch.ones(n_valid.shape, dtype=torch.float32, device=dev)
    thresh = float(np.float32(2.0) * np.float32(params.noise_bound)
                   * np.sqrt(np.float32(params.cbar2)))
    adj = (dn - scale[..., None, None] * sn).abs() <= thresh

    if params.inlier_selection_mode == InlierSelectionMode.NONE:
        clique, clique_size = valid, n_valid
    elif params.inlier_selection_mode == InlierSelectionMode.KCORE_HEU:
        # the max k-core contains the max clique on clique-dominated graphs
        clique, _ = max_kcore(adj, valid)
        clique_size = clique.sum(-1)
    else:
        clique, clique_size = max_clique_greedy(adj, valid)
    # fall back to all valid points if the clique degenerates
    sel = torch.where((clique_size >= 3)[..., None], clique, valid)

    src_s = src * scale[..., None, None]
    complete = params.rotation_tim_graph == InlierGraphFormulation.COMPLETE
    if complete:
        src_tims = ds[..., iu[0], iu[1], :] * scale[..., None, None]
        dst_tims = dd[..., iu[0], iu[1], :]
        tim_valid = (sel[..., :, None] & sel[..., None, :])[..., iu[0], iu[1]]
    else:
        src_tims, dst_tims, tim_valid, order = _chain_tims(src_s, dst, sel)

    if algo == RotationEstimationAlgorithm.FGR:
        R, rot_inl = _gnc_fgr_rotation(src_tims, dst_tims, tim_valid, params)
    elif algo == RotationEstimationAlgorithm.QUATRO:
        R, rot_inl = _gnc_tls_rotation(src_tims, dst_tims, tim_valid, params,
                                       solve_fn=_yaw_rotation_only)
    else:
        R, rot_inl = _gnc_tls_rotation(src_tims, dst_tims, tim_valid, params)

    diffs = dst - src_s @ R.transpose(-1, -2)
    nb = _f32(params.noise_bound)
    per_axis = [_component_tls(diffs[..., a], sel, nb) for a in range(3)]
    t = torch.stack([e for e, _ in per_axis], dim=-1)
    trans_inliers = per_axis[0][1] & per_axis[1][1] & per_axis[2][1] & sel
    # complete-graph measurements do not map 1:1 to points
    rot_inliers = sel if complete else torch.zeros_like(sel).scatter(-1, order, rot_inl)

    if params.refit:
        refit_w = (trans_inliers & sel).to(torch.float32)
        enough = refit_w.sum(-1) >= 3
        if algo == RotationEstimationAlgorithm.QUATRO:
            # yaw-only on the centred inliers: a full Horn refit would bring
            # back the roll and pitch QUATRO excludes
            wsum = torch.clamp(refit_w.sum(-1), min=1.0)[..., None]
            cs = (src_s * refit_w[..., None]).sum(-2) / wsum
            cd = (dst * refit_w[..., None]).sum(-2) / wsum
            R_fit = _yaw_rotation_only(src_s - cs[..., None, :], dst - cd[..., None, :], refit_w)
            t_fit = cd - (R_fit @ cs[..., None])[..., 0]
        else:
            R_fit, t_fit = kabsch_batched(src_s, dst, refit_w)
        R = torch.where(enough[..., None, None], R_fit, R)
        t = torch.where(enough[..., None], t_fit, t)

    ok = n_valid >= 3
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    return TeaserSolution(
        rotation=torch.where(ok[..., None, None], R, eye),
        translation=torch.where(ok[..., None], t, torch.zeros_like(t)),
        scale=scale, valid=ok, clique_mask=sel & valid, rotation_inliers=rot_inliers & valid,
        translation_inliers=trans_inliers & valid)
