"""TEASER-class robust registration (counterpart of ``teaser_solve`` in
``poseestimator_tpu/registration/teaser.py``) on the configuration the
template search uses: scale fixed at 1, inliers by the maximum clique of the
pairwise-consistency graph (the greedy clique of ``maxclique.py``), rotation
by graduated non-convexity over a truncated least-squares cost on the CHAIN
graph's translation-invariant measurements, translation by component-wise
adaptive voting, and a Horn refit on the translation inliers.

Every function takes a leading batch of problems. The while loops run as
JAX runs them under ``vmap``: while any member continues, and a member that
has stopped keeps its state. Options the JAX package offers beyond this
configuration (FGR and QUATRO rotations, the k-core inlier heuristic, the
COMPLETE measurement graph, scale estimation) raise ``NotImplementedError``.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch

from ..geom3d.se3 import make_T, quat_to_R
from .kabsch import _davenport, _quest_q_batched, kabsch_batched
from .maxclique import max_clique_greedy


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


def _check_supported(params: TeaserParams) -> None:
    if params.estimate_scaling:
        raise NotImplementedError("teaser_solve: estimate_scaling is not ported")
    if params.rotation_estimation_algorithm != RotationEstimationAlgorithm.GNC_TLS:
        raise NotImplementedError(
            f"teaser_solve: rotation algorithm "
            f"{RotationEstimationAlgorithm(params.rotation_estimation_algorithm).name} "
            f"is not ported (GNC_TLS is)")
    if params.rotation_tim_graph != InlierGraphFormulation.CHAIN:
        raise NotImplementedError("teaser_solve: the COMPLETE TIM graph is not ported")
    if params.inlier_selection_mode == InlierSelectionMode.KCORE_HEU:
        raise NotImplementedError("teaser_solve: KCORE_HEU inlier selection is not ported")


def _horn_rotation_only(src, dst, w):
    """R maximizing sum_i w_i dst_i . (R src_i) for (..., K, 3) measurements
    (translation-invariant, no centroids)."""
    S = (src * w[..., None]).transpose(-1, -2) @ dst
    return quat_to_R(_quest_q_batched(_davenport(S)))


def _f32(x) -> float:
    """``x`` rounded to float32 (the JAX package's params are float32)."""
    return float(np.float32(x))


def _gnc_tls_rotation(src_tims, dst_tims, tim_valid, params: TeaserParams):
    """Graduated non-convexity with a truncated least-squares cost: at most
    ``rotation_max_iterations`` weighted Wahba solves, stopping when the cost
    stops changing by more than ``rotation_cost_threshold``."""
    e = np.float32(2.0) * np.float32(params.noise_bound)  # float32 products
    eps2 = float(e * e * np.float32(params.cbar2))
    w0 = tim_valid.to(torch.float32)

    def residual2(R):
        diff = dst_tims - src_tims @ R.transpose(-1, -2)
        return (diff * diff).sum(-1)

    R0 = _horn_rotation_only(src_tims, dst_tims, w0)
    r2_0 = residual2(R0)
    r2_max = torch.where(tim_valid, r2_0, torch.zeros_like(r2_0)).amax(-1)
    mu0 = torch.clamp(eps2 / torch.clamp(2.0 * r2_max - eps2, min=1e-12), min=1e-6)
    cost0 = torch.where(tim_valid, torch.clamp(r2_0, max=eps2), torch.zeros_like(r2_0)).sum(-1)

    R, w, mu, cost, prev_cost = R0, w0, mu0, cost0, cost0 + 1.0
    it = torch.zeros_like(mu0, dtype=torch.int64)
    while True:
        active = (it < params.rotation_max_iterations) & (
            (cost - prev_cost).abs() > params.rotation_cost_threshold)
        if not bool(active.any()):
            break
        r2 = residual2(R)
        th1 = ((mu + 1.0) / mu * eps2)[..., None]  # above: weight 0
        th2 = (mu / (mu + 1.0) * eps2)[..., None]  # below: weight 1
        mid = torch.sqrt((eps2 * mu * (mu + 1.0))[..., None] / torch.clamp(r2, min=1e-20)) \
            - mu[..., None]
        w_new = torch.where(r2 >= th1, 0.0, torch.where(r2 <= th2, 1.0, mid))
        w_new = torch.clamp(w_new, 0.0, 1.0) * tim_valid.to(torch.float32)
        R_new = _horn_rotation_only(src_tims, dst_tims, w_new)
        new_cost = (w_new * torch.clamp(residual2(R_new), max=eps2)).sum(-1)
        a = active
        R = torch.where(a[..., None, None], R_new, R)
        w = torch.where(a[..., None], w_new, w)
        prev_cost = torch.where(a, cost, prev_cost)
        cost = torch.where(a, new_cost, cost)
        mu = torch.where(a, mu * params.rotation_gnc_factor, mu)
        it = it + a.to(torch.int64)
    return R, (w > 0.5) & tim_valid


def _component_tls(values, valid, noise_bound):
    """1-D truncated least squares by adaptive voting over (..., K) values:
    the mean of the largest set of intervals [v - b, v + b] sharing a point
    (the candidates are the interval ends)."""
    lo = values - noise_bound
    hi = values + noise_bound
    cands = torch.cat([lo, hi], dim=-1)
    cand_valid = torch.cat([valid, valid], dim=-1)
    member = ((cands[..., :, None] >= lo[..., None, :] - 1e-9)
              & (cands[..., :, None] <= hi[..., None, :] + 1e-9)
              & valid[..., None, :] & cand_valid[..., :, None])
    best = torch.argmax(member.sum(-1), dim=-1)
    inliers = member.gather(-2, best[..., None, None].expand(
        best.shape + (1, values.shape[-1])))[..., 0, :]
    n = torch.clamp(inliers.to(torch.float32).sum(-1), min=1.0)
    est = torch.where(inliers, values, torch.zeros_like(values)).sum(-1) / n
    return est, inliers


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
    _check_supported(params)
    K = src.shape[-2]
    n_valid = valid.sum(-1)

    # pairwise-consistency graph (scale 1)
    ds = src[..., :, None, :] - src[..., None, :, :]
    dd = dst[..., :, None, :] - dst[..., None, :, :]
    sn = torch.sqrt((ds * ds).sum(-1))
    dn = torch.sqrt((dd * dd).sum(-1))
    thresh = float(np.float32(2.0) * np.float32(params.noise_bound)
                   * np.sqrt(np.float32(params.cbar2)))
    adj = (dn - sn).abs() <= thresh

    if params.inlier_selection_mode == InlierSelectionMode.NONE:
        clique, clique_size = valid, n_valid
    else:
        clique, clique_size = max_clique_greedy(adj, valid)
    # fall back to all valid points if the clique degenerates
    sel = torch.where((clique_size >= 3)[..., None], clique, valid)

    src_tims, dst_tims, tim_valid, order = _chain_tims(src, dst, sel)
    R, rot_inl_sorted = _gnc_tls_rotation(src_tims, dst_tims, tim_valid, params)

    diffs = dst - src @ R.transpose(-1, -2)
    nb = _f32(params.noise_bound)
    per_axis = [_component_tls(diffs[..., a], sel, nb) for a in range(3)]
    t = torch.stack([e for e, _ in per_axis], dim=-1)
    trans_inliers = per_axis[0][1] & per_axis[1][1] & per_axis[2][1] & sel
    rot_inliers = torch.zeros_like(sel).scatter(-1, order, rot_inl_sorted)

    if params.refit:
        refit_w = (trans_inliers & sel).to(torch.float32)
        enough = refit_w.sum(-1) >= 3
        R_fit, t_fit = kabsch_batched(src, dst, refit_w)
        R = torch.where(enough[..., None, None], R_fit, R)
        t = torch.where(enough[..., None], t_fit, t)

    ok = n_valid >= 3
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    return TeaserSolution(
        rotation=torch.where(ok[..., None, None], R, eye),
        translation=torch.where(ok[..., None], t, torch.zeros_like(t)),
        valid=ok, clique_mask=sel & valid, rotation_inliers=rot_inliers & valid,
        translation_inliers=trans_inliers & valid)
