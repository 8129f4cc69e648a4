"""RANSAC over feature correspondences (counterpart of ``sample_triads``,
``_triad_rt``, ``ransac_registration`` and ``get_correspondences`` in
``poseestimator_tpu/registration/ransac.py``): a fixed budget of 3-point
hypotheses drawn by one inverse-CDF pass over the valid matches, each
checked by edge lengths (ratio 0.9) and sample distances, solved in closed
form from the two triangles' frames and scored by its inlier count with an
rmse tie-break; the winning sample is refit by the Horn solve.

Every function but the retry ladder ``get_correspondences`` takes a leading
batch of problems (the search's templates) against one shared destination
cloud. The uniform draws come from a
``torch.Generator`` or are injected, so a test can hand both packages the
same numbers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from ..geom3d.se3 import transform_points
from ..utils.profiling import host_read
from .kabsch import kabsch_batched

# hypotheses scored at once: bounds the (chunk, N, 3) moved-cloud temporary
_CHUNK = 256


@dataclass
class RansacResult:
    T: torch.Tensor  # (..., 4, 4)
    fitness: torch.Tensor  # inlier fraction among candidate matches
    inlier_rmse: torch.Tensor
    n_inliers: torch.Tensor  # int64
    corr_mask: torch.Tensor  # (..., N) bool: matches within distance under T
    found: torch.Tensor  # bool: any hypothesis passed both checkers
    triad: torch.Tensor  # (..., 3) int64: the winning sample's match indices


def sample_triads(match_valid: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """(..., n_iters, 3) indices into the match list from uniforms in [0, 1)
    of the same shape, uniform over the valid matches with replacement (a
    repeated index gives a zero-length edge the edge checker rejects)."""
    cdf = torch.cumsum(match_valid.to(torch.float32), dim=-1)
    u = uniforms * cdf[..., -1:, None]
    idx = torch.searchsorted(cdf.contiguous(), u.reshape(u.shape[:-2] + (-1,)).contiguous(),
                             right=True)
    return torch.clamp(idx, max=match_valid.shape[-1] - 1).reshape(uniforms.shape)


def _frame(x: torch.Tensor) -> torch.Tensor:
    """Right-handed frame (columns) of centred triangles (..., 3 points, 3)."""
    e1 = x[..., 1, :] - x[..., 0, :]
    e1 = e1 / torch.clamp(torch.linalg.vector_norm(e1, dim=-1, keepdim=True), min=1e-12)
    v = x[..., 2, :] - x[..., 0, :]
    e2 = v - (v * e1).sum(-1, keepdim=True) * e1
    e2 = e2 / torch.clamp(torch.linalg.vector_norm(e2, dim=-1, keepdim=True), min=1e-12)
    return torch.stack([e1, e2, torch.linalg.cross(e1, e2, dim=-1)], dim=-1)


def triad_rt(s3: torch.Tensor, d3: torch.Tensor):
    """Closed-form rigid alignment of 3-point samples (..., 3, 3): R maps the
    source triangle's frame onto the destination's (exact for congruent
    triangles; degenerate samples give a finite frame the edge checker
    rejects)."""
    cs = s3.mean(-2)
    cd = d3.mean(-2)
    R = _frame(d3 - cd[..., None, :]) @ _frame(s3 - cs[..., None, :]).transpose(-1, -2)
    return R, cd - (R @ cs[..., None])[..., 0]


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., N, 3) rows at idx (..., H, 3) -> (..., H, 3, 3)."""
    flat = idx.reshape(idx.shape[:-2] + (-1,))
    g = x.gather(-2, flat[..., None].expand(flat.shape + (3,)))
    return g.reshape(idx.shape + (3,))


def _scores(sel, src_c, dst_c, match_valid, max_corr_dist, edge_ratio):
    """Score of each hypothesis sel (..., H, 3); -1 where a checker fails."""
    s3 = _gather_rows(src_c, sel)
    d3 = _gather_rows(dst_c, sel)
    nxt = [1, 2, 0]
    es = torch.linalg.vector_norm(s3 - s3[..., nxt, :], dim=-1)
    ed = torch.linalg.vector_norm(d3 - d3[..., nxt, :], dim=-1)
    edge_ok = ((es > edge_ratio * ed) & (ed > edge_ratio * es)).all(-1)
    R, t = triad_rt(s3, d3)
    dist_ok = (torch.linalg.vector_norm(s3 @ R.transpose(-1, -2) + t[..., None, :] - d3, dim=-1)
               <= max_corr_dist).all(-1)
    moved = src_c[..., None, :, :] @ R.transpose(-1, -2) + t[..., None, :]  # (..., H, N, 3)
    d = torch.linalg.vector_norm(moved - dst_c[..., None, :, :], dim=-1)
    inl = match_valid[..., None, :] & (d <= max_corr_dist)
    n_inl = inl.sum(-1)
    rmse = torch.sqrt(torch.where(inl, d * d, torch.zeros_like(d)).sum(-1)
                      / torch.clamp(n_inl, min=1))
    # lexicographic (inliers, -rmse): counts differ by >= 1, the tie-break < 1
    score = n_inl.to(torch.float32) + 0.5 * (1.0 - rmse / max_corr_dist)
    return torch.where(edge_ok & dist_ok, score, torch.full_like(score, -1.0))


def ransac_registration(src_pts: torch.Tensor, dst_pts: torch.Tensor, match_idx: torch.Tensor,
                        match_valid: torch.Tensor, max_corr_dist, edge_ratio: float = 0.9,
                        n_iters: int = 4096, generator: Optional[torch.Generator] = None,
                        uniforms: Optional[torch.Tensor] = None) -> RansacResult:
    """RANSAC rigid registration of src (..., N, 3) onto dst (M, 3) over the
    matches ``match_idx`` (..., N) / ``match_valid`` (..., N).
    ``uniforms`` (..., n_iters, 3) in [0, 1) inject the sample draws."""
    if uniforms is None:
        uniforms = torch.rand(match_valid.shape[:-1] + (n_iters, 3), generator=generator,
                              device=src_pts.device)
    dst_c = dst_pts[match_idx]  # (..., N, 3) matched destination points
    sel = sample_triads(match_valid, uniforms)
    scores = torch.cat([_scores(sel[..., s:s + _CHUNK, :], src_pts, dst_c, match_valid,
                                max_corr_dist, edge_ratio)
                        for s in range(0, uniforms.shape[-2], _CHUNK)], dim=-1)
    best = torch.argmax(scores, dim=-1)
    found = scores.gather(-1, best[..., None])[..., 0] > 0.0
    triad = sel.gather(-2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    # least-squares (Horn) refit of the winning sample
    s3 = _gather_rows(src_pts, triad[..., None, :])[..., 0, :, :]
    d3 = _gather_rows(dst_c, triad[..., None, :])[..., 0, :, :]
    R, t = kabsch_batched(s3, d3, torch.ones(s3.shape[:-1], device=s3.device))
    eye = torch.eye(4, dtype=R.dtype, device=R.device)
    T = eye.expand(R.shape[:-2] + (4, 4)).clone()
    T[..., :3, :3] = torch.where(found[..., None, None], R, eye[:3, :3])
    T[..., :3, 3] = torch.where(found[..., None], t, torch.zeros_like(t))
    d = torch.linalg.vector_norm(transform_points(T, src_pts) - dst_c, dim=-1)
    corr = match_valid & (d <= max_corr_dist) & found[..., None]
    n_inl = corr.sum(-1)
    n_cand = torch.clamp(match_valid.sum(-1), min=1)
    rmse = torch.sqrt(torch.where(corr, d * d, torch.zeros_like(d)).sum(-1)
                      / torch.clamp(n_inl, min=1))
    return RansacResult(T=T, fitness=n_inl.to(torch.float32) / n_cand.to(torch.float32),
                        inlier_rmse=rmse, n_inliers=n_inl, corr_mask=corr, found=found,
                        triad=triad)


def get_correspondences(src_pts: torch.Tensor, dst_pts: torch.Tensor, match_idx: torch.Tensor,
                        match_valid: torch.Tensor, distance_threshold: float,
                        n_iters: int = 4096, generator: Optional[torch.Generator] = None,
                        uniforms: Optional[Sequence[torch.Tensor]] = None) -> RansacResult:
    """The threshold retry ladder: RANSAC at ``distance_threshold``, then at
    twice and at half of it, returning the first result with >= 3 inliers
    (else the last). A rung runs only when the one before it failed, decided
    on the host. ``uniforms``: the three rungs' (n_iters, 3) draws."""
    rungs = (1.0, 2.0, 0.5)
    for k, f in enumerate(rungs):
        r = ransac_registration(src_pts, dst_pts, match_idx, match_valid,
                                distance_threshold * f, n_iters=n_iters, generator=generator,
                                uniforms=None if uniforms is None else uniforms[k])
        if k == len(rungs) - 1:
            return r
        with host_read():
            enough = int(r.n_inliers) >= 3
        if enough:
            return r
