"""Uniform sampling without replacement (counterpart of
``random_sample`` / ``_stratified_sample`` in
``poseestimator_tpu/geom3d/sampling.py``).

Randomness comes from an explicit ``torch.Generator``, or is injected as
``draws = (gumbel, uniform)``: the Gumbel scores (capacity,) and, on the
stratified route, the scalar uniform offset. Injected draws let a test feed
the exact numbers the JAX package drew and demand identical indices. Every
index order that feeds an output uses a stable sort, so ties go to the lower
index as in JAX's ``top_k`` / ``sort_key_val``.
"""
from __future__ import annotations

from typing import Optional

import torch

from .cloud import PointCloud

STRAT_BIN = 64  # bin width of the stratified sampler


def uses_stratified(capacity: int, n: int) -> bool:
    """Route of ``random_sample``: large pools (capacity >= 8n) go through
    the exact stratified pass."""
    return capacity >= 8 * min(n, capacity)


def make_draws(capacity: int, n: int, generator: Optional[torch.Generator],
               device) -> tuple:
    """Fresh ``(gumbel (capacity,), uniform () or None)`` for one call."""
    u = torch.rand(capacity, generator=generator, device=device).clamp_(min=1e-38)
    g = -torch.log(-torch.log(u))
    uni = None
    if uses_stratified(capacity, n):
        uni = torch.rand((), generator=generator, device=device)
    return g, uni


def random_sample(cloud: PointCloud, n: int,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[tuple] = None) -> PointCloud:
    """Uniform sample of ``min(n, count)`` valid points without replacement
    into an ``min(n, capacity)``-row buffer (output mask = true count)."""
    n = min(n, cloud.capacity)
    if draws is None:
        draws = make_draws(cloud.capacity, n, generator, cloud.points.device)
    g, uni = draws
    if uses_stratified(cloud.capacity, n):
        return _stratified_sample(cloud, n, g, uni)
    score = torch.where(cloud.valid, g, torch.full_like(g, float("-inf")))
    vals, idx = torch.sort(score, descending=True, stable=True)
    vals, idx = vals[:n], idx[:n]
    return PointCloud(points=cloud.points[idx], valid=torch.isfinite(vals))


def _stratified_sample(cloud: PointCloud, n: int, g: torch.Tensor,
                       uni: torch.Tensor) -> PointCloud:
    """Exact spatially-stratified sample for large pools.

    The pool splits into contiguous bins of ``STRAT_BIN`` points; bin b with
    ``c_b`` valid points gets the quota
    ``floor((C_b t + r) / m) - floor((C_{b-1} t + r) / m)`` (C = inclusive
    cumsum of c, t = min(count, n), m = count, r = floor(u m)), filled by the
    bin's top-quota Gumbel-scored valid points. The marks are exact integer
    arithmetic (int64 here, where the JAX package needs a modular scan to
    stay inside int32), so the output carries exactly ``t`` valid points and
    every valid point is kept with probability t / m.
    """
    N = cloud.capacity
    S = STRAT_BIN
    B = -(-N // S)
    pad = B * S - N
    dev = cloud.points.device
    score = torch.where(cloud.valid, g, torch.full_like(g, float("-inf")))
    if pad:
        score = torch.cat([score, score.new_full((pad,), float("-inf"))])
    score = score.reshape(B, S)
    # descending within-bin order, lower index first on ties
    sorted_score, sidx = torch.sort(score, dim=1, descending=True, stable=True)
    sidx = sidx + torch.arange(B, device=dev)[:, None] * S

    c = torch.isfinite(score).sum(1)  # int64 valid per bin
    total = c.sum()
    target = torch.clamp(total, max=n)
    m = torch.clamp(total, min=1)
    r = torch.minimum((uni * m.to(torch.float32)).to(torch.int64), m - 1)
    ct = c * target
    # rem_b = (C_b t + r) mod m; marks_b = floor((C_b t + r) / m) - floor(r / m)
    csum = torch.cumsum(ct, 0) + r
    marks = csum // m - r // m
    j = torch.arange(n, device=dev)
    bsel = torch.clamp(torch.searchsorted(marks, j, right=True), 0, B - 1)
    offsets = torch.cat([marks.new_zeros(1), marks[:-1]])
    rank = torch.clamp(j - offsets[bsel], 0, S - 1)
    # slots past the valid count may land in the bin padding; clamp as JAX's
    # gather does (those rows are invalid either way)
    sel = torch.clamp(sidx[bsel, rank], max=N - 1)
    new_valid = (j < target) & torch.isfinite(sorted_score[bsel, rank])
    return PointCloud(points=cloud.points[sel], valid=new_valid)
