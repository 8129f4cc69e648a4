"""Uniform sampling without replacement, farthest-point sampling and
voxel-grid downsampling (counterpart of ``random_sample``,
``_stratified_sample``, ``farthest_point_sampling``, ``downsample_to``,
``voxel_down_sample`` and ``voxel_coverage`` in
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

from .cloud import PointCloud, compact

STRAT_BIN = 64  # bin width of the stratified sampler
SENTINEL = 2 ** 30  # voxel coordinate of invalid points


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
    return _gather(cloud, idx, torch.isfinite(vals))


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
    return _gather(cloud, sel, new_valid)


def _gather(cloud: PointCloud, idx: torch.Tensor, valid: torch.Tensor) -> PointCloud:
    """The rows ``idx`` of the cloud (points, normals, colours) under ``valid``."""
    take = lambda a: None if a is None else a[idx]  # noqa: E731
    return PointCloud(points=cloud.points[idx], valid=valid, normals=take(cloud.normals),
                      colors=take(cloud.colors))


def farthest_point_sampling(cloud: PointCloud, n: int,
                            generator: Optional[torch.Generator] = None,
                            gumbel: Optional[torch.Tensor] = None) -> PointCloud:
    """Farthest-point sampling of ``n`` points: the start is the valid point
    of highest Gumbel score (``gumbel`` (capacity,) injected, or drawn from
    ``generator``), then each step takes the point farthest from all taken
    so far (the first on ties). A taken point's distance is set to -inf and
    invalid points start there, so once the valid points run out the steps
    take index 0; the output marks ``min(n, count)`` rows valid. The steps
    run on the device without a host read."""
    pts = cloud.points
    if gumbel is None:
        gumbel = make_draws(cloud.capacity, cloud.capacity, generator, pts.device)[0]
    neg_inf = torch.full_like(gumbel, float("-inf"))
    first = torch.argmax(torch.where(cloud.valid, gumbel, neg_inf))
    dist = torch.where(cloud.valid, torch.full_like(gumbel, float("inf")), neg_inf)
    dist.index_fill_(0, first.view(1), float("-inf"))
    sel = torch.zeros(n, dtype=torch.int64, device=pts.device)
    sel[0] = first
    for i in range(1, n):
        # index tensors, not Python ints: no step waits for the device
        d = torch.linalg.vector_norm(pts - pts.index_select(0, sel[i - 1:i]), dim=1)
        dist = torch.minimum(dist, d)
        nxt = torch.argmax(dist)
        dist.index_fill_(0, nxt.view(1), float("-inf"))
        sel[i] = nxt
    new_valid = torch.arange(n, device=pts.device) < torch.clamp(cloud.count(), max=n)
    return _gather(cloud, sel, new_valid)


def downsample_to(cloud: PointCloud, n: int, method: str = "fps",
                  generator: Optional[torch.Generator] = None, draws=None) -> PointCloud:
    """``n`` points by farthest-point sampling (``draws``: the Gumbel start
    scores) or by ``random_sample`` (``draws``: its ``(gumbel, uniform)``)."""
    if method == "fps":
        return farthest_point_sampling(cloud, n, generator, draws)
    if method == "random":
        return random_sample(cloud, n, generator, draws)
    raise ValueError(f"unknown sampling method {method!r}")


def _voxel_coords(points: torch.Tensor, valid: torch.Tensor, voxel_size) -> torch.Tensor:
    coords = torch.floor(points / voxel_size).to(torch.int32)
    return torch.where(valid[..., None], coords, torch.full_like(coords, SENTINEL))


def voxel_down_sample(cloud: PointCloud, voxel_size: float,
                      capacity: Optional[int] = None) -> PointCloud:
    """Mean point of each occupied voxel (Open3D ``voxel_down_sample``: the
    grid anchored at the cloud's min bound), voxels in lexicographic order of
    their integer coordinates, compacted to the front of a ``capacity``-row
    buffer (default: the input capacity).

    The JAX package keeps the first ``capacity + 1`` unique coordinate rows
    (``jnp.unique(size=capacity + 1, fill_value=SENTINEL)``, the invalid
    points' sentinel row sorting last) and drops the points of every voxel
    past them; the port emulates exactly that on ``torch.unique(dim=0)``,
    which sorts rows the same way.
    """
    cap = cloud.capacity if capacity is None else int(capacity)
    pts, valid = cloud.points, cloud.valid
    lo = torch.where(valid[:, None], pts, torch.full_like(pts, 1e30)).amin(0)
    coords = _voxel_coords(pts - lo, valid, voxel_size)
    uniq, inv = torch.unique(coords, dim=0, return_inverse=True)
    n_seg = cap + 1
    if uniq.shape[0] < n_seg:
        uniq = torch.cat([uniq, uniq.new_full((n_seg - uniq.shape[0], 3), SENTINEL)])
    uniq = uniq[:n_seg]
    hit = inv < n_seg  # the point's voxel survived the capacity cut
    w = valid & hit
    seg = torch.where(hit, inv, torch.zeros_like(inv))
    counts = segment_sum(w.to(torch.float32)[:, None], seg, n_seg)[:, 0]
    sums = segment_sum(pts * w[:, None].to(torch.float32), seg, n_seg)
    means = sums / torch.clamp(counts, min=1.0)[:, None]
    voxel_ok = (counts > 0) & (uniq != SENTINEL).any(1)
    return compact(PointCloud(points=means[:cap], valid=voxel_ok[:cap]), cap)


def segment_sum(values: torch.Tensor, seg: torch.Tensor, n_seg: int) -> torch.Tensor:
    """Row sums of ``values`` (N, C) by segment id ``seg`` (N,) -> (n_seg, C),
    in an order fixed by the data alone: the rows are stably sorted by
    segment, then each segment is summed by a segmented inclusive scan of
    log2(N) elementwise doubling steps, and read at its last row. No
    atomics, so runs on the card agree bit for bit (a float ``index_add_``
    adds in whatever order its atomics land)."""
    order = torch.argsort(seg, stable=True)
    s, x = seg[order], values[order]
    n = s.shape[0]
    step = 1
    while step < n:
        same = (s[step:] == s[:-step])[:, None]
        x = torch.cat([x[:step], torch.where(same, x[step:] + x[:-step], x[step:])])
        step *= 2
    last = torch.ones_like(s, dtype=torch.bool)
    last[:-1] = s[1:] != s[:-1]
    out = values.new_zeros((n_seg, values.shape[1]))
    out[s[last]] = x[last]  # one row per segment: no two writes collide
    return out


def voxel_coverage(points: torch.Tensor, valid: torch.Tensor, voxel_size) -> torch.Tensor:
    """Number of distinct occupied voxels of a grid anchored at the origin,
    per cloud of a (..., N, 3) batch -> (...,) int64. The rows are sorted
    lexicographically per cloud (three stable sorts) and counted where they
    change, so any int32 coordinates count exactly."""
    coords = _voxel_coords(points, valid, voxel_size)
    order = torch.arange(coords.shape[-2], device=coords.device).expand(coords.shape[:-1])
    for col in (2, 1, 0):
        key = coords[..., col].gather(-1, order)
        order = order.gather(-1, torch.argsort(key, dim=-1, stable=True))
    rows = coords.gather(-2, order[..., None].expand(coords.shape))
    new = torch.ones(rows.shape[:-1], dtype=torch.bool, device=rows.device)
    new[..., 1:] = (rows[..., 1:, :] != rows[..., :-1, :]).any(-1)
    return (new & (rows != SENTINEL).any(-1)).sum(-1)
