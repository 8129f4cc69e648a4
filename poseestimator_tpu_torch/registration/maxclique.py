"""Maximum-clique inlier selection (counterpart of ``max_clique_greedy``
and ``max_kcore`` in ``poseestimator_tpu/registration/maxclique.py``):
greedy growth from every vertex at once, each step one batched 0/1 product
that counts every candidate's neighbours among its seed's candidates; and
the maximum k-core by min-degree peeling. The counts are exact small
integers in float32, so the picks do not depend on summation order.
"""
from __future__ import annotations

import torch

from ..utils.profiling import host_read

# the loop's exit flag is read back every this many steps: a step on a seed
# without candidates changes nothing, so steps past the exit are no-ops
_CHECK_EVERY = 8


def max_clique_greedy(adj: torch.Tensor, valid: torch.Tensor):
    """(Near-)maximum clique of each graph of a (..., K, K) batch.

    adj: symmetric bool adjacency (diagonal ignored); valid: (..., K) vertex
    mask. Every vertex seeds a clique; each step, every seed adds the
    candidate with the most neighbours among its candidates (lowest index
    on ties) and keeps only candidates adjacent to it. Returns
    ``(clique_mask (..., K) bool, size (...,) int64)``: the largest seed
    clique (the lowest seed on ties).
    """
    K = adj.shape[-1]
    eye = torch.eye(K, dtype=torch.bool, device=adj.device)
    pair = valid[..., :, None] & valid[..., None, :]
    A = adj & pair & ~eye
    Af = A.to(torch.float32)
    in_clique = eye & pair
    cand = A.clone()
    step = 0
    while step < K:
        if step % _CHECK_EVERY == 0:
            left = cand.any()
            with host_read():
                if not bool(left):
                    break
        deg = cand.to(torch.float32) @ Af  # (..., S, K)
        pick = torch.argmax(torch.where(cand, deg, torch.full_like(deg, -1.0)), dim=-1)
        has = cand.any(-1)
        pick_oh = torch.nn.functional.one_hot(pick, K).to(torch.bool) & has[..., None]
        in_clique = in_clique | pick_oh
        rows = A.gather(-2, pick[..., None].expand(pick.shape + (K,)))
        cand = cand & torch.where(has[..., None], rows, cand) & ~pick_oh
        step += 1
    sizes = torch.where(valid, in_clique.sum(-1), torch.zeros_like(valid, dtype=torch.int64))
    best = torch.argmax(sizes, dim=-1)
    clique = in_clique.gather(-2, best[..., None, None].expand(best.shape + (1, K)))[..., 0, :]
    return clique, sizes.gather(-1, best[..., None])[..., 0]


def max_kcore(adj: torch.Tensor, valid: torch.Tensor):
    """Maximum k-core of each graph of a (..., K, K) batch (TEASER's
    KCORE_HEU inlier selection): k* is the degeneracy, the largest minimum
    degree met while peeling the vertex of least degree K times (lowest
    index on ties); the core is then the fixpoint of deleting vertices of
    degree < k*. Returns ``(core (..., K) bool, k* (...,) int64)``."""
    K = adj.shape[-1]
    eye = torch.eye(K, dtype=torch.bool, device=adj.device)
    A = adj & valid[..., :, None] & valid[..., None, :] & ~eye
    Af = A.to(torch.float32)

    def degree(m):
        return (Af @ m.to(torch.float32)[..., None])[..., 0]

    m = valid.clone()
    kstar = torch.zeros(valid.shape[:-1], dtype=torch.int64, device=adj.device)
    for _ in range(K):
        deg = torch.where(m, degree(m), torch.full_like(Af[..., 0], float(K + 1)))
        v = torch.argmin(deg, dim=-1)
        dmin = deg.gather(-1, v[..., None])[..., 0].to(torch.int64)
        kstar = torch.where(m.any(-1), torch.maximum(kstar, dmin), kstar)
        m = m & ~torch.nn.functional.one_hot(v, K).to(torch.bool)
    core = valid
    while True:
        keep = core & (degree(core) >= kstar[..., None].to(torch.float32))
        with host_read():
            if torch.equal(keep, core):
                return core, kstar
        core = keep
