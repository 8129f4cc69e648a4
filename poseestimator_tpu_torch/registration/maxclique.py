"""Maximum-clique inlier selection (counterpart of ``max_clique_greedy`` in
``poseestimator_tpu/registration/maxclique.py``): greedy growth from every
vertex at once, each step one batched 0/1 product that counts every
candidate's neighbours among its seed's candidates. The counts are exact
small integers in float32, so the picks do not depend on summation order.
"""
from __future__ import annotations

import torch

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
        if step % _CHECK_EVERY == 0 and not bool(cand.any()):
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
