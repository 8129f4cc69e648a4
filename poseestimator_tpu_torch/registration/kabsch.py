"""Weighted rigid alignment by Horn's quaternion method with a QUEST-style
eigenvector extraction (counterpart of
``poseestimator_tpu/registration/kabsch.py``).

The optimal rotation is the principal eigenvector of the traceless 4x4
Davenport matrix of the weighted cross-covariance. Its characteristic
polynomial is a depressed quartic whose largest root is reached by 10 Newton
steps from the upper bound sqrt(tr N^2); the eigenvector is the largest
column of adj(N - lambda I). Everything is elementwise tensor arithmetic on
the device: no eigensolver and no host round trip.

``kabsch`` solves one problem; ``kabsch_batched`` solves a leading batch of
them (the search's ICP chains, RANSAC and TEASER refits) with the same
arithmetic, and on the CPU each member rounds exactly as ``kabsch`` does:
torch's CPU ``bmm`` runs products of fewer than 400 multiply-adds per matrix
as a scalar loop, which rounds differently from the BLAS call a 2-D ``@``
makes, so the batched 4x4 products are padded onto the BLAS route; a 3x3
matrix-vector product is summed in the BLAS gemv's order; ``torch.trace``
accumulates in float64.

On the card a member's result must not depend on the batch beside it
either, and a CUDA reduction splits its rows by the batch's size (a (16,
2048) row sum rounds each row apart at B = 8). So ``batch_sum`` sums the
batched problems' weights, centroids and cross-covariances over their
points by ``tree_sum``, a pairwise tree of elementwise adds whose order is
fixed by the point count alone; on the CPU it is the plain ``sum``, which
already rounds each row alike at every batch size.
"""
from __future__ import annotations

import itertools

import torch

from ..geom3d.se3 import make_T, quat_to_R

# row/column indices of the 16 3x3 minors of a 4x4 matrix, in (i, j) order
_MINOR_ROWS = [[r for r in range(4) if r != i] for i in range(4)]
_MINOR_IDX = [(i, j) for i, j in itertools.product(range(4), range(4))]
_SIGN = [(-1.0) ** (i + j) for i, j in _MINOR_IDX]


def _davenport(S: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) Davenport matrix of (..., 3, 3) cross-covariances."""
    sxx, sxy, sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    syx, syy, syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    szx, szy, szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    return torch.stack([
        torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
        torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], -1),
        torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], -1),
    ], -2)


_index_cache: dict = {}


def _minor_index(device):
    """Gather indices of the 16 minors and their signs, made once per device
    (a fresh host-to-device copy per call would cost more than the math)."""
    if device not in _index_cache:
        rows = torch.tensor([_MINOR_ROWS[i] for i, _ in _MINOR_IDX], device=device)
        cols = torch.tensor([_MINOR_ROWS[j] for _, j in _MINOR_IDX], device=device)
        sign = torch.tensor(_SIGN, dtype=torch.float32, device=device)
        _index_cache[device] = (rows[:, :, None], cols[:, None, :], sign)
    return _index_cache[device]


def _cofactors(M: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) cofactor matrix: C[i, j] = (-1)^(i+j) det(minor(i, j)),
    every minor expanded along its first row."""
    rows, cols, sign = _minor_index(M.device)
    m = M[..., rows, cols]  # (..., 16, 3, 3)
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i_ = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    det3 = a * (e * i_ - f * h) - b * (d * i_ - f * g) + c * (d * h - e * g)
    return (sign * det3).reshape(M.shape[:-2] + (4, 4))


def _quest_q(N: torch.Tensor) -> torch.Tensor:
    """Principal eigenvector of the traceless symmetric Davenport matrix."""
    N2 = N @ N
    trN2 = torch.trace(N2)
    e2 = -0.5 * trN2
    e3 = (N2 * N).sum() / 3.0
    e4 = (N[0] * _cofactors(N)[0]).sum()  # det(N) by first-row expansion
    lam = torch.sqrt(torch.clamp(trN2, min=1e-30))
    for _ in range(10):
        p = ((lam * lam + e2) * lam - e3) * lam + e4
        dp = (4.0 * lam * lam + 2.0 * e2) * lam - e3
        lam = lam - p / torch.where(dp.abs() > 1e-30, dp, torch.full_like(dp, 1e-30))
    M = N - lam * torch.eye(4, dtype=N.dtype, device=N.device)
    adj = _cofactors(M).T
    q = adj[:, torch.argmax((adj * adj).sum(0))]
    return q / torch.clamp(torch.linalg.vector_norm(q), min=1e-30)


def kabsch(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor):
    """Best-fit ``(R, t)`` minimizing sum_i w_i ||R src_i + t - dst_i||^2;
    identity for all-zero weights."""
    w = weights.to(torch.float32)
    wsum = w.sum()
    ok = wsum > 1e-12
    wn = w / torch.where(ok, wsum, torch.ones_like(wsum))
    cs = (src * wn[:, None]).sum(0)
    cd = (dst * wn[:, None]).sum(0)
    S = ((src - cs) * wn[:, None]).T @ (dst - cd)  # 3x3 cross-covariance
    R = quat_to_R(_quest_q(_davenport(S)))
    t = cd - R @ cs
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    return torch.where(ok, R, eye), torch.where(ok, t, torch.zeros_like(t))


def kabsch_T(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``kabsch`` as one (4, 4) transform."""
    R, t = kabsch(src, dst, weights)
    return make_T(R, t)


def matmul_small(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product of (..., r, k) and (..., k, c) matrices with r, k, c
    <= 8, rounded on the CPU as the unbatched 2-D ``@`` rounds (see the
    module docstring)."""
    r, c = a.shape[-2], b.shape[-1]
    pa = torch.nn.functional.pad(a, (0, 8 - a.shape[-1], 0, 8 - r))
    pb = torch.nn.functional.pad(b, (0, 8 - c, 0, 8 - b.shape[-2]))
    return (pa @ pb)[..., :r, :c]


def _matvec3(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``R @ v`` for (..., 3, 3) and (..., 3), summed as the CPU gemv of an
    unbatched 3x3 ``R @ v`` sums."""
    return R[..., 0] * v[..., None, 0] + (R[..., 1] * v[..., None, 1]
                                          + R[..., 2] * v[..., None, 2])


def _quest_q_batched(N: torch.Tensor) -> torch.Tensor:
    """``_quest_q`` over a leading batch of (..., 4, 4) matrices."""
    N2 = matmul_small(N, N)
    trN2 = N2.diagonal(dim1=-2, dim2=-1).double().sum(-1).to(N.dtype)
    e2 = -0.5 * trN2
    e3 = (N2 * N).sum((-2, -1)) / 3.0
    e4 = (N[..., 0, :] * _cofactors(N)[..., 0, :]).sum(-1)
    lam = torch.sqrt(torch.clamp(trN2, min=1e-30))
    for _ in range(10):
        p = ((lam * lam + e2) * lam - e3) * lam + e4
        dp = (4.0 * lam * lam + 2.0 * e2) * lam - e3
        lam = lam - p / torch.where(dp.abs() > 1e-30, dp, torch.full_like(dp, 1e-30))
    M = N - lam[..., None, None] * torch.eye(4, dtype=N.dtype, device=N.device)
    adj = _cofactors(M).transpose(-1, -2)
    col = torch.argmax((adj * adj).sum(-2), dim=-1)
    q = adj.gather(-1, col[..., None, None].expand(adj.shape[:-1] + (1,)))[..., 0]
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1), min=1e-30)[..., None]


def tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` as a pairwise tree: zero-padded to a power of two,
    then halved by elementwise adds of the two halves. The order of the
    adds is fixed by the length of ``dim`` alone, so every slice rounds
    alike whatever the other dimensions hold, and the card's result is the
    CPU's bit for bit (elementwise adds, no contraction)."""
    dim = dim % x.dim()
    n = x.shape[dim]
    if n == 0:
        return x.sum(dim)
    pad = (1 << (n - 1).bit_length()) - n
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim)
    while x.shape[dim] > 1:
        h = x.shape[dim] // 2
        x = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
    return x.squeeze(dim)


def fixed_order(x: torch.Tensor) -> bool:
    """Whether a batched problem's sums over its points take ``tree_sum``:
    on the card, where a reduction's order depends on the batch's size."""
    return x.device.type != "cpu"


def batch_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A batched problem's sum over its points, rounded alike at every
    batch size: ``tree_sum`` on the card, the plain ``sum`` on the CPU."""
    return tree_sum(x, dim) if fixed_order(x) else x.sum(dim)


def weighted_moments(src: torch.Tensor, dst: torch.Tensor, wn: torch.Tensor, tree: bool):
    """Weighted centroids ``cs``, ``cd`` (..., 3) and cross-covariance ``S``
    (..., 3, 3) of src, dst (..., N, 3) under normalised weights (..., N):
    by ``tree_sum`` when ``tree``, else by the plain sums and product."""
    if not tree:
        cs = (src * wn[..., None]).sum(-2)
        cd = (dst * wn[..., None]).sum(-2)
        S = ((src - cs[..., None, :]) * wn[..., None]).transpose(-1, -2) @ (dst - cd[..., None, :])
        return cs, cd, S
    c = tree_sum(torch.cat([src, dst], -1) * wn[..., None], -2)
    cs, cd = c[..., :3], c[..., 3:]
    a = (src - cs[..., None, :]) * wn[..., None]
    return cs, cd, tree_sum(a[..., :, None] * (dst - cd[..., None, :])[..., None, :], -3)


def kabsch_batched(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor):
    """``kabsch`` over a leading batch: src, dst (..., N, 3), weights (..., N)
    -> (R (..., 3, 3), t (..., 3)); each member's result is independent of
    the batch (``batch_sum``)."""
    w = weights.to(torch.float32)
    wsum = batch_sum(w, -1)
    ok = wsum > 1e-12
    wn = w / torch.where(ok, wsum, torch.ones_like(wsum))[..., None]
    cs, cd, S = weighted_moments(src, dst, wn, tree=fixed_order(src))
    R = quat_to_R(_quest_q_batched(_davenport(S)))
    t = cd - _matvec3(R, cs)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    return (torch.where(ok[..., None, None], R, eye),
            torch.where(ok[..., None], t, torch.zeros_like(t)))
