"""Weighted rigid alignment by Horn's quaternion method with a QUEST-style
eigenvector extraction (counterpart of
``poseestimator_tpu/registration/kabsch.py``).

The optimal rotation is the principal eigenvector of the traceless 4x4
Davenport matrix of the weighted cross-covariance. Its characteristic
polynomial is a depressed quartic whose largest root is reached by 10 Newton
steps from the upper bound sqrt(tr N^2); the eigenvector is the largest
column of adj(N - lambda I). Everything is elementwise tensor arithmetic on
the device: no eigensolver and no host round trip.
"""
from __future__ import annotations

import itertools

import torch

from ..geom3d.se3 import quat_to_R

# row/column indices of the 16 3x3 minors of a 4x4 matrix, in (i, j) order
_MINOR_ROWS = [[r for r in range(4) if r != i] for i in range(4)]
_MINOR_IDX = [(i, j) for i, j in itertools.product(range(4), range(4))]
_SIGN = [(-1.0) ** (i + j) for i, j in _MINOR_IDX]


def _davenport(S: torch.Tensor) -> torch.Tensor:
    sxx, sxy, sxz = S[0, 0], S[0, 1], S[0, 2]
    syx, syy, syz = S[1, 0], S[1, 1], S[1, 2]
    szx, szy, szz = S[2, 0], S[2, 1], S[2, 2]
    return torch.stack([
        torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx]),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz]),
        torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy]),
        torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz]),
    ])


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
    """(4, 4) cofactor matrix: C[i, j] = (-1)^(i+j) det(minor(i, j)), every
    minor expanded along its first row."""
    rows, cols, sign = _minor_index(M.device)
    m = M[rows, cols]  # (16, 3, 3)
    a, b, c = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e, f = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    g, h, i_ = m[:, 2, 0], m[:, 2, 1], m[:, 2, 2]
    det3 = a * (e * i_ - f * h) - b * (d * i_ - f * g) + c * (d * h - e * g)
    return (sign * det3).reshape(4, 4)


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
