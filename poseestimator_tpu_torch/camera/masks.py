"""The segmentation-error model of the JAX package's tracking evaluation
(``tools/eval_tracking.py``), without cv2: a perfect mask eroded or dilated
by up to ``px`` pixels, then each pixel of its boundary ring flipped with
probability 0.25. Erosion and dilation with an all-ones square kernel are a
min and a max filter, so both run as ``max_pool2d``; as with cv2's default
border, pixels outside the image take no part."""
from __future__ import annotations

import numpy as np
import torch


def _dilate(m: torch.Tensor, k: int) -> torch.Tensor:
    """Max over the k x k square around each pixel (k odd), (H, W) float."""
    return torch.nn.functional.max_pool2d(m[None, None], k, stride=1, padding=k // 2)[0, 0]


def _erode(m: torch.Tensor, k: int) -> torch.Tensor:
    return -_dilate(-m, k)


def degrade_mask(mask: torch.Tensor, px: int, rng: np.random.Generator) -> torch.Tensor:
    """One frame of mask error for an (H, W) bool mask, drawing from ``rng``
    in the evaluation's order: the kernel size ``2 * integers(1, px + 1) +
    1`` and the erode-or-dilate coin (only when ``px > 0``), then the
    uniform field of the boundary flips."""
    m = mask.to(torch.float32)
    if px > 0:
        k = 2 * int(rng.integers(1, px + 1)) + 1
        m = _erode(m, k) if rng.random() < 0.5 else _dilate(m, k)
    ring = (_dilate(m, 3) - _erode(m, 3)) > 0
    flip = torch.from_numpy(rng.random(tuple(m.shape)) < 0.25).to(mask.device) & ring
    return torch.where(flip, m < 0.5, m > 0.5)
