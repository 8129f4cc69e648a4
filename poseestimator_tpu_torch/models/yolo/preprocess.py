"""Letterbox preprocessing (counterpart of
``poseestimator_tpu/models/yolo/preprocess.py``): resize keeping aspect
ratio into a fixed square canvas, pad with 114-gray, normalize to [0, 1]."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class LetterboxMeta:
    scale: float  # float32 value
    pad_x: float
    pad_y: float
    orig_h: int
    orig_w: int


def letterbox(img: torch.Tensor, size: int = 640):
    """(H, W, 3) uint8/float image -> ((size, size, 3) float32 in [0, 1],
    LetterboxMeta). Bilinear resample at pixel centres, centred with
    symmetric padding (value 114). The geometry is static, computed on the
    host in float32 as the JAX package computes it."""
    h, w = img.shape[:2]
    dev = img.device
    img = img.to(torch.float32)
    scale = np.float32(min(size / h, size / w))
    new_h = int(np.round(np.float32(h) * scale))
    new_w = int(np.round(np.float32(w) * scale))
    pad_y = (size - new_h) // 2
    pad_x = (size - new_w) // 2
    ar = torch.arange(size, dtype=torch.float32, device=dev)
    ys = (ar - pad_y + 0.5) / float(scale) - 0.5
    xs = (ar - pad_x + 0.5) / float(scale) - 0.5
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0)[:, None, None]
    wx = torch.clamp(xs - x0, 0.0, 1.0)[None, :, None]
    r0, r1 = img[y0], img[y1]
    g = (r0[:, x0] * (1 - wy) * (1 - wx) + r0[:, x1] * (1 - wy) * wx
         + r1[:, x0] * wy * (1 - wx) + r1[:, x1] * wy * wx)
    in_y = (ar >= pad_y) & (ar < pad_y + new_h)
    in_x = (ar >= pad_x) & (ar < pad_x + new_w)
    inside = in_y[:, None] & in_x[None, :]
    out = torch.where(inside[..., None], g, torch.full_like(g, 114.0)) / 255.0
    meta = LetterboxMeta(scale=float(scale), pad_x=float(pad_x), pad_y=float(pad_y),
                         orig_h=h, orig_w=w)
    return out, meta


def boxes_to_original(boxes_xyxy: torch.Tensor, meta: LetterboxMeta) -> torch.Tensor:
    """Letterboxed-pixel boxes (..., 4) xyxy -> original image pixels,
    clipped to the image."""
    x1 = (boxes_xyxy[..., 0] - meta.pad_x) / meta.scale
    y1 = (boxes_xyxy[..., 1] - meta.pad_y) / meta.scale
    x2 = (boxes_xyxy[..., 2] - meta.pad_x) / meta.scale
    y2 = (boxes_xyxy[..., 3] - meta.pad_y) / meta.scale
    return torch.stack([x1.clamp(0, meta.orig_w), y1.clamp(0, meta.orig_h),
                        x2.clamp(0, meta.orig_w), y2.clamp(0, meta.orig_h)], dim=-1)
