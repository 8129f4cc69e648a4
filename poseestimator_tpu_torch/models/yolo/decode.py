"""Head decode (counterpart of ``poseestimator_tpu/models/yolo/decode.py``):
anchor centres at cell + 0.5, the 16-bin DFL softmax expectation, lt/rb
distances scaled by stride, levels flattened stride-8 first; and the
inverse mapping of boxes to clamped distances that training targets use."""
from __future__ import annotations

import torch

from .model import STRIDES


def make_anchors(shapes, strides, device, offset: float = 0.5):
    """``(anchors (A, 2) xy in feature units, stride per anchor (A,))``."""
    pts, sts = [], []
    for (h, w), s in zip(shapes, strides):
        xs = torch.arange(w, dtype=torch.float32, device=device) + offset
        ys = torch.arange(h, dtype=torch.float32, device=device) + offset
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1))
        sts.append(torch.full((h * w,), float(s), device=device))
    return torch.cat(pts), torch.cat(sts)


def dfl_expectation(box_raw: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """(..., 4 reg_max) logits -> (..., 4) float32 expected distances: the
    softmax expectation over each side's bins (the softmax in the logits'
    dtype, the expectation in float32, as JAX promotes a bfloat16 head's
    probabilities against its float32 bins)."""
    p = box_raw.reshape(*box_raw.shape[:-1], 4, reg_max).softmax(-1)
    bins = torch.arange(reg_max, dtype=torch.float32, device=p.device)
    return (p * bins).sum(-1)


def dist2bbox(dist: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """(l, t, r, b) distances + anchor centres -> xyxy (feature units)."""
    return torch.cat([anchors - dist[..., :2], anchors + dist[..., 2:]], -1)


def bbox2dist(bbox_xyxy: torch.Tensor, anchors: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """xyxy boxes -> (l, t, r, b) distances from the anchors, clamped to the
    bin range [0, reg_max - 1.01]."""
    d = torch.cat([anchors - bbox_xyxy[..., :2], bbox_xyxy[..., 2:] - anchors], -1)
    return torch.clamp(d, 0.0, reg_max - 1 - 0.01)


def flatten_levels(per_level) -> torch.Tensor:
    """Tuple of (B, H, W, C) -> (B, sum(H W), C), row-major per level."""
    return torch.cat([x.reshape(x.shape[0], -1, x.shape[-1]) for x in per_level], dim=1)


def decode_boxes(raw: dict, strides=STRIDES, reg_max: int = 16):
    """Raw head outputs -> ``(boxes_xyxy_px (B, A, 4), cls_prob (B, A, nc),
    mask_coeffs (B, A, nm))``: the boxes float32, the probabilities and
    coefficients in the head's dtype."""
    shapes = [x.shape[1:3] for x in raw["box"]]
    anchors, stride_pa = make_anchors(shapes, strides, raw["box"][0].device)
    dist = dfl_expectation(flatten_levels(raw["box"]), reg_max)
    boxes = dist2bbox(dist, anchors[None]) * stride_pa[None, :, None]
    return boxes, torch.sigmoid(flatten_levels(raw["cls"])), flatten_levels(raw["mc"])
