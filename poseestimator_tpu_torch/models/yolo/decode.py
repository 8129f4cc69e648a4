"""Head decode (counterpart of ``poseestimator_tpu/models/yolo/decode.py``):
anchor centres at cell + 0.5, the 16-bin DFL softmax expectation, lt/rb
distances scaled by stride, levels flattened stride-8 first."""
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


def flatten_levels(per_level) -> torch.Tensor:
    """Tuple of (B, H, W, C) -> (B, sum(H W), C), row-major per level."""
    return torch.cat([x.reshape(x.shape[0], -1, x.shape[-1]) for x in per_level], dim=1)


def decode_boxes(raw: dict, strides=STRIDES, reg_max: int = 16):
    """Raw head outputs -> ``(boxes_xyxy_px (B, A, 4), cls_prob (B, A, nc),
    mask_coeffs (B, A, nm))``."""
    shapes = [x.shape[1:3] for x in raw["box"]]
    anchors, stride_pa = make_anchors(shapes, strides, raw["box"][0].device)
    box_flat = flatten_levels(raw["box"])
    p = box_flat.reshape(*box_flat.shape[:-1], 4, reg_max).softmax(-1)
    bins = torch.arange(reg_max, dtype=torch.float32, device=p.device)
    dist = (p * bins).sum(-1)
    boxes = torch.cat([anchors[None] - dist[..., :2], anchors[None] + dist[..., 2:]], -1)
    boxes = boxes * stride_pa[None, :, None]
    return boxes, torch.sigmoid(flatten_levels(raw["cls"])), flatten_levels(raw["mc"])
