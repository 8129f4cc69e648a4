"""Instance-mask assembly from prototypes and per-detection coefficients,
and the host-side polygon round trip of the detector's masks (counterpart
of ``poseestimator_tpu/models/yolo/masks.py``). The polygons are OpenCV's
(``contours.py``: ``findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)``) and
so is their fill (``utils/draw.fill_poly``), without OpenCV."""
from __future__ import annotations

import numpy as np
import torch

from ...utils.draw import fill_poly
from .contours import contour_area, find_external_contours
from .preprocess import LetterboxMeta


def assemble_masks(proto: torch.Tensor, coeffs: torch.Tensor,
                   boxes_letterbox: torch.Tensor, det_valid: torch.Tensor,
                   meta: LetterboxMeta, out_h: int, out_w: int,
                   threshold: float = 0.5) -> torch.Tensor:
    """proto (Hp, Wp, nm), coeffs (D, nm), boxes (D, 4) in letterbox pixels
    -> (D, out_h, out_w) bool masks in the original image frame:
    sigmoid(coef . proto), bilinear resample at original pixel centres (as
    two full-float32 matmuls), crop to the box, threshold. A bfloat16 head's
    logits and sigmoid stay bfloat16 and meet the float32 resampling
    weights in float32, as JAX promotes them."""
    Hp, Wp, _ = proto.shape
    dev = proto.device
    m = torch.sigmoid(torch.einsum("dn,hwn->dhw", coeffs, proto)).float()
    ys = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) * meta.scale + meta.pad_y
    xs = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) * meta.scale + meta.pad_x
    py, px = ys / 4.0, xs / 4.0
    y0 = torch.clamp(torch.floor(py - 0.5).to(torch.int64), 0, Hp - 1)
    x0 = torch.clamp(torch.floor(px - 0.5).to(torch.int64), 0, Wp - 1)
    y1 = torch.clamp(y0 + 1, 0, Hp - 1)
    x1 = torch.clamp(x0 + 1, 0, Wp - 1)
    wy = torch.clamp(py - 0.5 - y0, 0.0, 1.0)
    wx = torch.clamp(px - 0.5 - x0, 0.0, 1.0)
    oh = torch.nn.functional.one_hot
    Wy = (1.0 - wy)[:, None] * oh(y0, Hp).float() + wy[:, None] * oh(y1, Hp).float()
    Wx = (1.0 - wx)[:, None] * oh(x0, Wp).float() + wx[:, None] * oh(x1, Wp).float()
    up = torch.einsum("dhw,Hh->dHw", m, Wy)
    up = torch.einsum("dHw,Ww->dHW", up, Wx)

    pad = torch.tensor([meta.pad_x, meta.pad_y, meta.pad_x, meta.pad_y],
                       dtype=torch.float32, device=dev)
    bx = (boxes_letterbox - pad) / meta.scale
    gx = torch.arange(out_w, dtype=torch.float32, device=dev)[None, None, :]
    gy = torch.arange(out_h, dtype=torch.float32, device=dev)[None, :, None]
    inside = ((gx >= bx[:, 0, None, None]) & (gx <= bx[:, 2, None, None])
              & (gy >= bx[:, 1, None, None]) & (gy <= bx[:, 3, None, None]))
    return (up > threshold) & inside & det_valid[:, None, None]


def masks_to_polygons(mask) -> list[np.ndarray]:
    """Binary (H, W) mask -> its outer borders as (K, 2) float32 polygons of
    at least 3 points, largest area first (a stable sort: equal areas keep
    the border order)."""
    polys = [c.astype(np.float32) for c in find_external_contours(np.asarray(mask) > 0)
             if len(c) >= 3]
    polys.sort(key=lambda p: -contour_area(p))
    return polys


def polygon_to_mask(poly, h: int, w: int) -> np.ndarray:
    """A filled polygon -> (H, W) uint8 {0, 255} mask (``cv2.fillPoly``)."""
    out = np.zeros((h, w), np.uint8)
    if len(poly) >= 3:
        fill_poly(out, np.asarray(poly, np.float32).astype(np.int32), 255)
    return out
