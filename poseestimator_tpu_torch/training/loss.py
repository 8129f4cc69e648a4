"""YOLO11-seg training losses (counterpart of
``poseestimator_tpu/training/loss.py``): BCE classification, CIoU + DFL box
regression and prototype-mask BCE over TAL targets.

A bfloat16 model's head outputs meet the float32 targets as JAX promotes
them: an op of a bfloat16 and a float32 tensor computes in float32, an op
of a bfloat16 tensor alone (the logistic, the log-softmax, the BCE's
``exp(-|x|)``, the mask logits' product) rounds to bfloat16, and every loss
part is float32."""
from __future__ import annotations

import math

import torch

from ..models.yolo.decode import (bbox2dist, dfl_expectation, dist2bbox, flatten_levels,
                                  make_anchors)
from ..models.yolo.model import STRIDES
from .assigner import TAL_TOPK, assign


def ciou(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Complete IoU between aligned box pairs (..., 4) xyxy; the aspect
    term's weight ``a`` carries no gradient."""
    x1 = torch.maximum(box1[..., 0], box2[..., 0])
    y1 = torch.maximum(box1[..., 1], box2[..., 1])
    x2 = torch.minimum(box1[..., 2], box2[..., 2])
    y2 = torch.minimum(box1[..., 3], box2[..., 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    w1 = torch.clamp(box1[..., 2] - box1[..., 0], min=0)
    h1 = torch.clamp(box1[..., 3] - box1[..., 1], min=0)
    w2 = torch.clamp(box2[..., 2] - box2[..., 0], min=0)
    h2 = torch.clamp(box2[..., 3] - box2[..., 1], min=0)
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    cw = torch.maximum(box1[..., 2], box2[..., 2]) - torch.minimum(box1[..., 0], box2[..., 0])
    ch = torch.maximum(box1[..., 3], box2[..., 3]) - torch.minimum(box1[..., 1], box2[..., 1])
    c2 = cw * cw + ch * ch + eps
    rho2 = (((box1[..., 0] + box1[..., 2]) - (box2[..., 0] + box2[..., 2])) ** 2
            + ((box1[..., 1] + box1[..., 3]) - (box2[..., 1] + box2[..., 3])) ** 2) / 4.0
    v = (4 / math.pi ** 2) * (torch.atan(w2 / torch.clamp(h2, min=eps))
                              - torch.atan(w1 / torch.clamp(h1, min=eps))) ** 2
    a = (v / torch.clamp(1.0 + eps - iou + v, min=eps)).detach()
    return iou - rho2 / c2 - a * v


def _dfl_loss(box_logits: torch.Tensor, target_dist: torch.Tensor, reg_max: int = 16):
    """Distribution focal loss: cross-entropy against the two bins around
    the target, mean over the 4 sides. box_logits (..., 4 reg_max),
    target_dist (..., 4) in [0, reg_max - 1]."""
    logits = box_logits.reshape(*box_logits.shape[:-1], 4, reg_max)
    tl = torch.floor(target_dist).long()
    tr = tl + 1
    wl = tr.to(torch.float32) - target_dist
    wr = 1.0 - wl
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, tl[..., None])[..., 0]
    lr = torch.gather(logp, -1, tr.clamp(0, reg_max - 1)[..., None])[..., 0]
    return -(ll * wl + lr * wr).mean(dim=-1)


def bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy on logits, in the stable form. With
    bfloat16 logits and float32 targets the result is float32, and the
    softplus term's ``exp`` rounds to bfloat16 while its ``log1p`` does not:
    XLA drops the rounding of an op whose result is promoted straight to
    float32, as this sum promotes it."""
    dt = torch.promote_types(logits.dtype, targets.dtype)
    x = logits.to(dt)
    return torch.clamp(x, min=0) - x * targets + torch.log1p(torch.exp(-logits.abs()).to(dt))


def segmentation_loss(raw: dict, gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                      gt_masks: torch.Tensor, gt_valid: torch.Tensor, box_gain: float = 7.5,
                      cls_gain: float = 0.5, dfl_gain: float = 1.5, reg_max: int = 16,
                      reduce=None):
    """Total loss and its parts for one batch of raw head outputs.

    gt_boxes (B, M, 4) xyxy letterbox px, gt_classes (B, M), gt_masks
    (B, M, S/4, S/4), gt_valid (B, M). The mask loss evaluates each
    image's top M x ``TAL_TOPK`` weighted anchors only, a (B, K, Hp, Wp)
    product, never (B, A, Hp, Wp).

    ``reduce`` (a sum over ranks, e.g. ``Mesh.all_reduce``): the batch is
    one rank's share of a global batch; the normaliser ``n_pos`` is then
    the global batch's, so the parts are this share's terms of the global
    loss and sum over ranks to it."""
    shapes = [x.shape[1:3] for x in raw["box"]]
    anchors, stride_pa = make_anchors(shapes, STRIDES, raw["box"][0].device)
    anchors_px = anchors * stride_pa[:, None]

    box_flat = flatten_levels(raw["box"])  # (B, A, 4 reg_max)
    cls_flat = flatten_levels(raw["cls"])  # (B, A, nc)
    mc_flat = flatten_levels(raw["mc"])  # (B, A, nm)
    proto = raw["proto"]  # (B, Hp, Wp, nm)

    dist = dfl_expectation(box_flat, reg_max)
    pred_boxes_px = dist2bbox(dist, anchors[None]) * stride_pa[None, :, None]
    cls_prob = torch.sigmoid(cls_flat)
    # the TAL targets are functions of the predictions and constants of the
    # loss: with a gradient through them the model shrinks its own targets
    fg, gt_idx, t_scores, t_boxes = assign(cls_prob.detach(), pred_boxes_px.detach(),
                                           anchors_px, gt_boxes, gt_classes, gt_valid)
    pos = t_scores.sum()
    n_pos = torch.clamp(pos if reduce is None else reduce(pos.detach()), min=1.0)
    l_cls = bce(cls_flat, t_scores).sum() / n_pos

    w = t_scores.sum(-1)  # (B, A)
    fgf = fg.to(w.dtype)
    l_box = ((1.0 - ciou(pred_boxes_px, t_boxes)) * w * fgf).sum() / n_pos
    t_dist = bbox2dist(t_boxes / stride_pa[None, :, None], anchors[None], reg_max)
    l_dfl = (_dfl_loss(box_flat, t_dist, reg_max) * w * fgf).sum() / n_pos

    B, Hp, Wp = proto.shape[0], proto.shape[1], proto.shape[2]
    k_mask = min(gt_boxes.shape[1] * TAL_TOPK, w.shape[1])
    sel_w, sel = torch.topk(w * fgf, k_mask, dim=1)  # (B, K)
    coef = torch.gather(mc_flat, 1, sel[..., None].expand(B, k_mask, mc_flat.shape[-1]))
    m_logits = torch.einsum("bkn,bhwn->bkhw", coef, proto)
    g = torch.gather(gt_idx, 1, sel)  # (B, K)
    tgt = gt_masks[torch.arange(B, device=g.device)[:, None], g]  # (B, K, Hp, Wp)
    bb = torch.gather(gt_boxes, 1, g[..., None].expand(B, k_mask, 4)) / 4.0
    gx = torch.arange(Wp, dtype=torch.float32, device=g.device)[None, None, None, :]
    gy = torch.arange(Hp, dtype=torch.float32, device=g.device)[None, None, :, None]
    inside = ((gx >= bb[..., 0, None, None]) & (gx <= bb[..., 2, None, None])
              & (gy >= bb[..., 1, None, None]) & (gy <= bb[..., 3, None, None]))
    per_pix = bce(m_logits, tgt) * inside
    area = torch.clamp((bb[..., 2] - bb[..., 0]) * (bb[..., 3] - bb[..., 1]), min=1.0)
    per_anchor = per_pix.sum((2, 3)) / area
    l_seg = (per_anchor * sel_w).sum() / n_pos

    total = box_gain * l_box + cls_gain * l_cls + dfl_gain * l_dfl + box_gain * l_seg
    return total, {"box": l_box, "cls": l_cls, "dfl": l_dfl, "seg": l_seg, "total": total,
                   "n_pos": n_pos}
