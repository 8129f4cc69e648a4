"""Task-aligned label assignment, TAL (counterpart of
``poseestimator_tpu/training/assigner.py``), batched over images.

For each GT box the candidate anchors are those whose centre lies inside
it; the alignment metric is ``score^alpha IoU^beta``; the top-k candidates
are kept (every anchor whose metric reaches the k-th value: ties at the
k-th value are all kept); an anchor claimed by several GTs goes to the GT
with the highest metric, the first on ties; target scores are normalised
per GT by ``metric iou_max / metric_max``. The targets are constants of
the loss: the assignment runs without gradient.
"""
from __future__ import annotations

import torch

from ..models.yolo.nms import box_iou

# Candidate anchors kept per GT box; the mask loss's positive bound derives
# from it.
TAL_TOPK = 10


@torch.no_grad()
def assign(cls_prob: torch.Tensor, pred_boxes: torch.Tensor, anchors_px: torch.Tensor,
           gt_boxes: torch.Tensor, gt_classes: torch.Tensor, gt_valid: torch.Tensor,
           topk: int = TAL_TOPK, alpha: float = 0.5, beta: float = 6.0):
    """cls_prob (B, A, nc) sigmoid scores, pred_boxes (B, A, 4) xyxy px,
    anchors_px (A, 2), gt_boxes (B, M, 4), gt_classes (B, M), gt_valid
    (B, M) -> ``(fg (B, A) bool, target_gt_idx (B, A) int64, target_scores
    (B, A, nc), target_boxes (B, A, 4))``."""
    B, A, nc = cls_prob.shape
    M = gt_boxes.shape[1]
    ax = anchors_px[None, None, :, 0]
    ay = anchors_px[None, None, :, 1]
    inside = ((ax > gt_boxes[..., 0:1]) & (ax < gt_boxes[..., 2:3])
              & (ay > gt_boxes[..., 1:2]) & (ay < gt_boxes[..., 3:4])) & gt_valid[..., None]
    iou = torch.stack([box_iou(gt_boxes[b], pred_boxes[b]) for b in range(B)])  # (B, M, A)
    cls_idx = gt_classes.long().clamp(0, nc - 1)
    cls_for_gt = torch.gather(cls_prob.transpose(1, 2), 1,
                              cls_idx[..., None].expand(B, M, A))  # (B, M, A)
    metric = cls_for_gt ** alpha * torch.clamp(iou, min=0.0) ** beta
    metric = torch.where(inside, metric, torch.zeros_like(metric))

    k = min(topk, A)
    kth = torch.topk(metric, k, dim=-1).values[..., -1:]
    is_topk = (metric >= torch.clamp(kth, min=1e-12)) & (metric > 0)

    claimed = torch.where(is_topk, metric, torch.full_like(metric, -1.0))
    best_gt = torch.argmax(claimed, dim=1)  # (B, A): the first maximum
    fg = claimed.amax(dim=1) > 0
    t_metric = torch.where(fg, torch.gather(claimed, 1, best_gt[:, None])[:, 0],
                           torch.zeros_like(fg, dtype=metric.dtype))
    mine = best_gt[:, None, :] == torch.arange(M, device=best_gt.device)[None, :, None]
    pos_metric = torch.where(is_topk & mine, metric, torch.zeros_like(metric))
    max_metric = pos_metric.amax(dim=-1)  # (B, M)
    max_iou = torch.where(pos_metric > 0, iou, torch.zeros_like(iou)).amax(dim=-1)
    norm = (torch.gather(max_iou, 1, best_gt)
            / torch.clamp(torch.gather(max_metric, 1, best_gt), min=1e-9))
    t_score = torch.clamp(t_metric * norm, 0.0, 1.0)

    t_cls = torch.gather(gt_classes.long(), 1, best_gt)
    onehot = torch.nn.functional.one_hot(t_cls.clamp(0, nc - 1), nc).to(metric.dtype)
    # jax.nn.one_hot of an out-of-range class is all zeros
    onehot = onehot * ((t_cls >= 0) & (t_cls < nc))[..., None]
    target_scores = onehot * t_score[..., None] * fg[..., None]
    target_boxes = torch.gather(gt_boxes, 1, best_gt[..., None].expand(B, A, 4)) * fg[..., None]
    return fg, best_gt, target_scores, target_boxes
