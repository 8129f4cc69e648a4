"""Non-maximum suppression with fixed output shapes (counterpart of
``poseestimator_tpu/models/yolo/nms.py``).

Confidence gate, the top ``pre_nms`` candidates by score (stable order:
ties keep the lower anchor index, as JAX's ``top_k``), then greedy
suppression as a whole-vector fixpoint on the (pre_nms, pre_nms) IoU matrix:
``keep[j] = ok[j] & no kept higher-ranked box overlaps j``, iterated until it
stops changing. The dependency is strictly triangular in rank, so the
fixpoint is unique and equals sequential greedy NMS; the host reads the
"changed" flag every few iterations. Class-aware by the coordinate-offset trick.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ...utils.profiling import host_read

_CHECK_EVERY = 4


@dataclass
class Detections:
    """Fixed-capacity detections for one image (rows beyond ``n`` invalid)."""

    boxes: torch.Tensor  # (max_det, 4) xyxy pixels
    scores: torch.Tensor  # (max_det,)
    classes: torch.Tensor  # (max_det,) int64, -1 where invalid
    coeffs: torch.Tensor  # (max_det, nm)
    valid: torch.Tensor  # (max_det,) bool

    def count(self) -> torch.Tensor:
        return self.valid.sum()


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes, (N, 4) x (M, 4) -> (N, M)."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp(a[:, 2] - a[:, 0], min=0) * torch.clamp(a[:, 3] - a[:, 1], min=0)
    area_b = torch.clamp(b[:, 2] - b[:, 0], min=0) * torch.clamp(b[:, 3] - b[:, 1], min=0)
    return inter / torch.clamp(area_a[:, None] + area_b[None, :] - inter, min=1e-9)


def _top(x: torch.Tensor, k: int):
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def nms(boxes, cls_prob, coeffs, conf_thres: float = 0.25, iou_thres: float = 0.7,
        pre_nms: int = 1024, max_det: int = 300) -> Detections:
    """Single-image NMS: boxes (A, 4), cls_prob (A, nc), coeffs (A, nm);
    per-anchor class = argmax. Scores in a half dtype (a bfloat16 head's)
    are widened to float32 first: exact, so the ranking and its ties are the
    half dtype's, and the threshold compares in float32 as the JAX
    package's float32 ``conf`` makes it; the scores leave as float32."""
    pre_nms = min(pre_nms, boxes.shape[0])
    max_det = min(max_det, pre_nms)
    scores_all, classes_all = cls_prob.max(dim=-1)
    scores_all = scores_all.float()
    gate = scores_all >= conf_thres
    cand_scores, order = _top(torch.where(gate, scores_all,
                                          torch.full_like(scores_all, -1.0)), pre_nms)
    cand_boxes = boxes[order]
    cand_classes = classes_all[order]
    cand_coeffs = coeffs[order]
    cand_ok = cand_scores > 0.0
    # separate classes in coordinate space so cross-class IoU is 0
    span = cand_boxes.abs().max() + 1.0
    off_boxes = cand_boxes + (cand_classes.to(torch.float32) * span)[:, None]
    iou = box_iou(off_boxes, off_boxes)
    ranks = torch.arange(pre_nms, device=boxes.device)
    sup = (iou > iou_thres) & (ranks[:, None] < ranks[None, :])

    # past the fixpoint an iteration changes nothing, so the host reads the
    # "changed" flag only every _CHECK_EVERY iterations
    keep = cand_ok
    for _ in range(0, pre_nms, _CHECK_EVERY):
        prev = keep
        for _ in range(_CHECK_EVERY):
            keep = cand_ok & ~(sup & keep[:, None]).any(dim=0)
        changed = (keep != prev).any()
        with host_read():
            if not bool(changed):
                break

    surv = torch.where(keep, cand_scores, torch.full_like(cand_scores, -1.0))
    top_scores, sel = _top(surv, max_det)
    valid = top_scores > 0.0
    return Detections(
        boxes=cand_boxes[sel],
        scores=torch.where(valid, top_scores, torch.zeros_like(top_scores)),
        classes=torch.where(valid, cand_classes[sel], torch.full_like(cand_classes[sel], -1)),
        coeffs=cand_coeffs[sel],
        valid=valid,
    )
