"""Detection and segmentation quality, COCO-style mAP (counterpart of
``poseestimator_tpu/training/evaluate.py``): greedy score-ordered matching
at IoU thresholds, all-point interpolated AP averaged over classes (mAP@50
and mAP@50:95), for boxes and optionally masks. Host numpy; the detector is
the port's."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..utils.draw import fill_poly
from ..utils.image import IMREAD_COLOR, read_image


@dataclass
class ImageEval:
    """Predictions and ground truth of one image."""

    pred_boxes: np.ndarray  # (P, 4) xyxy
    pred_scores: np.ndarray  # (P,)
    pred_classes: np.ndarray  # (P,)
    gt_boxes: np.ndarray  # (G, 4)
    gt_classes: np.ndarray  # (G,)
    pred_masks: Optional[np.ndarray] = None  # (P, H, W) bool
    gt_masks: Optional[np.ndarray] = None  # (G, H, W) bool


def _box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def _mask_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    af = a.reshape(len(a), -1).astype(np.float32)
    bf = b.reshape(len(b), -1).astype(np.float32)
    inter = af @ bf.T
    union = af.sum(1)[:, None] + bf.sum(1)[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def _ap_from_matches(scores, matched, n_gt) -> float:
    """All-point interpolated average precision."""
    if n_gt == 0:
        return float("nan")
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-scores)
    tp = matched[order].astype(np.float64)
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(1.0 - tp)
    recall = tp_cum / n_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
    precision = np.maximum.accumulate(precision[::-1])[::-1]  # envelope
    r = np.concatenate([[0.0], recall, [recall[-1] if len(recall) else 0.0]])
    p = np.concatenate([[precision[0] if len(precision) else 0.0], precision, [0.0]])
    return float(np.sum((r[1:] - r[:-1]) * p[1:]))


def compute_map(images: Sequence[ImageEval], iou_thresholds: Optional[Sequence[float]] = None,
                use_masks: bool = False) -> dict:
    """-> {"map50": x, "map50_95": y, "per_class": {cls: ap50}}."""
    if iou_thresholds is None:
        iou_thresholds = np.arange(0.5, 0.96, 0.05)
    classes = sorted({int(c) for im in images for c in im.gt_classes}
                     | {int(c) for im in images for c in im.pred_classes})
    aps = np.full((len(iou_thresholds), len(classes)), np.nan)
    per_class_50 = {}
    for ci, cls in enumerate(classes):
        for ti, thr in enumerate(iou_thresholds):
            scores_all, matched_all, n_gt = [], [], 0
            for im in images:
                pm = im.pred_classes == cls
                gm = im.gt_classes == cls
                n_gt += int(gm.sum())
                if not pm.any():
                    continue
                if use_masks and im.pred_masks is not None and im.gt_masks is not None:
                    iou = _mask_iou(im.pred_masks[pm], im.gt_masks[gm])
                else:
                    iou = _box_iou(im.pred_boxes[pm], im.gt_boxes[gm])
                sc = im.pred_scores[pm]
                taken = np.zeros(int(gm.sum()), bool)
                match = np.zeros(len(sc), bool)
                for pi in np.argsort(-sc):
                    if iou.shape[1] == 0:
                        break
                    gi = int(np.argmax(np.where(taken, -1.0, iou[pi])))
                    if iou[pi, gi] >= thr and not taken[gi]:
                        taken[gi] = True
                        match[pi] = True
                scores_all.append(sc)
                matched_all.append(match)
            scores = np.concatenate(scores_all) if scores_all else np.zeros(0)
            matched = np.concatenate(matched_all) if matched_all else np.zeros(0, bool)
            aps[ti, ci] = _ap_from_matches(scores, matched, n_gt)
        if not np.isnan(aps[0, ci]):
            per_class_50[cls] = float(aps[0, ci])
    with np.errstate(invalid="ignore"):
        map50 = float(np.nanmean(aps[0])) if aps.size else 0.0
        map50_95 = float(np.nanmean(aps)) if aps.size else 0.0
    return {"map50": map50, "map50_95": map50_95, "per_class": per_class_50}


# mAP-grade candidate pool: a conf 0.001 sweep needs the low-score tail
# that the product-sized caps (pre_nms 1024, max_det 32) cut on crowded
# scenes
EVAL_PRE_NMS = 4096
EVAL_MAX_DET = 300


def eval_grade(detector, pre_nms: int = EVAL_PRE_NMS, max_det: int = EVAL_MAX_DET):
    """A detector for mAP sweeps: the same weights, dtype and device, candidate
    caps raised to at least (pre_nms, max_det); the input itself when its
    caps suffice."""
    if detector.pre_nms >= pre_nms and detector.max_det >= max_det:
        return detector
    from ..pipeline.detector import Detector

    return Detector(detector.variables, nc=detector.model.nc, scale=detector.scale,
                    imgsz=detector.imgsz, max_det=max(max_det, detector.max_det),
                    pre_nms=max(pre_nms, detector.pre_nms), dtype=detector.dtype,
                    device=detector.device)


def evaluate_detector(detector, samples, imgsz: int = 640, conf: float = 0.001,
                      max_instances: int = 300, use_masks: bool = False,
                      eval_pool: bool = True, mesh=None) -> dict:
    """Run the port's ``Detector`` over (image_path, label_path) samples
    and compute mAP against the YOLO-seg labels; ``eval_pool`` raises the
    candidate caps to mAP grade first (``eval_grade``). Under ``mesh`` (a
    ``parallel.Mesh``) each rank runs its contiguous share of the samples
    and the mAP is computed from every rank's gathered predictions."""
    from .data import parse_label_file

    if eval_pool:
        detector = eval_grade(detector)
    share = samples
    if mesh is not None and mesh.size > 1:
        k = -(-len(samples) // mesh.size)
        share = samples[mesh.rank * k:(mesh.rank + 1) * k]
    images = []
    for img_path, lbl_path in share:
        img = read_image(img_path, IMREAD_COLOR)
        h, w = img.shape[:2]
        det, masks, boxes_orig = detector(img, conf=conf, with_masks=use_masks)
        n = int(det.count())
        gt = parse_label_file(lbl_path)[:max_instances]
        gt_boxes, gt_classes, gt_masks = [], [], []
        for cls, poly in gt:
            px, py = poly[:, 0] * w, poly[:, 1] * h
            gt_boxes.append([px.min(), py.min(), px.max(), py.max()])
            gt_classes.append(cls)
            if use_masks:
                m = np.zeros((h, w), np.uint8)
                fill_poly(m, np.stack([px, py], 1).round().astype(np.int32), 1)
                gt_masks.append(m.astype(bool))
        images.append(ImageEval(
            pred_boxes=boxes_orig[:n].cpu().numpy(), pred_scores=det.scores[:n].cpu().numpy(),
            pred_classes=det.classes[:n].cpu().numpy(),
            gt_boxes=np.asarray(gt_boxes, np.float32).reshape(-1, 4),
            gt_classes=np.asarray(gt_classes, np.int64),
            pred_masks=masks[:n].cpu().numpy() if use_masks else None,
            gt_masks=np.asarray(gt_masks) if use_masks and gt_masks else None))
    if mesh is not None and mesh.size > 1:
        images = [im for part in mesh.gather_objects(images) for im in part]
    return compute_map(images, use_masks=use_masks)
