"""YOLO11-seg detector with the JAX package's ``Detector`` surface
(counterpart of ``poseestimator_tpu/pipeline/detector.py``): letterbox ->
YOLO11 -> DFL decode -> NMS -> proto masks, on the device.

``model`` (the torch module) and ``variables`` (its state dict) are public:
``Tracker`` fuses detection into the frame when a detector carries both.
``detect_mask`` and the stateless ``detect_mask`` run the forward on the
device and the polygon round trip of each mask (outer border, then filled)
on the host, as the JAX package does, through the port's cv2-free
``masks_to_polygons`` / ``polygon_to_mask``.
"""
from __future__ import annotations

import os
from dataclasses import fields

import numpy as np
import torch

from ..device import resolve_device
from ..models.yolo.decode import decode_boxes
from ..models.yolo.masks import assemble_masks, masks_to_polygons, polygon_to_mask
from ..models.yolo.model import YOLO11Seg
from ..models.yolo.nms import Detections, nms
from ..models.yolo.preprocess import boxes_to_original, letterbox
from ..models.yolo.weights import load_checkpoint
from ..utils.image import IMREAD_COLOR, read_image
from ..utils.profiling import span, traced


class Detector:
    """YOLO11-seg detector.

    Args:
        yolo_weights: one of
            - a port checkpoint ``.pt`` written by ``Trainer.save`` (its
              ``"params"``: the EMA weights with the BN statistics);
            - a port state dict (``Trainer.export_variables``);
            - flax variables ``{"params", "batch_stats"}`` with numpy
              leaves, or a ``.npz`` holding them under ``"variables"``;
            - an Ultralytics checkpoint or state dict (a path, a mapping or
              an ``nn.Module``).
            The JAX trainer's orbax checkpoint directories are not read.
        nc: number of classes (must match the checkpoint).
        scale: YOLO11 compound scale.
        imgsz: square letterbox size.
        dtype: the network's compute dtype, ``"float32"`` or ``"bfloat16"``
            (the parameters stay float32; boxes and scores leave as
            float32, as ``YOLO11Seg`` and ``nms`` say).
        device: default the card (an error when there is none); ``"cpu"``
            runs on the CPU.
    """

    def __init__(self, yolo_weights, nc: int = 5, scale: str = "n", imgsz: int = 640,
                 max_det: int = 32, pre_nms: int = 1024, dtype: str = "float32",
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.nc, self.scale, self.dtype = nc, scale, dtype
        self.imgsz = imgsz
        self.max_det = max_det
        # pre-NMS candidate pool: plenty at product confidence (0.25+)
        self.pre_nms = pre_nms
        model = YOLO11Seg(nc=nc, scale=scale, dtype=dtype)
        model.load_state_dict(load_checkpoint(yolo_weights), strict=True)
        self.model = model.to(self.device).eval()
        self.variables = self.model.state_dict()

    def _image(self, img) -> torch.Tensor:
        if torch.is_tensor(img):
            return img.to(self.device)
        return torch.as_tensor(np.asarray(img), device=self.device)

    @torch.no_grad()
    @traced("detect")
    def __call__(self, img, conf: float = 0.25, iou: float = 0.7, with_masks: bool = True):
        """``(Detections, masks (D, H, W) bool or None, boxes_orig (D, 4))``
        for one (H, W, 3) image; ``with_masks=False`` skips the masks."""
        img = self._image(img)
        h, w = img.shape[:2]
        with span("detect.letterbox"):
            lb, meta = letterbox(img, self.imgsz)
        with span("detect.forward"):
            raw = self.model(lb.permute(2, 0, 1)[None])
        with span("detect.decode"):
            boxes, cls, mc = decode_boxes(raw)
        with span("detect.nms"):
            det = nms(boxes[0], cls[0], mc[0], conf_thres=conf, iou_thres=iou,
                      pre_nms=self.pre_nms, max_det=self.max_det)
        masks = None
        if with_masks:
            with span("detect.masks"):
                masks = assemble_masks(raw["proto"][0], det.coeffs, det.boxes, det.valid,
                                       meta, h, w)
        return det, masks, boxes_to_original(det.boxes, meta)

    @torch.no_grad()
    def predict_batch(self, imgs, conf: float = 0.25, iou: float = 0.7):
        """A same-size batch (B, H, W, 3) -> ``(Detections, boxes_orig)``,
        each field stacked along a leading batch axis (no masks)."""
        return predict_batch(self.model, self._image(imgs), self.imgsz, self.pre_nms,
                             self.max_det, conf, iou)

    def detect_mask(self, img_bgr, class_id: int = 0, conf: float = 0.7) -> list[dict]:
        """Every detection as ``{"mask", "class_id", "conf", "bbox"}``, best
        first (``class_id`` filters nothing, as in the JAX package). Each
        mask is the polygon round trip of the device mask: its largest
        outer border filled, (H, W) uint8 {0, 255}."""
        h, w = img_bgr.shape[:2]
        det, masks, boxes_orig = self(img_bgr, conf=conf)
        n = int(det.count())
        masks_np = masks[:n].cpu().numpy()
        classes = det.classes[:n].cpu().numpy()
        confs = det.scores[:n].cpu().numpy()
        boxes = boxes_orig[:n].cpu().numpy()
        out = []
        for i in range(n):
            polys = masks_to_polygons(masks_np[i])
            out.append({"mask": polygon_to_mask(polys[0], h, w) if polys
                        else np.zeros((h, w), np.uint8),
                        "class_id": int(classes[i]), "conf": float(confs[i]),
                        "bbox": boxes[i].tolist()})
        return out


@torch.no_grad()
def predict_batch(model: YOLO11Seg, imgs: torch.Tensor, imgsz: int, pre_nms: int, max_det: int,
                  conf: float = 0.25, iou: float = 0.7):
    """``Detector.predict_batch`` on a model: letterbox each image of the
    batch (B, H, W, 3) on its device, one forward, DFL decode, per-image
    NMS -> ``(Detections, boxes_orig)`` stacked along the batch axis."""
    lbs, metas = zip(*(letterbox(im, imgsz) for im in imgs))
    raw = model(torch.stack(lbs).permute(0, 3, 1, 2))
    boxes, cls, mc = decode_boxes(raw)
    dets = [nms(boxes[b], cls[b], mc[b], conf_thres=conf, iou_thres=iou,
                pre_nms=pre_nms, max_det=max_det) for b in range(len(lbs))]
    stacked = Detections(**{f.name: torch.stack([getattr(d, f.name) for d in dets])
                            for f in fields(Detections)})
    boxes_orig = torch.stack([boxes_to_original(d.boxes, m) for d, m in zip(dets, metas)])
    return stacked, boxes_orig


def detect_mask(weights_path, image, class_id: int = 0, nc: int = 5, scale: str = "n",
                dtype: str = "float32", device: str | torch.device = "cuda") -> np.ndarray:
    """The (H, W) uint8 mask of the first detection of ``class_id`` in
    ``image`` (a path, read as BGR, or a BGR array), all zero when there is
    none: the model loaded for the call, a 640 letterbox, confidence 0.7."""
    if isinstance(image, (str, os.PathLike)):
        if not os.path.exists(image):
            raise FileNotFoundError(f"Image not found at {image}")
        img = read_image(image, IMREAD_COLOR)
    elif isinstance(image, np.ndarray):
        img = image
    else:
        raise TypeError("Input must be a path or an image")
    h, w = img.shape[:2]
    det = Detector(weights_path, nc=nc, scale=scale, dtype=dtype, device=device)
    for r in det.detect_mask(img, class_id=class_id, conf=0.7):
        if r["class_id"] == class_id:
            return r["mask"]
    return np.zeros((h, w), np.uint8)
