"""Data-parallel batched detection serving over a mesh (counterpart of
``poseestimator_tpu/parallel/serving.py``).

The image batch shards over a 1-D mesh and each rank runs the whole
detect program (letterbox -> YOLO11-seg -> decode -> per-image NMS,
``pipeline.detector.predict_batch``) on its B / N images with the weights
replicated; the detections and boxes are all-gathered once at the output.
"""
from __future__ import annotations

import copy
from dataclasses import fields

import numpy as np
import torch

from ..models.yolo.nms import Detections
from ..pipeline.detector import predict_batch
from .mesh import Mesh, replicate


class ShardedDetector:
    """Batched detector with the batch axis sharded over ``mesh``: the
    model and variables (its state dict) of a ``pipeline.Detector``, whose
    ``from_detector`` lifts onto a mesh. Every rank calls it with the full
    batch (B divisible by the mesh size) and gets the full result. The
    weights are rank 0's, broadcast at construction."""

    def __init__(self, model, variables, mesh: Mesh, imgsz: int = 640, max_det: int = 32,
                 pre_nms: int = 1024, axis: str = "dp"):
        self.mesh, self.axis = mesh, axis
        self.imgsz, self.max_det, self.pre_nms = imgsz, max_det, pre_nms
        self.model = copy.deepcopy(model).to(mesh.device).eval()
        sd = {k: v.to(mesh.device) for k, v in variables.items()}
        self.model.load_state_dict(replicate(mesh, sd), strict=True)
        self.variables = self.model.state_dict()

    @classmethod
    def from_detector(cls, detector, mesh: Mesh, axis: str = "dp") -> "ShardedDetector":
        return cls(detector.model, detector.variables, mesh, imgsz=detector.imgsz,
                   max_det=detector.max_det, pre_nms=detector.pre_nms, axis=axis)

    @torch.no_grad()
    def __call__(self, imgs, conf: float = 0.25, iou: float = 0.7):
        """imgs (B, H, W, 3) -> ``(Detections, boxes_orig)`` stacked over B,
        as ``Detector.predict_batch`` returns them."""
        n = self.mesh.shape[self.axis]
        if imgs.shape[0] % n:
            raise ValueError(f"batch {imgs.shape[0]} not divisible by mesh size {n}")
        sl = self.mesh.slice_of(imgs.shape[0])
        mine = imgs[sl] if torch.is_tensor(imgs) else torch.from_numpy(np.ascontiguousarray(
            np.asarray(imgs)[sl]))
        dets, boxes = predict_batch(self.model, mine.to(self.mesh.device), self.imgsz,
                                    self.pre_nms, self.max_det, conf, iou)
        gather = self.mesh.all_gather
        return (Detections(**{f.name: gather(getattr(dets, f.name)) for f in fields(Detections)}),
                gather(boxes))
