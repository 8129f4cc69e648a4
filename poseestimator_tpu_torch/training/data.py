"""YOLO-seg dataset pipeline (counterpart of
``poseestimator_tpu/training/data.py``): the ``dataset.yaml`` + label-txt
contract loaded into fixed-shape batches, without OpenCV.

Schema: a YAML with a ``path`` root, ``train`` / ``val`` split dirs (each
holding ``images/`` and ``labels/``) and a ``names`` class map; labels are
YOLO-seg lines ``cls x1 y1 x2 y2 ...`` of normalised polygon vertices.
Batches are letterboxed float32 images with per-image padded instance
arrays (boxes in letterbox pixels, classes, polygon masks at the proto
resolution, validity). Images are read through ``utils/image.read_image``
and resized, colour-jittered and filled with OpenCV's arithmetic
(``utils/imgproc.py``, ``utils/draw.fill_poly``). Every random draw is the
JAX package's call on the same ``np.random.Generator`` in the same order,
so one seed gives the same batches in both packages.
"""
from __future__ import annotations

import os
import queue as queue_mod
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from ..utils import yaml_subset
from ..utils.draw import fill_poly
from ..utils.image import IMREAD_COLOR, read_image
from ..utils.imgproc import bgr_to_hsv_u8, hsv_to_bgr_u8, resize_linear_u8


@dataclass
class DatasetSpec:
    root: str
    train_dir: Optional[str]
    val_dir: Optional[str]
    names: dict[int, str]

    @property
    def nc(self) -> int:
        return max(self.names.keys()) + 1 if self.names else 0


def load_dataset_yaml(path: str) -> DatasetSpec:
    cfg = yaml_subset.load(path) or {}
    names = {int(k): str(v) for k, v in (cfg.get("names") or {}).items()}
    return DatasetSpec(root=str(cfg.get("path", os.path.dirname(path))),
                       train_dir=cfg.get("train"), val_dir=cfg.get("val"), names=names)


def _resolve_split(spec: DatasetSpec, split_dir: str) -> tuple[str, str]:
    base = split_dir if os.path.isabs(split_dir) else os.path.join(spec.root, split_dir)
    img_dir = os.path.join(base, "images")
    lbl_dir = os.path.join(base, "labels")
    if not os.path.isdir(img_dir):  # flat layout: images in base
        img_dir = base
        lbl_dir = base.replace("images", "labels")
    return img_dir, lbl_dir


def list_samples(spec: DatasetSpec, split: str = "train") -> list[tuple[str, str]]:
    split_dir = spec.train_dir if split == "train" else spec.val_dir
    if not split_dir:
        return []
    img_dir, lbl_dir = _resolve_split(spec, split_dir)
    out = []
    for f in sorted(os.listdir(img_dir)):
        if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
            stem = os.path.splitext(f)[0]
            out.append((os.path.join(img_dir, f), os.path.join(lbl_dir, stem + ".txt")))
    return out


def parse_label_file(path: str) -> list[tuple[int, np.ndarray]]:
    """-> [(class_id, polygon (K, 2) normalised), ...]; a missing file -> []."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) < 7:  # cls + at least 3 points
                continue
            cls = int(float(parts[0]))
            coords = np.asarray([float(x) for x in parts[1:]], np.float32)
            if len(coords) % 2:
                coords = coords[:-1]
            out.append((cls, coords.reshape(-1, 2)))
    return out


@dataclass
class Batch:
    images: np.ndarray  # (B, S, S, 3) float32 [0, 1] letterboxed, BGR
    boxes: np.ndarray  # (B, M, 4) xyxy letterbox px
    classes: np.ndarray  # (B, M) int32
    masks: np.ndarray  # (B, M, S/4, S/4) float32 {0, 1}
    inst_valid: np.ndarray  # (B, M) bool


def augment_hsv(img: np.ndarray, rng, h_gain=0.015, s_gain=0.7, v_gain=0.4) -> np.ndarray:
    """Random HSV jitter (the YOLO recipe's gains): BGR -> HSV, a lookup
    table per channel, HSV -> BGR."""
    r = rng.uniform(-1, 1, 3) * [h_gain, s_gain, v_gain] + 1
    hsv = bgr_to_hsv_u8(img)
    x = np.arange(256)
    lut_h = ((x * r[0]) % 180).astype(img.dtype)
    lut_s = np.clip(x * r[1], 0, 255).astype(img.dtype)
    lut_v = np.clip(x * r[2], 0, 255).astype(img.dtype)
    hsv = np.stack([lut_h[hsv[..., 0]], lut_s[hsv[..., 1]], lut_v[hsv[..., 2]]], axis=-1)
    return hsv_to_bgr_u8(hsv)


def _poly_mask(px: np.ndarray, py: np.ndarray, ms: int) -> np.ndarray:
    """The polygon at proto resolution, filled as ``cv2.fillPoly`` fills it."""
    m = np.zeros((ms, ms), np.uint8)
    fill_poly(m, np.round(np.stack([px, py], axis=1) / 4.0).astype(np.int32), 1)
    return m


def load_sample(img_path: str, lbl_path: str, imgsz: int = 640, max_instances: int = 32,
                flip_lr: bool = False, rng=None, scale_jitter: float = 0.0,
                translate_jitter: float = 0.0, hsv: bool = False):
    """Decode, letterbox and rasterise the labels of ONE sample, with the
    optional augmentations: left-right flip, scale in [1 - j, 1 + j],
    translation up to j x imgsz, HSV jitter."""
    img = read_image(img_path, IMREAD_COLOR)
    if hsv and rng is not None:
        img = augment_hsv(img, rng)
    h, w = img.shape[:2]
    scale = min(imgsz / h, imgsz / w)
    if scale_jitter and rng is not None:
        scale *= rng.uniform(1 - scale_jitter, 1 + scale_jitter)
        scale = min(scale, imgsz / h, imgsz / w)  # never overflow the canvas
    nh, nw = int(round(h * scale)), int(round(w * scale))
    pad_y, pad_x = (imgsz - nh) // 2, (imgsz - nw) // 2
    if translate_jitter and rng is not None:
        pad_y = int(np.clip(pad_y + rng.uniform(-1, 1) * translate_jitter * imgsz, 0, imgsz - nh))
        pad_x = int(np.clip(pad_x + rng.uniform(-1, 1) * translate_jitter * imgsz, 0, imgsz - nw))
    canvas = np.full((imgsz, imgsz, 3), 114, np.uint8)
    canvas[pad_y:pad_y + nh, pad_x:pad_x + nw] = resize_linear_u8(img, nw, nh)
    if flip_lr:
        canvas = canvas[:, ::-1]

    boxes = np.zeros((max_instances, 4), np.float32)
    classes = np.zeros((max_instances,), np.int32)
    ms = imgsz // 4
    masks = np.zeros((max_instances, ms, ms), np.float32)
    valid = np.zeros((max_instances,), bool)
    for i, (cls, poly) in enumerate(parse_label_file(lbl_path)[:max_instances]):
        px = poly[:, 0] * w * scale + pad_x
        py = poly[:, 1] * h * scale + pad_y
        if flip_lr:
            px = imgsz - px
        boxes[i] = [px.min(), py.min(), px.max(), py.max()]
        classes[i] = cls
        masks[i] = _poly_mask(px, py, ms)
        valid[i] = True
    return canvas.astype(np.float32) / 255.0, boxes, classes, masks, valid


def load_mosaic(samples: list, indices, imgsz: int, max_instances: int, rng) -> tuple:
    """4-image mosaic: four samples at half size in the quadrants of one
    canvas, labels merged; instances beyond ``max_instances`` are dropped
    by a draw from ``rng``."""
    half = imgsz // 2
    canvas = np.full((imgsz, imgsz, 3), 114, np.uint8)
    boxes_all, classes_all, masks_all = [], [], []
    ms = imgsz // 4
    for q, idx in enumerate(indices):
        img_path, lbl_path = samples[idx]
        img = read_image(img_path, IMREAD_COLOR)
        h, w = img.shape[:2]
        s = min(half / h, half / w)
        nh, nw = int(round(h * s)), int(round(w * s))
        ox = (q % 2) * half + (half - nw) // 2
        oy = (q // 2) * half + (half - nh) // 2
        canvas[oy:oy + nh, ox:ox + nw] = resize_linear_u8(img, nw, nh)
        for cls, poly in parse_label_file(lbl_path):
            px = poly[:, 0] * w * s + ox
            py = poly[:, 1] * h * s + oy
            boxes_all.append([px.min(), py.min(), px.max(), py.max()])
            classes_all.append(cls)
            masks_all.append(_poly_mask(px, py, ms).astype(np.float32))

    boxes = np.zeros((max_instances, 4), np.float32)
    classes = np.zeros((max_instances,), np.int32)
    masks = np.zeros((max_instances, ms, ms), np.float32)
    valid = np.zeros((max_instances,), bool)
    keep = list(range(len(boxes_all)))
    if len(keep) > max_instances:
        keep = list(rng.choice(len(keep), max_instances, replace=False))
    for j, i in enumerate(keep):
        boxes[j] = boxes_all[i]
        classes[j] = classes_all[i]
        masks[j] = masks_all[i]
        valid[j] = True
    return canvas.astype(np.float32) / 255.0, boxes, classes, masks, valid


class DataLoader:
    """Threaded prefetching loader of fixed-shape ``Batch``es.

    Shuffles per epoch and drops the last partial batch; a dataset smaller
    than one batch gives one batch, wrapped around. With ``augment=True``:
    left-right flip, HSV jitter, random scale and translation, and the
    4-image mosaic with probability ``mosaic``. One producer thread loads
    batches ahead, up to ``prefetch``; ``workers`` is accepted as in the
    JAX package, which also loads on one thread."""

    def __init__(self, samples: list[tuple[str, str]], batch_size: int, imgsz: int = 640,
                 max_instances: int = 32, shuffle: bool = True, augment: bool = False,
                 mosaic: float = 0.5, seed: int = 0, workers: int = 4, prefetch: int = 4):
        if not samples:
            raise ValueError("empty dataset")
        self.samples = samples
        self.batch_size = batch_size
        self.imgsz = imgsz
        self.max_instances = max_instances
        self.shuffle = shuffle
        self.augment = augment
        self.mosaic = mosaic if augment else 0.0
        self.workers = workers
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return max(len(self.samples) // self.batch_size, 1)

    def _epoch_order(self):
        idx = np.arange(len(self.samples))
        if self.shuffle:
            self._rng.shuffle(idx)
        n_b = len(self.samples) // self.batch_size
        if n_b == 0:  # tiny dataset: one batch, wrapped around
            reps = int(np.ceil(self.batch_size / len(self.samples)))
            return [np.tile(idx, reps)[: self.batch_size]]
        return np.array_split(idx[: n_b * self.batch_size], n_b)

    def _load_batch(self, batch_idx) -> Batch:
        flips = (self._rng.random(len(batch_idx)) < 0.5 if self.augment
                 else np.zeros(len(batch_idx), bool))
        aug = dict(rng=self._rng, scale_jitter=0.3, translate_jitter=0.1,
                   hsv=True) if self.augment else {}
        outs = []
        for i, flip in zip(batch_idx, flips):
            if self.mosaic and self._rng.random() < self.mosaic:
                others = self._rng.integers(0, len(self.samples), 3)
                outs.append(load_mosaic(self.samples, [i, *others], self.imgsz,
                                        self.max_instances, self._rng))
            else:
                outs.append(load_sample(*self.samples[i], self.imgsz, self.max_instances,
                                        flip, **aug))
        imgs, boxes, classes, masks, valid = map(np.stack, zip(*outs))
        return Batch(imgs, boxes, classes, masks, valid)

    def __iter__(self) -> Iterator[Batch]:
        order = self._epoch_order()
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        stop = object()
        failure = []

        def producer():
            try:
                for b in order:
                    q.put(self._load_batch(b))
            except Exception as e:  # re-raised in the consumer
                failure.append(e)
            finally:
                q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item
        t.join()
        if failure:
            raise failure[0]
