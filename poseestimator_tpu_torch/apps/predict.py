"""YOLO prediction on one image or a folder (the counterpart of
``detection/predict.py``): trained weights at imgsz 640, conf 0.8.
``--image`` prints the detections and, with ``--save``, writes the image
with each mask blended in a seeded colour and its box drawn at thickness
2. The label text that OpenCV's ``putText`` draws above each box is
printed instead of drawn (the port draws no text). ``--folder`` runs
``predict_batch`` over every image in batches of ``--batch``, the tail
batch padded with black images. The port opens no windows: ``--show``
exits.

    python -m poseestimator_tpu_torch.apps.predict --weights best.pt --image a.jpg --save out.jpg
    python -m poseestimator_tpu_torch.apps.predict --weights best.pt --folder images/ --device cpu
"""
from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import numpy as np

from ..device import resolve_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--weights", default="./data/best.pt")
    p.add_argument("--image", default=None)
    p.add_argument("--folder", default=None, help="batch inference over every image in a folder")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--conf", type=float, default=0.8)
    p.add_argument("--nc", type=int, default=5)
    p.add_argument("--show", action="store_true", help="not supported: the port opens no windows")
    p.add_argument("--save", default=None, help="write the annotated image here")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    return p


def annotate(img: np.ndarray, results: list) -> tuple[np.ndarray, list]:
    """The image with each detection's mask blended half-and-half with a
    colour drawn from ``default_rng(0)`` and its box outlined at thickness
    2, and the label texts ``[(text, (x, y), colour), ...]`` that the JAX
    package's script draws with ``cv2.putText``."""
    from ..utils.draw import line

    vis = img.copy()
    rng = np.random.default_rng(0)
    labels = []
    for r in results:
        color = tuple(int(c) for c in rng.integers(64, 255, 3))
        m = r["mask"] > 0
        vis[m] = (0.5 * vis[m] + 0.5 * np.asarray(color)).astype(np.uint8)
        x1, y1, x2, y2 = [int(v) for v in r["bbox"]]
        # cv2.rectangle at thickness 2: the closed outline of thick lines
        for p, q in (((x1, y1), (x2, y1)), ((x2, y1), (x2, y2)), ((x2, y2), (x1, y2)),
                     ((x1, y2), (x1, y1))):
            line(vis, p, q, color, thickness=2)
        labels.append((f"{r['class_id']}:{r['conf']:.2f}", (x1, max(y1 - 4, 10)), color))
    return vis, labels


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.show:
        raise SystemExit("--show: the port opens no windows; use --save")
    dev = resolve_device(args.device)
    from ..pipeline.detector import Detector
    from ..utils.image import read_image, write_image

    det = Detector(args.weights, nc=args.nc, device=dev)
    if args.folder:
        files = sorted(f for f in glob.glob(os.path.join(args.folder, "*"))
                       if f.lower().endswith((".jpg", ".jpeg", ".png")))
        if not files:
            raise SystemExit(f"no images in {args.folder}")
        imgs = [read_image(f) for f in files]
        t0 = time.time()
        n_total, B = 0, args.batch
        for i in range(0, len(imgs), B):
            chunk = imgs[i:i + B]
            while len(chunk) < B:  # the tail batch padded to the batch size
                chunk.append(np.zeros_like(chunk[0]))
            dets, _ = det.predict_batch(np.stack(chunk), conf=args.conf)
            counts = dets.valid.sum(dim=1).cpu().numpy()
            for j, f in enumerate(files[i:i + B]):
                print(f"{f}: {int(counts[j])} detections")
                n_total += int(counts[j])
        dt = time.time() - t0
        print(f"{len(files)} images in {dt:.2f}s ({len(files) / dt:.1f} img/s), "
              f"{n_total} detections")
        return 0

    if args.image is None or not os.path.exists(args.image):
        raise FileNotFoundError(f"Image not found at {args.image}")
    img = read_image(args.image)
    results = det.detect_mask(img, conf=args.conf)
    print(f"{len(results)} detections")
    vis, labels = annotate(img, results)
    for text, (x, y), color in labels:
        print(f"label {text} at ({x}, {y}) colour {color}")
    if args.save:
        write_image(args.save, vis)
    return 0


if __name__ == "__main__":
    sys.exit(main())
