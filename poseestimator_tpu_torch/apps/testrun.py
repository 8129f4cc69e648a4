"""YOLO-seg label viewer (the counterpart of ``detection/testrun.py``): the
normalised polygon labels drawn over the image, each outline at thickness
2 and then filled, in green, to check annotations. The port opens no
windows: pass ``--save`` (``--headless`` is accepted; without ``--save``
the script exits). Like every entry point of the port it starts only on a
machine with a card unless ``--device cpu`` is given (the drawing runs on
the host).

    python -m poseestimator_tpu_torch.apps.testrun --image a.jpg --label a.txt --save out.png \\
        --device cpu
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..device import resolve_device


def draw_yolo_polygons(image_path, label_path, class_filter=None, save=None) -> np.ndarray:
    """The image (BGR) with every label polygon of ``class_filter`` (all when
    None) outlined at thickness 2 and filled in (0, 255, 0)."""
    from ..training.data import parse_label_file
    from ..utils.draw import fill_poly, line
    from ..utils.image import read_image, write_image

    image = read_image(image_path)
    h, w = image.shape[:2]
    for class_id, poly in parse_label_file(label_path):
        if class_filter is not None and class_id != class_filter:
            continue
        pts = np.round(np.stack([poly[:, 0] * w, poly[:, 1] * h], axis=1)).astype(np.int32)
        for i in range(len(pts)):  # cv2.polylines(isClosed=True, thickness=2)
            line(image, pts[i - 1], pts[i], (0, 255, 0), thickness=2)
        fill_poly(image, pts, (0, 255, 0))
    if save:
        write_image(save, image)
    return image


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--image", required=True)
    p.add_argument("--label", required=True)
    p.add_argument("--class-id", type=int, default=None)
    p.add_argument("--save", default=None)
    p.add_argument("--headless", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    if not args.save:
        raise SystemExit("the port opens no windows; pass --save")
    draw_yolo_polygons(args.image, args.label, args.class_id, save=args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
