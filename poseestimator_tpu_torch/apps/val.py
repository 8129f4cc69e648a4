"""Validate a trained detector (counterpart of ``detection/val.py``):
COCO-style box (and optionally mask) mAP over a YOLO-format dataset split,
from a port checkpoint ``.pt`` written by the trainer (or any weights the
port's ``Detector`` reads).

Run:
    python -m poseestimator_tpu_torch.apps.val --weights runs/run/best.pt \\
        --data dataset.yaml [--masks] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys

from ..device import resolve_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--weights", required=True)
    p.add_argument("--data", default="dataset.yaml")
    p.add_argument("--split", default="val", choices=["train", "val"])
    p.add_argument("--conf", type=float, default=0.001)
    p.add_argument("--nc", type=int, default=None)
    p.add_argument("--scale", default="n")
    p.add_argument("--masks", action="store_true", help="also compute mask mAP")
    p.add_argument("--limit", type=int, default=0, help="max images (0 = all)")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    from ..pipeline.detector import Detector
    from ..training.data import list_samples, load_dataset_yaml
    from ..training.evaluate import evaluate_detector

    spec = load_dataset_yaml(args.data)
    nc = args.nc if args.nc is not None else max(spec.nc, 1)
    samples = list_samples(spec, args.split)
    if args.limit:
        samples = samples[: args.limit]
    if not samples:
        raise SystemExit(f"no {args.split} samples in {args.data}")
    det = Detector(args.weights, nc=nc, scale=args.scale, device=dev)
    m = evaluate_detector(det, samples, conf=args.conf, use_masks=args.masks)
    print(json.dumps(m, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
