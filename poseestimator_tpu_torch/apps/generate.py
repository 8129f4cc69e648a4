"""Synthetic dataset generation (counterpart of ``detection/generate.py``):
domain-randomised scenes of one or more CAD models (mutual occlusion,
distractor clutter, procedural backgrounds, photometric jitter) written as a
ready-to-train YOLO-seg dataset, and with ``--bop`` as a BOP scene for pose
evaluation (``apps/eval_bop.py``, ``apps/main_image.py``).

Run:
    python -m poseestimator_tpu_torch.apps.generate --cad lego=obj_000001.ply \\
        --out /data/synth --train 256 --val 64 --bop [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

from ..device import resolve_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cad", action="append", required=True,
                   help="CAD spec 'name=path.ply' (or a bare path; repeatable, one class each, "
                   "in order)")
    p.add_argument("--out", required=True, help="output dataset root")
    p.add_argument("--train", type=int, default=64, dest="n_train")
    p.add_argument("--val", type=int, default=16, dest="n_val")
    p.add_argument("--imgsz", default="640x480", help="WxH (default 640x480)")
    p.add_argument("--fov", type=float, default=60.0, help="camera FoV in degrees")
    p.add_argument("--max-objects", type=int, default=3)
    p.add_argument("--max-distractors", type=int, default=2)
    p.add_argument("--points", type=int, default=60_000,
                   help="surface samples per object (splat density)")
    p.add_argument("--min-visib-px", type=int, default=64)
    p.add_argument("--dist", default="1.6,3.2", help="camera distance range in object diagonals")
    p.add_argument("--noise-sigma", type=float, default=3.0)
    p.add_argument("--bop", action="store_true",
                   help="also write a BOP scene (scene_gt/scene_camera/depth/mask_visib)")
    p.add_argument("--depth-instrument", default="splat", choices=["splat", "mesh"],
                   help="'mesh': objects through the exact triangle raster (kernel K2)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    from ..training.synth import SynthConfig, generate

    w, h = (int(v) for v in args.imgsz.lower().split("x"))
    d0, d1 = (float(v) for v in args.dist.split(","))
    cfg = SynthConfig(cad=args.cad, out=args.out, n_train=args.n_train, n_val=args.n_val,
                      width=w, height=h, fov_deg=args.fov, max_objects=args.max_objects,
                      max_distractors=args.max_distractors, points_per_object=args.points,
                      min_visib_px=args.min_visib_px, dist_range=(d0, d1),
                      noise_sigma=args.noise_sigma, bop=args.bop,
                      depth_instrument=args.depth_instrument, seed=args.seed,
                      device=args.device)
    summary = generate(cfg)
    print(f"dataset.yaml: {summary['dataset_yaml']}")
    if args.bop:
        print(f"scene_gt: {summary['scene_gt']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
