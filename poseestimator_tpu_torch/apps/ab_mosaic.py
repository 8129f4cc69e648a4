"""Mosaic-augmentation A/B (counterpart of ``tools/ab_mosaic.py``): train
the detector twice on one cluttered synthetic dataset, mosaic off and on,
and report the val mAP50 delta (the reference trains under Ultralytics'
defaults, which include mosaic: reference ``detection/train.py:5-20``).

The dataset comes from ``apps/generate.py`` (several objects, distractor
clutter, procedural backgrounds: the occlusion and scale mixing mosaic is
for) on two classes, the L-shape evaluation CAD and a 0.12 m icosphere.
Both runs share the data, seed and schedule; their ``TrainConfig``s differ
only in ``mosaic`` and ``name``. Each runs ``Trainer.fit`` and then
``evaluate_map``.

Runs on the card unless ``--device cpu`` is given:

    python -m poseestimator_tpu_torch.apps.ab_mosaic --epochs 60 --train 48 --val 16
    python -m poseestimator_tpu_torch.apps.ab_mosaic --device cpu --epochs 1 --train 4 \\
        --val 2 --imgsz 64 --batch 2
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from .. import kernel_cases as kc
from ..device import resolve_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--train", type=int, default=48)
    p.add_argument("--val", type=int, default=16)
    p.add_argument("--imgsz", type=int, default=320)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr0", type=float, default=2e-3)
    p.add_argument("--mosaic", type=float, default=0.5, help="mosaic probability for the ON arm")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json-out", default="")
    return p


def make_dataset(args, root: str) -> str:
    """The two CADs as PLY and the generated dataset under ``root``; returns
    its ``dataset.yaml``."""
    from ..render.mesh import make_icosphere
    from ..utils.plyio import write_ply
    from . import generate

    l_ply = os.path.join(root, "l.ply")
    lv, lf = kc.lshape_mesh(1.0)
    write_ply(l_ply, lv, faces=lf)
    s_ply = os.path.join(root, "s.ply")
    sv, sf = make_icosphere(0.12, 3)
    write_ply(s_ply, sv, faces=sf)
    data_root = os.path.join(root, "synth")
    generate.main(["--cad", f"lshape={l_ply}", "--cad", f"sphere={s_ply}", "--out", data_root,
                   "--train", str(args.train), "--val", str(args.val),
                   "--imgsz", f"{args.imgsz}x{args.imgsz}", "--max-objects", "3",
                   "--max-distractors", "2", "--seed", str(args.seed),
                   "--device", args.device])
    return os.path.join(data_root, "dataset.yaml")


def arm_configs(args, yml: str, project: str) -> dict:
    """The two arms' ``TrainConfig``s, ``{"off": ..., "on": ...}``."""
    from ..training.trainer import TrainConfig

    return {name: TrainConfig(
        data=yml, epochs=args.epochs, imgsz=args.imgsz, batch=args.batch, lr0=args.lr0,
        warmup_epochs=3.0, patience=args.epochs, project=project, name=f"mosaic_{name}",
        workers=2, augment=True, mosaic=mosaic, max_instances=8, seed=args.seed,
        device=args.device) for name, mosaic in (("off", 0.0), ("on", args.mosaic))}


def run(args, work_dir: str | None = None) -> dict:
    from ..training.trainer import Trainer

    resolve_device(args.device)
    tmp = work_dir or tempfile.mkdtemp(prefix="ab_mosaic_")
    os.makedirs(tmp, exist_ok=True)
    yml = make_dataset(args, tmp)
    rows = {}
    for name, cfg in arm_configs(args, yml, os.path.join(tmp, "runs")).items():
        tr = Trainer(cfg)
        t0 = time.time()
        state, _ = tr.fit(log=lambda *a, **k: None, tensorboard=False)
        metrics = tr.evaluate_map(state)
        rows[name] = {"mosaic": cfg.mosaic, "map50": round(float(metrics["map50"]), 4),
                      "map50_95": round(float(metrics.get("map50_95", np.nan)), 4),
                      "train_s": round(time.time() - t0, 1)}
        print(f"mosaic={cfg.mosaic}: mAP50 {rows[name]['map50']:.3f} "
              f"({rows[name]['train_s']:.0f}s)", flush=True)
    delta = rows["on"]["map50"] - rows["off"]["map50"]
    return {"rows": rows, "map50_delta_on_minus_off": round(delta, 4), "epochs": args.epochs,
            "train_images": args.train, "imgsz": args.imgsz, "close_mosaic": cfg.close_mosaic}


def main(argv=None):
    args = build_parser().parse_args(argv)
    out = run(args)
    print(json.dumps(out), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
