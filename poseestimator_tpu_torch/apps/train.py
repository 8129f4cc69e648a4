"""YOLO11-seg fine-tuning (counterpart of ``detection/train.py``) at the
reference's operating point: epochs 300, imgsz 640, batch 16, Adam, lr0
0.001, patience 10, save + save_json, project/name run dirs, resume. The
card by default, ``--device cpu`` on request. Data-parallel over N devices
under ``torchrun``: every process joins the group torchrun describes, and
the trainer splits each global ``--batch`` over the ranks (rank 0 loads and
writes); a device list (``0,1``) raises.

Run:
    python -m poseestimator_tpu_torch.apps.train --data dataset.yaml [overrides]
    torchrun --nproc_per_node N -m poseestimator_tpu_torch.apps.train --data dataset.yaml
"""
from __future__ import annotations

import argparse
import sys

import torch.distributed as dist

from ..parallel.mesh import init_from_env
from ..training.trainer import TrainConfig, Trainer, check_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data", default="dataset.yaml")
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--optimizer", default="Adam")
    p.add_argument("--lr0", type=float, default=0.001)
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    p.add_argument("--name", default="Legoblock")
    p.add_argument("--project", default="output_runs")
    p.add_argument("--exist-ok", action="store_true", default=True)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--scale", default="n")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mosaic", type=float, default=0.5,
                   help="4-image mosaic probability (0 disables)")
    p.add_argument("--close-mosaic", type=int, default=10,
                   help="mosaic off for the final N epochs")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    check_device(args.device)
    cfg = TrainConfig(data=args.data, epochs=args.epochs, imgsz=args.imgsz, batch=args.batch,
                      optimizer=args.optimizer, lr0=args.lr0, name=args.name,
                      project=args.project, exist_ok=args.exist_ok, resume=args.resume,
                      patience=args.patience, scale=args.scale, dtype=args.dtype,
                      seed=args.seed, mosaic=args.mosaic, close_mosaic=args.close_mosaic,
                      device=args.device, save=True, save_json=True)
    joined = init_from_env(args.device)
    try:
        trainer = Trainer(cfg)
        state, history = trainer.fit()
    finally:
        if joined:
            dist.destroy_process_group()
    if trainer.rank0:
        print(f"finished: {len(history)} epochs, run dir {cfg.run_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
