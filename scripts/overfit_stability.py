#!/usr/bin/env python3
"""How often the single-batch overfit gate of ``chip_smoke.py`` (t3) passes
on the card, with cuDNN's default (nondeterministic) algorithms and with
its deterministic ones.

Writes the (t1) dataset (three CADs, 32 + 8 frames at 640x480, the
exact-raster instrument), then runs the (t3) recipe ``--runs`` times in
each mode: one batch of 16 images at 640, augmentation off, Adam 6e-3
constant, 250 steps from the seeded training init; then image 0's top
class score and its box's IoU with a GT box in eval mode (the gate: > 0.3
and > 0.5). One JSON line a run (the train loss every 10 steps, the
score, the IoU, the sum of the weights, which tells identical
trajectories apart), then a summary line. Needs one card:
    python3 scripts/overfit_stability.py [--runs 6]
"""
import argparse
import json
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from poseestimator_tpu_torch import kernel_cases as kc  # noqa: E402
from poseestimator_tpu_torch.device import resolve_device  # noqa: E402
from poseestimator_tpu_torch.models.yolo.decode import decode_boxes  # noqa: E402
from poseestimator_tpu_torch.models.yolo.nms import box_iou  # noqa: E402
from poseestimator_tpu_torch.render.mesh import make_icosphere  # noqa: E402
from poseestimator_tpu_torch.training import trainer as trainer_mod  # noqa: E402
from poseestimator_tpu_torch.training.data import DataLoader  # noqa: E402
from poseestimator_tpu_torch.training.synth import SynthConfig, generate  # noqa: E402
from poseestimator_tpu_torch.utils.plyio import write_ply  # noqa: E402


def overfit(yml: str, tmp: str, deterministic: bool) -> dict:
    torch.backends.cudnn.deterministic = deterministic
    tr = trainer_mod.Trainer(trainer_mod.TrainConfig(
        data=yml, imgsz=640, batch=16, augment=False, ema=False, device="cuda",
        project=tmp, name="t3"))
    state = tr.init_state()
    tr.tx = trainer_mod.Optimizer("adam", lambda count: 6e-3)
    state.opt_state = tr.tx.init(list(state.params.values()))
    ten = tr._tensors(next(iter(DataLoader(tr.train_samples[:16], 16, 640, 32, shuffle=False))))
    losses = []
    for i in range(250):
        state, p = tr._train_step(state, *ten)
        if i % 10 == 0 or i == 249:
            losses.append(round(float(p["total"]), 3))
    tr.model.eval()
    with torch.no_grad():
        bx, cl, _ = decode_boxes(tr.model(ten[0][:1]))
    score = cl[0].amax(-1)
    top = int(score.argmax())
    iou = float(box_iou(bx[0, top][None], ten[1][0][ten[4][0]]).max())
    return {"deterministic": deterministic, "losses": losses, "top_score": float(score[top]),
            "iou": iou, "passed": float(score[top]) > 0.3 and iou > 0.5,
            "weight_sum": float(sum(float(v.detach().double().sum())
                                    for v in state.params.values()))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--runs", type=int, default=6, help="runs in each mode")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    resolve_device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        cads = []
        for name, (v, f) in (("lshape", kc.lshape_mesh()),
                             ("benchbox", (kc.box_vertices(), kc.BOX_FACES)),
                             ("icosphere", make_icosphere(radius=0.1, subdivisions=4))):
            path = os.path.join(tmp, f"{name}.ply")
            write_ply(path, v, faces=f)
            cads.append(f"{name}={path}")
        yml = generate(SynthConfig(cad=cads, out=os.path.join(tmp, "synth"), n_train=32,
                                   n_val=8, depth_instrument="mesh", device="cuda"),
                       log=lambda *a: None)["dataset_yaml"]
        summary = {}
        for det in (False, True):
            runs = [overfit(yml, tmp, det) for _ in range(args.runs)]
            for r in runs:
                print(json.dumps(r), flush=True)
            summary["deterministic" if det else "default"] = {
                "runs": len(runs), "passed": sum(r["passed"] for r in runs),
                "distinct_trajectories": len({r["weight_sum"] for r in runs})}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
