"""Single-frame init sweep (the counterpart of ``tools/eval_init.py``): the
12-frame random-orientation L-shape BOP scene (exact-raster depth, no
noise, seed 7) is written once by ``apps/generate.py``, then each
product-search configuration ``view_set:polish:score_res`` is swept over it
through ``apps/eval_bop.py --registration product``. Prints one JSON line
per configuration and a table.

Runs on the card unless ``--cpu`` or ``--device cpu`` is given:

    python -m poseestimator_tpu_torch.apps.eval_init --cpu
    python -m poseestimator_tpu_torch.apps.eval_init --configs full:1:2
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from .. import kernel_cases as kc
from ..device import resolve_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--work-dir", default=None,
                   help="scene and template dir (default: a new temporary one; a fixed "
                        "path reuses the scene)")
    p.add_argument("--configs", nargs="*",
                   default=["reduced:1:2", "full:1:2", "full:2:2", "full:1:1", "full:2:1"],
                   help="view_set:polish:score_res triples to sweep")
    p.add_argument("--frames", type=int, default=12)
    p.add_argument("--imgsz", default="640x480", help="the scene's camera WxH")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (--device cpu)")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    p.add_argument("--json-out", default=None)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = "cpu" if args.cpu else args.device
    resolve_device(device)
    from ..utils.plyio import write_ply
    from . import eval_bop, generate

    work = args.work_dir or tempfile.mkdtemp(prefix="init_ab_")
    os.makedirs(work, exist_ok=True)
    cad = os.path.join(work, "l.ply")
    if not os.path.exists(cad):
        v, f = kc.lshape_mesh(1.0)
        write_ply(cad, v, faces=f)
    scene = os.path.join(work, "scene_mesh")
    if not os.path.exists(os.path.join(scene, "scene_gt.json")):
        # 10 train + 2 val frames, one object, no distractors, exact-raster
        # depth, no sensor noise, seed 7
        generate.main(["--cad", f"lshape={cad}", "--out", scene,
                       "--train", str(args.frames - 2), "--val", "2", "--imgsz", args.imgsz,
                       "--max-objects", "1", "--max-distractors", "0", "--bop",
                       "--depth-instrument", "mesh", "--noise-sigma", "0", "--seed", "7",
                       "--device", device])

    results = []
    for cfg in args.configs:
        view_set, polish, score_res = cfg.split(":")
        bop_args = ["--scene-dir", scene, "--ply", cad,
                    "--templates", os.path.join(work, f"views_{view_set}"),
                    "--mask", "visib", "--registration", "product", "--view-set", view_set,
                    "--polish", polish, "--score-res", score_res, "--device", device]
        summary = eval_bop.run(eval_bop.build_parser().parse_args(bop_args), quiet=True)
        row = {"config": cfg}
        if summary:
            row.update({k: summary[k] for k in ("adds_mean_mm", "bop_ar", "ar_vsd", "ar_mssd",
                                                "ar_mspd") if k in summary})
            if "ambiguous_frames" in summary:
                row["ambiguous_frames"] = summary["ambiguous_frames"]
        results.append(row)
        print(json.dumps(row), flush=True)

    print(f"{'config':>14} {'ADD-S mm':>10} {'BOP AR':>8} {'ambig':>6}")
    for r in results:
        print(f"{r['config']:>14} {r.get('adds_mean_mm', float('nan')):>10.1f} "
              f"{r.get('bop_ar', float('nan')):>8.3f} {r.get('ambiguous_frames', '-'):>6}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(results, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
