"""Template-axis scaling of the product search (the counterpart of
``tools/scaling_eval.py``): ``parallel.sharded_template_search`` at fixed
total work over worlds of 1, 2, 4, 8 processes started by
``parallel.launch``. On the CPU each rank is a gloo process; on the card
every rank shares one card over gloo (``--device cuda:0``). Ranks share
the host's cores or the one card, so the wall times give the shape of the
scaling, not a multi-card figure. The scores must be bit-equal across
worlds, and the winner's ADD below 0.15 m. The synthetic CAD has
CAD_POINTS points, the multi-device dry run's fixture: at 3000, the JAX
script's, both packages pick the matching template but its ADD is
0.19-0.20 m, and the JAX script fails this gate.

    python -m poseestimator_tpu_torch.apps.scaling_eval --cpu --worlds 1,2
    python -m poseestimator_tpu_torch.apps.scaling_eval --device cuda:0 --worlds 1,2

Prints one JSON line per world and a markdown table.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..device import resolve_device

CAD_POINTS = 1200


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--templates", type=int, default=16)
    p.add_argument("--points", type=int, default=256)
    p.add_argument("--repeat", type=int, default=3)
    p.add_argument("--worlds", "--devices", dest="worlds", default="1,2,4,8",
                   help="world sizes (processes) to run")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (--device cpu)")
    p.add_argument("--device", default="cuda:0",
                   help="torch device of every rank (cpu or cuda:k)")
    return p


def _padded(inputs: dict, n_real: int, nd: int) -> dict:
    """Template arrays padded by repetition to a multiple of the world size,
    as ``PoseEstimator`` pads them."""
    pad = (-n_real) % nd
    if pad == 0:
        return inputs
    reps = -(-(n_real + pad) // n_real)
    out = dict(inputs)
    for k in ("tpl_points", "tpl_valid", "tpl_fpfh"):
        out[k] = torch.cat([inputs[k]] * reps, dim=0)[: n_real + pad]
    return out


def rank_main(out_dir: str, n_tpl: int, points: int, repeat: int) -> None:
    """One rank: the sharded search ``repeat`` times after a warm-up; rank 0
    writes the scores, the winner's pose and the ms of each search."""
    from ..parallel import make_mesh, make_synthetic_search_inputs, sharded_template_search

    mesh = make_mesh("tp")
    if mesh.device.type == "cpu":  # ranks share the cores, OMP_NUM_THREADS at most
        share = max(1, (os.cpu_count() or 1) // mesh.size)
        torch.set_num_threads(min(share, int(os.environ.get("OMP_NUM_THREADS") or share)))
    inputs = make_synthetic_search_inputs(n_tpl=n_tpl, C=points, n_cad=CAD_POINTS,
                                          device=mesh.device)
    inputs.pop("good_idx")
    inputs.pop("T_gt")
    pin = _padded(inputs, n_tpl, mesh.shape["tp"])

    def search():
        gen = torch.Generator(device=mesh.device).manual_seed(0)
        return sharded_template_search(mesh, generator=gen, **pin)

    search()
    ms = []
    for _ in range(repeat):
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
        _, Hr, scores = search()
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        ms.append((time.perf_counter() - t0) * 1e3)
    if mesh.rank == 0:
        np.savez(os.path.join(out_dir, f"world{mesh.shape['tp']}.npz"),
                 scores=scores[:n_tpl].cpu().numpy(), H_ref=Hr[:n_tpl].cpu().numpy(),
                 ms=np.asarray(ms))


def run(args, quiet: bool = False) -> list:
    from ..geom3d.cloud import from_points
    from ..geom3d.metrics import add_metric
    from ..parallel import launch, make_synthetic_search_inputs

    device = "cpu" if args.cpu else args.device
    resolve_device(device)
    ref = make_synthetic_search_inputs(n_tpl=args.templates, C=args.points, n_cad=CAD_POINTS,
                                       device="cpu")
    model = from_points(ref["cad_points"].numpy(), device="cpu")
    T_gt = torch.from_numpy(np.asarray(ref["T_gt"], np.float32))
    out_dir = tempfile.mkdtemp(prefix="scaling_eval_")
    rows, ref_scores = [], None
    for nd in (int(w) for w in args.worlds.split(",")):
        launch(rank_main, nd, "gloo", device, args=(out_dir, args.templates, args.points,
                                                     args.repeat))
        r = np.load(os.path.join(out_dir, f"world{nd}.npz"))
        scores = r["scores"]
        w = int(np.argmin(scores))
        add = float(add_metric(torch.from_numpy(r["H_ref"][w]), T_gt, model))
        if not add < 0.15:
            raise RuntimeError(f"world {nd}: the winner's pose is wrong: ADD {add:.4f} m, "
                               f"scores {scores}")
        if ref_scores is None:
            ref_scores = scores
        elif not np.array_equal(scores, ref_scores):  # sharding must not change the math
            raise RuntimeError(f"world {nd}: scores differ from world {rows[0]['world']} by up "
                               f"to {np.abs(scores - ref_scores).max():.3g}")
        ms = float(np.mean(r["ms"]))
        row = {"world": nd, "device": device, "templates": args.templates,
               "points": args.points, "cad_points": CAD_POINTS, "wall_ms": round(ms, 2),
               "speedup_vs_first": round(rows[0]["wall_ms"] / ms, 2) if rows else 1.0,
               "winner": w, "winner_add_m": round(add, 5), "scores_bit_equal": True}
        rows.append(row)
        if not quiet:
            print(json.dumps(row), flush=True)
    if not quiet:
        print("\n| world | wall ms | speedup |")
        print("|---|---|---|")
        for r in rows:
            print(f"| {r['world']} | {r['wall_ms']} | {r['speedup_vs_first']}x |")
    return rows


def main(argv=None):
    return 0 if run(build_parser().parse_args(argv)) else 1


if __name__ == "__main__":
    sys.exit(main())
