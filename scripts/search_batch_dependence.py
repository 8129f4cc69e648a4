#!/usr/bin/env python3
"""Whether a chain's result in the template search's batched ICP depends on
how many chains run beside it, on the card, and what the fixed-order sums
that make it independent cost.

The template-sharded search gives each rank a slice of the chains, so at
world 2 every batched ICP of the search runs half the chains of world 1's.
This script runs the single-device search of the synthetic 16-template
fixture (``parallel.make_synthetic_search_inputs``, 128x96) twice: with the
batched registration's sums over points in ``kabsch.tree_sum``'s order (the
port's, ``"tree"``) and as plain CUDA row sums (``"plain"``, forced through
``kabsch.fixed_order``). Each time it records the inputs of the search's
four batched ICPs (the coarse stage, then the three polish stages), runs
each again on the first half of its chains and prints, per ICP, how many of
those chains moved (largest pose difference) and how many exit at another
iteration; then whether ``x.sum(-1)`` of the first half of a (B, N)
tensor's rows equals the same rows summed in the whole batch. With
``--reps N`` it then times the whole search N times in each order, in
turns (plain, tree, tree, plain, ...), and prints the medians. One JSON
line. Needs one card (``--device cpu`` runs the same on the CPU):
    python3 scripts/search_batch_dependence.py [--reps 10]
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from poseestimator_tpu_torch.device import resolve_device  # noqa: E402
from poseestimator_tpu_torch.parallel import make_synthetic_search_inputs  # noqa: E402
from poseestimator_tpu_torch.pipeline import pose_estimator as pe  # noqa: E402
from poseestimator_tpu_torch.registration import kabsch  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--reps", type=int, default=0, help="timed searches in each order")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    fx = make_synthetic_search_inputs(n_tpl=16, C=128, n_cad=1200, device=dev)
    icp, fixed = pe.icp_point_to_point_batched, kabsch.fixed_order
    # the CPU's plain sums are already batch-independent: it runs them alone
    orders = ("plain", "tree") if fixed(torch.zeros((), device=dev)) else ("plain",)

    def search():
        return pe.search_templates(fx["dst_points"], fx["dst_valid"], fx["tpl_points"],
                                   fx["tpl_valid"], fx["tpl_fpfh"], fx["cad_points"],
                                   fx["cad_valid"], fx["intr"], fx["mask_sil"], True, 0.05,
                                   torch.Generator(device=dev).manual_seed(0), n_final=None,
                                   render_kind="points")

    def set_order(order):
        kabsch.fixed_order = fixed if order == "tree" else (lambda x: False)

    out = {"device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"}
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        out["card"] = smi.stdout.strip()
    try:
        for order in orders:
            set_order(order)
            calls = []

            def recorded(*a, **k):
                r = icp(*a, **k)
                calls.append((a, k, r))
                return r

            pe.icp_point_to_point_batched = recorded
            try:
                search()
            finally:
                pe.icp_point_to_point_batched = icp
            for stage, (a, k, r) in enumerate(calls):
                B = a[0].shape[0]
                h = B // 2
                half = icp(a[0][:h], a[1][:h], a[2], a[3], *([a[4][:h]] if len(a) > 4 else []),
                           **k)
                diff = (r.T[:h] - half.T).abs().amax((1, 2))
                out[f"{order} sums, icp {stage}: {h} of B={B} chains x {a[0].shape[1]} points"] = {
                    "chains_moved": int((diff > 0).sum()), "max_pose_diff": float(diff.max()),
                    "exits_apart": int((r.n_iters[:h] != half.n_iters).sum())}
        for B, N in ((80, 128), (80, 1024), (16, 2048)):
            x = torch.randn(B, N, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
            out[f"sum(-1) of ({B}, {N}): first half equal alone"] = bool(
                torch.equal(x.sum(-1)[:B // 2], x[:B // 2].sum(-1)))
            out[f"tree_sum of ({B}, {N}): first half equal alone"] = bool(
                torch.equal(kabsch.tree_sum(x, -1)[:B // 2], kabsch.tree_sum(x[:B // 2], -1)))
        if args.reps:
            times = {o: [] for o in orders}
            for order in orders:  # warm-up
                set_order(order)
                search()
            for i in range(args.reps):
                for order in orders if i % 2 == 0 else orders[::-1]:
                    set_order(order)
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    t = time.perf_counter()
                    search()
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    times[order].append((time.perf_counter() - t) * 1e3)
            out["search_ms"] = {o: {"median": float(np.median(t)), "all": t}
                                for o, t in times.items()}
    finally:
        kabsch.fixed_order = fixed
    print(json.dumps({"search_batch_dependence": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
