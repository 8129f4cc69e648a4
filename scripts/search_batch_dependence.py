#!/usr/bin/env python3
"""Whether a chain's result in the template search's batched ICP depends on
how many chains run beside it, on the card.

The template-sharded search gives each rank a slice of the chains, so at
world 2 every batched ICP of the search runs half the chains of world 1's.
This script runs the single-device search of the synthetic 16-template
fixture (``parallel.make_synthetic_search_inputs``, 128x96), records the
inputs of its four batched ICPs (the coarse stage, then the three polish
stages), runs each again on the first half of its chains and prints, per
ICP, how many of those chains moved (largest pose difference) and how many
exit at another iteration; then whether ``x.sum(-1)`` of the first half of
a (B, N) tensor's rows equals the same rows summed in the whole batch. One
JSON line. Needs one card (``--device cpu`` runs the same on the CPU):
    python3 scripts/search_batch_dependence.py
"""
import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from poseestimator_tpu_torch.device import resolve_device  # noqa: E402
from poseestimator_tpu_torch.parallel import make_synthetic_search_inputs  # noqa: E402
from poseestimator_tpu_torch.pipeline import pose_estimator as pe  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    dev = resolve_device(p.parse_args(argv).device)
    fx = make_synthetic_search_inputs(n_tpl=16, C=128, n_cad=1200, device=dev)
    calls, icp = [], pe.icp_point_to_point_batched

    def recorded(*a, **k):
        r = icp(*a, **k)
        calls.append((a, k, r))
        return r

    pe.icp_point_to_point_batched = recorded
    try:
        pe.search_templates(fx["dst_points"], fx["dst_valid"], fx["tpl_points"],
                            fx["tpl_valid"], fx["tpl_fpfh"], fx["cad_points"], fx["cad_valid"],
                            fx["intr"], fx["mask_sil"], True, 0.05,
                            torch.Generator(device=dev).manual_seed(0), n_final=None,
                            render_kind="points")
    finally:
        pe.icp_point_to_point_batched = icp
    out = {"device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"}
    for stage, (a, k, r) in enumerate(calls):
        B = a[0].shape[0]
        h = B // 2
        half = icp(a[0][:h], a[1][:h], a[2], a[3], *([a[4][:h]] if len(a) > 4 else []), **k)
        diff = (r.T[:h] - half.T).abs().amax((1, 2))
        out[f"icp {stage}: {h} of B={B} chains x {a[0].shape[1]} points"] = {
            "chains_moved": int((diff > 0).sum()), "max_pose_diff": float(diff.max()),
            "exits_apart": int((r.n_iters[:h] != half.n_iters).sum())}
    for B, N in ((80, 128), (80, 1024), (16, 2048)):
        x = torch.randn(B, N, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
        out[f"sum(-1) of ({B}, {N}): first half equal alone"] = bool(
            torch.equal(x.sum(-1)[:B // 2], x[:B // 2].sum(-1)))
    print(json.dumps({"search_batch_dependence": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
