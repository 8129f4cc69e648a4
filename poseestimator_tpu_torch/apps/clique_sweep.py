"""Agreement of the greedy max clique with the exact one (the counterpart of
``tools/clique_sweep.py``): registration-family consistency graphs (a
planted inlier clique plus outlier edges from ``teaser_solve``'s own
adjacency rule, correlations included; numpy from ``--seed``) go through
``registration/maxclique.py``'s greedy growth on the card and the exact
branch and bound of ``registration/native.py``, and each (K, outlier
ratio) cell records how often the two clique sizes agree.

    python -m poseestimator_tpu_torch.apps.clique_sweep --cpu --budget 1000
    python -m poseestimator_tpu_torch.apps.clique_sweep --budget 1000   # greedy on the card
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..device import resolve_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cpu", action="store_true", help="run the greedy clique on the CPU")
    p.add_argument("--device", default="cuda", help="torch device of the greedy clique")
    p.add_argument("--ks", default="128,256,512,1024")
    p.add_argument("--ratios", default="0.1,0.3,0.5,0.7,0.9,0.95")
    p.add_argument("--budget", type=int, default=1000,
                   help="graphs over the whole grid (cells of larger K get fewer)")
    p.add_argument("--noise-bound", type=float, default=0.01)
    p.add_argument("--cbar2", type=float, default=1.0)
    p.add_argument("--json", default="", help="write the per-cell rows to this file")
    p.add_argument("--seed", type=int, default=0)
    return p


def make_graph(rng: np.random.Generator, K: int, ratio: float, noise_bound: float,
               cbar2: float):
    """One registration-family consistency graph: ``(adj (K, K) bool,
    n_inliers)``. Inliers are a rigid transform of the source plus noise;
    outlier destinations are uniform in the scene, their edges by the same
    rule ``| |dst_i - dst_j| - |src_i - src_j| | <= 2 noise_bound
    sqrt(cbar2)``."""
    n_out = int(round(K * ratio))
    n_in = K - n_out
    src = rng.uniform(-0.25, 0.25, (K, 3)).astype(np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))  # a random rotation
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    t = rng.uniform(-0.5, 0.5, 3)
    dst = (src @ q.T + t).astype(np.float32)
    dst[:n_in] += rng.normal(0, noise_bound / 3.0, (n_in, 3)).astype(np.float32)
    dst[n_in:] = rng.uniform(-0.25, 0.25, (n_out, 3)).astype(np.float32) + t
    sn = np.linalg.norm(src[:, None] - src[None, :], axis=-1)
    dn = np.linalg.norm(dst[:, None] - dst[None, :], axis=-1)
    adj = np.abs(dn - sn) <= 2.0 * noise_bound * np.sqrt(cbar2)
    np.fill_diagonal(adj, False)
    return adj, n_in


def trials_per_cell(ks, ratios, budget: int) -> np.ndarray:
    """Graphs a cell: the budget weighted ~1/K (a graph costs ~K^3), at least 3."""
    w = np.array([1.0 / k for k in ks for _ in ratios])
    return np.maximum(3, np.round(budget * w / w.sum())).astype(int)


def run(args, quiet: bool = False) -> list:
    from ..registration import native
    from ..registration.maxclique import max_clique_greedy

    dev = resolve_device("cpu" if args.cpu else args.device)
    if not native.available():
        raise SystemExit("the exact clique library did not build (needs g++)")
    ks = [int(k) for k in args.ks.split(",")]
    ratios = [float(r) for r in args.ratios.split(",")]
    trials = trials_per_cell(ks, ratios, args.budget)
    rng = np.random.default_rng(args.seed)
    rows, cell = [], 0
    for K in ks:
        for ratio in ratios:
            n_t = int(trials[cell])
            cell += 1
            agree, sizes = 0, []
            t_greedy = t_exact = 0.0
            for _ in range(n_t):
                adj, _ = make_graph(rng, K, ratio, args.noise_bound, args.cbar2)
                t0 = time.perf_counter()
                _, g_sz = max_clique_greedy(torch.from_numpy(adj).to(dev),
                                            torch.ones(K, dtype=torch.bool, device=dev))
                g_sz = int(g_sz)
                t_greedy += time.perf_counter() - t0
                t0 = time.perf_counter()
                _, e_sz = native.max_clique_exact(adj)
                t_exact += time.perf_counter() - t0
                if g_sz > e_sz:
                    raise RuntimeError(f"greedy clique {g_sz} larger than the exact {e_sz}")
                agree += int(g_sz == e_sz)
                sizes.append(g_sz / max(e_sz, 1))
            row = {"K": K, "outlier_ratio": ratio, "trials": n_t, "agreement_rate": agree / n_t,
                   "size_ratio_mean": float(np.mean(sizes)),
                   "size_ratio_min": float(np.min(sizes)),
                   "greedy_ms_mean": t_greedy / n_t * 1000.0,
                   "exact_ms_mean": t_exact / n_t * 1000.0, "device": str(dev)}
            rows.append(row)
            if not quiet:
                print(f"K={K:5d} ratio={ratio:4.2f} trials={n_t:4d} "
                      f"agree={row['agreement_rate'] * 100:6.2f}% "
                      f"size_ratio_min={row['size_ratio_min']:.3f} "
                      f"greedy={row['greedy_ms_mean']:7.2f}ms exact={row['exact_ms_mean']:7.2f}ms")
    worst = min(rows, key=lambda r: r["agreement_rate"])
    if not quiet:
        print(f"\ntotal graphs: {sum(r['trials'] for r in rows)}; worst cell: K={worst['K']} "
              f"ratio={worst['outlier_ratio']} agreement {worst['agreement_rate'] * 100:.2f}%")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


def main(argv=None):
    return 0 if run(build_parser().parse_args(argv)) else 1


if __name__ == "__main__":
    sys.exit(main())
