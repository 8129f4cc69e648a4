#!/usr/bin/env python3
"""The seed spread of two accuracy records, the JAX package against the
port, both on the CPU:

- ``eval_init`` full:1:2 (the 12-frame L-shape BOP scene, the product
  search) with ``PoseEstimator`` seeded 0, 1 and 2, both packages on one
  scene's files: the port's ``apps/eval_init.py`` writes the scene, the JAX
  package's ``tools/eval_init.py`` reads a copy of it and renders its own
  template database;
- (e5), ``eval_tracking --objects 3 --mixed-cad`` at 320x240 for 40 frames
  through the splat camera, with both estimators' seeds offset by 0, 10 and
  20 (``tools/eval_tracking.py`` against ``apps/eval_tracking.py``).

Each run is a subprocess (two threads, the JAX package on the CPU) that
wraps ``PoseEstimator.__init__`` to set the seed and calls the tool's
``main``. Prints one JSON line a run, then the spread of each record.

    python scripts/seed_spread.py --work-dir DIR [--parts init,e5] [--jobs 4]

About an hour on eight cores; a JAX (e5) run takes ~16 min on two.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (0, 1, 2)
OFFSETS = (0, 10, 20)
E5 = ["--objects", "3", "--mixed-cad", "--res", "320x240", "--frames", "40", "--modes", "0",
      "--observation", "splat"]


def child(pkg: str, part: str, seed: int, work: str, out: str) -> None:
    """One run in this process: ``seed`` sets (init) or offsets (e5) the
    estimators' seeds."""
    if pkg == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        import poseestimator_tpu.pipeline.pose_estimator as pe

        sys.path.insert(0, os.path.join(REPO, "tools"))
        import eval_init
        import eval_tracking
    else:
        import torch

        torch.set_num_threads(2)
        import poseestimator_tpu_torch.pipeline.pose_estimator as pe
        from poseestimator_tpu_torch.apps import eval_init, eval_tracking
    init = pe.PoseEstimator.__init__

    def seeded(self, *a, **k):
        k["seed"] = seed if part == "init" else k.get("seed", 0) + seed
        init(self, *a, **k)

    pe.PoseEstimator.__init__ = seeded
    if part == "init":
        eval_init.main(["--cpu", "--work-dir", work, "--configs", "full:1:2", "--json-out", out])
    else:
        eval_tracking.main(["--cpu", *E5, "--json-out", out])


def run(pkg: str, part: str, seed: int, work: str, out: str) -> dict:
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2",
           "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=2",
           "PYTHONPATH": REPO}
    p = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", pkg, part,
                        str(seed), work, out], cwd=REPO, env=env, capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"{pkg} {part} {seed}: rc {p.returncode}\n{p.stderr[-2000:]}")
    with open(out) as f:
        row = json.load(f)[0]
    keys = ("bop_ar", "adds_mean_mm") if part == "init" else ("adds_mean_cm",
                                                               "per_object_adds_cm")
    rec = {"package": pkg, "part": part, "seed": seed, **{k: row[k] for k in keys}}
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--work-dir", help="where the runs write (required)")
    p.add_argument("--parts", default="init,e5")
    p.add_argument("--jobs", type=int, default=4)
    p.add_argument("--child", nargs=5, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        pkg, part, seed, work, out = args.child
        child(pkg, part, int(seed), work, out)
        return 0
    if not args.work_dir:
        p.error("--work-dir is required")
    work = os.path.abspath(args.work_dir)
    os.makedirs(work, exist_ok=True)
    parts = args.parts.split(",")
    out = lambda pkg, part, seed: os.path.join(work, f"{part}_{pkg}_{seed}.json")  # noqa: E731
    rows, futs = [], []
    with ThreadPoolExecutor(args.jobs) as ex:
        if "e5" in parts:
            futs += [ex.submit(run, pkg, "e5", o, work, out(pkg, "e5", o))
                     for pkg in ("jax", "port") for o in OFFSETS]
        if "init" in parts:
            # seed 0 first in each package: it writes the scene (the port) and
            # the template database (each package) that the other seeds read
            port_dir, jax_dir = os.path.join(work, "init_port"), os.path.join(work, "init_jax")
            rows.append(run("port", "init", 0, port_dir, out("port", "init", 0)))
            futs += [ex.submit(run, "port", "init", s, port_dir, out("port", "init", s))
                     for s in SEEDS[1:]]
            os.makedirs(jax_dir, exist_ok=True)
            shutil.copy(os.path.join(port_dir, "l.ply"), jax_dir)
            shutil.copytree(os.path.join(port_dir, "scene_mesh"),
                            os.path.join(jax_dir, "scene_mesh"), dirs_exist_ok=True)
            rows.append(run("jax", "init", 0, jax_dir, out("jax", "init", 0)))
            futs += [ex.submit(run, "jax", "init", s, jax_dir, out("jax", "init", s))
                     for s in SEEDS[1:]]
        rows += [f.result() for f in futs]
    for part, key in (("init", "bop_ar"), ("e5", "adds_mean_cm")):
        for pkg in ("jax", "port"):
            vals = [r[key] for r in rows if r["part"] == part and r["package"] == pkg]
            if vals:
                print(json.dumps({"part": part, "package": pkg, key: vals,
                                  "range": [min(vals), max(vals)]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
