"""Run one cell of the benchmark of ``poseestimator_tpu_torch`` once.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``, the numbers compared with the reference
beside their limits (also the last lines of standard error). Exits non-zero
and prints no result when there is no CUDA card, when the cell asks for more
cards than there are, when JAX or the JAX package is loaded once the
window has closed, or when an end-to-end or per-layer reading is not
finite; a compared number that is not finite is printed as 1e308.
``--control tf32`` puts the reference computed in TF32 in the program's
place (a check of the check, never part of a benchmark run).
"""
from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The process's start on the ``perf_counter`` clock (falls back to
    now)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return now - age if 0.0 <= age < 600.0 else now
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("tf32",), default=None)
    args = p.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import cell, registry

    listed = [w["chips"] for w in registry.spec()["workloads"] if w["name"] == args.workload]
    chips = int(listed[0] if listed else registry.workload(args.workload).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {chips} CUDA card(s), found {n}",
              file=sys.stderr)
        return 2
    import poseestimator_tpu_torch  # noqa: F401  (absent: the run fails here)

    out = cell.run(args.workload, args.seed, args.seconds, bool(args.trace), args.control,
                   "cuda", T_START)
    bad = cell.loaded_forbidden()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    bad = [k for k, m in out["metrics"].items() if not math.isfinite(m["value"])]
    if bad:
        print(f"benchmark: no finite reading of {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        if not math.isfinite(c["value"]):  # nothing compared, or a NaN: fails its limit
            c["value"] = 1e308
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
