"""Read the numbers that decide ``correct`` over many seeds in one process:
one run of a cell a seed (its own set-up, a window of ``--seconds``, its
check), the program's or, with ``--control tf32``, the control's. Prints one
JSON line a seed: the seed, ``correct``, the requests and the numbers
compared beside their limits. It sets no limit; ``PERF.md`` records the
readings that the limits were set from.

    python3 benchmark/tests/seeds.py --workload d435_single.init --seconds 6 \\
        --seeds 4000000001 4000000002 [--control tf32]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", choices=("tf32",), default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import cell

    if not torch.cuda.is_available():
        print("seeds: needs a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        out = cell.run(args.workload, seed, args.seconds, False, args.control, "cuda")
        print(json.dumps({"seed": seed, "control": args.control, "correct": out["correct"],
                          "attempted": out["attempted"], "failed": out["failed"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
