"""Finds every part of the benchmark by its name: ``BENCHMARK.json`` at the
repository's root, ``configs/<config>.json``, ``workloads/<cell>.json``,
``drivers/<driver>.py``, ``metrics/<metric>.py`` and ``ops/<op>.py`` under
the benchmark's folder. A new configuration, cell, metric or counted op is a
new file; nothing here lists them."""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(kind: str, name: str, here: Path = HERE) -> dict:
    path = here / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def config(name: str, here: Path = HERE) -> dict:
    return _json("configs", name, here)


def workload(name: str, here: Path = HERE) -> dict:
    return _json("workloads", name, here)


def module(kind: str, name: str, here: Path = HERE):
    """``<kind>/<name>.py`` loaded by its path (a name may hold dots); a name
    ``<base>.<suffix>`` without a file of its own takes ``<base>.py``, so one
    reader serves a quantity split by the end-to-end metric it moves
    (``k1_roofline.frame``, ``k1_roofline.init``)."""
    path = here / kind / f"{name}.py"
    if not path.is_file() and "." in name:
        name = name.rsplit(".", 1)[0]
        path = here / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    key = f"benchmark.{kind}.{name}"
    if key not in sys.modules:
        s = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(s)
        sys.modules[key] = mod
        s.loader.exec_module(mod)
    return sys.modules[key]


def names(kind: str, suffix: str, here: Path = HERE) -> list[str]:
    """Every name of a kind that has a file."""
    return sorted(p.name[: -len(suffix)] for p in (here / kind).glob(f"*{suffix}")
                  if not p.name.startswith("_"))


def cell_metrics(bench: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end, per-layer) metric entries that ``cell`` reports: those
    that list it, and those without a ``workloads`` key (for a per-layer
    metric: in every cell that reports the metric it moves)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if cell in m.get("workloads", []) or ("workloads" not in m and m["moves"] in moved)]
    return e2e, layer
