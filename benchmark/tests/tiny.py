"""Small copies of the benchmark's cells that a CPU test can run: the same
drivers, metrics and ops, the configurations cut to a 160 x 120 camera, a
320-face CAD, three objects and the 5-view database, and the workloads cut
to short streams and small pools. The limits of these copies hold at this
size (a 28-pixel object reads larger pose gaps than the cells do)."""
from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
# set from this size's sound readings on the CPU (pose gaps 0.09 / 1.66 /
# 0.41 mm; the search's fit excess 0.07-0.62 mm and score gap 0.017-0.098 on
# four seeds): above them, below the faults' (one frame's motion, 2-8 mm; a
# 20 mm shift, which reads a fit excess of 13 mm)
LIMITS = {"d435_single.track": {"det_gap": 1e-4, "pose_gap_mm": 1.0},
          "d435_single.init": {"pose_gap_mm": 6.0, "fit_excess_mm": 3.0, "score_gap": 0.3},
          "lmo8_multi.track": {"det_gap": 1e-4, "pose_gap_mm": 3.0, "missed_updates": 0}}


def make(tmp: Path) -> Path:
    """A benchmark folder in ``tmp`` with the small configurations and
    workloads, its drivers, metrics and ops those of the repository."""
    for d in ("configs", "workloads"):
        (tmp / d).mkdir(parents=True, exist_ok=True)
    for d in ("drivers", "metrics", "ops"):
        link = tmp / d
        if not link.exists():
            link.symlink_to(HERE / d)
    c = json.loads((HERE / "configs" / "d435_single.json").read_text())
    c["camera"] = {"width": 160, "height": 120, "fov_deg": 60.0}
    c["detector"]["imgsz"] = 160
    c["cad"]["subdivisions"] = 2
    c["search"]["view_set"] = "reduced"
    (tmp / "configs" / "d435_single.json").write_text(json.dumps(c))
    m = json.loads((HERE / "configs" / "lmo8_multi.json").read_text())
    m["camera"] = {"width": 160, "height": 120, "fx": 143.1, "fy": 143.4, "cx": 81.3, "cy": 60.5}
    m["detector"]["imgsz"] = 160
    m["cad"]["subdivisions"] = 2
    m["objects"] = m["objects"][:3]
    (tmp / "configs" / "lmo8_multi.json").write_text(json.dumps(m))
    for name, lim in LIMITS.items():
        w = json.loads((HERE / "workloads" / f"{name}.json").read_text())
        w["trace_steps"] = 2
        if "forward_frames" in w["traffic"]:
            w["traffic"].update(forward_frames=20, frames=60)
        else:
            w["traffic"]["pool"] = 4
        w["check"]["samples"] = 3
        if "surface" in w["check"]:
            w["check"]["surface"] = 5000
        if "tap_every" in w["check"]:
            w["check"]["tap_every"] = 2
        w["limits"] = lim
        (tmp / "workloads" / f"{name}.json").write_text(json.dumps(w))
    return tmp


def run(here: Path, cell: str, seed: int = 1234567890123, seconds: float = 2.0,
        trace: bool = False, control=None, device: str = "cpu") -> dict:
    import torch

    from benchmark.harness import cell as hcell

    torch.set_num_threads(2)
    return hcell.run(cell, seed, seconds, trace, control, device, here=here)
