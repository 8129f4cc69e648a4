"""What the drivers share for deciding ``correct``: the precision switch of
the reference and its control, a tap on the detector's raw outputs in the
timed path, and the draw of the requests that are checked."""
from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch


@contextlib.contextmanager
def precision(control: str | None):
    """float32 with TF32 off for matrix products and convolutions (the
    configurations' precision), or TF32 on for the control (``"tf32"``)."""
    keep = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = control == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = keep


class OutputTap:
    """Keeps the raw outputs of a module's forward on the requests marked
    by ``key`` (None: not kept). A forward hook stores a reference; it reads
    nothing back and adds no work on the device."""

    def __init__(self, module: torch.nn.Module):
        self.key = None
        self.kept: dict = {}
        self._h = module.register_forward_hook(self._hook)

    def _hook(self, module, inputs, output):
        if self.key is not None:
            self.kept[self.key] = output

    def close(self) -> None:
        self._h.remove()


def sample(n_done: int, k: int, seed: int, skip: int = 0) -> list[int]:
    """Up to ``k`` distinct request indices of ``skip .. n_done - 1`` drawn
    from ``seed``, the last one always among them."""
    pool = np.arange(skip, n_done)
    if len(pool) <= k:
        return pool.tolist()
    pick = np.random.default_rng(seed).choice(pool[:-1], size=k - 1, replace=False)
    return sorted(pick.tolist() + [int(pool[-1])])


def tapped(i: int, every: int, seed: int) -> bool:
    """Whether the tap keeps request ``i``'s detector outputs: the first
    request, then one in ``every`` from an offset drawn from the seed."""
    off = int(np.random.default_rng(seed + 1).integers(0, every))
    return i == 0 or (i >= off and (i - off) % every == 0)


def det_gap(tap: OutputTap, sd: dict, color_of, imgsz: int, control) -> float:
    """Widest gap of the kept detector outputs against the reference's
    forward of the same image (``color_of(i)``, (H, W, 3) uint8 on the
    device) on the benchmark's weights ``sd``; the control's forward in
    place of the program's under ``control``. No kept output: infinite."""
    from benchmark.reference import yolo as ref_yolo

    worst = float("inf") if not tap.kept else 0.0
    for i, raw in sorted(tap.kept.items()):
        x = ref_yolo.letterbox(color_of(i), imgsz)
        with precision(None):
            ref = ref_yolo.forward(sd, x)
        if control:
            with precision(control):
                raw = ref_yolo.forward(sd, x)
        worst = max(worst, ref_yolo.widest_gap(raw, ref))
    tap.kept.clear()
    return worst


def detail(msg: str) -> None:
    """One line of what a check compared, on standard error."""
    print(f"detail {msg}", file=sys.stderr, flush=True)


def gap_line(name: str, value: float, limit: float) -> dict:
    return {"name": name, "value": float(value), "limit": float(limit)}
