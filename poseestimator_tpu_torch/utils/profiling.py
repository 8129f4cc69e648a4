"""Profiling hooks (counterpart of ``poseestimator_tpu/utils/profiling.py``):
per-stage wall times that wait for the device's work, and an opt-in
``torch.profiler`` trace of a block."""
from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


class StageTimer:
    """Collects per-stage wall times, in ms, that include the device's
    work."""

    def __init__(self):
        self.timings_ms: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time a block by the wall clock (no device wait)."""
        t0 = time.perf_counter()
        yield
        self.timings_ms[name] = (time.perf_counter() - t0) * 1000.0

    def timed(self, name: str, fn, *args, **kwargs):
        """Run ``fn``, wait for the card's queued work (when there is a
        card), and record the time."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.timings_ms[name] = (time.perf_counter() - t0) * 1000.0
        return out


@contextlib.contextmanager
def torch_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA when there is
    a card), written to ``log_dir`` as a Chrome trace; a no-op when
    ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield
