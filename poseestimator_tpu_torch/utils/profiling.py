"""Profiling hooks (counterpart of ``poseestimator_tpu/utils/profiling.py``):
per-stage wall times that wait for the device's work, an opt-in
``torch.profiler`` trace of a block, and the device's kernels and busy time
over a few calls (the per-stage profilers, ``apps/profile_stages.py`` and
``apps/profile_search.py``)."""
from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


def _wait(sync) -> None:
    """Wait for the card's queued work on ``sync``'s device: a tensor, a
    device, or True for the current card. Nothing to wait for on the CPU."""
    if sync is True:
        dev = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    else:
        dev = sync.device if isinstance(sync, torch.Tensor) else torch.device(sync)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class StageTimer:
    """Collects per-stage wall times, in ms; ``timed`` and ``stage(...,
    sync=)`` include the device's work."""

    def __init__(self):
        self.timings_ms: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Time a block by the wall clock. With ``sync`` (a tensor or a
        device whose card to wait on, or True for the current card) the
        clock stops after the card's queued work, so the time includes the
        device's work; without it, only the host's."""
        t0 = time.perf_counter()
        yield
        if sync is not None:
            _wait(sync)
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


def time_calls(fn, n: int, device, after_warm=None) -> float:
    """ms a call of ``fn(i)`` for i in 0..n-1, run back to back after two
    warm calls (then ``after_warm()``, e.g. resetting launch counts), with
    one wait for the card at the end."""
    fn(0)
    fn(0)
    _wait(torch.device(device))
    if after_warm is not None:
        after_warm()
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    _wait(torch.device(device))
    return (time.perf_counter() - t0) / n * 1000.0


def device_activity(fn, n: int) -> tuple[float, float]:
    """``(kernels, device-busy ms)`` a call of ``fn(i)`` over n calls traced
    by ``torch.profiler`` on the card: the device's kernels (copies and
    fills not counted), and the device time of every device-side event
    (kernels, copies, fills). Only the device's activity is recorded, and
    its raw events are read, not ``key_averages()``: a search's tens of
    thousands of kernels would otherwise take seconds to sort."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    n_kern = sum(not e.name().startswith(("Memcpy", "Memset")) for e in dev)
    busy_ms = sum(e.duration_ns() for e in dev) / 1e6
    return n_kern / n, busy_ms / n
