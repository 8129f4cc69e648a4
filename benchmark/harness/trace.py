"""The device's activity in a traced slice, from ``torch.profiler``'s raw
device events.

The reading is copied from ``poseestimator_tpu_torch/utils/profiling.py::
device_activity``: only the device's activity is recorded, its raw events
are read (not ``key_averages()``, which would sort tens of thousands of
events), and kernels are counted without copies and fills (``Memcpy``,
``Memset``). Added here: busy time as the union of the event intervals and
the top device operations (``spans.py`` names the idle gaps).
"""
from __future__ import annotations

from collections import defaultdict

COPY_FILL = ("Memcpy", "Memset")


def device_events(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, duration ns) of every device event of a finished
    ``torch.profiler.profile``."""
    import torch

    return [(e.name(), e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


def kernel_count(events) -> int:
    return sum(not name.startswith(COPY_FILL) for name, _, _ in events)


def busy_ns(events) -> int:
    """Length of the union of the events' intervals."""
    total, end = 0, None
    for _, s, d in sorted(events, key=lambda e: e[1]):
        e = s + d
        if end is None or s >= end:
            total += d
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _short(name: str, n: int = 60) -> str:
    return name if len(name) <= n else name[: n - 3] + "..."


def top_ops(events, k: int = 10) -> list[list]:
    """[[name, seconds], ...] of the k device operations with the most time."""
    by = defaultdict(int)
    for name, _, d in events:
        by[_short(name)] += d
    return [[n, t / 1e9] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]


def matching_ns(events, patterns) -> int:
    """Device time of the events whose name holds one of ``patterns``."""
    return sum(d for name, _, d in events if any(p in name for p in patterns))
