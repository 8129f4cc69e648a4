"""Arithmetic that the per-layer metric readers share: a kernel's share of
its roofline, and the whole step's share of the float32 peak. A slice with
no device events (a run off the card) gives no device reading."""
from __future__ import annotations

from . import peaks, trace


def roofline_pct(r, op: str):
    """Least time of the op's recorded work over the device time of its
    kernels in the slice, in %; None when the slice ran none."""
    counted = r.counted.get(op)
    if not counted:
        return None
    dev_s = trace.matching_ns(r.events, r.ops[op].KERNELS) / 1e9
    if dev_s <= 0:
        return None
    least = sum(peaks.least_s(ops, nbytes) for ops, nbytes in counted)
    return 100.0 * least / dev_s


def mfu_pct(r):
    """Counted operations a request (every recorded op in the slice, over its
    requests) times the requests before the slice, over that time at the
    float32 peak, in %."""
    if not r.events or not r.slice_steps or not r.before_steps:
        return None
    ops = sum(o for calls in r.counted.values() for o, _ in calls) / r.slice_steps
    if ops <= 0:
        return None
    return 100.0 * ops * r.before_steps / (r.before_s * peaks.F32_FLOPS)


def launches(r):
    return trace.kernel_count(r.events) / r.slice_steps if r.events else None


def idle_pct(r):
    if not r.events:
        return None
    return 100.0 * (1.0 - trace.busy_ns(r.events) / 1e9 / r.slice_s)
