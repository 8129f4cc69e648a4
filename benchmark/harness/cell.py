"""One run of one cell: set-up, the measured window (closed loop: each
request starts when the last one has returned), the traced slice with
``--trace 1``, then the check of the outputs against the reference.

A run's result is one dict, printed by ``run.py`` as the last line of
standard output. With ``--trace 0`` its metrics are the cell's end-to-end
metrics; with ``--trace 1`` its per-layer metrics, read by
``metrics/<name>.py`` from the slice that closes the window.
"""
from __future__ import annotations

import gc
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import torch

from . import registry, trace as tr
from .record import Recorder
from .spans import HostSpans, label_gaps

FORBIDDEN = ("jax", "jaxlib", "flax", "poseestimator_tpu")


def loaded_forbidden() -> list[str]:
    """Top-level names of loaded modules that the port may not bring in,
    compared whole (``poseestimator_tpu_torch`` is not
    ``poseestimator_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def window(drv, seconds: float, trace: bool, device):
    """Run requests for ``seconds``; with ``trace`` the last
    ``drv.trace_steps`` of them run under the profiler and the recorder.
    Returns the reading of the run."""
    steps_s = []
    i = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        a = time.perf_counter()
        drv.step(i)
        sync(device)
        b = time.perf_counter()
        steps_s.append(b - a)
        i += 1
        if trace and b + drv.trace_steps * statistics.median(steps_s) >= deadline:
            break
        if b >= deadline:
            break
    r = SimpleNamespace(unit=drv.UNIT, before_s=b - t0, before_steps=i, step_s=steps_s,
                        events=[], slice_steps=0, slice_s=0.0, counted={}, ops={},
                        counters={})
    if trace:
        from torch.profiler import ProfilerActivity, profile

        ops = {n: registry.module("ops", n) for n in registry.names("ops", ".py")}
        acts = [ProfilerActivity.CUDA if torch.device(device).type == "cuda"
                else ProfilerActivity.CPU]
        with Recorder(ops) as rec, HostSpans() as hs, profile(activities=acts) as prof:
            hs.mark(device)
            a = time.perf_counter()
            for _ in range(drv.trace_steps):
                t0 = time.perf_counter_ns()
                drv.step(i)
                sync(device)
                hs.add_step(t0, time.perf_counter_ns())
                i += 1
            r.slice_s = time.perf_counter() - a
        r.slice_steps = drv.trace_steps
        r.events = tr.device_events(prof)
        r.counted = rec.counted()
        r.ops = ops
        r.idle_by_stage = label_gaps(r.events, hs.spans, hs.mark_ns)
    r.attempted = i
    r.counters = drv.counters()
    return r


def run(cell: str, seed: int, seconds: float, trace: bool, control: str | None = None,
        device: str = "cuda", t_start: float | None = None, here=registry.HERE) -> dict:
    """One run of ``cell`` (its files under ``here``); the result dict."""
    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    wl = registry.workload(cell, here)
    cfg = registry.config(wl["config"], here)
    e2e_spec, layer_spec = registry.cell_metrics(registry.spec(), cell)
    work = tempfile.mkdtemp(prefix="bench_")
    try:
        drv = registry.module("drivers", wl["driver"], here).Driver(cfg, wl, seed, device, work)
        drv.setup()
        sync(device)
        setup_s = time.perf_counter() - t_start
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        r = window(drv, seconds, trace, device)
        dev_info = {"platform": "gpu" if cuda else "cpu",
                    "kind": torch.cuda.get_device_name(0) if cuda else "cpu", "count": 1}
        if cuda:
            dev_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
            dev_info["power_limit"] = power_limit()
        metrics = {}
        if trace:
            dev_info["busy_s"] = tr.busy_ns(r.events) / 1e9
            dev_info["window_s"] = r.slice_s
            for m in layer_spec:
                v = registry.module("metrics", m["name"], here).read(r)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        else:
            values = {"setup_s": setup_s, f"{drv.UNIT}_ms": r.before_s / r.before_steps * 1e3}
            values.update(drv.end_to_end(r))
            for m in e2e_spec:
                if m["name"] in values:
                    metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
        failed = drv.failed()
        drv.free()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        checks = drv.check(control)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks)
    out = {"correct": correct, "attempted": r.attempted, "failed": failed, "metrics": metrics,
           "device": dev_info}
    if trace:
        out["breakdown"] = {"device_ops": tr.top_ops(r.events), "idle_gaps": r.idle_by_stage}
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return out
