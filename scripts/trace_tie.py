#!/usr/bin/env python3
"""Whether the program's spans (``utils/profiling.py``) sit on the device
trace's clock, and what recording them costs, on a traced slice of one of
the benchmark's cells (``d435_single.track`` unless ``--cell`` says).

The slice runs as the benchmark's ``--trace 1`` run does (the profiler's
device activity, the benchmark's recorder and its marker spans), after an
untraced window of the same frames. Then, on the session's tie (the
profiler's clock less ``perf_counter_ns``):

- ``launch_in_span``: every launch of K1 (``fused_nn_kernel``) and K2
  (``raster_kernel``), as the profiler's runtime events of the host record
  it, lies inside a ``k1`` / ``k2`` span;
- ``idle_start``: every kernel launched inside a ``k1`` or ``k2`` span that
  starts on an idle card starts within [span start, span start + 200 us];
  ``first_kernel``, the same without the runtime's launch records: the
  first K1 / K2 near each such span that opens on an idle card;
- ``launch_us_after_span_start`` / ``launch_us_before_span_end``: where in
  its span each launch lies (a tie off by more than these would put
  launches outside), and ``kernel_us_after_launch_on_idle_card``;
- ``marker_tie_us``: the tie against ``benchmark/harness/spans.py``'s marker
  (the device start of a fill less the host's time before its launch,
  which holds the fill's launch latency too), and ``marker_launch_tie_us``,
  the marker taken at the fill's launch as the runtime records it;
- the tracer's cost: ns a span with the profiler on and off, spans a
  request, and the traced slice's ms a request against the window's;
- ``self_ms_a_request``: each span name's self time a request, largest
  first; ``launches_a_request``, the kernel launches the runtime records in
  each span name's self time; ``profiler_ns_a_launch``, what the profiler's
  device activity adds to the host's time for one launch (a loop of small
  launches with the profiler on and off); and ``self_ms_less_profiler``,
  each self time less its launches times that cost: the host time a
  request would spend there untraced, as far as launches explain the
  difference.

One JSON line on standard output (``--out`` keeps it); exit 0 when every
launch lies in its span and the marker, taken at its launch, agrees within
50 us. Needs one card:
    python3 scripts/trace_tie.py [--cell d435_single.track] [--seed 3000000019]
                                 [--window-frames 30]
"""
import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

KERNELS = {"k1": "fused_nn_kernel", "k2": "raster_kernel"}


def span_cost_ns(profiling, n: int = 50_000) -> float:
    """ns a span inside a request, in whatever state the profiler is."""
    with profiling.span("cost"):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with profiling.span("x"):
                pass
        t1 = time.perf_counter_ns()
    return (t1 - t0) / n


def launch_ns(torch, n: int = 20_000) -> float:
    """Host ns to issue one small kernel, in whatever state the profiler
    is; the card keeps up, so the queue never fills."""
    x = torch.zeros(1, device="cuda")
    for _ in range(100):
        x.add_(1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        x.add_(1.0)
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / n


def innermost(s, tie: int, times) -> list:
    """The record open innermost at each of ``times`` (sorted, on the
    profiler's clock), -1 outside every record. Records nest, so a stack
    swept in time order holds the open ones."""
    start = s.start_ns + tie
    end = s.end_ns + tie
    order = sorted(range(len(start)), key=lambda r: (start[r], r))
    stack, j, out = [], 0, []
    for t in times:
        while j < len(order) and start[order[j]] <= t:
            r = order[j]
            while stack and end[stack[-1]] < start[r]:
                stack.pop()
            stack.append(r)
            j += 1
        while stack and end[stack[-1]] < t:
            stack.pop()
        out.append(stack[-1] if stack else -1)
    return out


def summary(xs):
    return {"min": min(xs), "median": statistics.median(xs), "max": max(xs)} if xs else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cell", default="d435_single.track")
    p.add_argument("--seed", type=int, default=3000000019)
    p.add_argument("--window-frames", type=int, default=30)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness import registry
    from benchmark.harness.cell import power_limit
    from benchmark.harness.record import Recorder
    from benchmark.harness.spans import HostSpans
    from poseestimator_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print("trace_tie: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    wl = registry.workload(args.cell)
    cfg = registry.config(wl["config"])
    work = tempfile.mkdtemp(prefix="trace_tie_")
    drv = registry.module("drivers", wl["driver"]).Driver(cfg, wl, args.seed, dev, work)
    drv.setup()
    torch.cuda.synchronize()

    i = 0
    window = []
    for _ in range(args.window_frames):
        a = time.perf_counter()
        drv.step(i)
        torch.cuda.synchronize()
        window.append(time.perf_counter() - a)
        i += 1

    ops = {n: registry.module("ops", n) for n in registry.names("ops", ".py")}
    steps = drv.trace_steps
    with Recorder(ops), HostSpans() as hs, profile(activities=[ProfilerActivity.CUDA]) as prof:
        hs.mark(dev)
        a = time.perf_counter()
        for _ in range(steps):
            drv.step(i)
            torch.cuda.synchronize()
            i += 1
        slice_s = time.perf_counter() - a
    s = profiling.last_session()
    tie = s.tie_ns

    evs = list(prof.profiler.kineto_results.events())
    is_dev = [e.device_type() == torch.autograd.DeviceType.CUDA for e in evs]
    dev_ev = [e for e, d in zip(evs, is_dev) if d]
    launches = {e.correlation_id(): e.start_ns() for e, d in zip(evs, is_dev)
                if not d and "Launch" in e.name()}
    dev_sorted = sorted(dev_ev, key=lambda e: e.start_ns())
    dev_starts = np.array([e.start_ns() for e in dev_sorted], np.int64)
    dev_ends = np.maximum.accumulate(np.array([e.start_ns() + e.duration_ns()
                                               for e in dev_sorted], np.int64))

    def idle_at(t):
        """No device event in flight at ``t`` (every one started before it
        has ended)."""
        k = np.searchsorted(dev_starts, t, side="left")
        return k == 0 or dev_ends[k - 1] <= t

    spans = {k: [(int(s.start_ns[j]) + tie, int(s.end_ns[j]) + tie) for j in s.named(k)]
             for k in KERNELS}
    launch_in, launch_out = 0, []
    after_start, before_end, latency = [], [], []
    idle_ok, idle_bad, offsets = 0, [], []
    for e in dev_ev:
        kind = next((k for k, n in KERNELS.items() if n in e.name()), None)
        L = launches.get(e.correlation_id())
        if kind is None or L is None:
            continue
        inside = [sp for sp in spans[kind] if sp[0] <= L <= sp[1]]
        if inside:
            launch_in += 1
        else:
            near = min(spans[kind], key=lambda sp: min(abs(L - sp[0]), abs(L - sp[1])))
            launch_out.append((L - near[0]) / 1e3)
            continue
        a0, a1 = inside[0]
        after_start.append((L - a0) / 1e3)
        before_end.append((a1 - L) / 1e3)
        if idle_at(L):
            latency.append((e.start_ns() - L) / 1e3)
            off = (e.start_ns() - a0) / 1e3
            offsets.append(off)
            if 0.0 <= off <= 200.0:
                idle_ok += 1
            else:
                idle_bad.append(off)

    # without the runtime's launch records: each kernel span that opens on an
    # idle card, and the first of its kernels that starts after a point 1 ms
    # before it (a frame's ICP launches a K1 every few ms)
    first_ok, first_bad = 0, []
    for kind, name in KERNELS.items():
        ks = np.array(sorted(e.start_ns() for e in dev_ev if name in e.name()), np.int64)
        for a0, _ in spans[kind]:
            if not len(ks) or not idle_at(a0):
                continue
            k = np.searchsorted(ks, a0 - 1_000_000, side="left")
            if k == len(ks):
                continue
            off = (int(ks[k]) - a0) / 1e3
            if 0.0 <= off <= 200.0:
                first_ok += 1
            else:
                first_bad.append(off)

    fills = sorted((e.start_ns(), e.correlation_id()) for e in dev_ev
                   if "FillFunctor" in e.name())
    marker_tie = marker_launch = None
    if fills and hs.mark_ns is not None:
        marker_tie = fills[0][0] - hs.mark_ns
        if fills[0][1] in launches:  # the fill's launch on the host, not its start
            marker_launch = launches[fills[0][1]] - hs.mark_ns

    cost_off = span_cost_ns(profiling)
    with profile(activities=[ProfilerActivity.CUDA]):
        cost_on = span_cost_ns(profiling)
    launch_off = [launch_ns(torch) for _ in range(3)]
    with profile(activities=[ProfilerActivity.CUDA]):
        launch_on = [launch_ns(torch) for _ in range(3)]
    per_launch = statistics.median(launch_on) - statistics.median(launch_off)
    owners = innermost(s, tie, sorted(e.start_ns() for e, d in zip(evs, is_dev)
                                      if not d and "Launch" in e.name()))
    by_name = {}
    for r in owners:
        n = "(none)" if r < 0 else s.names[r]
        by_name[n] = by_name.get(n, 0) + 1
    records = len(s.names)
    own = s.self_ns()
    self_ms = dict(sorted(
        ((n, float(own[s.named(n)].sum()) / 1e6 / steps) for n in set(s.names)),
        key=lambda x: -x[1]))
    out = {
        "device": power_limit(), "cell": args.cell, "seed": args.seed,
        "requests": s.requests, "records": records, "dropped": s.dropped,
        "launch_in_span": {"inside": launch_in, "outside": len(launch_out),
                           "outside_us_from_span_start": launch_out[:10]},
        "idle_start": {"within_0_200us": idle_ok, "outside": len(idle_bad),
                       "outside_us": idle_bad[:10],
                       "us_after_span_start": summary(offsets)},
        "first_kernel": {"within_0_200us": first_ok, "outside": len(first_bad),
                         "outside_us": first_bad[:10]},
        "launch_us_after_span_start": summary(after_start),
        "launch_us_before_span_end": summary(before_end),
        "kernel_us_after_launch_on_idle_card": summary(latency),
        "marker_tie_us": None if marker_tie is None else (marker_tie - tie) / 1e3,
        "marker_launch_tie_us": None if marker_launch is None else (marker_launch - tie) / 1e3,
        "span_ns_off": cost_off, "span_ns_on": cost_on,
        "spans_a_request": records / s.requests,
        "tracer_ms_a_request": records / s.requests * cost_on / 1e6,
        "window_ms_a_request": statistics.median(window) * 1e3,
        "window_ms_mean": sum(window) / len(window) * 1e3,
        "slice_ms_a_request": slice_s / steps * 1e3,
        "self_ms_a_request": self_ms,
        "launch_ns_off": launch_off, "launch_ns_on": launch_on,
        "profiler_ns_a_launch": per_launch,
        "launches_a_request": {n: by_name.get(n, 0) / steps for n in self_ms},
        "launches_outside_spans_a_request": by_name.get("(none)", 0) / steps,
        "profiler_ms_a_request": len(owners) * per_launch / 1e6 / steps,
        "self_ms_less_profiler": {
            n: ms - by_name.get(n, 0) * per_launch / 1e6 / steps for n, ms in self_ms.items()},
    }
    drv.free()
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    ok = (launch_in and not launch_out and out["marker_launch_tie_us"] is not None
          and abs(out["marker_launch_tie_us"]) <= 50.0)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
