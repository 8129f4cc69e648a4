"""Profiling hooks (counterpart of ``poseestimator_tpu/utils/profiling.py``):
per-stage wall times that wait for the device's work, an opt-in
``torch.profiler`` trace of a block, and the device's kernels and busy time
over a few calls (the per-stage profilers, ``apps/profile_stages.py`` and
``apps/profile_search.py``).

The program's tracer, below them: ``span(name)`` around a stage and
``count(name, n)`` of the work done in it, recorded only while a
``torch.profiler`` session is active (``torch_trace``, or a benchmark's
traced slice), and read back with ``last_session()``; a profiler started
right after another, with no request between them, takes a
``new_session()`` first. The first span
opened while none is open is a request's root; it alone asks the profiler
whether it is on, and every span and counter inside it tests one
module-level flag. With the profiler off a request reads no clock and
records nothing. Nothing goes into the profiler's own trace: a
``record_function`` costs microseconds even with the profiler off, and
could add device-typed events to the trace. A session records the tie of
its ``perf_counter_ns`` spans to the profiler's clock (the Unix clock), so
a device event can be placed under the span open when it started. The
tracer follows the requests of one thread, as the program makes them.
"""
from __future__ import annotations

import contextlib
import functools
import glob
import inspect
import json
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
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
    a card), written to ``log_dir`` as a Chrome trace, with the program's
    spans of the block beside it (``program_spans.json``, on the trace's
    clock); a no-op when ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    before = _last
    new_session()
    with torch.profiler.profile(activities=acts,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield
    if _last is not before:  # the block ran requests: their spans beside the trace
        traces = sorted(glob.glob(os.path.join(log_dir, "*.pt.trace.json")), key=os.path.getmtime)
        base = 0
        if traces:
            with open(traces[-1]) as f:
                base = int(json.load(f).get("baseTimeNanoseconds", 0))
        last_session().write_chrome(os.path.join(log_dir, "program_spans.json"), base)


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


# --- the program's tracer --------------------------------------------------

CAPACITY = 1 << 17  # span records a session keeps; the rest are counted as dropped


class _Null:
    """The span of a request that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        return False


class _OffRoot(_Null):
    """The root of a request with the profiler off: closing it ends the
    request."""

    __slots__ = ()

    def __exit__(self, et, ev, tb):
        global _active
        _active = None
        return False


_NULL = _Null()
_OFF_ROOT = _OffRoot()
_OFF = object()  # _active while a request that records nothing is open
# None outside a request, _OFF inside one with the profiler off, else the
# recording _Recorder: the one flag every inner span and counter tests
_active = None
_last = None  # the newest session's _Recorder
_fresh = True  # the next root that finds the profiler on starts a session


def span(name: str, a=None, b=None, c=None):
    """A context manager around one stage of a request; ``a``, ``b``, ``c``
    are sizes that explain the work (a batch, point counts). The first
    span opened while none is open is the request's root."""
    s = _active
    if s is _OFF:
        return _NULL
    if s is None:
        return _root(name, a, b, c)
    return s.open(name, a, b, c)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the request's counter ``name``."""
    s = _active
    if s is _OFF or s is None:
        return
    s.add(name, n)


def host_read():
    """A context manager around one device-to-host read: a ``read`` span
    and one ``host_reads``."""
    sp = span("read")
    count("host_reads")
    return sp


def _root_only(name: str):
    """A span ``name`` that opens only as a request's root: inside a
    request it records nothing."""
    return _root(name, None, None, None) if _active is None else _NULL


def traced(name: str, only_root: bool = False):
    """Decorator: every call of the function, or every run of the generator
    function, in a span ``name`` (``only_root``: only where it opens a
    request)."""
    opener = _root_only if only_root else span

    def wrap(fn):
        if inspect.isgeneratorfunction(fn):
            @functools.wraps(fn)
            def program(*args, **kwargs):
                with opener(name):
                    return (yield from fn(*args, **kwargs))

            return program

        @functools.wraps(fn)
        def call(*args, **kwargs):
            with opener(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def strands(n: int) -> list:
    """The contexts in which ``n`` interleaved programs
    (``chains.run_batched``) run: a ``Strand`` each while recording."""
    s = _active
    if s is _OFF or s is None:
        return [_NULL] * n
    return [Strand(s) for _ in range(n)]


def new_session() -> None:
    """Make the next request that finds the profiler on start a session of
    its own: call it before starting a ``torch.profiler`` session when the
    one before may have ended with no request run in between
    (``torch_trace`` does)."""
    global _fresh
    _fresh = True


def _root(name, a, b, c):
    global _active, _last, _fresh
    if not torch.autograd._profiler_enabled():
        _active = _OFF
        _fresh = True
        return _OFF_ROOT
    if _fresh:
        _last = _Recorder(CAPACITY)
        _fresh = False
    _active = _last
    _last.requests += 1
    return _last.open(name, a, b, c)


def _unix_tie() -> int:
    """``time.time_ns()`` less ``time.perf_counter_ns()``: the profiler's
    timestamps are on the Unix clock. The closest of five readings."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, u - (a + b) // 2)
    return best[1]


class _Span:
    __slots__ = ("rec", "name", "attrs", "first", "seg")

    def __init__(self, rec, name, attrs):
        self.rec, self.name, self.attrs = rec, name, attrs
        self.first = -1  # record of the span's first segment
        self.seg = -1  # record of its open segment (-1: dropped)

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        self.rec.close(self)
        return False


class Strand:
    """The open spans of one interleaved program. Entering it re-opens them
    as new segments under the current span; leaving it closes the
    segments the program leaves open and keeps them for its next
    resumption. So each resumption is charged to the program's own
    innermost span, and every record nests in its parent."""

    __slots__ = ("rec", "saved", "base")

    def __init__(self, rec):
        self.rec, self.saved, self.base = rec, [], 0

    def __enter__(self):
        rec = self.rec
        self.base = len(rec.stack)
        for sp in self.saved:
            rec.push(sp)
        self.saved = []
        return self

    def __exit__(self, et, ev, tb):
        stack = self.rec.stack
        t = time.perf_counter_ns()
        self.saved = stack[self.base:]
        del stack[self.base:]
        for sp in self.saved:
            if sp.seg >= 0:
                self.rec.end[sp.seg] = t
        return False


class _Recorder:
    """A session's bounded store of span records (one per span, or per
    segment of an interleaved program's span) and its counters."""

    def __init__(self, cap: int):
        self.cap = cap
        self.n = 0
        self.dropped = 0
        self.requests = 0
        self.names = [None] * cap
        self.attrs = [None] * cap
        self.parent = [0] * cap
        self.request = [0] * cap
        self.first = [0] * cap
        self.start = [0] * cap
        self.end = [0] * cap
        self.counters: dict = {}
        self.stack: list = []
        self.tie_ns = _unix_tie()

    def open(self, name, a, b, c):
        sp = _Span(self, name, None if a is None else (a, b, c))
        self.push(sp)
        return sp

    def push(self, sp) -> None:
        i = self.n
        stack = self.stack
        if i < self.cap:
            self.n = i + 1
            if sp.first < 0:
                sp.first = i
            self.names[i] = sp.name
            self.attrs[i] = sp.attrs
            self.parent[i] = stack[-1].seg if stack else -1
            self.request[i] = self.requests - 1
            self.first[i] = sp.first
            sp.seg = i
            stack.append(sp)
            self.start[i] = time.perf_counter_ns()
        else:
            self.dropped += 1
            sp.seg = -1
            stack.append(sp)

    def close(self, sp) -> None:
        t = time.perf_counter_ns()
        stack = self.stack
        if stack and stack[-1] is sp:
            stack.pop()
            if sp.seg >= 0:
                self.end[sp.seg] = t
        elif sp in stack:  # spans left open above it (an abandoned generator) close with it
            while stack:
                top = stack.pop()
                if top.seg >= 0:
                    self.end[top.seg] = t
                if top is sp:
                    break
        else:  # its program was left suspended: its last segment is closed already
            return
        if not stack:
            global _active
            _active = None

    def add(self, name, n) -> None:
        per = self.counters.get(name)
        if per is None:
            per = self.counters[name] = {}
        r = self.requests - 1
        per[r] = per.get(r, 0) + n


@dataclass(frozen=True)
class Session:
    """What the tracer recorded while one ``torch.profiler`` session was
    active: one record per span (per segment of an interleaved program's
    span), on the ``perf_counter_ns`` clock, each under its parent record
    (-1: a request's root) and in its request; the counters per request;
    ``tie_ns``, the profiler's clock less ``perf_counter_ns``; ``dropped``,
    the records the store had no room for (then the tree is incomplete)."""

    names: list
    attrs: list
    start_ns: np.ndarray
    end_ns: np.ndarray
    parent: np.ndarray
    request: np.ndarray
    first: np.ndarray
    counters: dict
    requests: int
    tie_ns: int
    dropped: int

    def duration_ns(self) -> np.ndarray:
        return self.end_ns - self.start_ns

    def self_ns(self) -> np.ndarray:
        """Each record's duration less what its children cover (children
        nest in their parent and do not overlap)."""
        dur = self.duration_ns()
        kids = self.parent >= 0
        covered = np.bincount(self.parent[kids], weights=dur[kids], minlength=len(dur))
        return dur - covered.astype(np.int64)

    def named(self, name: str) -> np.ndarray:
        """Indices of the records of ``name``."""
        return np.flatnonzero(np.array([n == name for n in self.names], bool))

    def counter(self, name: str) -> int:
        """The counter's total over the session's requests."""
        return int(sum(self.counters.get(name, {}).values()))

    def write_chrome(self, path: str, base_ns: int = 0) -> None:
        """The records as Chrome trace events on the profiler's clock, ``ts``
        in microseconds after ``base_ns``; a root's args carry its
        request's counters."""
        own = self.self_ns()
        events = []
        for i, name in enumerate(self.names):
            args = {"request": int(self.request[i]), "self_us": own[i] / 1e3}
            if self.attrs[i] is not None:
                args["sizes"] = [x for x in self.attrs[i] if x is not None]
            if self.parent[i] < 0:
                args.update({k: v.get(int(self.request[i]), 0)
                             for k, v in self.counters.items()})
            events.append({"name": name, "ph": "X", "pid": "program", "tid": 0,
                           "ts": (int(self.start_ns[i]) + self.tie_ns - base_ns) / 1e3,
                           "dur": int(self.end_ns[i] - self.start_ns[i]) / 1e3, "args": args})
        with open(path, "w") as f:
            json.dump({"baseTimeNanoseconds": base_ns, "displayTimeUnit": "ms",
                       "dropped": self.dropped, "traceEvents": events}, f)


def last_session() -> Optional[Session]:
    """The newest session's records (None before the first): a session
    starts at the first root that finds the profiler on after a root that
    found it off, or after ``new_session()``."""
    r = _last
    if r is None:
        return None
    n = r.n
    ints = lambda a: np.array(a[:n], np.int64)  # noqa: E731
    return Session(names=r.names[:n], attrs=r.attrs[:n], start_ns=ints(r.start),
                   end_ns=ints(r.end), parent=ints(r.parent), request=ints(r.request),
                   first=ints(r.first),
                   counters={k: dict(v) for k, v in r.counters.items()},
                   requests=r.requests, tie_ns=r.tie_ns, dropped=r.dropped)
