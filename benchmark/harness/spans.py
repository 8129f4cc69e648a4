"""Host spans from the benchmark's side around the program's stages, kept in
the traced slice only: each wrapper notes its stage's start and end on the
host clock. They name the device's idle gaps by what the host was doing (the
innermost stage open at the middle of the gap). Spans inside the program
itself are a later change; these wrap module-level functions that the
program looks up at call time, so wrapping them changes no result."""
from __future__ import annotations

import bisect
import inspect
import time

import torch

from .record import _resolve

T = "poseestimator_tpu_torch.pipeline.tracking"
D = "poseestimator_tpu_torch.pipeline.detector"
P = "poseestimator_tpu_torch.pipeline.pose_estimator"
STAGES = (
    ("detect.letterbox", T, "letterbox"), ("detect.letterbox", D, "letterbox"),
    ("detect.forward", "poseestimator_tpu_torch.models.yolo.model", "YOLO11Seg.forward"),
    ("detect.decode", T, "decode_boxes"), ("detect.decode", D, "decode_boxes"),
    ("detect.nms", T, "nms"), ("detect.nms", D, "nms"),
    ("detect.masks", T, "assemble_masks"), ("detect.masks", D, "assemble_masks"),
    ("track.step", T, "track_step"),
    ("track.step_batched", "poseestimator_tpu_torch.pipeline.multi_tracking",
     "track_step_batched"),
    ("track.backproject", T, "backproject_depth"),
    ("track.sample", T, "random_sample"),
    ("track.outliers", T, "remove_statistical_outlier"),
    ("track.icp", T, "icp_point_to_point_program"),
    ("search.prep", P, "_prep_dst"), ("search.hypotheses", P, "_hypotheses"),
    ("search.coarse", P, "_coarse"), ("search.polish", P, "polish"),
    ("search.scores", P, "view_scores"),
    ("camera.cloud", "poseestimator_tpu_torch.camera.source", "_depth_to_cloud"),
)


class HostSpans:
    """While entered, each stage's calls add (name, start ns, end ns) on the
    ``perf_counter_ns`` clock; ``mark`` launches a fill whose device start
    ties that clock to the trace's."""

    def __init__(self):
        self.spans: list[tuple[str, int, int]] = []
        self._saved = []
        self.mark_ns = None

    def __enter__(self):
        for name, mod, attr in STAGES:
            owner, last = _resolve(mod, attr)
            orig = getattr(owner, last)
            self._saved.append((owner, last, orig))
            setattr(owner, last, self._wrap(name, orig))
        return self

    def _wrap(self, name, orig):
        spans = self.spans
        if inspect.isgeneratorfunction(orig):  # a program of ``chains``: span its whole run
            def program(*args, **kwargs):
                t0 = time.perf_counter_ns()
                try:
                    return (yield from orig(*args, **kwargs))
                finally:
                    spans.append((name, t0, time.perf_counter_ns()))

            return program

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter_ns()
            try:
                return orig(*args, **kwargs)
            finally:
                spans.append((name, t0, time.perf_counter_ns()))

        return wrapper

    def __exit__(self, *exc):
        for owner, last, orig in reversed(self._saved):
            setattr(owner, last, orig)
        self._saved.clear()

    def mark(self, device) -> None:
        """A one-element fill on the card, its launch time noted."""
        x = torch.empty(1, device=device)
        self.mark_ns = time.perf_counter_ns()
        x.fill_(0.5)

    def add_step(self, t0: int, t1: int) -> None:
        self.spans.append(("request", t0, t1))


def label_gaps(events, spans, mark_ns, k: int = 10) -> list[list]:
    """[[stage, seconds], ...] of the k stages with the most device idle
    time: each gap between device events goes to the innermost host span
    open at its middle (the latest-starting one that contains it)."""
    fills = [s for name, s, _ in events if "FillFunctor" in name]
    if mark_ns is None or not fills:
        return []
    offset = min(fills) - mark_ns  # device clock minus host clock
    spans = sorted(spans, key=lambda s: s[1])
    starts = [a for _, a, _ in spans]
    by: dict[str, int] = {}
    end = None
    for name, s, d in sorted(events, key=lambda e: e[1]):
        if end is not None and s > end:
            mid = (end + s) // 2 - offset
            inner = "outside the program's stages"
            j = bisect.bisect_right(starts, mid) - 1
            while j >= 0:  # the latest-starting span still open at mid
                if spans[j][2] >= mid:
                    inner = spans[j][0]
                    break
                j -= 1
            by[inner] = by.get(inner, 0) + (s - end)
        if end is None or s + d > end:
            end = s + d
    return [[n, t / 1e9] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]
