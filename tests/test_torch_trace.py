"""The program's tracer (``utils/profiling.py``: ``span``, ``count``,
``host_read``, ``last_session``) on the CPU: the span trees of a fused
frame, a batched track step at B = 3 and a 2-view template search under
``torch.profiler``, where every record nests in its parent and the self
times of a request's records add up to its root's duration; the
``host_reads`` counter against the reads the code makes; results bit for
bit the same with the tracer on and off; nothing recorded, and no clock
read, with no profiler; no profiler event named after a span; the Chrome
export of ``torch_trace``; and the benchmark's readers of the spans
(``benchmark/metrics/host_reads.py``, ``read_wait_ms.py``,
``icp_self_ms.py``, ``detect_device_ms.py``) on built readings."""
import json
import os
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import registry
from poseestimator_tpu_torch import kernel_cases as kc
from poseestimator_tpu_torch.apps._scene import make_scene
from poseestimator_tpu_torch.geom3d.camera import Intrinsics
from poseestimator_tpu_torch.models.yolo.model import YOLO11Seg, init_random_
from poseestimator_tpu_torch.pipeline.pose_estimator import PoseEstimator
from poseestimator_tpu_torch.pipeline.tracking import FusedFrame, track_step_batched
from poseestimator_tpu_torch.render.mesh import pad_faces
from poseestimator_tpu_torch.render.raster import render_depth_mesh_batched
from poseestimator_tpu_torch.utils import profiling
from torch_threads import two_threads  # noqa: F401

W, H = 160, 120
INTR = Intrinsics.from_fov(60.0, W, H)
WIN = (32, 64)
# every way the code brings a tensor's value to the host (a ``.numpy()``
# follows a ``.cpu()`` throughout the port, and reads nothing more), and the
# modules whose reads a request makes on the device (``models/yolo/model.py``
# converts a tensor it made on the host)
READS = ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "cpu")
READERS = ("/pipeline/", "/registration/", "/chains.py", "/models/yolo/nms.py")


def _pose(yaw, x, z):
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    T[:3, 3] = [x, 0.0, z]
    return T


def _box():
    return (torch.from_numpy(kc.box_vertices()),
            torch.from_numpy(pad_faces(kc.BOX_FACES, 256).astype(np.int64)))


def _scene(T_obs):
    """Depth (H, W) of boxes at the poses ``T_obs`` (B, 4, 4), each box's
    silhouette (B, H, W)."""
    v, f = _box()
    deps = render_depth_mesh_batched(v, f, torch.from_numpy(T_obs), INTR, near=0.01, far=5.0)
    masks = deps > 0
    depth = torch.where(masks, deps, torch.full_like(deps, 1e9)).amin(0)
    return torch.where(depth < 1e8, depth, torch.zeros_like(depth)), masks


def _nudged(T_obs):
    d = np.eye(4, dtype=np.float32)
    d[:3, 3] = [0.004, -0.002, 0.003]
    return torch.from_numpy(np.stack([d @ T for T in T_obs]))


def _traced(fn):
    profiling.new_session()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, profiling.last_session(), prof


def _count_reads(monkeypatch, fn):
    """``fn()`` with every host conversion of a tensor in ``READERS``
    counted."""
    n, depth = [0], [0]
    for name in READS:
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **k):
            caller = sys._getframe(1).f_code.co_filename.replace(os.sep, "/")
            # a conversion inside another is the same read
            n[0] += depth[0] == 0 and any(m in caller for m in READERS)
            depth[0] += 1
            try:
                return _orig(self, *a, **k)
            finally:
                depth[0] -= 1

        monkeypatch.setattr(torch.Tensor, name, counted)
    try:
        return fn(), n[0]
    finally:
        monkeypatch.undo()


def _check_tree(s, roots):
    """Every record nests in its parent, self times are not negative, and
    each request's self times add up to its root's duration."""
    assert s.dropped == 0 and s.requests == len(roots)
    top = np.flatnonzero(s.parent < 0)
    assert [s.names[i] for i in top] == roots
    p = np.maximum(s.parent, 0)
    kid = s.parent >= 0
    assert (s.end_ns >= s.start_ns).all()
    assert (s.start_ns[kid] >= s.start_ns[p[kid]]).all()
    assert (s.end_ns[kid] <= s.end_ns[p[kid]]).all()
    own = s.self_ns()
    assert own.min() >= 0
    for r, i in enumerate(top):
        total = own[s.request == r].sum()
        assert abs(total - s.duration_ns()[i]) <= 0.01 * s.duration_ns()[i]


def _under(s, name, parent):
    """Records of ``name`` whose parent record is a ``parent``."""
    return [i for i in s.named(name) if s.parent[i] >= 0 and s.names[s.parent[i]] == parent]


@pytest.fixture(scope="module")
def fused():
    T_obs = _pose(0.4, 0.0, 0.5)[None]
    depth, masks = _scene(T_obs)
    v, f = _box()
    model = init_random_(YOLO11Seg(nc=5, scale="n"), torch.Generator().manual_seed(0))
    frame = FusedFrame(model, v, f, INTR, win_hw=WIN, imgsz=64, max_det=32, device="cpu")
    color = torch.from_numpy(np.random.default_rng(0).integers(0, 255, (H, W, 3), np.uint8))

    def run():
        return frame(color, depth, _nudged(T_obs)[0], conf=0.25, icp_dist=0.01,
                     mask_union=masks[0], generator=torch.Generator().manual_seed(1))

    return run


def _same(a, b):
    for k in ("T", "ok", "fitness", "rmse", "cov"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert a.n_iters == b.n_iters


def test_fused_frame_spans_and_reads(fused, monkeypatch):
    off, n_reads = _count_reads(monkeypatch, fused)
    on, s, prof = _traced(fused)
    _same(on, off)
    _check_tree(s, ["frame"])
    assert {s.names[i] for i in np.flatnonzero(s.parent == 0)} == {"detect", "track"}
    assert len(_under(s, "detect.forward", "detect")) == 1
    assert len(_under(s, "icp", "track.icp")) == 1
    n_icp_reads = len(_under(s, "read", "icp"))
    # the ICP reads its loop flag before each body and stops without a read
    # at the cap; NMS reads once every _CHECK_EVERY rounds; nothing else reads
    assert n_icp_reads == min(off.n_iters + 1, 30)
    assert len(_under(s, "k1", "icp")) == off.n_iters + 1
    nms_reads = len(_under(s, "read", "detect.nms"))
    assert nms_reads >= 1
    assert s.counter("host_reads") == n_icp_reads + nms_reads == n_reads == len(s.named("read"))
    # the tracer adds nothing to the profiler's own trace
    assert not {e.name for e in prof.events()} & set(s.names)


def test_batched_step_spans_and_reads(monkeypatch):
    T_obs = np.stack([_pose(0.4, -0.12, 0.5), _pose(0.2, 0.0, 0.55), _pose(0.6, 0.12, 0.6)])
    depth, masks = _scene(T_obs)
    v, f = _box()

    def run():
        return track_step_batched(v, f, masks, depth, _nudged(T_obs), INTR,
                                  torch.tensor([0.05, 0.02, 0.01]), win_hw=WIN,
                                  generator=torch.Generator().manual_seed(0))

    off, n_reads = _count_reads(monkeypatch, run)
    on, s, _ = _traced(run)
    for k in ("T", "fitness", "rmse", "cov"):
        assert torch.equal(getattr(on, k), getattr(off, k)), k
    assert on.n_iters == off.n_iters and len(set(off.n_iters)) > 1
    _check_tree(s, ["batch"])
    first = s.first == np.arange(len(s.names))
    # three programs, each span cut into a segment per resumption
    for name in ("track", "icp"):
        segs = s.named(name)
        assert first[segs].sum() == 3 < len(segs)
    # the batched serves belong to the batch: one flag read a round
    rounds = max(min(n + 1, 30) for n in off.n_iters)
    assert len(_under(s, "read", "batch")) == rounds == s.counter("host_reads") == n_reads
    assert len(_under(s, "k1", "batch")) == max(off.n_iters) + 1


@pytest.fixture(scope="module")
def search_scene():
    intr = Intrinsics.from_fov(60.0, 128, 96)
    with tempfile.TemporaryDirectory() as work:
        sc = make_scene(intr, np.random.default_rng(0), "cpu", work)
    est = sc.estimator
    tpl = [a[:2].numpy() for a in (est._tpl_points, est._tpl_valid, est._tpl_fpfh)]

    def run():
        two = PoseEstimator.from_prepared(est.mesh, intr, *tpl, seed=1, device="cpu")
        return two.find_best_template_candidates(sc.dst_cloud, mask=sc.obj_sil)

    return run


def test_search_spans_and_reads(search_scene, monkeypatch):
    (H0, _, c0), n_reads = _count_reads(monkeypatch, search_scene)
    (H1, _, c1), s, _ = _traced(search_scene)
    np.testing.assert_array_equal(H0, H1)
    assert len(c0) == len(c1) == 2
    for a, b in zip(c0, c1):
        assert a[0] == b[0] and a[2] == b[2]
        np.testing.assert_array_equal(a[1], b[1])
    _check_tree(s, ["search"])
    stages = [s.names[i] for i in np.flatnonzero(s.parent == 0)]
    for stage in ("search.prep", "search.hypotheses", "search.coarse", "search.scores"):
        assert stage in stages
    assert [s.attrs[i][0] for i in s.named("search.polish")] == [0, 1, 2]
    assert len(_under(s, "icp", "search.coarse")) == 1
    assert len(_under(s, "icp", "search.polish")) == 3
    assert s.counter("host_reads") == n_reads == len(s.named("read"))


def test_nothing_recorded_without_a_profiler(fused, monkeypatch):
    _traced(fused)
    before = profiling.last_session()

    def no_clock():
        raise AssertionError("the tracer read the clock with the profiler off")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    fused()
    monkeypatch.undo()
    after = profiling.last_session()
    assert profiling._active is None
    assert len(after.names) == len(before.names) and after.requests == before.requests
    np.testing.assert_array_equal(after.start_ns, before.start_ns)


def _requests(n):
    for _ in range(n):
        with profiling.span("a"):
            with profiling.host_read():
                pass


def test_sessions_and_dropped_records(monkeypatch):
    profiling.new_session()
    with profile(activities=[ProfilerActivity.CPU]):
        _requests(2)
    s = profiling.last_session()
    assert s.requests == 2 and s.names == ["a", "read", "a", "read"]
    assert s.counters == {"host_reads": {0: 1, 1: 1}} and s.counter("host_reads") == 2
    assert list(s.parent) == [-1, 0, -1, 2] and list(s.request) == [0, 0, 1, 1]
    # a request with the profiler off ends the session: the next starts anew
    _requests(1)
    with profile(activities=[ProfilerActivity.CPU]):
        _requests(1)
    assert profiling.last_session().requests == 1
    profiling.new_session()
    monkeypatch.setattr(profiling, "CAPACITY", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("a"):
            for _ in range(4):
                with profiling.span("b", 2, 3):
                    profiling.count("c", 5)
    s = profiling.last_session()
    assert s.requests == 1 and s.dropped == 2 and len(s.names) == 3
    assert s.attrs[1] == (2, 3, None) and s.counter("c") == 20
    assert profiling._active is None


def test_back_to_back_profilers_keep_their_sessions(tmp_path):
    """Two ``torch_trace`` blocks, and then two profilers with a
    ``new_session()`` between, with no request between them: a session
    each, and an export for each block."""
    sessions = []
    for k in range(2):
        log = str(tmp_path / f"trace{k}")
        with profiling.torch_trace(log):
            _requests(k + 1)
        sessions.append(profiling.last_session())
        with open(os.path.join(log, "program_spans.json")) as f:
            assert [e["name"] for e in json.load(f)["traceEvents"]] == ["a", "read"] * (k + 1)
    for k in range(2):
        profiling.new_session()
        with profile(activities=[ProfilerActivity.CPU]):
            _requests(k + 3)
        sessions.append(profiling.last_session())
    assert [s.requests for s in sessions] == [1, 2, 3, 4]
    assert [len(s.names) for s in sessions] == [2, 4, 6, 8]


def test_torch_trace_writes_program_spans(fused, tmp_path):
    log = str(tmp_path / "trace")
    with profiling.torch_trace(log):
        fused()
    s = profiling.last_session()
    with open(os.path.join(log, "program_spans.json")) as f:
        spans = json.load(f)
    trace = [n for n in os.listdir(log) if n.endswith(".pt.trace.json")]
    with open(os.path.join(log, trace[0])) as f:
        kineto = json.load(f)
    base = kineto.get("baseTimeNanoseconds", 0)
    assert spans["baseTimeNanoseconds"] == base and spans["dropped"] == 0
    ev = spans["traceEvents"]
    assert [e["name"] for e in ev] == s.names
    assert ev[0]["ts"] == pytest.approx((s.start_ns[0] + s.tie_ns - base) / 1e3)
    assert ev[0]["args"]["host_reads"] == s.counter("host_reads")
    # the program's spans lie where the profiler's own events of the frame lie
    ops = [e for e in kineto["traceEvents"] if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    lo, hi = ev[0]["ts"], ev[0]["ts"] + ev[0]["dur"]
    inside = [e for e in ops if lo <= e["ts"] <= hi]
    assert len(inside) >= 0.9 * len(ops)


# --- the benchmark's readers of the spans ------------------------------------


def _session(dropped=0):
    """A frame of 1000 ns: ``detect`` (100-400) and ``icp`` (500-900) with a
    K1 call (550-650) and a read (700-750) under it; three reads counted;
    the trace's clock 10 000 ns ahead."""
    names = ["frame", "detect", "icp", "k1", "read"]
    start = np.array([0, 100, 500, 550, 700], np.int64)
    end = np.array([1000, 400, 900, 650, 750], np.int64)
    return profiling.Session(
        names=names, attrs=[None] * 5, start_ns=start, end_ns=end,
        parent=np.array([-1, 0, 0, 2, 2]), request=np.zeros(5, np.int64),
        first=np.arange(5), counters={"host_reads": {0: 3}}, requests=1, tie_ns=10_000,
        dropped=dropped)


@pytest.mark.parametrize("name,want", [
    ("host_reads.frame", 3.0), ("host_reads.init", 3.0), ("read_wait_ms.frame", 50e-6),
    ("read_wait_ms.init", 50e-6), ("icp_self_ms.frame", 250e-6), ("icp_self_ms.init", 250e-6),
    ("detect_device_ms.frame", 50e-6)])
def test_readers_on_a_built_reading(monkeypatch, name, want):
    read = registry.module("metrics", name).read
    # device events at 150 (20 ns) and 390 (30 ns) inside detect, 450 and 90 outside
    events = [("k", 10_150, 20), ("k", 10_390, 30), ("k", 10_450, 5), ("k", 10_090, 7)]
    r = SimpleNamespace(events=events, slice_steps=1)
    monkeypatch.setattr(profiling, "last_session", lambda: _session())
    assert read(r) == pytest.approx(want)
    monkeypatch.setattr(profiling, "last_session", lambda: _session(dropped=1))
    assert read(r) is None
    monkeypatch.setattr(profiling, "last_session", _session)
    assert read(SimpleNamespace(events=[], slice_steps=1)) is None  # off the card
    assert read(SimpleNamespace(events=events, slice_steps=2)) is None  # fewer requests
    monkeypatch.delattr(profiling, "last_session")  # a program without the tracer
    assert read(r) is None
