"""The port's ``apps/main_realsense`` end to end on the CPU at 128x96, with
a stub detector whose mask is the camera's true silhouette (depth > 0), on
the 0.3-scale L-shape of ``tests/test_torch_offline.py`` and its 5-view
template database: the synthetic source (the point-splat camera turning
0.01 rad a frame) through warm-up, the template search and tracking; the
same frames recorded by ``camera/record.py`` and replayed, whose poses equal
the live run's bit for bit (PNG and ``.npy`` are lossless, and the replay
takes the recorded depth as it is); and ``--multi`` (``MultiTracker``),
which acquires the object."""
import numpy as np
import pytest
import torch

from poseestimator_tpu_torch.apps import main_realsense as app
from poseestimator_tpu_torch.camera.record import record
from poseestimator_tpu_torch.geom3d.camera import Intrinsics
from poseestimator_tpu_torch.models.yolo.nms import Detections
from poseestimator_tpu_torch.pipeline import multi_tracking, tracking

from test_torch_offline import scene  # noqa: F401 (fixtures)
from torch_threads import two_threads  # noqa: F401

SMALL = Intrinsics.from_fov(60.0, 128, 96)
FRAMES = 6  # 10 warm-up frames make the first result, then 5 tracked
MULTI_FRAMES = 4


class DepthSilhouette:
    """The detector: one detection, the camera's depth > 0 as its mask and
    the mask's bounding box."""

    def __init__(self, *args, **kwargs):
        self.cam = None

    def __call__(self, img, conf=0.7, iou=0.7):
        m = self.cam.depth > 0
        ys, xs = torch.nonzero(m, as_tuple=True)
        box = torch.stack([xs.min(), ys.min(), xs.max(), ys.max()]).float()[None]
        det = Detections(boxes=box, scores=torch.ones(1),
                         classes=torch.zeros(1, dtype=torch.int64),
                         coeffs=torch.zeros(1, 32), valid=torch.ones(1, dtype=torch.bool))
        return det, m[None], box


@pytest.fixture
def wired(monkeypatch):
    """The app with the stub detector and a 128x96 camera; the poses each
    ``Tracker`` result carries, and the tracks of each ``MultiTracker``
    frame."""
    stub = DepthSilhouette()
    monkeypatch.setattr(app, "Detector", lambda *a, **k: stub)
    make = app.make_camera

    def make_small(args, intr):
        stub.cam = make(args, SMALL)
        return stub.cam

    monkeypatch.setattr(app, "make_camera", make_small)
    out = {"poses": [], "tracks": [], "make": make}
    rec = tracking.Tracker._record

    def _record(self, res):
        out["poses"].append(None if res.T_m2c is None else np.array(res.T_m2c))
        return rec(self, res)

    monkeypatch.setattr(tracking.Tracker, "_record", _record)
    step = multi_tracking.MultiTracker.step

    def multi_step(self):
        res = step(self)
        if res is not None:
            out["tracks"].append(len(res.tracks))
        return res

    monkeypatch.setattr(multi_tracking.MultiTracker, "step", multi_step)
    return out


def _argv(scene, source, *extra, frames=FRAMES):  # noqa: F811
    return ["--weights", "unused", "--pcd-path", str(scene["dir"] / "views_full"),
            "--cad-path", scene["cad"], "--source", source, "--headless", "--max-frames",
            str(frames), "--target-pts", "300", "--icp-dist", "0.05", "--view-set", "reduced",
            "--init-rollout", "0", "--device", "cpu", *extra]


def test_synthetic_then_replay_of_its_recording(scene, wired, tmp_path):  # noqa: F811
    assert app.main(_argv(scene, "synthetic")) == 0
    live = list(wired["poses"])
    assert len(live) == FRAMES and all(np.isfinite(P).all() for P in live)
    # the same camera, recorded: the warm-up frames and the tracked ones
    args = type("A", (), {"source": "synthetic", "cad_path": scene["cad"], "device": "cpu"})
    n = 10 + FRAMES - 1
    assert record(wired["make"](args, SMALL), str(tmp_path / "rec"), n, verbose=False) == n
    wired["poses"].clear()
    assert app.main(_argv(scene, f"replay:{tmp_path / 'rec'}")) == 0
    replay = wired["poses"]
    assert len(replay) == FRAMES
    for a, b in zip(live, replay):
        np.testing.assert_array_equal(b, a)


def test_multi(scene, wired):  # noqa: F811
    assert app.main(_argv(scene, "synthetic", "--multi", frames=MULTI_FRAMES)) == 0
    assert wired["tracks"] == [1] * MULTI_FRAMES


def test_detector_dtype_bfloat16(scene, wired, monkeypatch):  # noqa: F811
    """``--detector-dtype bfloat16`` runs the session with the app's
    detector built in bfloat16 (the fused bfloat16 frame itself is held to
    the JAX package's in ``tests/test_torch_bf16.py``)."""
    seen = {}
    make = app.Detector
    monkeypatch.setattr(app, "Detector", lambda *a, **k: (seen.update(k), make(*a, **k))[1])
    assert app.main(_argv(scene, "synthetic", "--detector-dtype", "bfloat16", frames=2)) == 0
    assert seen["dtype"] == "bfloat16"
    assert len(wired["poses"]) == 2 and all(np.isfinite(P).all() for P in wired["poses"])
