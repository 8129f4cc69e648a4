"""Port parity, ``apps/eval_tracking.py`` against the JAX package's
``tools/eval_tracking.py`` (the other evaluation and detection scripts
are in ``tests/test_torch_eval_scripts.py``). Tolerances, stated per
test:

- ``eval_tracking`` end to end (``--res 128x96 --frames 6 --modes 0``, the
  JAX package's own smoke run, in a subprocess beside the port's run): the
  row's keys equal the JAX row's in order, the frame accounting equal,
  ``frames_tracked`` within 1, both ADD-S means under the JAX test's 5 cm
  and within 0.5 cm of each other (randomness is not bit-matched; at this
  size the splat instrument puts both near 2.8 cm);
- the row math on one seeded pose series: ADD-S, MSSD, MSPD and VSD per
  frame and the BOP Average Recall within 1e-5 of the JAX package's
  functions;
- the degraded masks bit-equal to the JAX script's cv2 recipe on the same
  numpy generator, single and per instance;
- the ``trained-ckpt`` round trip: the port's fp16 checkpoint gives the
  detections of a ``Detector`` on the fp16-rounded weights, bit for bit;
- ``--objects 2`` at 128x96: the JAX multi-object test's gates;
"""
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

from poseestimator_tpu_torch import kernel_cases as kc
from poseestimator_tpu_torch.apps import eval_tracking
from poseestimator_tpu_torch.geom3d.camera import Intrinsics
from poseestimator_tpu_torch.geom3d.cloud import from_points
from torch_threads import two_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = ["--cpu", "--res", "128x96", "--frames", "6", "--modes", "0"]


@pytest.fixture(scope="module", autouse=True)
def jax_smoke_row(tmp_path_factory):
    """The JAX package's tools/eval_tracking.py on SMOKE, in a subprocess
    started with the module's first test, so that it runs while the port's
    tests do (the parity test that reads it comes last)."""
    out = tmp_path_factory.mktemp("jax_et") / "rows.json"
    # one device, two threads: the run is serial, and the workers beside it
    # keep the cores
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2",
           "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=2"}
    proc = subprocess.Popen([sys.executable, os.path.join(REPO, "tools", "eval_tracking.py"),
                             *SMOKE, "--json-out", str(out)], cwd=REPO, env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)

    def row():
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err[-2000:]
        return json.loads(out.read_text())[0]
    yield row
    if proc.poll() is None:
        proc.kill()


def _series(n=12, seed=0):
    """A seeded pose series about the evaluation's view: truths turning
    about z, estimates a few mm and mrad off."""
    rng = np.random.default_rng(seed)
    base = eval_tracking._look_at_cv(np.ones(3) / np.sqrt(3) * 1.6)
    gts, ests = [], []
    for i in range(n):
        T = (eval_tracking._rot_z(0.1 + 0.008 * i) @ base).astype(np.float32)
        w = rng.normal(0, 0.01, 3)
        th = np.linalg.norm(w)
        Kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
        R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
        E = T.astype(np.float64).copy()
        E[:3, :3] = R @ E[:3, :3]
        E[:3, 3] += rng.normal(0, 0.004, 3)
        gts.append(T)
        ests.append(E.astype(np.float32))
    return ests, gts


def test_row_math_matches_jax():
    import jax.numpy as jnp

    from poseestimator_tpu import geom3d as g3
    from poseestimator_tpu.render import vsd_multi_tau as j_vsd
    from poseestimator_tpu.utils.bop import BOP_FRACS, bop_average_recall as j_ar

    from poseestimator_tpu_torch.render.mesh import TriangleMesh

    v, f = kc.lshape_mesh()
    mesh = TriangleMesh(v, f)
    diag = float(np.linalg.norm(mesh.extent))
    model = mesh.sample_points_uniformly(512, np.random.default_rng(0))[0]
    cad = mesh.sample_points_uniformly(20_000, np.random.default_rng(1))[0]
    intr = Intrinsics.from_fov(60.0, 128, 96)
    jintr = g3.Intrinsics.from_fov(60.0, 128, 96)
    ests, gts = _series()
    mp = from_points(model, device="cpu")
    cad_t = torch.from_numpy(cad)
    cad_v = torch.ones(len(cad), dtype=torch.bool)
    jm = g3.from_points(jnp.asarray(model))
    K = jnp.asarray(jintr.K, jnp.float32)
    taus = jnp.asarray(BOP_FRACS * diag, jnp.float32)
    got = [eval_tracking.frame_metrics(E, G, mp, cad_t, cad_v, intr, diag) for E, G in zip(ests, gts)]
    for (a, ms, mp_, vsd), E, G in zip(got, ests, gts):
        E, G = jnp.asarray(E), jnp.asarray(G)
        np.testing.assert_allclose(a, float(g3.adds_metric(E, G, jm)), atol=1e-5)
        np.testing.assert_allclose(ms, float(g3.mssd_metric(E, G, jm)), atol=1e-5)
        np.testing.assert_allclose(mp_, float(g3.mspd_metric(E, G, K, jm)), atol=1e-5)
        np.testing.assert_allclose(vsd, np.asarray(j_vsd(E, G, jnp.asarray(cad),
                                                         jnp.ones(len(cad), bool), jintr, taus)),
                                   atol=1e-5)
    adds, mssd, mspd, vsd = (np.asarray(x) for x in zip(*got))
    frames = [13 + i + (i >= 5) for i in range(len(ests))]  # a frame lost: no jitter across it
    row = eval_tracking.series_row(adds, mssd, mspd, vsd, diag, 128, ests, gts, frames,
                                   sig_t=[1.0] * len(ests), sig_r=[0.1] * len(ests))
    want = j_ar(vsd, mssd, mspd, diameter=diag, image_width=128)
    for k, val in want.items():
        assert abs(row[k] - val) <= 1e-5, k
    assert row["adds_mean_cm"] == round(float(adds.mean()) * 100, 2)
    assert row["vsd_mean"] == round(float(vsd[:, 1].mean()), 4)
    # the JAX script's jitter loop over the same series
    jt, prev = [], None
    for E, G, fr in zip(ests, gts, frames):
        E, G = np.asarray(E, np.float64), np.asarray(G, np.float64)
        if prev is not None and fr == prev[2] + 1:
            D = (E @ np.linalg.inv(prev[0])) @ np.linalg.inv(G @ np.linalg.inv(prev[1]))
            jt.append(float(np.linalg.norm(D[:3, 3])))
        prev = (E, G, fr)
    assert len(jt) == len(ests) - 2
    assert row["jitter_t_mm"] == round(float(np.mean(jt)) * 1000, 3)


def _cv2_degrade(m, px, rng):
    """tools/eval_tracking.py:464-475 and :212-226, verbatim."""
    m = m.astype(np.uint8)
    if px > 0:
        k = 2 * rng.integers(1, px + 1) + 1
        kernel = np.ones((k, k), np.uint8)
        m = (cv2.erode if rng.random() < 0.5 else cv2.dilate)(m, kernel)
    ring = cv2.dilate(m, np.ones((3, 3), np.uint8)) - cv2.erode(m, np.ones((3, 3), np.uint8))
    flip = (rng.random(m.shape) < 0.25) & (ring > 0)
    return np.where(flip, 1 - m, m).astype(bool)


@pytest.mark.parametrize("px", [0, 1, 2, 3])
def test_degraded_masks_match_cv2_recipe(px):
    sil = np.zeros((48, 64), bool)
    sil[10:30, 8:40] = True
    sil[25:44, 30:36] = True
    sil[0:5, 60:64] = True  # touches the border
    cam = SimpleNamespace(object_mask=sil, object_masks=np.stack([sil, sil[:, ::-1]]))
    single = eval_tracking.DegradedMaskDetector(cam, torch.device("cpu"), px)
    multi = eval_tracking.PerfectMultiMaskDetector(cam, torch.device("cpu"), degrade_px=px)
    r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(4):
        got = single(None)[1][0].numpy()
        np.testing.assert_array_equal(got, _cv2_degrade(sil, px, r1))
        det, masks, _ = multi(None)
        # the JAX script degrades per instance only when px > 0
        want = [_cv2_degrade(m, px, r2) if px else m for m in cam.object_masks]
        assert int(det.valid.sum()) == 2
        for i in range(2):
            np.testing.assert_array_equal(masks[i].numpy(), want[i])


def test_trained_ckpt_round_trip_detections(tmp_path):
    from poseestimator_tpu_torch.models.yolo.model import YOLO11Seg, init_random_
    from poseestimator_tpu_torch.pipeline.detector import Detector

    sd = init_random_(YOLO11Seg(nc=1, scale="n"), torch.Generator().manual_seed(0)).state_dict()
    det = Detector(sd, nc=1, imgsz=64, device="cpu")
    back = eval_tracking.ckpt_roundtrip_detector(SimpleNamespace(detector_dtype="float32"), det,
                                                 str(tmp_path))
    half = Detector({k: v.half().float() if v.is_floating_point() else v for k, v in sd.items()},
                    nc=1, imgsz=64, device="cpu")
    for k, v in half.variables.items():
        assert torch.equal(back.variables[k], v), k
    img = (np.random.default_rng(0).random((48, 64, 3)) * 255).astype(np.uint8)
    (d1, m1, b1), (d2, m2, b2) = back(img, conf=0.001), half(img, conf=0.001)
    assert int(d1.count()) > 0
    for a, b in ((d1.boxes, d2.boxes), (d1.scores, d2.scores), (d1.valid, d2.valid), (m1, m2),
                 (b1, b2)):
        assert torch.equal(a, b)


def test_multi_object_row():
    args = eval_tracking.build_parser().parse_args(
        ["--cpu", "--res", "128x96", "--frames", "6", "--modes", "300", "--objects", "2"])
    row = eval_tracking.run(args, quiet=True)[0]
    assert row["objects"] == 2 and len(row["per_object_adds_cm"]) == 2
    assert row["acquired_at_frame"] <= 3
    assert row["frames_scored"] >= 5
    assert row["frames_distinct"] == 1.0 and row["id_switches"] == 0
    assert 0.0 < row["adds_mean_cm"] < 8.0


def test_eval_tracking_row_matches_jax(jax_smoke_row):
    rows = eval_tracking.run(eval_tracking.build_parser().parse_args(SMOKE), quiet=True)
    assert len(rows) == 1
    got, want = rows[0], jax_smoke_row()
    assert list(got) == list(want)
    for k in ("mode", "target_pts", "motion_frames", "camera_frames", "detector", "conf"):
        assert got[k] == want[k], k
    assert abs(got["frames_tracked"] - want["frames_tracked"]) <= 1
    assert got["frames_tracked"] >= 5
    for r in (got, want):
        assert 0.0 < r["adds_mean_cm"] < 5.0 and r["adds_last10pct_cm"] < 5.0
    assert abs(got["adds_mean_cm"] - want["adds_mean_cm"]) < 0.5
