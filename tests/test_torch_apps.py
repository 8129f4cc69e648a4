"""Port parity, the user-facing apps and their helpers, on the CPU.

Against the JAX package: ``project_points_distorted`` (4-, 5- and 8-term
D, 1e-4 px) and ``euler_xyz_to_R`` (1e-6); the seibersdorf ``load_calib``
(both calibration forms, 1e-6) and ``project_count`` (``in_img`` on at
least 99.9% of the points alike, differing pixels within 1 px); the YAML
subset against ``yaml.safe_load`` both ways on ``detection/dataset.yaml``,
calibration files and ``save_config``'s output; ``load_config`` /
``save_config`` across the packages; the replay recorder in both
directions; the depth-noise injectors, bit-equal. Then the apps end to end
with a stub detector whose device mask is the object's silhouette (the
port's ``detect_mask`` then runs its real polygon round trip):
``main_image`` and ``main_seibersdorf`` on the 0.3-scale L-shape scene of
``tests/test_torch_offline.py`` (160x120), and ``eval_bop --mask
detector``, whose masks and summary equal ``--mask visib``'s."""
import dataclasses
import json
import os
import re

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from poseestimator_tpu import geom3d as g3
from poseestimator_tpu.apps import main_realsense as j_realsense
from poseestimator_tpu.apps import main_seibersdorf as j_seiber
from poseestimator_tpu.camera import record as j_record
from poseestimator_tpu.templates import creation as j_creation
from poseestimator_tpu.utils import config as j_config
from poseestimator_tpu_torch import kernel_cases as kc
from poseestimator_tpu_torch.apps import eval_bop, main_image, main_realsense, main_seibersdorf
from poseestimator_tpu_torch.camera.record import record
from poseestimator_tpu_torch.geom3d.camera import project_points_distorted
from poseestimator_tpu_torch.geom3d.se3 import euler_xyz_to_R
from poseestimator_tpu_torch.models.yolo.nms import Detections
from poseestimator_tpu_torch.pipeline import detector as detector_mod
from poseestimator_tpu_torch.templates import creation
from poseestimator_tpu_torch.utils import config, yaml_subset
from poseestimator_tpu_torch.utils.plyio import write_ply
from poseestimator_tpu_torch.utils.png import read_png

from test_torch_offline import INTR, scene  # noqa: F401 (fixtures)
from torch_threads import two_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- geometry helpers ---------------------------------------------------------


def _project_f64(pts, K, D, T):
    """The Brown-Conrady projection in float64 (the value both packages
    round)."""
    pc = pts.astype(np.float64) @ T[:3, :3].T.astype(np.float64) + T[:3, 3]
    xp, yp = pc[:, 0] / pc[:, 2], pc[:, 1] / pc[:, 2]
    k1, k2, p1, p2, k3, k4, k5, k6 = np.concatenate([D, np.zeros(8)])[:8].astype(np.float64)
    r2 = xp * xp + yp * yp
    rad = (1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3) / (1 + k4 * r2 + k5 * r2 ** 2 + k6 * r2 ** 3)
    x2 = xp * rad + 2 * p1 * xp * yp + p2 * (r2 + 2 * xp * xp)
    y2 = yp * rad + p1 * (r2 + 2 * yp * yp) + 2 * p2 * xp * yp
    return np.stack([K[0, 0] * x2 + K[0, 2], K[1, 1] * y2 + K[1, 2]], -1)


@pytest.mark.parametrize("nd", [4, 5, 8])
def test_project_points_distorted_matches_jax(nd):
    """Camera-frame points (identity pose): within 1e-4 px of the JAX
    package. Under a general pose the packages' float32 3x3 products
    round differently (XLA's dot against ATen's, one ulp of the camera-
    frame point, a few ulps of a 400 px coordinate), so there the two are
    held within 1e-4 px plus 2e-6 of the coordinate (16 float32 ulps) of
    each other and of the float64 projection."""
    rng = np.random.default_rng(nd)
    pts = (rng.normal(size=(500, 3)) * [0.4, 0.3, 0.2] + [0, 0, 1.5]).astype(np.float32)
    K = np.array([[600.0, 0, 320], [0, 610, 240], [0, 0, 1]], np.float32)
    D = (rng.normal(size=nd) * [0.1, 0.02, 0.001, 0.001, 0.005, 0.01, 0.002, 0.001][:nd]
         ).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    uj, fj = g3.project_points_distorted(jnp.asarray(pts), jnp.asarray(K), jnp.asarray(D),
                                         jnp.asarray(T))
    ut, ft = project_points_distorted(*(torch.from_numpy(a) for a in (pts, K, D, T)))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0, atol=1e-4)
    T[:3, :3] = np.asarray(g3.euler_xyz_to_R(jnp.asarray([0.1, -0.2, 0.3], jnp.float32)))
    T[:3, 3] = [0.05, -0.02, 0.1]
    uj, fj = g3.project_points_distorted(jnp.asarray(pts), jnp.asarray(K), jnp.asarray(D),
                                         jnp.asarray(T))
    ut, ft = project_points_distorted(*(torch.from_numpy(a) for a in (pts, K, D, T)))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    for want in (np.asarray(uj), _project_f64(pts, K, D, T)):
        np.testing.assert_allclose(ut.numpy(), want, rtol=2e-6, atol=1e-4)


def test_euler_xyz_to_R_matches_jax():
    rng = np.random.default_rng(0)
    for rpy in rng.uniform(-3.2, 3.2, size=(20, 3)):
        want = np.asarray(g3.euler_xyz_to_R(jnp.asarray(rpy, jnp.float32)))
        np.testing.assert_allclose(euler_xyz_to_R(rpy).numpy(), want, rtol=0, atol=1e-6)


def _calib_files(d) -> dict:
    """The two calibration forms, written by PyYAML as the JAX tests write
    them: T (4x4, 5-term D) and xyz + rpy (empty D)."""
    rng = np.random.default_rng(1)
    K = [300.0, 0.0, 160.0, 0.0, 300.0, 120.0, 0.0, 0.0, 1.0]
    T = np.eye(4)
    T[:3, :3] = cv2.Rodrigues(np.array([0.2, -0.1, 0.3]))[0]
    T[:3, 3] = [0.1, -0.2, 0.05]
    files = {"T": {"K": K, "D": rng.normal(size=5).tolist(), "T": T.reshape(-1).tolist()},
             "xyz+rpy": {"K": K, "D": [], "xyz": [1.0, 2.0, 3.0], "rpy": [0.1, 0.2, 0.3]}}
    out = {}
    for name, data in files.items():
        path = os.path.join(d, f"calib_{name.replace('+', '_')}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(data, f)
        out[name] = path
    return out


def test_load_calib_and_project_count_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    cam_pts = rng.normal(size=(20000, 3)) * [1.5, 1.0, 0.5] + [0, 0, 2.0]
    for name, path in _calib_files(str(tmp_path)).items():
        Kj, Dj, Tj = j_seiber.load_calib(path)
        Kt, Dt, Tt = main_seibersdorf.load_calib(path)
        np.testing.assert_array_equal(Kt, Kj)
        np.testing.assert_array_equal(Dt, Dj)
        np.testing.assert_allclose(Tt, Tj, rtol=0, atol=1e-6)
        D = Dj * 0.01 if Dj.size else Dj  # a mild 5-term distortion, and none
        pts = cam_pts @ Tj[:3, :3].T + Tj[:3, 3]  # into the LiDAR frame
        Ti = np.linalg.inv(Tj)
        nj, fj, uvj, inj = j_seiber.project_count(pts, Ti[:3, :3], Ti[:3, 3], Kj, D, 320, 240)
        nt, ft, uvt, int_ = main_seibersdorf.project_count(pts, Ti[:3, :3], Ti[:3, 3], Kt, D,
                                                           320, 240)
        assert nj > 1000, name
        np.testing.assert_array_equal(ft, fj)
        assert (int_ == inj).mean() >= 0.999, name
        sel = int_ | inj  # the pixels the app reads the mask at
        assert np.abs(uvt[sel] - uvj[sel]).max() <= 1, name


# --- YAML and the configuration tree ------------------------------------------


def _yaml_texts(d) -> dict:
    texts = {"dataset.yaml": open(os.path.join(REPO, "detection", "dataset.yaml")).read()}
    for name, path in _calib_files(str(d)).items():
        texts[f"calib {name}"] = open(path).read()
    path = str(d / "cfg.yaml")
    j_config.save_config(j_config.PipelineConfig(), path)
    texts["save_config"] = open(path).read()
    return texts


def test_yaml_subset_matches_pyyaml(tmp_path):
    """Both ways: the subset reads what PyYAML reads, and PyYAML (and the
    subset) read back what the subset writes; anchors, tags, block scalars
    and multi-document streams raise."""
    for name, text in _yaml_texts(tmp_path).items():
        data = yaml.safe_load(text)
        assert yaml_subset.loads(text) == data, name
        assert yaml.safe_load(yaml_subset.dumps(data)) == data, name
        assert yaml_subset.loads(yaml_subset.dumps(data)) == data, name
    odd = {"quoted": ["yes", "1.5", "a: b", "", " x", "null", "#c", "it's"],
           "numbers": [1.5e-07, 1e16, -0.0, 3, 0x1F, True, None, float("inf")],
           "flow": {"x": [[1, 2], {"a": 1}], "empty": {}}}
    assert yaml.safe_load(yaml_subset.dumps(odd)) == odd
    assert yaml_subset.loads("a: [1, {b: 'c'}]  # note\nd: 0x10\ne: 017\nf: 1e-05\n") == \
        yaml.safe_load("a: [1, {b: 'c'}]  # note\nd: 0x10\ne: 017\nf: 1e-05\n")
    for bad in ("a: &x 1\nb: *x\n", "a: !!str 1\n", "a: 1\n---\nb: 2\n", "a: |\n  x\n"):
        with pytest.raises(ValueError):
            yaml_subset.loads(bad)


def test_config_round_trips_match_jax(tmp_path):
    jc = j_config.load_config(None, **{"tracker.icp_dist": 0.05, "camera.source": "synthetic"})
    pj = str(tmp_path / "jax.yaml")
    j_config.save_config(jc, pj)
    tc = config.load_config(pj)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    tc.detector.conf = 0.4
    tc.metrics_path = "m.jsonl"
    pt = str(tmp_path / "port.yaml")
    config.save_config(tc, pt)
    assert dataclasses.asdict(j_config.load_config(pt)) == dataclasses.asdict(tc)
    assert dataclasses.asdict(config.load_config(pt)) == dataclasses.asdict(tc)
    assert dataclasses.asdict(config.load_config()) == dataclasses.asdict(j_config.load_config())
    with pytest.raises(KeyError):
        config.load_config(None, **{"tracker.nope": 1})


# --- the replay recorder, both directions -------------------------------------


class _FakeCamera:
    """A camera source over fixed frames (BGR uint8, float32 metres)."""

    def __init__(self, frames, intr):
        self.frames, self.intrinsics, self.i = frames, intr, 0

    def get_rgbd(self):
        if self.i >= len(self.frames):
            return None
        self.color, self.depth = self.frames[self.i]
        self.i += 1
        return self.color


def test_record_replay_both_directions(tmp_path):
    """Each package's ``record`` writes what the other's replay source
    reads back: the same colour, depth and intrinsics, frame for frame; a
    source that ends early stops the recording."""
    rng = np.random.default_rng(4)
    frames = [(rng.integers(0, 255, (24, 32, 3), dtype=np.uint8),
               rng.uniform(0.2, 3.0, (24, 32)).astype(np.float32)) for _ in range(3)]
    jintr = g3.Intrinsics.from_fov(60.0, 32, 24)
    tintr = INTR.__class__.from_fov(60.0, 32, 24)
    assert record(_FakeCamera(frames, tintr), str(tmp_path / "port"), 5, verbose=False) == 3
    assert j_record.record(_FakeCamera(frames, jintr), str(tmp_path / "jax"), 5,
                           verbose=False) == 3
    for src, reader in (("port", "jax"), ("jax", "port")):
        args = type("A", (), {"source": f"replay:{tmp_path / src}", "device": "cpu"})
        if reader == "jax":
            cam = j_realsense.make_camera(args, jintr)
            got = [(c, np.asarray(d)) for c, d in cam.frames]
            K, w, h = cam.intrinsics.K, cam.intrinsics.width, cam.intrinsics.height
        else:
            cam = main_realsense.make_camera(args, tintr)
            got = [(c, np.asarray(d)) for c, d in cam.frames]
            K, w, h = cam.intrinsics.K, cam.intrinsics.width, cam.intrinsics.height
        assert len(got) == 3 and (w, h) == (32, 24)
        np.testing.assert_allclose(np.asarray(K), tintr.K, rtol=1e-6)
        for (c0, d0), (c1, d1) in zip(frames, got):
            np.testing.assert_array_equal(c1, c0)
            np.testing.assert_array_equal(d1, d0)


def test_depth_noise_injectors_bit_equal():
    d = np.random.default_rng(5).uniform(0.0, 3.0, (40, 50)).astype(np.float32)
    for kw in ({}, {"sigma": 0.01, "prob_missing": 0.1}):
        np.testing.assert_array_equal(
            creation.add_depth_noise(d, rng=np.random.default_rng(6), **kw),
            j_creation.add_depth_noise(d, rng=np.random.default_rng(6), **kw))
    np.testing.assert_array_equal(creation.add_depth_dependent_noise(d, 0.003),
                                  j_creation.add_depth_dependent_noise(d, 0.003))


def test_stage_timer_and_torch_trace(tmp_path):
    """``StageTimer`` records each stage in ms and returns the stage's
    output; ``torch_trace`` writes a trace for a directory and is a no-op
    without one."""
    from poseestimator_tpu_torch.utils.profiling import StageTimer, torch_trace

    timer = StageTimer()
    out = timer.timed("sum", lambda x: {"s": (x.sum(), [x * 2])}, torch.ones(8))
    assert float(out["s"][0]) == 8.0 and timer.timings_ms["sum"] >= 0.0
    with timer.stage("block"):
        torch.ones(4).sum()
    assert set(timer.timings_ms) == {"sum", "block"}
    with torch_trace(None):
        pass
    with torch_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(n.endswith(".json") for n in os.listdir(tmp_path / "trace"))


# --- the apps end to end ------------------------------------------------------


def _colour_silhouette(img) -> np.ndarray:
    """The object's pixels of a flat-coloured test image: all but the
    background grey (30, 30, 30)."""
    return (np.asarray(img) != 30).any(-1)


class SilhouetteDetector(detector_mod.Detector):
    """The port's ``Detector`` surface without a network: one detection
    whose device mask is ``silhouette(image)``; the inherited
    ``detect_mask`` runs the real polygon round trip on it."""

    silhouette = staticmethod(_colour_silhouette)

    def __init__(self, *args, **kwargs):
        self.device = torch.device("cpu")

    def __call__(self, img, conf=0.25, iou=0.7, with_masks=True):
        m = torch.from_numpy(np.ascontiguousarray(self.silhouette(img)))
        det = Detections(boxes=torch.zeros(1, 4), scores=torch.ones(1),
                         classes=torch.zeros(1, dtype=torch.int64),
                         coeffs=torch.zeros(1, 32), valid=torch.ones(1, dtype=torch.bool))
        return det, m[None], torch.zeros(1, 4)


def test_apps_refuse_windows_and_need_a_device_or_cpu():
    for app in (main_image, main_realsense, main_seibersdorf):
        argv = ["--image", "x", "--cloud", "x", "--calib", "x"] if app is main_seibersdorf else []
        with pytest.raises(SystemExit, match="--headless"):
            app.main(argv)


def test_main_image_headless(scene, tmp_path, monkeypatch, capsys):  # noqa: F811
    """Frame 1 of the scene: the detector's round-trip mask, the offline
    registration at 100 points, the BOP metric block, the overlay PNG."""
    monkeypatch.setattr(detector_mod, "Detector", SilhouetteDetector)
    sd = scene["scene"]
    gt1 = tmp_path / "scene_gt.json"  # main_image scores the file's first frame
    with open(os.path.join(sd, "scene_gt.json")) as f:
        json.dump({"0": json.load(f)["1"]}, gt1.open("w"))
    cam1 = tmp_path / "scene_camera.json"
    with open(os.path.join(sd, "scene_camera.json")) as f:
        json.dump({"0": json.load(f)["1"]}, cam1.open("w"))
    overlay = str(tmp_path / "overlay.png")
    rc = main_image.main([
        "--weights", "unused", "--rgb", os.path.join(sd, "rgb", "000001.png"),
        "--depth", os.path.join(sd, "depth", "000001.png"), "--scene-camera", str(cam1),
        "--templates", scene["views"], "--scene-gt", str(gt1), "--ply", scene["cad"],
        "--models-info", os.path.join(sd, "models_info.json"), "--target-points", "100",
        "--headless", "--save-overlay", overlay, "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    ov = read_png(overlay)
    assert ov.shape == (INTR.height, INTR.width, 3)
    assert ((ov[..., 0] == 255) & (ov[..., 1] == 0) & (ov[..., 2] == 0)).sum() > 20  # red dots
    line = [ln for ln in out.splitlines() if "BOP AR" in ln]
    assert line, out
    mssd = float(re.search(r"MSSD = ([\d.]+) mm", out).group(1))
    ar_mssd = float(re.search(r"MSSD ([\d.]+)", line[0]).group(1))
    diam_mm = 1000.0 * float(np.linalg.norm(np.ptp(scene["verts"], axis=0)))
    assert abs(ar_mssd - np.mean(mssd < np.arange(0.05, 0.501, 0.05) * diam_mm)) < 1e-6
    assert mssd < 0.15 * diam_mm


def test_eval_bop_detector_mask_equals_visib(scene, monkeypatch):  # noqa: F811
    """``--mask detector`` with one detector for the sweep: each frame's
    round-trip mask is the hole-free silhouette's, so it equals
    ``mask_visib`` and the sweep's summary equals ``--mask visib``'s."""
    sd = scene["scene"]
    for k in range(3):
        img = cv2.imread(os.path.join(sd, "rgb", f"{k:06d}.png"))
        got = SilhouetteDetector().detect_mask(img)[0]["mask"]
        np.testing.assert_array_equal(got, read_png(os.path.join(sd, "mask_visib",
                                                                 f"{k:06d}_000000.png")))
    made = []

    class CountingDetector(SilhouetteDetector):
        def __init__(self, *a, **k):
            super().__init__()
            made.append(a)

    monkeypatch.setattr(eval_bop, "Detector", CountingDetector)
    base = ["--scene-dir", sd, "--ply", scene["cad"], "--templates", scene["views"],
            "--target-points", "100", "--device", "cpu", "--max-frames", "1",
            "--models-info", os.path.join(sd, "models_info.json")]
    visib = eval_bop.run(eval_bop.build_parser().parse_args(base + ["--mask", "visib"]),
                         quiet=True)
    det = eval_bop.run(eval_bop.build_parser().parse_args(
        base + ["--mask", "detector", "--weights", "w.pt"]), quiet=True)
    assert len(made) == 1
    assert det.pop("mask") == "detector" and visib.pop("mask") == "visib"
    assert det == visib


def test_main_seibersdorf_headless(scene, tmp_path, monkeypatch):  # noqa: F811
    """A LiDAR cloud of the CAD's surface plus clutter, in a LiDAR frame
    given as xyz + rpy with a 5-term D, the image the object's projected
    points dilated: the camera-frame search lands within 0.1 x diag (ADD-S
    against the nearer symmetric twin)."""
    from poseestimator_tpu_torch.geom3d.se3 import look_at
    from poseestimator_tpu_torch.render.mesh import TriangleMesh

    v, f = scene["verts"], scene["faces"]
    mesh = TriangleMesh(vertices=v.astype(np.float64), faces=f)
    diag = float(np.linalg.norm(np.ptp(v, axis=0)))
    d = np.ones(3) / np.sqrt(3.0)
    T_m2c = (kc.GL_TO_CV @ look_at(d * 0.6, [0, 0, 0], [0, 1, 0]).numpy()).astype(np.float64)
    # the LiDAR frame: the model frame moved by (R_l, t_l); T maps camera -> LiDAR
    rpy, xyz = [0.05, -0.1, 0.2], [0.3, -0.1, 0.2]
    R_l = euler_xyz_to_R(rpy).numpy().astype(np.float64)
    T_l = np.eye(4)
    T_l[:3, :3], T_l[:3, 3] = R_l, xyz  # model -> LiDAR
    T_calib = T_l @ np.linalg.inv(T_m2c)  # camera -> LiDAR
    rng = np.random.default_rng(3)
    surf, _ = mesh.sample_points_uniformly(6000, rng)
    clutter = rng.uniform(-1.0, 1.0, (3000, 3)) + [0, 0, -1.5]
    cloud = np.concatenate([surf, clutter]) @ T_l[:3, :3].T + T_l[:3, 3]
    write_ply(str(tmp_path / "cloud.ply"), cloud.astype(np.float32))
    from scipy.spatial.transform import Rotation

    calib = {"K": INTR.K.astype(float).reshape(-1).tolist(),
             "D": [1e-3, -1e-3, 0.0, 0.0, 0.0],
             "xyz": T_calib[:3, 3].tolist(),
             "rpy": Rotation.from_matrix(T_calib[:3, :3]).as_euler("xyz").tolist()}
    with open(tmp_path / "calib.yaml", "w") as fh:
        yaml.safe_dump(calib, fh)
    cam_pts = surf @ T_m2c[:3, :3].T + T_m2c[:3, 3]
    uv = (INTR.K @ cam_pts.T).T
    uv = (uv[:, :2] / uv[:, 2:3]).astype(int)
    ok = (uv[:, 0] >= 0) & (uv[:, 0] < INTR.width) & (uv[:, 1] >= 0) & (uv[:, 1] < INTR.height)
    img = np.full((INTR.height, INTR.width, 3), 30, np.uint8)
    img[uv[ok, 1], uv[ok, 0]] = (90, 160, 200)
    cv2.imwrite(str(tmp_path / "frame.png"), img)

    class DilatedSilhouette(SilhouetteDetector):
        silhouette = staticmethod(lambda im: cv2.dilate(
            _colour_silhouette(im).astype(np.uint8), np.ones((5, 5), np.uint8)) > 0)

    poses = []

    class RecordingEstimator(main_seibersdorf.PoseEstimator):
        def find_best_template_teaser(self, *a, **k):
            out = super().find_best_template_teaser(*a, **k)
            poses.append(out[0])
            return out

    monkeypatch.setattr(main_seibersdorf, "Detector", DilatedSilhouette)
    monkeypatch.setattr(main_seibersdorf, "PoseEstimator", RecordingEstimator)
    overlay = str(tmp_path / "ov.png")
    rc = main_seibersdorf.main([
        "--weights", "unused", "--ply-path", str(scene["dir"] / "views_full"),
        "--cad-path", scene["cad"], "--image", str(tmp_path / "frame.png"),
        "--cloud", str(tmp_path / "cloud.ply"), "--calib", str(tmp_path / "calib.yaml"),
        "--headless", "--save-overlay", overlay, "--target-points", "300", "--device", "cpu"])
    assert rc == 0 and read_png(overlay).shape == (INTR.height, INTR.width, 3)
    (T_est,) = poses
    S = kc.lshape_symmetry(0.3)
    samples = surf[:500]
    adds = []
    for Tt in (T_m2c, T_m2c @ S):
        a = samples @ np.asarray(T_est)[:3, :3].T + np.asarray(T_est)[:3, 3]
        b = samples @ Tt[:3, :3].T + Tt[:3, 3]
        dd = np.linalg.norm(a[:, None] - b[None], axis=-1).min(1)
        adds.append(dd.mean())
    assert min(adds) < 0.1 * diag, adds
