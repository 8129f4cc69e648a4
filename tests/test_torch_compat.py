"""Port parity, the compat namespace: ``poseestimator_tpu_torch.compat``
holds the reference's module paths (``pose_estimator/``'s surface as
``tests/test_compat_namespace.py`` walks it) and forwards to the port.
Every import line of that surface resolves in the twin; every free
function, given the same numpy inputs on the CPU (``device="cpu"``),
returns numpy equal to the JAX twin's within 1e-5 (principal axes up to
each column's sign, which is the eigensolver's); the classes, the apps and
the template helpers are the port's own."""
import importlib
import json

import numpy as np
import pytest

from poseestimator_tpu_torch.apps import main_image, main_realsense, main_seibersdorf
from poseestimator_tpu_torch.camera.source import RealSenseCamera
from poseestimator_tpu_torch.pipeline import detector, offline, pose_estimator
from poseestimator_tpu_torch.templates import creation
from poseestimator_tpu_torch.utils import bop, metrics_log
from torch_threads import two_threads  # noqa: F401

J = "pose_estimator"
T = "poseestimator_tpu_torch.compat"
CPU = {"device": "cpu"}


def _both(module: str):
    return importlib.import_module(f"{J}.{module}"), importlib.import_module(f"{T}.{module}")


def test_import_surface():
    """The reference's import lines, in the twin; each name the port's."""
    from poseestimator_tpu_torch.compat import main_image as c_image
    from poseestimator_tpu_torch.compat import main_realsense as c_realsense
    from poseestimator_tpu_torch.compat import main_seibersdorf as c_seibersdorf
    from poseestimator_tpu_torch.compat.EstimHelpers.Detector import Detector
    from poseestimator_tpu_torch.compat.EstimHelpers.detection_utils import detect_mask
    from poseestimator_tpu_torch.compat.EstimHelpers.PoseEstimator import PoseEstimator
    from poseestimator_tpu_torch.compat.EstimHelpers.RealSenseClass import RealSenseCamera as R
    from poseestimator_tpu_torch.compat.EstimHelpers.registration_utils import (
        TemplateMetrics, find_best_template_teaser, get_pointcloud, load_camera_intrinsics)
    from poseestimator_tpu_torch.compat.EstimHelpers.template_creation import (
        render_lego_views, render_templates)

    assert Detector is detector.Detector and detect_mask is detector.detect_mask
    assert PoseEstimator is pose_estimator.PoseEstimator and R is RealSenseCamera
    assert TemplateMetrics is metrics_log.TemplateMetrics
    assert find_best_template_teaser is offline.find_best_template_teaser
    assert get_pointcloud is bop.get_pointcloud
    assert load_camera_intrinsics is bop.load_camera_intrinsics
    assert render_lego_views is render_templates is creation.render_templates
    for twin, app in ((c_image, main_image), (c_realsense, main_realsense),
                      (c_seibersdorf, main_seibersdorf)):
        assert twin.main is app.main and twin.build_parser is app.build_parser


@pytest.mark.parametrize("module", ["EstimHelpers.HelpersRealtime",
                                    "EstimHelpers.registration_utils"])
def test_every_exported_name_exists(module):
    j, t = _both(module)
    assert set(j.__all__) <= set(t.__all__)
    for name in j.__all__:
        assert callable(getattr(t, name)), name


def test_apps_parse_the_reference_arguments():
    """Each app's parser accepts every option the JAX twin's defines
    (the port adds ``--device``)."""
    for name in ("main_image", "main_realsense", "main_seibersdorf"):
        j, t = _both(name)
        jo = {o for a in j.build_parser()._actions for o in a.option_strings}
        to = {o for a in t.build_parser()._actions for o in a.option_strings}
        assert jo <= to, (name, jo - to)


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.default_rng(7)
    a = rng.normal(size=(120, 3)) * [0.05, 0.03, 0.02] + [0.0, 0.0, 0.6]
    b = a @ np.array([[0.995, -0.0998, 0.0], [0.0998, 0.995, 0.0], [0, 0, 1]]).T + 0.004
    return a.astype(np.float64), b.astype(np.float64)


def test_helpers_realtime(clouds):
    j, t = _both("EstimHelpers.HelpersRealtime")
    a, b = clouds
    for T in (np.diag([1.0, -1.0, -1.0, 1.0]), np.eye(4)):
        out = t.enforce_upright_pose_y_up(T, **CPU)
        assert isinstance(out, np.ndarray) and out.shape == (4, 4)
        np.testing.assert_allclose(out, j.enforce_upright_pose_y_up(T), atol=1e-5)
    H = np.eye(4)
    H[:3, :3] = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
    H[:3, 3] = [0.02, -0.01, 0.5]
    for x, y in zip(t.camera_eye_lookat_up_from_H(H, **CPU), j.camera_eye_lookat_up_from_H(H)):
        np.testing.assert_allclose(x, y, atol=1e-5)
    K = np.array([[100.0, 0, 32], [0, 100, 32], [0, 0, 1]])
    Tc = np.eye(4)
    Tc[2, 3] = -0.55  # a few points behind the camera
    uv = t.project_points(a, K, Tc, **CPU)
    assert uv.dtype.kind == "i" and uv.shape[1] == 2
    np.testing.assert_array_equal(uv, j.project_points(a, K, Tc))
    np.testing.assert_allclose(np.sort(t.nn_residuals(a, b, **CPU)),
                               np.sort(j.nn_residuals(a, b)), atol=1e-5)
    for vox in (0.01, 10.0):
        assert t.voxel_coverage(a, vox, **CPU) == j.voxel_coverage(a, vox)
    np.testing.assert_allclose(t.alignment_score(b, a, b, 0.01, **CPU),
                               j.alignment_score(b, a, b, 0.01), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t.cloud_resolution(a, **CPU), j.cloud_resolution(a), rtol=1e-5)
    img = np.zeros((64, 64, 3), np.uint8)
    Tm = np.eye(4)
    Tm[2, 3] = 0.6
    drawn = t.draw_model_projection_with_axes(img.copy(), a[:, :3] - [0, 0, 0.6], K, Tm)
    np.testing.assert_array_equal(drawn, j.draw_model_projection_with_axes(
        img.copy(), a[:, :3] - [0, 0, 0.6], K, Tm))


def test_registration_utils(clouds, tmp_path):
    j, t = _both("EstimHelpers.registration_utils")
    a, b = clouds
    R = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    np.testing.assert_allclose(t.get_angular_error(np.eye(3), R, **CPU),
                               j.get_angular_error(np.eye(3), R), atol=1e-5)
    np.testing.assert_allclose(t.chamfer_distance(a, b, **CPU), j.chamfer_distance(a, b),
                               rtol=1e-5)
    np.testing.assert_allclose(t.centroid_of(a, **CPU), j.centroid_of(a), atol=1e-5)
    (Rt, st), (Rj, sj) = t.pca_axes(a, **CPU), j.pca_axes(a)
    np.testing.assert_allclose(st, sj, rtol=1e-5)
    np.testing.assert_allclose(np.abs(Rt), np.abs(Rj), atol=1e-5)
    np.testing.assert_allclose(t.initial_align_centroid_pca(a, b, **CPU),
                               j.initial_align_centroid_pca(a, b), atol=1e-5)
    np.testing.assert_allclose(t.cloud_resolution(b, **CPU), j.cloud_resolution(b), rtol=1e-5)
    cam = tmp_path / "scene_camera.json"
    cam.write_text(json.dumps({"0": {"cam_K": [600.0, 0, 320, 0, 610, 240, 0, 0, 1],
                                     "depth_scale": 0.1}}))
    it, dt, kt = t.load_camera_intrinsics(str(cam), 0, 640, 480)
    ij, dj, kj = j.load_camera_intrinsics(str(cam), 0, 640, 480)
    assert (it.fx, it.fy, it.cx, it.cy, it.width, it.height) == \
        (ij.fx, ij.fy, ij.cx, ij.cy, ij.width, ij.height)
    assert dt == dj and list(kt) == list(kj)


def test_template_creation():
    j, t = _both("EstimHelpers.template_creation")
    assert t.render_lego_views is t.render_templates
    for fov, w in ((60.0, 640), (42.5, 1280)):
        np.testing.assert_allclose(t.fx_from_fov(fov, w), j.fx_from_fov(fov, w), rtol=1e-12)
    for pt, pj in zip(t.get_reduced_camera_positions(0.6), j.get_reduced_camera_positions(0.6)):
        for x, y in zip(pt, pj):
            if isinstance(y, str):
                assert x == y
            else:
                np.testing.assert_allclose(np.asarray(x, np.float64), np.asarray(y), atol=1e-6)
    args = ([0.3, 0.2, 0.5], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    np.testing.assert_allclose(np.asarray(t.o3d_lookat(*args)), np.asarray(j.o3d_lookat(*args)),
                               atol=1e-5)
    depth = np.random.default_rng(0).uniform(0.4, 0.8, (24, 32)).astype(np.float32)
    depth[:4] = 0.0
    for name, kw in (("add_depth_noise", {"prob_missing": 0.1}), ("add_depth_dependent_noise", {})):
        np.testing.assert_allclose(
            getattr(t, name)(depth, rng=np.random.default_rng(1), **kw),
            getattr(j, name)(depth, rng=np.random.default_rng(1), **kw), atol=1e-6)
