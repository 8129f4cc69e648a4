"""Port parity, the camera sources and the detector wrapper: the depth
filters against the JAX package's to 1e-6; ``SyntheticCamera`` (splat,
mesh, occluder, background wall, multi-instance) and ``ReplayCamera`` with
the filter chain against the JAX cameras at 128x96 (depth within 1e-5
relative: XLA contracts the projection into multiply-adds; masks equal;
colour equal where at most one point shades the pixel); the analytic L-shape
depth exactly; the same points in the cloud of ``get_pcd_from_rgbd``; ``Detector`` on
seeded flax variables against the JAX ``Detector`` at a 96 letterbox
(counts and classes equal, boxes to 1e-4, masks equal on >= 99.9% of the
pixels); and every new entry point refusing the card when there is none."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseestimator_tpu import geom3d as g3
from poseestimator_tpu.camera import ReplayCamera as JReplayCamera
from poseestimator_tpu.camera import SyntheticCamera as JSyntheticCamera
from poseestimator_tpu.camera import analytic as janalytic
from poseestimator_tpu.camera import filters as jfilters
from poseestimator_tpu.models.yolo.weights import state_dict_to_variables
from poseestimator_tpu.pipeline.detector import Detector as JDetector
from poseestimator_tpu_torch.camera import (
    ReplayCamera,
    SyntheticCamera,
    hole_filling_filter,
    spatial_filter,
    temporal_filter,
)
from poseestimator_tpu_torch.camera import analytic
from poseestimator_tpu_torch.geom3d.camera import Intrinsics
from poseestimator_tpu_torch.geom3d.se3 import transform_points
from poseestimator_tpu_torch.models.yolo.model import YOLO11Seg, init_random_
from poseestimator_tpu_torch.models.yolo.weights import variables_to_state_dict
from poseestimator_tpu_torch.pipeline import Detector, Tracker
from poseestimator_tpu_torch.pipeline.tracking import _so3_exp
from poseestimator_tpu_torch.render.mesh import TriangleMesh

from helpers import l_shape_mesh
from test_torch_yolo import _randomized
from torch_threads import two_threads  # noqa: F401

W, H = 128, 96
J_INTR = g3.Intrinsics.from_fov(60.0, W, H)
T_INTR = Intrinsics.from_fov(60.0, W, H)


def _noisy_depth(seed):
    """A step edge, holes and noise: every branch of every filter."""
    rng = np.random.default_rng(seed)
    d = np.full((H, W), 1.0, np.float32)
    d[:, W // 2:] = 1.5
    d += rng.normal(size=d.shape).astype(np.float32) * 0.008
    d[rng.uniform(size=d.shape) < 0.05] = 0.0
    d[10:14, 20:23] = 0.0
    return d


def test_filters_match_jax():
    d0, d1 = _noisy_depth(0), _noisy_depth(1)
    t0, t1 = torch.from_numpy(d0), torch.from_numpy(d1)
    for it in (1, 2):
        np.testing.assert_allclose(spatial_filter(t0, iterations=it).numpy(),
                                   np.asarray(jfilters.spatial_filter(jnp.asarray(d0),
                                                                      iterations=it)),
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(temporal_filter(t1, t0).numpy(),
                               np.asarray(jfilters.temporal_filter(jnp.asarray(d1),
                                                                   jnp.asarray(d0))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(hole_filling_filter(t0).numpy(),
                               np.asarray(jfilters.hole_filling_filter(jnp.asarray(d0))),
                               rtol=0, atol=1e-6)
    # an array goes to the device named; a tensor stays where it is
    assert spatial_filter(d0, device="cpu").device.type == "cpu"


_GL_TO_CV = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)


def gt_pose(angle=0.1, shift=0.0):
    """tests/test_pipeline.py's pose near template view 11, 2 m away."""
    d = np.ones(3) / np.sqrt(3.0)
    T_gl = np.asarray(g3.look_at(d * 2.0, [0, 0, 0], [0, 1, 0]))
    P = np.eye(4, dtype=np.float32)
    P[:3, :3] = _so3_exp(np.array([0.0, 0.0, angle])) @ _so3_exp(np.array([angle * 0.5, 0, 0]))
    T = (P @ (_GL_TO_CV @ T_gl)).astype(np.float32)
    T[0, 3] += shift
    return T


@pytest.fixture(scope="module")
def cad():
    mesh = l_shape_mesh()
    pts, nrm = TriangleMesh(vertices=np.asarray(mesh.vertices, np.float32),
                            faces=np.asarray(mesh.faces, np.int32)).sample_points_uniformly(
        8000, np.random.default_rng(0))
    return mesh, pts.astype(np.float32), nrm.astype(np.float32)


def _owners(pts, T, depth):
    """(H, W) count of the z-buffer-winning points that shade each pixel
    (the splat shader's rule, re-derived): where it is below 2 the colour
    does not depend on which duplicate write lands."""
    cam = transform_points(torch.from_numpy(T), torch.from_numpy(pts)).numpy()
    z = cam[:, 2]
    u = np.round(T_INTR.fx * cam[:, 0] / z + T_INTR.cx).astype(np.int64)
    v = np.round(T_INTR.fy * cam[:, 1] / z + T_INTR.cy).astype(np.int64)
    ok = (z > 0.01) & (z < 10.0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    won = ok.copy()
    won[ok] = z[ok] <= depth[v[ok], u[ok]] + 1e-4
    return np.bincount(v[won] * W + u[won], minlength=H * W).reshape(H, W)


SCENES = {
    "splat": dict(poses=[gt_pose(0.1), gt_pose(0.15)]),
    "mesh": dict(poses=[gt_pose(0.1), gt_pose(0.15)], mesh=True),
    "occluder and wall": dict(poses=[gt_pose(0.1)], occluder=(60, 68, 1.0),
                              background_depth=3.0),
    "multi-instance splat": dict(poses=[np.stack([gt_pose(0.1, -0.45), gt_pose(0.4, 0.45)])]),
    "multi-instance mesh": dict(poses=[np.stack([gt_pose(0.1, -0.45), gt_pose(0.4, 0.45)])],
                                mesh=True),
}


@pytest.mark.parametrize("name", list(SCENES))
def test_synthetic_camera_matches_jax(cad, name):
    mesh, pts, nrm = cad
    sc = dict(SCENES[name])
    poses = sc.pop("poses")
    use_mesh = sc.pop("mesh", False)
    jcam = JSyntheticCamera(pts, nrm, iter(poses), J_INTR, mesh=mesh if use_mesh else None,
                            **sc)
    tcam = SyntheticCamera(pts, nrm, iter(poses), T_INTR,
                           mesh=(mesh.vertices, mesh.faces) if use_mesh else None,
                           device="cpu", **sc)
    for T in poses:
        cj, ct = jcam.get_rgbd(), tcam.get_rgbd()
        dj, dt = np.asarray(jcam.depth), tcam.depth.numpy()
        assert tcam.depth.dtype == torch.float32 and ct.dtype == np.uint8
        np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=0)
        np.testing.assert_array_equal(tcam.object_masks, np.asarray(jcam.object_masks))
        np.testing.assert_array_equal(tcam.object_mask, np.asarray(jcam.object_mask))
        np.testing.assert_array_equal(tcam.current_gt, jcam.current_gt)
        assert tcam.object_mask.sum() > 100
        if use_mesh:
            np.testing.assert_allclose(ct.astype(int), cj.astype(int), atol=1)
        elif T.ndim == 2:
            owners = _owners(pts, T, dt)
            assert (owners == 1).any()
            np.testing.assert_array_equal(ct[owners < 2], cj[owners < 2])
    assert tcam.get_rgbd() is None and jcam.get_rgbd() is None


@pytest.mark.parametrize("splat", [0, 1])
def test_render_shaded_matches_jax(splat):
    """A plane facing the camera, 4 points a pixel: most pixels have
    several z-buffer winners. Depth within 1e-5 relative; colour equal
    where at most one point shades the pixel, and there one of the winners'
    colours."""
    from poseestimator_tpu.render.points import render_shaded as j_shaded
    from poseestimator_tpu_torch.render.points import render_shaded

    rng = np.random.default_rng(splat)
    n = 4 * W * H
    pts = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.45, 0.45, n),
                    rng.normal(size=n) * 1e-5], axis=1).astype(np.float32)
    nrm = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (n, 1))
    nrm[::3] = [0.0, 0.6, -0.8]  # two shades among duplicate writers
    T = np.eye(4, dtype=np.float32)
    T[2, 3] = 1.2
    valid = np.ones(n, bool)
    dj, cj = (np.asarray(a) for a in j_shaded(jnp.asarray(pts), jnp.asarray(nrm),
                                              jnp.asarray(valid), jnp.asarray(T), J_INTR,
                                              near=0.01, far=10.0, splat=splat))
    dt, ct = (a.numpy() for a in render_shaded(torch.from_numpy(pts), torch.from_numpy(nrm),
                                               torch.from_numpy(valid), torch.from_numpy(T),
                                               T_INTR, near=0.01, far=10.0, splat=splat))
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=0)
    owners = _owners(pts, T, dt)
    assert (owners == 1).sum() > 100 and (owners > 1).sum() > 100
    np.testing.assert_array_equal(ct[owners < 2], cj[owners < 2])
    blue = ct[owners > 1][:, 2]  # the headlight terms of the two normals
    assert np.isclose(blue[:, None], [1.0, 0.8]).any(1).all()


def test_noisy_filtered_stream_and_clouds_match_jax(cad):
    """noise_sigma with the RealSense chain draws the same numpy noise; the
    cloud of get_pcd_from_rgbd keeps the same points at 128x96 (the pool
    is under PCD_CAPACITY, so the sample takes every valid point)."""
    mesh, pts, nrm = cad
    poses = [gt_pose(0.1), gt_pose(0.12), gt_pose(0.14)]
    kw = dict(noise_sigma=0.003, filter_depth=True, seed=3)
    jcam = JSyntheticCamera(pts, nrm, iter(poses), J_INTR, mesh=mesh, **kw)
    tcam = SyntheticCamera(pts, nrm, iter(poses), T_INTR, mesh=(mesh.vertices, mesh.faces),
                           device="cpu", **kw)
    for _ in poses:
        jcam.get_rgbd()
        tcam.get_rgbd()
        np.testing.assert_allclose(tcam.depth.numpy(), np.asarray(jcam.depth), rtol=1e-5,
                                   atol=0)
    m = tcam.object_mask
    cj = jcam.get_pcd_from_rgbd(m)
    ct = tcam.get_pcd_from_rgbd(m)
    assert int(ct.count()) == int(cj.count()) > 500
    a = ct.points.numpy()[ct.valid.numpy()]
    b = np.asarray(cj.points)[np.asarray(cj.valid)]
    np.testing.assert_allclose(np.sort(a, axis=0), np.sort(b, axis=0), rtol=1e-5, atol=1e-6)


def test_replay_camera_with_filters_matches_jax():
    frames = [(np.full((H, W, 3), k, np.uint8), _noisy_depth(k)) for k in range(3)]
    jcam = JReplayCamera(frames, J_INTR, loop=False)
    tcam = ReplayCamera(frames, T_INTR, loop=False, device="cpu")
    for k in range(3):
        assert tcam.get_rgbd()[0, 0, 0] == jcam.get_rgbd()[0, 0, 0] == k
        np.testing.assert_allclose(tcam.depth.numpy(), np.asarray(jcam.depth), rtol=0,
                                   atol=1e-6)
    assert tcam.get_rgbd() is None and jcam.get_rgbd() is None and tcam.exhausted
    raw = ReplayCamera(frames, T_INTR, filter_depth=False, device="cpu")
    for k in range(4):  # loops
        raw.get_rgbd()
    np.testing.assert_array_equal(raw.depth.numpy(), frames[0][1])
    intr, K = raw.rs_get_intrinsics()
    assert intr == T_INTR and np.array_equal(K, T_INTR.K)


def test_analytic_depth_is_the_jax_depth():
    T = gt_pose(0.2)
    d = analytic.raycast_boxes_depth(T_INTR, T, analytic.l_shape_boxes(1.0))
    np.testing.assert_array_equal(
        d, janalytic.raycast_boxes_depth(J_INTR, T, janalytic.l_shape_boxes(1.0)))
    assert (d > 0).sum() > 100
    cam = SyntheticCamera(np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32), [T],
                          T_INTR, depth_fn=analytic.make_lshape_raycaster(T_INTR), device="cpu")
    cam.get_rgbd()
    np.testing.assert_array_equal(cam.depth.numpy(), d)
    np.testing.assert_array_equal(cam.object_mask, d > 0)


def test_lshape_twin_poses_render_alike():
    """The evaluation L-shape is two-fold symmetric: T and T @ S
    (``kernel_cases.lshape_symmetry``) give the same depth, by the analytic
    ray-cast and by the raster alike, from views all around it."""
    from poseestimator_tpu_torch import kernel_cases as kc
    from poseestimator_tpu_torch.render.raster import render_depth_mesh

    S = kc.lshape_symmetry()
    v, f = kc.lshape_mesh()
    boxes = analytic.l_shape_boxes(1.0)
    rng = np.random.default_rng(0)
    for k in range(4):
        T = gt_pose(rng.uniform(-1.0, 1.0))
        T[:3, :3] = T[:3, :3] @ _so3_exp(rng.normal(size=3))
        d0 = analytic.raycast_boxes_depth(T_INTR, T, boxes)
        d1 = analytic.raycast_boxes_depth(T_INTR, T @ S, boxes)
        np.testing.assert_array_equal(d0 > 0, d1 > 0)
        np.testing.assert_allclose(d1, d0, rtol=0, atol=1e-5)
        r0, r1 = (render_depth_mesh(torch.from_numpy(v), torch.from_numpy(f),
                                    torch.from_numpy(P.astype(np.float32)), T_INTR, near=0.01,
                                    far=10.0) for P in (T, T @ S))
        assert (r0 > 0).sum() > 100 and ((r0 > 0) != (r1 > 0)).sum() <= 2
    assert not np.allclose(S, np.eye(4))


IMGSZ = 96


@pytest.fixture(scope="module")
def yolo_variables():
    """Seeded flax variables, made without compiling flax's init: the port
    model's seeded weights through the JAX package's importer, then batch
    statistics and biases randomised as in tests/test_torch_yolo.py."""
    tmodel = init_random_(YOLO11Seg(nc=5, scale="n"), torch.Generator().manual_seed(3))
    return jax.tree_util.tree_map(
        np.asarray, _randomized(state_dict_to_variables(tmodel.state_dict()), seed=4))


def test_detector_matches_jax(yolo_variables):
    """One image with masks, then a batch of two without."""
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 255, size=(2, 72, 112, 3), dtype=np.uint8)
    jdet = JDetector(yolo_variables, nc=5, imgsz=IMGSZ)
    tdet = Detector(yolo_variables, nc=5, imgsz=IMGSZ, device="cpu")
    assert hasattr(tdet, "model") and hasattr(tdet, "variables")
    dj, mj, bj = jdet(imgs[0], conf=0.05)
    dt, mt, bt = tdet(imgs[0], conf=0.05)
    n = int(dj.count())
    assert int(dt.count()) == n >= 1
    np.testing.assert_array_equal(dt.classes.numpy()[:n], np.asarray(dj.classes)[:n])
    np.testing.assert_allclose(dt.boxes.numpy()[:n], np.asarray(dj.boxes)[:n], atol=1e-4)
    np.testing.assert_allclose(bt.numpy()[:n], np.asarray(bj)[:n], atol=1e-4)
    assert mt.shape == (tdet.max_det, 72, 112)
    assert (mt.numpy() == np.asarray(mj)).mean() >= 0.999
    assert mt.numpy()[:n].any()
    dj, bj = jdet.predict_batch(imgs, conf=0.05)
    dt, bt = tdet.predict_batch(imgs, conf=0.05)
    np.testing.assert_array_equal(dt.valid.numpy(), np.asarray(dj.valid))
    v = dt.valid.numpy()
    np.testing.assert_array_equal(dt.classes.numpy()[v], np.asarray(dj.classes)[v])
    np.testing.assert_allclose(bt.numpy()[v], np.asarray(bj)[v], atol=1e-4)
    _, none, _ = tdet(imgs[0], with_masks=False)
    assert none is None


def test_detector_weight_sources(yolo_variables, tmp_path):
    """flax variables, their .npz, an fp16 Ultralytics-style checkpoint (with
    the fixed DFL projection) all load the same model; an orbax directory
    is refused."""
    ref = Detector(yolo_variables, device="cpu").variables
    np.savez(tmp_path / "v.npz", variables=np.array(yolo_variables, dtype=object))
    sd = {k: v.half() if v.is_floating_point() else v
          for k, v in variables_to_state_dict(yolo_variables).items()}
    sd["model.23.dfl.conv.weight"] = torch.arange(16.0).view(1, 16, 1, 1)
    torch.save({"model": sd, "epoch": 3}, tmp_path / "best.pt")
    for src in (str(tmp_path / "v.npz"), str(tmp_path / "best.pt"), sd):
        got = Detector(src, device="cpu").variables
        tol = 0 if str(src).endswith(".npz") else 1e-2
        for k, v in ref.items():
            torch.testing.assert_close(got[k].float(), v.float(), rtol=tol, atol=tol)
    (tmp_path / "orbax").mkdir()
    with pytest.raises(NotImplementedError):
        Detector(str(tmp_path / "orbax"), device="cpu")


def test_entry_points_refuse_cuda_without_a_card(cad, yolo_variables, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh, pts, nrm = cad
    d = _noisy_depth(0)
    for call in (lambda: spatial_filter(d), lambda: temporal_filter(d, d),
                 lambda: hole_filling_filter(d),
                 lambda: SyntheticCamera(pts, nrm, [], T_INTR),
                 lambda: ReplayCamera([(None, d)], T_INTR),
                 lambda: Detector(yolo_variables),
                 lambda: Tracker(None, None, None)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
