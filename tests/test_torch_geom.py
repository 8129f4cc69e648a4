"""Port parity, geometry primitives: the PyTorch counterparts of camera,
se3, cloud, masked and window against the JAX package on the same numpy
inputs (JAX on the CPU, the port with device="cpu")."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseestimator_tpu import geom3d as g3
from poseestimator_tpu.geom3d.cloud import PointCloud as JCloud
from poseestimator_tpu.geom3d.masked import masked_mean as j_masked_mean
from poseestimator_tpu.geom3d.masked import masked_std as j_masked_std
from poseestimator_tpu.pipeline import window as jwin
from poseestimator_tpu_torch.device import resolve_device
from poseestimator_tpu_torch.geom3d import se3 as tse3
from poseestimator_tpu_torch.geom3d.camera import Intrinsics, backproject_depth
from poseestimator_tpu_torch.geom3d.cloud import PointCloud
from poseestimator_tpu_torch.geom3d.masked import masked_mean, masked_std
from poseestimator_tpu_torch.pipeline import window as twin

J_INTR = g3.Intrinsics(fx=300.0, fy=310.0, cx=80.5, cy=59.5, width=160, height=120)
T_INTR = Intrinsics(fx=300.0, fy=310.0, cx=80.5, cy=59.5, width=160, height=120)


def _pose(rng, z=0.5):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.asarray(g3.quat_to_R(jnp.asarray(q, jnp.float32)))
    T[:3, 3] = [rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05), z]
    return T


def _depth(rng, h=120, w=160):
    d = rng.uniform(0.3, 1.2, size=(h, w)).astype(np.float32)
    d[rng.uniform(size=(h, w)) < 0.2] = 0.0
    return d


class TestIntrinsics:
    def test_from_fov_and_K_match(self):
        j = g3.Intrinsics.from_fov(60.0, 640, 480)
        t = Intrinsics.from_fov(60.0, 640, 480)
        assert (t.fx, t.fy, t.cx, t.cy, t.width, t.height) == (
            j.fx, j.fy, j.cx, j.cy, j.width, j.height)
        np.testing.assert_array_equal(t.K, j.K)
        k = Intrinsics.from_K(j.K, 640, 480)
        assert (k.fx, k.cy) == (np.float32(j.fx), np.float32(j.cy))


class TestBackproject:
    """Bitwise-equal points and masks (tolerance 1e-7 m where XLA fuses)."""

    def test_full_frame(self, rng):
        d = _depth(rng)
        m = rng.uniform(size=d.shape) < 0.7
        jc = g3.backproject_depth(jnp.asarray(d), J_INTR, mask=jnp.asarray(m),
                                  depth_min=0.35, depth_max=1.1)
        tc = backproject_depth(torch.from_numpy(d), T_INTR, mask=torch.from_numpy(m),
                               depth_min=0.35, depth_max=1.1)
        np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
        np.testing.assert_allclose(tc.points.numpy(), np.asarray(jc.points),
                                   rtol=0, atol=1e-7)

    def test_window_origin(self, rng):
        d = _depth(rng, 32, 64)
        origin = np.array([40, 20], np.int32)
        jc = g3.backproject_depth(jnp.asarray(d), J_INTR, depth_min=0.01,
                                  origin=jnp.asarray(origin))
        tc = backproject_depth(torch.from_numpy(d), T_INTR, depth_min=0.01,
                               origin=torch.from_numpy(origin))
        np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
        np.testing.assert_allclose(tc.points.numpy(), np.asarray(jc.points),
                                   rtol=0, atol=1e-7)


class TestSE3Cloud:
    def test_make_inv_transform(self, rng):
        T = _pose(rng)
        pts = rng.normal(size=(50, 3)).astype(np.float32)
        Tt = torch.from_numpy(T)
        np.testing.assert_allclose(
            tse3.make_T(Tt[:3, :3], Tt[:3, 3]).numpy(),
            np.asarray(g3.make_T(jnp.asarray(T[:3, :3]), jnp.asarray(T[:3, 3]))), atol=0)
        np.testing.assert_allclose(tse3.inv_T(Tt).numpy(),
                                   np.asarray(g3.inv_T(jnp.asarray(T))), atol=1e-6)
        np.testing.assert_allclose(
            tse3.transform_points(Tt, torch.from_numpy(pts)).numpy(),
            np.asarray(g3.transform_points(jnp.asarray(T), jnp.asarray(pts))), atol=1e-6)

    def test_rotations(self, rng):
        axis = rng.normal(size=3).astype(np.float32)
        np.testing.assert_allclose(
            tse3.axis_angle_to_R(torch.from_numpy(axis), 0.7).numpy(),
            np.asarray(g3.axis_angle_to_R(jnp.asarray(axis), 0.7)), atol=1e-6)
        q = rng.normal(size=4).astype(np.float32)
        q /= np.linalg.norm(q)
        np.testing.assert_allclose(tse3.quat_to_R(torch.from_numpy(q)).numpy(),
                                   np.asarray(g3.quat_to_R(jnp.asarray(q))), atol=1e-6)

    def test_cloud_ops(self, rng):
        pts = rng.normal(size=(64, 3)).astype(np.float32)
        valid = rng.uniform(size=64) < 0.6
        keep = rng.uniform(size=64) < 0.5
        T = _pose(rng)
        jc = JCloud(points=jnp.asarray(pts), valid=jnp.asarray(valid))
        tc = PointCloud(points=torch.from_numpy(pts), valid=torch.from_numpy(valid))
        assert int(tc.count()) == int(jc.count())
        np.testing.assert_allclose(tc.transform(torch.from_numpy(T)).points.numpy(),
                                   np.asarray(jc.transform(jnp.asarray(T)).points), atol=1e-6)
        np.testing.assert_array_equal(tc.mask_where(torch.from_numpy(keep)).valid.numpy(),
                                      np.asarray(jc.mask_where(jnp.asarray(keep)).valid))

    def test_masked_stats(self, rng):
        x = rng.normal(size=(30, 20)).astype(np.float32)
        m = rng.uniform(size=(30, 20)) < 0.5
        for dim in (None, 1):
            np.testing.assert_allclose(
                masked_mean(torch.from_numpy(x), torch.from_numpy(m), dim=dim).numpy(),
                np.asarray(j_masked_mean(jnp.asarray(x), jnp.asarray(m), axis=dim)),
                rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(
                masked_std(torch.from_numpy(x), torch.from_numpy(m), dim=dim).numpy(),
                np.asarray(j_masked_std(jnp.asarray(x), jnp.asarray(m), axis=dim)),
                rtol=1e-5, atol=1e-7)


class TestWindow:
    """Window sizing and origin must match exactly (they are integers)."""

    @pytest.mark.parametrize("diag,z", [(0.1526, 0.5), (0.95, 1.2), (0.3, 0.25), (0.05, 2.0)])
    def test_window_for_object(self, diag, z):
        for w, h in ((320, 240), (80, 60)):
            fj = g3.Intrinsics.from_fov(60.0, w, h)
            ft = Intrinsics.from_fov(60.0, w, h)
            assert twin.window_for_object(ft, diag, z) == jwin.window_for_object(fj, diag, z)
            for cfg in ("auto", None, (64, 128), (999, 999)):
                assert twin.window_dims(ft, cfg) == jwin.window_dims(fj, cfg)

    def test_window_origin(self, rng):
        verts = rng.uniform(-0.06, 0.06, size=(8, 3)).astype(np.float32)
        fj = g3.Intrinsics.from_fov(60.0, 320, 240)
        ft = Intrinsics.from_fov(60.0, 320, 240)
        for k in range(20):
            T = _pose(rng, z=rng.uniform(0.2, 1.0))
            T[:2, 3] = rng.uniform(-0.3, 0.3, size=2)
            if k == 0:
                T[2, 3] = -1.0  # behind the camera: frame-centre fallback
            o_j = np.asarray(jwin.window_origin(jnp.asarray(verts), jnp.asarray(T), fj, 128, 128))
            o_t = twin.window_origin(torch.from_numpy(verts), torch.from_numpy(T), ft, 128, 128)
            np.testing.assert_array_equal(o_t.numpy(), o_j)


def test_resolve_device_cpu():
    assert resolve_device("cpu").type == "cpu"
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
