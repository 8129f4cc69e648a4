"""Port parity, registration: the Horn/QUEST alignment and point-to-point
ICP against the JAX package on the same clouds. T within 1e-5, identical
``n_iters`` (the early-exit loop is part of parity), covariance within 1e-4
relative to its largest entry."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseestimator_tpu.geom3d.cloud import PointCloud as JCloud
from poseestimator_tpu.registration.icp import icp_point_to_point as j_icp
from poseestimator_tpu.registration.kabsch import kabsch as j_kabsch
from poseestimator_tpu_torch.geom3d.cloud import PointCloud
from poseestimator_tpu_torch.registration.icp import icp_point_to_point
from poseestimator_tpu_torch.registration.kabsch import kabsch

from helpers import box_mesh
from torch_threads import two_threads  # noqa: F401


def _rot(axis, ang):
    axis = np.asarray(axis, np.float64)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K


def test_kabsch_matches(rng):
    src = rng.normal(size=(200, 3)).astype(np.float32)
    R = _rot([0.3, -1.0, 0.5], 0.4)
    dst = (src @ R.T + [0.1, -0.2, 0.05] + rng.normal(size=src.shape) * 0.01).astype(np.float32)
    w = (rng.uniform(size=200) * (rng.uniform(size=200) < 0.8)).astype(np.float32)
    Rj, tj = j_kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    Rt, tt = kabsch(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
    # degenerate weights -> identity
    R0, t0 = kabsch(torch.from_numpy(src), torch.from_numpy(dst), torch.zeros(200))
    assert torch.equal(R0, torch.eye(3)) and torch.equal(t0, torch.zeros(3))


@pytest.fixture(scope="module")
def clouds():
    """A box surface observed one small motion away, with noise, clutter and
    invalid padding rows (the tracking regime at small size). Centred at the
    origin: 0.5 m out, the expanded distance form's rounding (~3e-8 m^2)
    reaches ~1% of a mm-scale neighbour distance, and the JAX package (XLA
    fuses multiply-adds on the CPU) and the port break such near-ties
    differently — the K1 tests cover that regime."""
    rng = np.random.default_rng(3)
    mesh = box_mesh(0.12, 0.08, 0.05)
    pts, _ = mesh.sample_points_uniformly(700, rng)
    src = np.zeros((800, 3), np.float32)
    src[:700] = pts
    sv = np.arange(800) < 700
    R = _rot([0.2, 1.0, -0.3], 0.03)
    dst = np.zeros((900, 3), np.float32)
    dst[:700] = src[:700] @ R.T + [0.004, -0.002, 0.001]
    dst[:700] += rng.normal(size=(700, 3)).astype(np.float32) * 5e-4
    dst[700:760] = rng.uniform(-0.1, 0.1, size=(60, 3))  # clutter
    dv = np.arange(900) < 760
    return src, sv, dst.astype(np.float32), dv


@pytest.mark.parametrize("accel,robust,with_cov", [
    (False, "none", True),
    (True, "none", True),
    (False, "huber", False),
    (True, "tukey", True),
])
def test_icp_point_to_point_matches(clouds, accel, robust, with_cov):
    src, sv, dst, dv = clouds
    kw = dict(max_corr_dist=0.02, max_iterations=30, robust=robust, with_cov=with_cov,
              accel=accel, accel_pose_tol=5e-5)
    rj = j_icp(JCloud(points=jnp.asarray(src), valid=jnp.asarray(sv)),
               JCloud(points=jnp.asarray(dst), valid=jnp.asarray(dv)), **kw)
    rt = icp_point_to_point(PointCloud(points=torch.from_numpy(src), valid=torch.from_numpy(sv)),
                            PointCloud(points=torch.from_numpy(dst), valid=torch.from_numpy(dv)),
                            **kw)
    assert rt.n_iters == int(rj.n_iters)
    assert 2 <= rt.n_iters < 30
    np.testing.assert_allclose(rt.T.numpy(), np.asarray(rj.T), atol=1e-5)
    np.testing.assert_allclose(float(rt.fitness), float(rj.fitness), atol=1e-6)
    np.testing.assert_allclose(float(rt.inlier_rmse), float(rj.inlier_rmse), rtol=1e-4)
    if with_cov:
        cj = np.asarray(rj.cov)
        np.testing.assert_allclose(rt.cov.numpy(), cj, atol=1e-4 * np.abs(cj).max())
