"""Port parity, the search's geometry: voxel downsampling and coverage,
normals, FPFH, feature matching, the point splat, the alignment score,
masked percentiles and the PCA hypotheses, each against the JAX package on
the same numpy inputs (JAX on the CPU, the port with CPU tensors).

Tolerances: voxel means within 1e-6 m (segment sums in another order);
normals |dot| >= 1 - 1e-5; FPFH within 1e-3 on >= 99% of the points (a
neighbour at the radius or an angle on a bin edge may round to the other
side); matches, voxel order, coverage and splat depth equal; scores within
1e-6 (the port's nearest-neighbour pass rounds as K1 does, the JAX CPU path
as a matmul does)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseestimator_tpu import geom3d as g3
from poseestimator_tpu.geom3d.cloud import PointCloud as JCloud
from poseestimator_tpu.geom3d.fpfh import compute_fpfh as j_fpfh
from poseestimator_tpu.geom3d.masked import masked_percentile as j_percentile
from poseestimator_tpu.geom3d.metrics import alignment_score as j_alignment_score
from poseestimator_tpu.geom3d.normals import estimate_normals as j_normals
from poseestimator_tpu.geom3d.sampling import voxel_coverage as j_coverage
from poseestimator_tpu.geom3d.sampling import voxel_down_sample as j_voxel
from poseestimator_tpu.pipeline.pose_estimator import _pca_hypotheses as j_pca_hypotheses
from poseestimator_tpu.registration.features import match_features as j_match
from poseestimator_tpu.render.points import render_depth as j_render_depth
from poseestimator_tpu_torch.geom3d.camera import Intrinsics
from poseestimator_tpu_torch.geom3d.cloud import PointCloud, compact
from poseestimator_tpu_torch.geom3d.fpfh import compute_fpfh
from poseestimator_tpu_torch.geom3d.masked import masked_median, masked_percentile
from poseestimator_tpu_torch.geom3d.metrics import alignment_score
from poseestimator_tpu_torch.geom3d.normals import estimate_normals
from poseestimator_tpu_torch.geom3d.sampling import voxel_coverage, voxel_down_sample
from poseestimator_tpu_torch.geom3d.se3 import enforce_upright_pose_y_up, look_at
from poseestimator_tpu_torch.pipeline.pose_estimator import _pca_hypotheses
from poseestimator_tpu_torch.registration.features import match_features
from poseestimator_tpu_torch.render.points import render_depth

from helpers import l_shape_mesh
from torch_threads import two_threads  # noqa: F401


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _surface(rng, n, n_pad, noise=0.0):
    """Samples of the L-shape CAD's surface padded with invalid rows."""
    pts, _ = l_shape_mesh().sample_points_uniformly(n, rng)
    pts = pts + rng.normal(size=pts.shape).astype(np.float32) * noise
    out = np.zeros((n + n_pad, 3), np.float32)
    out[:n] = pts
    valid = np.arange(n + n_pad) < n
    perm = rng.permutation(n + n_pad)
    return out[perm], valid[perm]


def _sphere(rng, n, radius=0.3):
    d = rng.normal(size=(n, 3))
    return (radius * d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("cap,voxel", [(None, 0.05), (64, 0.05), (1024, 0.1)])
def test_voxel_down_sample_matches(rng, cap, voxel):
    pts, valid = _surface(rng, 3000, 200, noise=0.002)
    jc = j_voxel(JCloud(points=jnp.asarray(pts), valid=jnp.asarray(valid)), voxel, capacity=cap)
    tc = voxel_down_sample(PointCloud(_t(pts), _t(valid)), voxel, capacity=cap)
    jv = np.asarray(jc.valid)
    np.testing.assert_array_equal(tc.valid.numpy(), jv)
    assert 0 < jv.sum() <= (cap or len(pts))
    np.testing.assert_allclose(tc.points.numpy(), np.asarray(jc.points), atol=1e-6)
    if cap == 64:  # more occupied voxels than the capacity: the guard cut
        assert jv.all()


def test_voxel_coverage_matches_batched(rng):
    clouds = [_surface(rng, 500, 40, noise=0.01) for _ in range(4)]
    pts = np.stack([c[0] for c in clouds]) + np.float32([[[0.0, 0.0, 0.5]]])
    valid = np.stack([c[1] for c in clouds])
    got = voxel_coverage(_t(pts), _t(valid), 0.05).numpy()
    want = [int(j_coverage(jnp.asarray(p), jnp.asarray(v), 0.05)) for p, v in zip(pts, valid)]
    np.testing.assert_array_equal(got, want)


def test_estimate_normals_match(rng):
    pts = _sphere(rng, 800) + np.float32([0.0, 0.0, 1.0])
    valid = rng.uniform(size=800) < 0.95
    for orient in ((0.0, 0.0, 0.0), (0.0, 0.0, 1.0)):
        jn = np.asarray(j_normals(JCloud(points=jnp.asarray(pts), valid=jnp.asarray(valid)),
                                  radius=0.1, max_nn=30,
                                  orient_towards=jnp.asarray(orient, jnp.float32)).normals)
        tn = estimate_normals(PointCloud(_t(pts), _t(valid)), radius=0.1, max_nn=30,
                              orient_towards=orient).normals.numpy()
        dots = np.sum(jn * tn, axis=1)[valid]
        assert np.all(dots >= 1.0 - 1e-5), dots.min()  # same sign: orientation is fixed
        np.testing.assert_array_equal(tn[~valid], 0.0)


def test_fpfh_matches(rng):
    pts = _sphere(rng, 400)
    valid = rng.uniform(size=400) < 0.95
    nrm = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    nrm = nrm + rng.normal(size=nrm.shape).astype(np.float32) * 0.05  # uneven angles
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    jf, jv = j_fpfh(JCloud(points=jnp.asarray(pts), valid=jnp.asarray(valid),
                           normals=jnp.asarray(nrm)), radius=0.25, max_nn=100)
    tf, tv = compute_fpfh(PointCloud(_t(pts), _t(valid), normals=_t(nrm)), radius=0.25,
                          max_nn=100)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    err = np.abs(tf.numpy() - np.asarray(jf)).max(axis=1)
    assert np.mean(err <= 1e-3) >= 0.99, np.sort(err)[-10:]
    assert np.asarray(jf)[valid].sum(1).min() > 0  # every valid point has neighbours


def test_fpfh_needs_normals():
    with pytest.raises(ValueError):
        compute_fpfh(PointCloud(torch.zeros(4, 3), torch.ones(4, dtype=torch.bool)), 0.1)


@pytest.mark.parametrize("mutual", [False, True])
def test_match_features_matches(rng, mutual):
    fs = rng.uniform(0, 50, size=(3, 128, 33)).astype(np.float32)
    fd = rng.uniform(0, 50, size=(512, 33)).astype(np.float32)
    fd[:64:7] = fs[0, :128:14] + 0.01  # some near-exact pairs
    sv = rng.uniform(size=(3, 128)) < 0.9
    dv = rng.uniform(size=512) < 0.8
    ti, tok = match_features(_t(fs), _t(sv), _t(fd), _t(dv), mutual=mutual)
    for b in range(3):
        ji, jok = j_match(jnp.asarray(fs[b]), jnp.asarray(sv[b]), jnp.asarray(fd),
                          jnp.asarray(dv), mutual=mutual)
        np.testing.assert_array_equal(tok[b].numpy(), np.asarray(jok))
        np.testing.assert_array_equal(ti[b].numpy()[np.asarray(jok)],
                                      np.asarray(ji)[np.asarray(jok)])


@pytest.mark.parametrize("splat", [0, 1])
def test_render_depth_matches(rng, splat):
    """The observed-cloud splat of the search: identity pose, a cloud in
    front of the camera and some points behind it or outside the frame."""
    pts = (rng.uniform(-0.4, 0.4, size=(3000, 3)) + [0.0, 0.0, 1.0]).astype(np.float32)
    pts[:50, 2] = -0.5  # behind the camera
    valid = rng.uniform(size=3000) < 0.9
    ji = g3.Intrinsics.from_fov(60.0, 80, 60)
    ti = Intrinsics.from_fov(60.0, 80, 60)
    jd = j_render_depth(jnp.asarray(pts), jnp.asarray(valid), jnp.eye(4), ji, near=0.01,
                        far=5.0, splat=splat)
    td = render_depth(_t(pts), _t(valid), torch.eye(4), ti, near=0.01, far=5.0, splat=splat)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert (td > 0).sum() > 500


def test_masked_percentile_matches(rng):
    x = rng.normal(size=(5, 300)).astype(np.float32)
    m = rng.uniform(size=(5, 300)) < 0.6
    m[3] = False  # empty row -> 0
    m[4] = False
    m[4, 17] = True  # one valid entry
    for q in (50.0, 90.0):
        got = masked_percentile(_t(x), _t(m), q).numpy()
        want = [float(j_percentile(jnp.asarray(a), jnp.asarray(b), q)) for a, b in zip(x, m)]
        np.testing.assert_allclose(got, want, atol=1e-6)
        np.testing.assert_allclose(got[:3], [np.percentile(a[b], q) for a, b in zip(x[:3], m[:3])],
                                   atol=1e-6)
    assert float(masked_median(_t(x[4]), _t(m[4]))) == x[4, 17]


def test_alignment_score_matches_batched(rng):
    src, sv = _surface(rng, 120, 8)
    dst, dv = _surface(rng, 400, 112, noise=0.003)
    ang = [0.0, 0.05, 0.3, 1.5]
    aligned = []
    for a in ang:
        c, s = np.cos(a), np.sin(a)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        aligned.append(src @ R.T + np.float32([0.01 * a, 0.0, 0.0]))
    aligned = np.stack(aligned).astype(np.float32)
    svb = np.broadcast_to(sv, aligned.shape[:2])
    got = alignment_score(PointCloud(_t(aligned), _t(svb.copy())),
                          PointCloud(_t(np.broadcast_to(src, aligned.shape).copy()),
                                     _t(svb.copy())),
                          PointCloud(_t(dst), _t(dv)), 0.05).numpy()
    want = [float(j_alignment_score(JCloud(points=jnp.asarray(a), valid=jnp.asarray(sv)),
                                    JCloud(points=jnp.asarray(src), valid=jnp.asarray(sv)),
                                    JCloud(points=jnp.asarray(dst), valid=jnp.asarray(dv)), 0.05))
            for a in aligned]
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert got[0] < got[-1]


def test_pca_hypotheses_match_as_a_set(rng):
    """The 4 sign alignments do not depend on the eigensolvers' column
    signs as a set; their order may."""
    src, sv = _surface(rng, 300, 20)
    dst, dv = _surface(rng, 500, 30)
    c, s = np.cos(0.7), np.sin(0.7)
    dst = (dst @ np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32).T + 0.2).astype(np.float32)
    jh = np.asarray(j_pca_hypotheses(JCloud(points=jnp.asarray(src), valid=jnp.asarray(sv)),
                                     JCloud(points=jnp.asarray(dst), valid=jnp.asarray(dv))))
    th = _pca_hypotheses(_t(src)[None], _t(sv)[None], PointCloud(_t(dst), _t(dv)))[0].numpy()
    used = set()
    for h in th:
        err = [np.abs(h - j).max() for j in jh]
        k = int(np.argmin(err))
        assert err[k] < 1e-4 and k not in used, err
        used.add(k)


@pytest.mark.parametrize("turns", [0, 1, 2, 3, None])
def test_enforce_upright_and_look_at_match(rng, turns):
    """A pose whose model +Y lies 0.2 rad from world -Y after ``turns``
    quarter turns about the model's Z (None: a random pose, which
    usually stays unchanged)."""
    eye = rng.uniform(-1.0, 1.0, 3) + [0.0, 0.0, 2.0]
    T_j = np.asarray(g3.look_at(eye, [0.0, 0.1, 0.0], [0.0, 1.0, 0.0]))
    T_t = look_at(eye, [0.0, 0.1, 0.0], [0.0, 1.0, 0.0]).numpy()
    np.testing.assert_allclose(T_t, T_j, atol=1e-6)
    if turns is None:
        R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        R = R * np.sign(np.linalg.det(R))
    else:
        c, s = np.cos(0.2), np.sin(0.2)
        R0 = np.array([[1, 0, 0], [0, -c, -s], [0, s, -c]])  # column 1 near (0, -1, 0)
        rz = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
        R = R0 @ np.linalg.matrix_power(rz.T, turns)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = rng.uniform(-0.1, 0.1, 3)
    got = enforce_upright_pose_y_up(_t(T)).numpy()
    np.testing.assert_allclose(got, np.asarray(g3.enforce_upright_pose_y_up(jnp.asarray(T))),
                               atol=1e-6)
    if turns is not None:
        assert got[1, 1] < -0.9  # snapped


def test_compact_keeps_order(rng):
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    valid = rng.uniform(size=50) < 0.5
    c = compact(PointCloud(_t(pts), _t(valid)), 64)
    n = int(valid.sum())
    np.testing.assert_array_equal(c.points[:n].numpy(), pts[valid])
    assert c.valid[:n].all() and not c.valid[n:].any()
    assert (c.points[n:] == 0).all()
