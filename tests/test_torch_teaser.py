"""Port parity, the search's registration: RANSAC with the JAX package's own
uniform draws injected (the same winning triad, T within 1e-5, equal
correspondence masks), the greedy max clique (equal masks and sizes),
``teaser_solve`` (equal clique masks, R and t within 1e-4) and the batched
point-to-point ICP: each chain equal bit for bit to an unbatched call of the
port, and to the JAX package's ``vmap`` of its loop within the ICP
tolerance of ``tests/test_torch_icp.py`` (T within 1e-5, equal n_iters).
Every port call runs a batch of problems; the JAX side runs them one by
one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseestimator_tpu.geom3d.cloud import PointCloud as JCloud
from poseestimator_tpu.registration import teaser as jteaser
from poseestimator_tpu.registration.icp import icp_point_to_point as j_icp
from poseestimator_tpu.registration.maxclique import max_clique_greedy as j_clique
from poseestimator_tpu.registration.ransac import _hypothesis as j_hypothesis
from poseestimator_tpu.registration.ransac import ransac_registration as j_ransac
from poseestimator_tpu.registration.ransac import sample_triads as j_sample_triads
from poseestimator_tpu_torch.geom3d.cloud import PointCloud
from poseestimator_tpu_torch.registration import teaser
from poseestimator_tpu_torch.registration.icp import (icp_point_to_point,
                                                      icp_point_to_point_batched)
from poseestimator_tpu_torch.registration.maxclique import max_clique_greedy
from poseestimator_tpu_torch.registration.ransac import ransac_registration

from helpers import box_mesh
from torch_threads import two_threads  # noqa: F401


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rot(axis, ang):
    axis = np.asarray(axis, np.float64)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K


def _correspondences(rng, K=128, inlier_frac=0.5, noise=0.005, scale=0.3):
    """src (K, 3) and dst = R src + t (+ noise) on an inlier subset, random
    elsewhere; a trailing block of invalid rows."""
    src = rng.uniform(-scale, scale, size=(K, 3)).astype(np.float32)
    R = _rot(rng.normal(size=3), rng.uniform(0.3, 2.0))
    t = rng.uniform(-0.2, 0.2, size=3)
    dst = src @ R.T + t + rng.normal(size=(K, 3)) * noise
    inl = rng.uniform(size=K) < inlier_frac
    dst[~inl] = rng.uniform(-scale, scale, size=(int((~inl).sum()), 3)) + t
    valid = np.arange(K) < K - 8
    return src, dst.astype(np.float32), valid, inl & valid, R.astype(np.float32), t


@pytest.fixture(scope="module")
def ransac_problems():
    """Two template-sized match sets against one shared destination cloud."""
    rng = np.random.default_rng(11)
    probs = []
    dst_all = []
    for b in range(2):
        src, dst, valid, inl, _, _ = _correspondences(rng, K=128, inlier_frac=0.4)
        dst_all.append(dst)
        probs.append((src, valid))
    dst_pts = np.concatenate(dst_all + [rng.uniform(-0.3, 0.3, size=(256, 3)).astype(np.float32)])
    # match b, i -> its own row in the stacked destination
    midx = np.stack([np.arange(128) + 128 * b for b in range(2)])
    src = np.stack([p[0] for p in probs])
    mok = np.stack([p[1] for p in probs])
    return src, dst_pts, midx, mok


def test_ransac_injected_uniforms_match(ransac_problems):
    src, dst_pts, midx, mok = ransac_problems
    corr = 0.02
    keys = [jax.random.PRNGKey(5 + b) for b in range(2)]
    u = np.stack([np.asarray(jax.random.uniform(k, (2048, 3))) for k in keys])
    tr = ransac_registration(_t(src), _t(dst_pts), _t(midx), _t(mok), corr, n_iters=2048,
                             uniforms=_t(u))
    for b in range(2):
        jr = j_ransac(keys[b], jnp.asarray(src[b]), jnp.asarray(dst_pts), jnp.asarray(midx[b]),
                      jnp.asarray(mok[b]), corr, n_iters=2048)
        # the JAX winner, from its own hypothesis scores
        sel = j_sample_triads(keys[b], jnp.asarray(mok[b]), 2048)
        dst_c = jnp.asarray(dst_pts)[jnp.asarray(midx[b])]
        scores, _, _, _ = jax.vmap(lambda s: j_hypothesis(
            s, jnp.asarray(src[b]), dst_c, jnp.asarray(mok[b]), jnp.float32(corr), 0.9))(sel)
        np.testing.assert_array_equal(tr.triad[b].numpy(), np.asarray(sel[jnp.argmax(scores)]))
        assert bool(tr.found[b]) and bool(jr.found)
        np.testing.assert_allclose(tr.T[b].numpy(), np.asarray(jr.T), atol=1e-5)
        np.testing.assert_array_equal(tr.corr_mask[b].numpy(), np.asarray(jr.corr_mask))
        assert int(tr.n_inliers[b]) == int(jr.n_inliers) > 30
        np.testing.assert_allclose(float(tr.inlier_rmse[b]), float(jr.inlier_rmse), rtol=1e-4)


def _planted_graphs(rng, n=3, K=96):
    adj = np.zeros((n, K, K), bool)
    valid = np.ones((n, K), bool)
    for b in range(n):
        A = rng.uniform(size=(K, K)) < 0.08 + 0.04 * b
        members = rng.choice(K, size=20 + 5 * b, replace=False)
        A[np.ix_(members, members)] = True
        A = A | A.T
        adj[b] = A
        valid[b, rng.choice(K, size=6, replace=False)] = False
    return adj, valid


def test_max_clique_greedy_matches(rng):
    adj, valid = _planted_graphs(rng)
    cm, size = max_clique_greedy(_t(adj), _t(valid))
    for b in range(adj.shape[0]):
        jm, js = j_clique(jnp.asarray(adj[b]), jnp.asarray(valid[b]))
        np.testing.assert_array_equal(cm[b].numpy(), np.asarray(jm))
        assert int(size[b]) == int(js) == int(cm[b].sum()) >= 15
        members = np.flatnonzero(cm[b].numpy())
        sub = adj[b][np.ix_(members, members)] | np.eye(len(members), dtype=bool)
        assert sub.all() and valid[b][members].all()  # a clique of valid vertices


def test_teaser_solve_matches(rng):
    probs = [_correspondences(rng, K=128, inlier_frac=f, noise=0.004) for f in (0.6, 0.3)]
    src = np.stack([p[0] for p in probs])
    dst = np.stack([p[1] for p in probs])
    valid = np.stack([p[2] for p in probs])
    params = teaser.TeaserParams(noise_bound=0.01)
    ts = teaser.teaser_solve(_t(src), _t(dst), _t(valid), params)
    for b, (_, _, _, inl, R_true, t_true) in enumerate(probs):
        js = jteaser.teaser_solve(jnp.asarray(src[b]), jnp.asarray(dst[b]), jnp.asarray(valid[b]),
                                  jteaser.TeaserParams(noise_bound=0.01))
        np.testing.assert_array_equal(ts.clique_mask[b].numpy(), np.asarray(js.clique_mask))
        np.testing.assert_allclose(ts.rotation[b].numpy(), np.asarray(js.rotation), atol=1e-4)
        np.testing.assert_allclose(ts.translation[b].numpy(), np.asarray(js.translation),
                                   atol=1e-4)
        np.testing.assert_array_equal(ts.translation_inliers[b].numpy(),
                                      np.asarray(js.translation_inliers))
        assert bool(ts.valid[b])
        np.testing.assert_allclose(ts.rotation[b].numpy(), R_true, atol=0.03)
        np.testing.assert_allclose(ts.T[b, :3, 3].numpy(), t_true, atol=0.02)


def test_teaser_degenerate_and_unported(rng):
    """Fewer than 3 correspondences give the identity, invalid; every
    option the port once refused now solves (each is held to the JAX
    package in tests/test_torch_offline.py)."""
    src, dst, valid, _, _, _ = _correspondences(rng, K=16)
    few = np.zeros(16, bool)
    few[:2] = True
    s = teaser.teaser_solve(_t(src), _t(dst), _t(few))
    assert not bool(s.valid) and torch.equal(s.T, torch.eye(4))
    for kw in (dict(rotation_estimation_algorithm=int(teaser.RotationEstimationAlgorithm.FGR)),
               dict(rotation_estimation_algorithm=int(teaser.RotationEstimationAlgorithm.QUATRO)),
               dict(inlier_selection_mode=int(teaser.InlierSelectionMode.KCORE_HEU)),
               dict(rotation_tim_graph=int(teaser.InlierGraphFormulation.COMPLETE)),
               dict(estimate_scaling=True)):
        s = teaser.teaser_solve(_t(src), _t(dst), _t(valid), teaser.TeaserParams(**kw))
        assert bool(s.valid) and torch.isfinite(s.T).all()


@pytest.fixture(scope="module")
def chains():
    """Five chains of one box cloud from different starts (the coarse
    stage's shape: a leading chain axis, one shared destination), centred at
    the origin (see tests/test_torch_icp.py on near-ties further out)."""
    rng = np.random.default_rng(4)
    pts, _ = box_mesh(0.12, 0.08, 0.05).sample_points_uniformly(400, rng)
    dst = np.zeros((500, 3), np.float32)
    dst[:400] = pts + rng.normal(size=pts.shape).astype(np.float32) * 5e-4
    dv = np.arange(500) < 430
    dst[400:430] = rng.uniform(-0.08, 0.08, size=(30, 3))
    src = np.zeros((5, 320, 3), np.float32)
    sv = np.zeros((5, 320), bool)
    T0 = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    for b in range(5):
        n = 250 + 10 * b
        src[b, :n] = pts[rng.choice(400, n, replace=False)]
        sv[b, :n] = True
        T0[b, :3, :3] = _rot(rng.normal(size=3), 0.02 + 0.02 * b)
        T0[b, :3, 3] = rng.uniform(-0.006, 0.006, size=3)
    return src, sv, dst, dv, T0


def test_batched_icp_equals_unbatched_and_jax_vmap(chains):
    src, sv, dst, dv, T0 = chains
    kw = dict(max_corr_dist=0.02, max_iterations=30, relative_fitness=1e-6, relative_rmse=1e-6)
    D = PointCloud(_t(dst), _t(dv))
    rb = icp_point_to_point_batched(_t(src), _t(sv), D, init_T=_t(T0), **kw)
    for b in range(5):
        ru = icp_point_to_point(PointCloud(_t(src[b]), _t(sv[b])), D, init_T=_t(T0[b]), **kw)
        assert int(rb.n_iters[b]) == ru.n_iters
        assert torch.equal(rb.T[b], ru.T)
        assert torch.equal(rb.fitness[b], ru.fitness)
        assert torch.equal(rb.inlier_rmse[b], ru.inlier_rmse)
    assert rb.n_evals == int(rb.n_iters.max()) + 1
    assert len(set(rb.n_iters.tolist())) > 1  # chains stop at different iterations

    jd = JCloud(points=jnp.asarray(dst), valid=jnp.asarray(dv))
    jr = jax.vmap(lambda p, v, T: j_icp(JCloud(points=p, valid=v), jd, init_T=T, **kw))(
        jnp.asarray(src), jnp.asarray(sv), jnp.asarray(T0))
    np.testing.assert_array_equal(rb.n_iters.numpy(), np.asarray(jr.n_iters))
    np.testing.assert_allclose(rb.T.numpy(), np.asarray(jr.T), atol=1e-5)
    np.testing.assert_allclose(rb.fitness.numpy(), np.asarray(jr.fitness), atol=1e-6)
