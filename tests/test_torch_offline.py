"""Port parity, the offline single-frame path: the small geometry helpers
(``from_points``, ``angular_error``, ``project_points``,
``initial_align_centroid_pca``) to 1e-6, farthest-point sampling from an
injected start (identical indices), the RANSAC retry ladder on injected
triads (the same rung, equal correspondence masks), the native exact clique
(the same certified clique as the JAX package's binding; four processes
loading it at once from an empty build directory all succeed), every TEASER
back-end the port used to refuse against the JAX ``teaser_solve`` (R and t
within 1e-4), ``load_geometry``, and ``find_best_template_teaser`` end to
end on a 160x120 frame with the JAX package's own draws injected (the same
template, correspondence count and clique; both under ADD 0.15 x diag).

The scene, the CAD and the template database are written by the port; the
JAX side reads the port's files (templates cut to 2000 points each, three
of the five views, so that its compiled search stays small). The L-shape is
cut to 0.3 scale and seen from 0.6 m: 100 farthest-point samples are then
dense enough for the fixed 5 cm normal radius. On sparser samples most
neighbourhoods hold one or two points, and the normal of such a degenerate
neighbourhood is whatever basis the eigensolver returns, which differs
between LAPACK builds (the two packages' FPFH features then differ)."""
import fcntl
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseestimator_tpu import geom3d as g3
from poseestimator_tpu.pipeline.offline import find_best_template_teaser as j_offline
from poseestimator_tpu.registration import native as j_native
from poseestimator_tpu.registration import teaser as jteaser
from poseestimator_tpu.registration.ransac import get_correspondences as j_get_corr
from poseestimator_tpu.render.mesh import load_geometry as j_load_geometry
from poseestimator_tpu.utils import bop as j_bop
from poseestimator_tpu_torch import kernel_cases as kc
from poseestimator_tpu_torch.geom3d import camera as t_camera
from poseestimator_tpu_torch.geom3d import cloud as t_cloud
from poseestimator_tpu_torch.geom3d import se3 as t_se3
from poseestimator_tpu_torch.geom3d.camera import Intrinsics
from poseestimator_tpu_torch.geom3d.sampling import downsample_to, farthest_point_sampling
from poseestimator_tpu_torch.pipeline import offline
from poseestimator_tpu_torch.registration import native, teaser
from poseestimator_tpu_torch.registration.ransac import get_correspondences
from poseestimator_tpu_torch.render.mesh import TriangleMesh, load_geometry
from poseestimator_tpu_torch.templates.creation import render_templates
from poseestimator_tpu_torch.utils.plyio import read_ply, write_ply
from torch_threads import two_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INTR = Intrinsics.from_fov(60.0, 160, 120)
SCALE, DIST = 0.3, 0.6
TEMPLATE_VIEWS = (1, 3, 4)  # views 7, 11 and 12 of the reduced set
TEMPLATE_POINTS = 2000


def _t(a):
    return torch.from_numpy(np.array(a))


_WHOLE_PROBE = "import ctypes, sys; ctypes.CDLL(sys.argv[1]).pe_max_clique"


@pytest.fixture(scope="module", autouse=True)
def _jax_native_whole():
    """Make the JAX package's own exact clique library whole before this
    module's comparisons, and load it. That binding runs ``make`` on
    ``native/libpe_native.so`` at first use, and other test processes may
    be writing that file at the same moment (``tests/test_native.py``
    loads it in its module-level ``skipif``): a process that finds it half
    written fails to load it and then runs the greedy clique where the
    port runs the exact one. Here ``make -C native`` runs under the lock
    of the port's own build (``build/native/lock``), and the result counts
    as whole once a child process has loaded it: a child that meets a
    half-written file fails (or dies) in place of this one, and the make
    and the probe are retried. A binding that already loaded a library
    keeps it; its state is restored afterwards."""
    saved = j_native._lib, j_native._tried
    if j_native._lib is None:
        so = j_native._SO_PATH
        native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(native.BUILD_DIR / "lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            for _ in range(10):
                made = subprocess.run(["make", "-s", "-C", os.path.dirname(so)],
                                      capture_output=True, timeout=120).returncode == 0
                if not made and not os.path.exists(so):
                    break  # no compiler: neither package has the exact clique
                if os.path.exists(so) and subprocess.run(
                        [sys.executable, "-c", _WHOLE_PROBE, so],
                        capture_output=True, timeout=60).returncode == 0:
                    break
                time.sleep(1.0)
        j_native._lib, j_native._tried = None, False
        j_native._load()
    yield
    j_native._lib, j_native._tried = saved


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The L-shape CAD at 0.3 scale, its template database (port-rendered,
    cut to three views of 2000 points), and a three-frame 160x120 BOP
    scene."""
    d = tmp_path_factory.mktemp("offline")
    v, f = kc.lshape_mesh(SCALE)
    cad = str(d / "obj_000001.ply")
    write_ply(cad, v, faces=f)
    full = render_templates(cad, str(d / "views_full"), device="cpu")
    views = d / "views"
    views.mkdir()
    rng = np.random.default_rng(0)
    for i in TEMPLATE_VIEWS:
        pts = read_ply(full[i]).vertices
        keep = np.sort(rng.choice(len(pts), TEMPLATE_POINTS, replace=False))
        write_ply(str(views / os.path.basename(full[i])), pts[keep])
    poses = kc.bop_scene_poses(DIST)
    sd = str(d / "scene")
    kc.write_bop_scene(sd, v, f, INTR, poses, symmetries=kc.lshape_symmetry(SCALE)[None])
    return {"dir": d, "cad": cad, "views": str(views), "scene": sd, "poses": poses,
            "verts": v, "faces": f}


# --- small helpers ------------------------------------------------------------


def test_helpers_match_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    nrm = rng.normal(size=(50, 3)).astype(np.float32)
    jc = g3.from_points(pts, capacity=64, normals=nrm)
    tc = t_cloud.from_points(pts, capacity=64, normals=nrm, device="cpu")
    np.testing.assert_array_equal(tc.points.numpy(), np.asarray(jc.points))
    np.testing.assert_array_equal(tc.normals.numpy(), np.asarray(jc.normals))
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
    np.testing.assert_array_equal(t_cloud.to_numpy(tc), g3.to_numpy(jc))
    with pytest.raises(ValueError):
        t_cloud.from_points(pts, capacity=10, device="cpu")

    for ang in (1e-4, 0.3, 2.0, 3.1):
        R1 = np.asarray(g3.axis_angle_to_R(jnp.asarray(rng.normal(size=3), jnp.float32), 0.7))
        R2 = np.asarray(g3.axis_angle_to_R(jnp.asarray(rng.normal(size=3), jnp.float32), ang))
        R2 = (R1 @ R2).astype(np.float32)
        np.testing.assert_allclose(float(t_se3.angular_error(_t(R1), _t(R2))),
                                   float(g3.angular_error(jnp.asarray(R1), jnp.asarray(R2))),
                                   rtol=1e-6, atol=1e-7)

    K = np.array([[500.0, 0, 320], [0, 510.0, 240], [0, 0, 1]], np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.asarray(g3.axis_angle_to_R(jnp.asarray([0.2, 1.0, -0.3]), 0.4))
    T[:3, 3] = [0.05, -0.02, 0.5]
    mpts = (rng.normal(size=(200, 3)) * 0.3).astype(np.float32)  # some behind the camera
    uv_j, fr_j = g3.project_points(jnp.asarray(mpts), jnp.asarray(K), jnp.asarray(T))
    uv_t, fr_t = t_camera.project_points(_t(mpts), _t(K), _t(T))
    np.testing.assert_array_equal(fr_t.numpy(), np.asarray(fr_j))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-6, atol=1e-4)


def test_initial_align_matches_jax_and_ignores_eigenvector_signs():
    rng = np.random.default_rng(1)
    src = (rng.normal(size=(300, 3)) * [0.3, 0.1, 0.05]).astype(np.float32)
    R = np.asarray(g3.axis_angle_to_R(jnp.asarray([0.3, -0.5, 0.8]), 1.1))
    dst = (src[:250] @ R.T + [0.1, 0.2, 1.5]).astype(np.float32)
    T_j = np.asarray(g3.initial_align_centroid_pca(g3.from_points(src), g3.from_points(dst)))
    ts = t_cloud.from_points(src, capacity=320, device="cpu")
    td = t_cloud.from_points(dst, device="cpu")
    T_t = t_se3.initial_align_centroid_pca(ts, td).numpy()
    np.testing.assert_allclose(T_t, T_j, atol=1e-6)
    # flipped eigenvector columns on either side give the same T0
    real = t_se3.pca_axes

    def flipped(points, valid):
        R_, s_ = real(points, valid)
        return R_ * torch.tensor([-1.0, 1.0, -1.0]), s_

    t_se3.pca_axes = flipped
    try:
        T_f = t_se3.initial_align_centroid_pca(ts, td).numpy()
    finally:
        t_se3.pca_axes = real
    np.testing.assert_allclose(T_f, T_t, atol=1e-6)
    # the four sign candidates: the same set as the JAX package's
    from poseestimator_tpu.pipeline.offline import _pca_sign_candidates as j_cands

    cj = np.stack(j_cands(g3.from_points(src), g3.from_points(dst)))
    ct = offline._pca_sign_candidates(ts, td).numpy()
    for c in ct:
        assert np.min(np.abs(cj - c).reshape(4, -1).max(1)) < 1e-5


def test_farthest_point_sampling_matches_jax():
    rng = np.random.default_rng(2)
    pts = (rng.normal(size=(700, 3)) * 0.2).astype(np.float32)  # centred at the origin
    valid = rng.uniform(size=700) < 0.9
    jc = g3.PointCloud(points=jnp.asarray(pts), valid=jnp.asarray(valid))
    tc = t_cloud.PointCloud(points=_t(pts), valid=_t(valid))
    for n, seed in ((100, 0), (64, 1)):
        key = jax.random.PRNGKey(seed)
        jd = g3.farthest_point_sampling(key, jc, n)
        g = _t(np.asarray(jax.random.gumbel(key, (700,))))
        td = farthest_point_sampling(tc, n, gumbel=g)
        np.testing.assert_array_equal(td.points.numpy(), np.asarray(jd.points))
        np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jd.valid))
        assert torch.equal(downsample_to(tc, n, "fps", draws=g).points, td.points)
    # more samples than valid points: the tail is invalid
    few = np.zeros(700, bool)
    few[[3, 50, 400]] = True
    key = jax.random.PRNGKey(3)
    jd = g3.farthest_point_sampling(key, g3.PointCloud(points=jnp.asarray(pts),
                                                       valid=jnp.asarray(few)), 8)
    td = farthest_point_sampling(t_cloud.PointCloud(points=_t(pts), valid=_t(few)), 8,
                                 gumbel=_t(np.asarray(jax.random.gumbel(key, (700,)))))
    np.testing.assert_array_equal(td.points.numpy(), np.asarray(jd.points))
    np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jd.valid))


def test_load_geometry_matches_jax(scene):
    mj, mt = j_load_geometry(scene["cad"]), load_geometry(scene["cad"])
    assert isinstance(mt, TriangleMesh)
    np.testing.assert_array_equal(mt.faces, np.asarray(mj.faces))
    np.testing.assert_allclose(mt.vertex_normals, np.asarray(mj.vertex_normals), atol=1e-6)
    tpl = os.path.join(scene["views"], sorted(os.listdir(scene["views"]))[0])
    pj, pt = j_load_geometry(tpl), load_geometry(tpl)
    assert not isinstance(pt, TriangleMesh)
    np.testing.assert_array_equal(pt.vertices, np.asarray(pj.vertices))


# --- registration -------------------------------------------------------------


def _correspondences(rng, K, inlier_frac=0.6, noise=0.004, scale=0.3, yaw_only=False, s=1.0):
    src = rng.uniform(-scale, scale, size=(K, 3)).astype(np.float32)
    axis = np.array([0.0, 0.0, 1.0]) if yaw_only else rng.normal(size=3)
    R = np.asarray(g3.axis_angle_to_R(jnp.asarray(axis, jnp.float32), rng.uniform(0.3, 1.5)))
    t = rng.uniform(-0.2, 0.2, size=3)
    dst = s * src @ R.T + t + rng.normal(size=(K, 3)) * noise
    inl = rng.uniform(size=K) < inlier_frac
    dst[~inl] = rng.uniform(-scale, scale, size=(int((~inl).sum()), 3)) + t
    valid = np.arange(K) < K - 5
    return src, dst.astype(np.float32), valid, R, t


_BACKENDS = {
    "FGR": dict(rotation_estimation_algorithm=int(teaser.RotationEstimationAlgorithm.FGR)),
    "QUATRO": dict(rotation_estimation_algorithm=int(teaser.RotationEstimationAlgorithm.QUATRO)),
    "KCORE_HEU": dict(inlier_selection_mode=int(teaser.InlierSelectionMode.KCORE_HEU)),
    "COMPLETE": dict(rotation_tim_graph=int(teaser.InlierGraphFormulation.COMPLETE)),
    "estimate_scaling": dict(estimate_scaling=True),
}


@pytest.mark.parametrize("name", list(_BACKENDS))
def test_teaser_backends_match_jax(name):
    """Each back-end on two problems (one port call, a batch of 2) against
    the JAX ``teaser_solve`` one by one: equal clique and translation
    inlier masks, R and t within 1e-4."""
    rng = np.random.default_rng(7)
    K = 40 if name in ("COMPLETE", "estimate_scaling") else 100
    probs = [_correspondences(rng, K, yaw_only=name == "QUATRO",
                              s=1.3 if name == "estimate_scaling" else 1.0) for _ in range(2)]
    src, dst, valid = (np.stack([p[i] for p in probs]) for i in range(3))
    kw = dict(noise_bound=0.01, **_BACKENDS[name])
    ts = teaser.teaser_solve(_t(src), _t(dst), _t(valid), teaser.TeaserParams(**kw))
    for b, (_, _, _, R_true, t_true) in enumerate(probs):
        js = jteaser.teaser_solve(jnp.asarray(src[b]), jnp.asarray(dst[b]), jnp.asarray(valid[b]),
                                  jteaser.TeaserParams(**kw))
        np.testing.assert_array_equal(ts.clique_mask[b].numpy(), np.asarray(js.clique_mask))
        np.testing.assert_array_equal(ts.translation_inliers[b].numpy(),
                                      np.asarray(js.translation_inliers))
        np.testing.assert_array_equal(ts.rotation_inliers[b].numpy(),
                                      np.asarray(js.rotation_inliers))
        np.testing.assert_allclose(float(ts.scale[b]), float(js.scale), rtol=1e-5)
        np.testing.assert_allclose(ts.rotation[b].numpy(), np.asarray(js.rotation), atol=1e-4)
        np.testing.assert_allclose(ts.translation[b].numpy(), np.asarray(js.translation),
                                   atol=1e-4)
        assert bool(ts.valid[b])
        if name != "estimate_scaling":
            np.testing.assert_allclose(ts.rotation[b].numpy(), R_true, atol=0.03)


def test_max_kcore_matches_jax():
    from poseestimator_tpu.registration.maxclique import max_kcore as j_kcore
    from poseestimator_tpu_torch.registration.maxclique import max_kcore

    rng = np.random.default_rng(8)
    for K in (12, 40):
        adj = rng.uniform(size=(K, K)) < 0.3
        adj[:8, :8] = True  # a planted clique
        adj = adj | adj.T
        valid = rng.uniform(size=K) < 0.9
        cj, kj = j_kcore(jnp.asarray(adj), jnp.asarray(valid))
        ct, kt = max_kcore(_t(adj), _t(valid))
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        assert int(kt) == int(kj)


@pytest.mark.parametrize("threshold,rung", [(0.02, 0), (4.5e-4, 1), (1e-5, 2)])
def test_retry_ladder_matches_jax(threshold, rung):
    """The retry ladder on matches whose inliers sit 4 mm off: a threshold
    met at once, one that first finds a hypothesis at twice itself, and one
    that fails through to the last rung. Both packages take the rung named
    (the JAX package's draws of each rung injected) and give equal
    correspondence masks."""
    from poseestimator_tpu.registration.ransac import ransac_registration as j_ransac

    rng = np.random.default_rng(9)
    N, M = 120, 150
    dst = (rng.normal(size=(M, 3)) * 0.2).astype(np.float32)
    midx = rng.integers(0, M, N)
    dirs = rng.normal(size=(N, 3))
    src = (dst[midx] + 0.004 * dirs / np.linalg.norm(dirs, axis=1, keepdims=True))
    src[::3] = rng.normal(size=(len(src[::3]), 3)) * 0.2
    src = src.astype(np.float32)
    mok = rng.uniform(size=N) < 0.95
    key = jax.random.PRNGKey(2)
    args = (jnp.asarray(src), jnp.asarray(dst), jnp.asarray(midx), jnp.asarray(mok))
    rj = j_get_corr(key, *args, threshold, n_iters=512)
    keys = jax.random.split(key, 3)
    want = j_ransac(keys[rung], *args, threshold * (1.0, 2.0, 0.5)[rung], n_iters=512)
    np.testing.assert_array_equal(np.asarray(rj.corr_mask), np.asarray(want.corr_mask))
    assert (int(rj.n_inliers) >= 3) == (rung < 2)
    u = [_t(np.asarray(jax.random.uniform(k, (512, 3)))) for k in keys]
    rt = get_correspondences(_t(src), _t(dst), _t(midx), _t(mok), threshold, n_iters=512,
                             uniforms=u)
    np.testing.assert_array_equal(rt.corr_mask.numpy(), np.asarray(rj.corr_mask))
    assert int(rt.n_inliers) == int(rj.n_inliers)
    np.testing.assert_allclose(rt.T.numpy(), np.asarray(rj.T), atol=1e-5)


# --- the native exact clique --------------------------------------------------


def test_native_clique_matches_jax_binding():
    if not j_native.available():
        pytest.skip("the JAX package's native library did not build")
    assert native.available()
    rng = np.random.default_rng(10)
    for K, p in ((30, 0.5), (80, 0.3), (200, 0.1)):
        adj = rng.uniform(size=(K, K)) < p
        adj = adj | adj.T
        valid = rng.uniform(size=K) < 0.9
        mj, sj = j_native.max_clique_exact(adj, valid)
        mt, st = native.max_clique_exact(adj, valid)
        assert st == sj
        np.testing.assert_array_equal(mt, mj)
        sub = adj[np.ix_(mt, mt)] | np.eye(st, dtype=bool)
        assert sub.all() and valid[mt].all()


_LOAD_PROBE = r"""
import sys
from pathlib import Path
from poseestimator_tpu_torch.registration import native
native.BUILD_DIR = Path(sys.argv[1])
import numpy as np
adj = np.ones((5, 5), bool)
print(int(native.available()), native.max_clique_exact(adj)[1])
"""


def test_native_concurrent_first_load(tmp_path):
    """Four processes load the library at once from an empty build
    directory: one builds under the lock, every one loads a whole file."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    build = tmp_path / "native"
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD_PROBE, str(build)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == ["1", "5"], (out, err)
    libs = sorted(x.name for x in build.iterdir() if x.suffix == ".so")
    assert len(libs) == 1 and not any(x.suffix == ".tmp" for x in build.iterdir())
    # nothing of the port's build lands in the source directory (the JAX
    # binding's own libpe_native.so may appear there from another test)
    port_made = [x for x in os.listdir(os.path.join(REPO, "native"))
                 if x == "lock" or x.endswith(".tmp") or x.startswith("libpe_native-")]
    assert port_made == []


# --- the offline flavour end to end -------------------------------------------


def _jax_offline_draws(seed, n_dst, n_srcs):
    """The JAX package's draws of ``find_best_template_teaser(seed=...)``:
    the observation's farthest-point start, then per template its start
    and its RANSAC uniforms, in its key-split order."""
    key = jax.random.PRNGKey(seed)
    key, kd = jax.random.split(key)
    draws = {"dst": _t(np.asarray(jax.random.gumbel(kd, (n_dst,)))), "templates": []}
    for n in n_srcs:
        key, k1, k2 = jax.random.split(key, 3)
        draws["templates"].append((_t(np.asarray(jax.random.gumbel(k1, (n,)))),
                                   _t(np.asarray(jax.random.uniform(k2, (4096, 3))))))
    return draws


def test_offline_flavor_matches_jax(scene):
    """Frame 0 through both packages' ``find_best_template_teaser`` at
    target_points=100 from the same cloud and draws: the same template,
    the same correspondence counts and cliques, and both poses under ADD
    0.15 x diag against the ground truth."""
    from poseestimator_tpu.geom3d.cloud import from_points as j_from_points

    sd = scene["scene"]
    mask = ((read_png_mask(sd)) * 255).astype(np.uint8)
    jc, _ = j_bop.get_pointcloud(os.path.join(sd, "depth", "000000.png"), None,
                                 os.path.join(sd, "scene_camera.json"), mask, capacity=4096)
    tc = t_cloud.PointCloud(points=_t(np.asarray(jc.points)), valid=_t(np.asarray(jc.valid)))
    files = sorted(os.path.join(scene["views"], f) for f in os.listdir(scene["views"]))
    tpl = [read_ply(f).vertices for f in files]
    j_src = [j_from_points(p) for p in tpl]
    t_src = [t_cloud.from_points(p, device="cpu") for p in tpl]

    ij, Hj, sj, mj = j_offline(jc, j_src, target_points=100, seed=0)
    draws = _jax_offline_draws(0, tc.capacity, [len(p) for p in tpl])
    it, Ht, st, mt = offline.find_best_template_teaser(tc, t_src, target_points=100, draws=draws)
    assert it == ij, (mt, mj)
    assert [m["num_corr"] for m in mt] == [m["num_corr"] for m in mj]
    assert [m.get("clique") for m in mt] == [m.get("clique") for m in mj]
    assert set(mt[0]) == set(mj[0])
    np.testing.assert_allclose(st, sj, rtol=1e-3)

    v = scene["verts"]
    model = g3.from_points(v)
    diag = float(np.linalg.norm(v.max(0) - v.min(0)))
    T_gt = jnp.asarray(scene["poses"][0])
    for H in (Hj, Ht):
        add = float(g3.add_metric(jnp.asarray(H, jnp.float32), T_gt, model))
        assert add < 0.15 * diag, (add, diag)


def read_png_mask(sd):
    from poseestimator_tpu_torch.utils.png import read_png

    return read_png(os.path.join(sd, "mask_visib", "000000_000000.png")) > 0


def test_offline_native_failure_keeps_greedy(scene, monkeypatch):
    """Without the native library (or with ``PMC_HEU``) the solve's greedy
    clique runs and each metrics dict says so; a degenerate exact clique
    falls back to the greedy in-solve selection."""
    sd = scene["scene"]
    from poseestimator_tpu_torch.utils import bop

    mask = (read_png_mask(sd) * 255).astype(np.uint8)
    tc, _ = bop.get_pointcloud(os.path.join(sd, "depth", "000000.png"), None,
                               os.path.join(sd, "scene_camera.json"), mask, capacity=4096,
                               device="cpu")
    files = sorted(os.path.join(scene["views"], f) for f in os.listdir(scene["views"]))
    t_src = [t_cloud.from_points(read_ply(f).vertices, device="cpu") for f in files[1:2]]
    seen = []
    real = offline.teaser_solve
    monkeypatch.setattr(offline, "teaser_solve",
                        lambda s, d, m, p: (seen.append(p.inlier_selection_mode),
                                            real(s, d, m, p))[1])
    monkeypatch.setattr(offline.native, "max_clique_exact",
                        lambda adj, valid=None: (np.zeros(adj.shape[0], bool), 0))
    _, _, score, metrics = offline.find_best_template_teaser(tc, t_src, target_points=100)
    scored = [m for m in metrics if m.get("note") != "few_corr"]
    assert scored and all(m["clique"] == "greedy" for m in scored)
    assert seen == [int(teaser.InlierSelectionMode.PMC_EXACT)] * len(scored)
    assert np.isfinite(score)
    seen.clear()
    _, _, _, metrics = offline.find_best_template_teaser(
        tc, t_src, target_points=100, inlier_selection_mode=int(teaser.InlierSelectionMode.PMC_HEU))
    assert all(m["clique"] == "greedy" for m in metrics if m.get("note") != "few_corr")
