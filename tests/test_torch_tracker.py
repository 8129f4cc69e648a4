"""Port parity, the tracking loop: the host helpers of
``pipeline/tracking.py`` (to 1e-12 in float64), the ``Tracker`` state
machine against the JAX package's on scripted detections, searches and
track steps (equal states, counters and radii), the track step's sparse,
robust and point-to-plane options against the JAX ``_track_step`` on the
same sampler draws, and the port's ``Tracker`` alone on the L-shape scene of
``tests/test_pipeline.py`` (128x96): INIT then TRACK within 0.15 x the
CAD's diagonal, and the multi-frame init rollout choosing the true basin.

The JAX side's nearest-neighbour pass goes through the numpy K1 of
``tests/test_torch_track_step.py``, which rounds as the card's K1 and the
port's plain version do."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseestimator_tpu import geom3d as g3
from poseestimator_tpu.models.yolo.nms import Detections as JDetections
from poseestimator_tpu.pipeline import tracking as jtrk
from poseestimator_tpu.registration import icp as j_icp_module
from poseestimator_tpu.registration.icp import icp_point_to_plane as j_icp_p2l
from poseestimator_tpu.render.raster import render_depth_mesh as j_render
from poseestimator_tpu_torch.camera import SyntheticCamera
from poseestimator_tpu_torch.geom3d.camera import Intrinsics
from poseestimator_tpu_torch.geom3d.cloud import PointCloud
from poseestimator_tpu_torch.geom3d.se3 import look_at
from poseestimator_tpu_torch.models.yolo.nms import Detections
from poseestimator_tpu_torch.pipeline import PoseEstimator
from poseestimator_tpu_torch.pipeline import tracking as trk
from poseestimator_tpu_torch.registration.icp import icp_point_to_plane
from poseestimator_tpu_torch.render.mesh import TriangleMesh, pad_faces
from poseestimator_tpu_torch.utils.metrics_log import MetricsLogger
from poseestimator_tpu_torch.utils.plyio import write_ply

from helpers import l_shape_mesh
from test_torch_track_step import BOX_FACES, BOX_HALF, _delta, _k1_callback
from torch_threads import two_threads  # noqa: F401

_GL_TO_CV = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)


def _rot(rng, ang=None):
    w = rng.normal(size=3)
    w /= np.linalg.norm(w)
    return w * (rng.uniform(0.0, np.pi) if ang is None else ang)


# --- host helpers ----------------------------------------------------------


@pytest.mark.parametrize("ang", [None, 1e-9, np.pi - 1e-7, np.pi])
def test_so3_log_exp_match_jax(ang):
    """Random angles, the small-angle branch and both sides of near pi."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        w = _rot(rng, ang)
        R = jtrk._so3_exp(w)
        np.testing.assert_allclose(trk._so3_exp(w), R, rtol=0, atol=1e-12)
        np.testing.assert_allclose(trk._so3_log(R), jtrk._so3_log(R), rtol=0, atol=1e-12)


def test_pose_filter_predictor_and_sigmas_match_jax():
    rng = np.random.default_rng(1)
    for alpha, beta in ((0.5, 0.3), (0.2, 0.6), (1.0, 0.3)):
        fp, fj = trk.PoseFilter(alpha, beta), jtrk.PoseFilter(alpha, beta)
        T = np.eye(4)
        for k in range(25):
            D = np.eye(4)
            D[:3, :3] = jtrk._so3_exp(_rot(rng, 0.02))
            D[:3, 3] = rng.normal(size=3) * 0.003
            T = D @ T
            if k == 12:
                fp.reset()
                fj.reset()
            np.testing.assert_allclose(fp(T), fj(T), rtol=0, atol=1e-12)
    for _ in range(10):
        Tc, Tp = np.eye(4), np.eye(4)
        Tc[:3, :3], Tp[:3, :3] = jtrk._so3_exp(_rot(rng, 0.1)), jtrk._so3_exp(_rot(rng, 0.1))
        Tc[:3, 3], Tp[:3, 3] = rng.normal(size=3), rng.normal(size=3)
        np.testing.assert_allclose(trk.predict_pose_cv(Tc, Tp), jtrk.predict_pose_cv(Tc, Tp),
                                   rtol=0, atol=1e-12)
        A = rng.normal(size=(6, 6))
        cov = A @ A.T * 1e-6
        np.testing.assert_allclose(trk._cov_sigmas(cov), jtrk._cov_sigmas(cov), rtol=0,
                                   atol=1e-12)


# --- the state machine on scripted inputs ----------------------------------

FSM_INTR = (640, 480)
FSM_DIAG = 0.2  # the stub CAD's diagonal (m)


def _pose(z=0.5, yaw=0.3):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = jtrk._so3_exp(np.array([0.0, yaw, 0.1])) @ np.diag([1.0, -1.0, -1.0])
    T[2, 3] = z
    return T


class _Mesh:
    extent = np.array([FSM_DIAG, 0.0, 0.0])


class _Estimator:
    """The search returns a fixed ranking of candidates."""

    def __init__(self, jax_side, candidates):
        self.mesh = _Mesh()
        W, H = FSM_INTR
        self.intr = (g3.Intrinsics if jax_side else Intrinsics).from_fov(60.0, W, H)
        self._mesh_v = self._mesh_f = None
        self.candidates = candidates
        self.searches = 0

    def find_best_template_candidates(self, dst_cloud, keep_pre_icp=False, mask=None):
        self.searches += 1
        return self.candidates[0][1], None, list(self.candidates)


class _Camera:
    def __init__(self, jax_side, n):
        self.n = n
        W, H = FSM_INTR
        self.depth = (jnp.ones((H, W)) if jax_side else torch.ones(H, W))

    def get_rgbd(self):
        if self.n == 0:
            return None
        self.n -= 1
        return np.zeros((4, 4, 3), np.uint8)

    def get_pcd_from_rgbd(self, mask):
        return None


class _Detector:
    """Hit or miss by call, from a script (hits after the script ends)."""

    def __init__(self, jax_side, hits):
        self.jax_side, self.hits, self.calls = jax_side, list(hits), 0

    def __call__(self, img, conf=0.7, iou=0.7):
        hit = bool(self.hits[self.calls]) if self.calls < len(self.hits) else True
        self.calls += 1
        W, H = FSM_INTR
        if self.jax_side:
            det = JDetections(boxes=jnp.zeros((1, 4)), scores=jnp.ones(1) * hit,
                              classes=jnp.zeros(1, jnp.int32), coeffs=jnp.zeros((1, 32)),
                              valid=jnp.array([hit]))
            return det, jnp.full((1, H, W), hit), jnp.zeros((1, 4))
        det = Detections(boxes=torch.zeros(1, 4), scores=torch.ones(1) * hit,
                         classes=torch.zeros(1, dtype=torch.int64), coeffs=torch.zeros(1, 32),
                         valid=torch.tensor([hit]))
        return det, torch.full((1, H, W), hit), torch.zeros(1, 4)


_COV = np.diag([1e-4, 2e-4, 3e-4, 1e-6, 2e-6, 3e-6]).astype(np.float32)


def _scripted_step(calls, fitness, motion, jax_side):
    """A track step that records (radius, window, pose) and returns the
    scripted fitness and ``motion[k] @ T``."""
    def step(*args, **kw):
        T = np.asarray(args[4], np.float32)
        k = len(calls)
        calls.append((round(float(kw["icp_dist"]), 7), kw["win_hw"], T))
        T_new = (motion[k] if k < len(motion) else np.eye(4, dtype=np.float32)) @ T
        f = fitness[k] if k < len(fitness) else 0.9
        if jax_side:
            return jnp.asarray(T_new), jnp.float32(f), jnp.float32(0.001), jnp.asarray(_COV)
        return trk.TrackResult(T=torch.from_numpy(T_new), fitness=torch.tensor(f),
                               rmse=torch.tensor(0.001), cov=torch.from_numpy(_COV), n_iters=1)
    return step


def _drive(monkeypatch, jax_side, n_frames, hits, fitness, motion, candidates, **cfg):
    calls = []
    est = _Estimator(jax_side, candidates)
    cam = _Camera(jax_side, n_frames)
    if jax_side:
        monkeypatch.setattr(jtrk, "_track_step",
                            _scripted_step(calls, fitness, motion, True))
        tr = jtrk.Tracker(cam, est, _Detector(True, hits), **cfg)
    else:
        monkeypatch.setattr(trk, "track_step", _scripted_step(calls, fitness, motion, False))
        tr = trk.Tracker(cam, est, _Detector(False, hits), device="cpu", **cfg)
    log = []
    while True:
        res = tr.step()
        if res is None:
            break
        log.append(dict(state=res.state, detected=res.detected, init=tr.initialized,
                        errors=tr.errorcounter, cand=tr._candidate_idx, post=tr._post_init,
                        win=tr._win_hw, T=None if res.T_m2c is None else np.asarray(res.T_m2c),
                        fit=res.icp_fitness, sig=(res.sigma_rot_deg, res.sigma_t_mm)))
    return log, calls, est.searches


def _motion(n, dz=None, yaw=0.004):
    out = []
    for k in range(n):
        D = np.eye(4, dtype=np.float32)
        D[:3, :3] = jtrk._so3_exp(np.array([0.0, 0.0, yaw]))
        D[:3, 3] = [0.002, -0.001, 0.0]
        if dz and k in dz:
            D[2, 3] = dz[k]
        out.append(D)
    return out


CANDS = [(0.1, _pose(0.5, 0.3), 0), (0.2, _pose(0.52, 1.2), 3), (0.3, _pose(0.55, 2.0), 1)]
SCENARIOS = {
    # a miss during warm-up resets the count; max_misses + 1 misses re-init
    "warm-up reset and re-init on misses": dict(
        n_frames=24, hits=[1, 0, 1, 1, 1, 1, 1, 1, 0, 0, 0], fitness=[], motion=_motion(20),
        cfg=dict(warmup_frames=3, max_misses=2, icp_dist=0.01)),
    # the ladder of tests/test_pipeline.py:541-600: a miss keeps the rung,
    # the 0.02 rung floors at icp_dist = 0.03
    "post-init ladder": dict(
        n_frames=8, hits=[1, 0], fitness=[], motion=_motion(8),
        cfg=dict(warmup_frames=1, icp_dist=0.03, target_pts=300)),
    "candidate fallback": dict(
        n_frames=16, hits=[], fitness=[0.2, 0.3, 0.9, 0.1, 0.1, 0.1, 0.95, 0.1, 0.1, 0.1],
        motion=_motion(16), cfg=dict(warmup_frames=1, min_fitness=0.5, fitness_patience=2)),
    "low-fitness re-init": dict(
        n_frames=16, hits=[], fitness=[0.9, 0.2, 0.1, 0.6, 0.1, 0.1, 0.1, 0.9],
        motion=_motion(16), cfg=dict(warmup_frames=2, reinit_fitness=0.5, reinit_patience=2,
                                     min_fitness=0.3, fitness_patience=1)),
    "track_every 2": dict(
        n_frames=10, hits=[], fitness=[], motion=_motion(10),
        cfg=dict(warmup_frames=1, track_every=2)),
    # the object approaches by > 25%: the window bucket is chosen again
    "distance re-bucketing": dict(
        n_frames=10, hits=[], fitness=[], motion=_motion(10, dz={2: -0.2, 5: 0.4}),
        cfg=dict(warmup_frames=1)),
    "constant velocity and smoothing": dict(
        n_frames=10, hits=[1, 1, 1, 0], fitness=[], motion=_motion(10, yaw=0.02),
        cfg=dict(warmup_frames=1, motion_model="constant_velocity", smooth_alpha=0.5)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fsm_transitions_match_jax(monkeypatch, name):
    sc = SCENARIOS[name]
    args = (sc["n_frames"], sc["hits"], sc["fitness"], sc["motion"], CANDS)
    log_j, calls_j, n_search_j = _drive(monkeypatch, True, *args, **sc["cfg"])
    log_p, calls_p, n_search_p = _drive(monkeypatch, False, *args, **sc["cfg"])
    assert n_search_p == n_search_j >= 1
    assert len(log_p) == len(log_j) and len(calls_p) == len(calls_j)
    for a, b in zip(log_p, log_j):
        assert {k: a[k] for k in ("state", "detected", "init", "errors", "cand", "post", "win")} \
            == {k: b[k] for k in ("state", "detected", "init", "errors", "cand", "post", "win")}
        assert (a["T"] is None) == (b["T"] is None)
        if a["T"] is not None:
            np.testing.assert_allclose(a["T"], b["T"], rtol=0, atol=1e-6)
        assert a["fit"] == pytest.approx(b["fit"], abs=1e-7)
        np.testing.assert_allclose(a["sig"], b["sig"], rtol=1e-6)
    for (rp, wp, Tp), (rj, wj, Tj) in zip(calls_p, calls_j):
        assert (rp, wp) == (rj, wj)
        np.testing.assert_allclose(Tp, Tj, rtol=0, atol=1e-6)
    states = [e["state"] for e in log_p]
    if name == "post-init ladder":
        assert [c[0] for c in calls_p[:3]] == [0.05, 0.03, 0.03]
    if name.startswith("warm-up"):
        assert states.count("init") == 2
    if name.startswith("low-fitness"):
        assert any(e["state"] == "lost" and e["detected"] for e in log_p)
        assert states.count("init") >= 2
    if name == "candidate fallback":
        assert log_p[-1]["cand"] == 2
    if name == "distance re-bucketing":
        assert len({c[1] for c in calls_p}) >= 2


def test_metrics_logger_records_every_step(monkeypatch, tmp_path):
    """Every step is logged with the timings its state has, taken on
    ``time.perf_counter``: a wall clock stepped back an hour between calls
    moves none of them."""
    sc = SCENARIOS["warm-up reset and re-init on misses"]
    monkeypatch.setattr(trk, "track_step", _scripted_step([], [], sc["motion"], False))
    wall = iter(range(10**9, 0, -3600))
    monkeypatch.setattr(trk.time, "time", lambda: float(next(wall)))
    logger = MetricsLogger(str(tmp_path / "m.jsonl"))
    tr = trk.Tracker(_Camera(False, sc["n_frames"]), _Estimator(False, CANDS),
                     _Detector(False, sc["hits"]), metrics=logger, device="cpu",
                     **sc["cfg"])
    n = 0
    while tr.step() is not None:
        n += 1
    s = logger.summary()
    logger.close()
    assert s["frames"] == n == s["n_init"] + s["n_track"] + s["n_lost"]
    assert s["n_init"] == 2 and s["n_lost"] == 3
    assert len((tmp_path / "m.jsonl").read_text().splitlines()) == n
    keys = {"init": {"global_registration"}, "track": {"detect", "track_step"},
            "lost": {"detect"}}
    for r in logger.records:
        assert set(r["timings_ms"]) == keys[r["state"]], r
        assert all(0.0 <= v < 60_000.0 for v in r["timings_ms"].values()), r
    assert {f"{k}_ms_p95" for k in ("global_registration", "detect", "track_step")} <= set(s)


# --- the track step's options ----------------------------------------------

W, H = 160, 120
J_INTR = g3.Intrinsics.from_fov(60.0, W, H)
T_INTR = Intrinsics.from_fov(60.0, W, H)


@pytest.fixture(scope="module")
def box_scene():
    """The box of tests/test_torch_track_step.py turned to show three faces
    0.3 m away: with one dominant face point-to-plane has no hold on the
    in-plane motion and diverges in both packages."""
    bx, by, bz = BOX_HALF
    verts = np.array([[sx * bx, sy * by, sz * bz] for sx in (-1, 1) for sy in (-1, 1)
                      for sz in (-1, 1)], np.float32)
    faces = pad_faces(BOX_FACES, 256)
    T0 = np.eye(4, dtype=np.float32)
    T0[:3, :3] = jtrk._so3_exp(np.array([0.6, 0.0, 0.0])) @ jtrk._so3_exp(
        np.array([0.0, 0.7, 0.0]))
    T0[2, 3] = 0.3
    T_obs = _delta(0.05, [0.006, -0.003, 0.002]) @ T0
    depth = np.array(j_render(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(T_obs),
                              J_INTR, near=0.01, far=5.0))
    return verts, faces, T0, depth


def _draw(key, cap, n):
    """The draws of the JAX ``random_sample(key, cloud of capacity cap, n)``."""
    n = min(n, cap)
    if cap >= 8 * n:
        kg, ku = jax.random.split(key)
        return (torch.from_numpy(np.array(jax.random.gumbel(kg, (cap,), jnp.float32))),
                torch.from_numpy(np.array(jax.random.uniform(ku, ()))))
    return torch.from_numpy(np.array(jax.random.gumbel(key, (cap,)))), None


def jax_step_draws(key, target_pts):
    """Every draw ``_track_step`` makes from ``key`` on the full frame."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    cap_t, cap_o = (H // 2) * (W // 2), H * W
    out = {"tpl": _draw(k3, cap_t, 4096), "obs": _draw(k4, cap_o, 4096)}
    if target_pts:
        out["tpl_target"] = _draw(k1, min(4096, cap_t), target_pts)
        out["obs_target"] = _draw(k2, min(4096, cap_o), target_pts)
    return out


# two compiles of the JAX step cover the three options: sparse (300
# points) with the Huber kernel, and dense point-to-plane with Tukey's
@pytest.mark.parametrize("target_pts,variant,kernel,seed", [
    (300, "p2p", "huber", 2), (0, "p2l", "tukey", 4)])
def test_track_step_options_match_jax(monkeypatch, box_scene, target_pts, variant, kernel, seed):
    """On the full frame of the box scene (the exact Open3D-parity loop):
    T within 1e-4, the same fitness, rmse within 1e-3 relative."""
    monkeypatch.setattr(j_icp_module, "nearest_neighbor", _k1_callback)
    jax.clear_caches()
    verts, faces, T0, depth = box_scene
    mask = depth > 0
    key = jax.random.PRNGKey(seed)
    Tj, fitj, rmsej, _ = jtrk._track_step(
        jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(mask), jnp.asarray(depth),
        jnp.asarray(T0), J_INTR, target_pts, key, icp_dist=jnp.float32(0.01),
        icp_variant=variant, icp_kernel=kernel, win_hw="auto")
    res = trk.track_step(torch.from_numpy(verts), torch.from_numpy(faces),
                         torch.from_numpy(mask), torch.from_numpy(depth), torch.from_numpy(T0),
                         T_INTR, 0.01, win_hw="auto", target_pts=target_pts,
                         icp_variant=variant, icp_kernel=kernel,
                         draws=jax_step_draws(key, target_pts))
    assert res.n_iters >= 2
    np.testing.assert_allclose(res.T.numpy(), np.asarray(Tj), atol=1e-4)
    assert float(res.fitness) == pytest.approx(float(fitj), abs=1e-6)
    np.testing.assert_allclose(float(res.rmse), float(rmsej), rtol=1e-3)
    assert float(res.fitness) > 0.8


def test_icp_point_to_plane_matches_jax(monkeypatch):
    """Origin-centred clouds with normals (no K1 cancellation), the Huber
    kernel: T within 1e-5, equal n_iters and fitness, covariance within
    1e-3 relative."""
    monkeypatch.setattr(j_icp_module, "nearest_neighbor", _k1_callback)
    jax.clear_caches()
    rng = np.random.default_rng(5)
    # a corner of three planes: every twist direction is observable
    pts = rng.uniform(-0.05, 0.05, size=(3, 400, 3)).astype(np.float32)
    for a in range(3):
        pts[a, :, a] = 0.0
    dst = pts.reshape(-1, 3)
    nrm = np.repeat(np.eye(3, dtype=np.float32), 400, axis=0)
    D = _delta(0.03, [0.004, -0.002, 0.003])
    src = ((dst - D[:3, 3]) @ D[:3, :3]).astype(np.float32)  # D^-1 applied
    src[::7] += rng.normal(size=src[::7].shape).astype(np.float32) * 0.004
    valid = np.ones(len(dst), bool)
    rj = j_icp_p2l(g3.cloud.PointCloud(points=jnp.asarray(src), valid=jnp.asarray(valid)),
                   g3.cloud.PointCloud(points=jnp.asarray(dst), valid=jnp.asarray(valid),
                                       normals=jnp.asarray(nrm)),
                   max_corr_dist=0.02, robust="huber", with_cov=True)
    rp = icp_point_to_plane(PointCloud(torch.from_numpy(src), torch.from_numpy(valid)),
                            PointCloud(torch.from_numpy(dst), torch.from_numpy(valid),
                                       normals=torch.from_numpy(nrm)),
                            max_corr_dist=0.02, robust="huber", with_cov=True)
    assert rp.n_iters == int(rj.n_iters) >= 2
    np.testing.assert_allclose(rp.T.numpy(), np.asarray(rj.T), atol=1e-5)
    assert float(rp.fitness) == float(rj.fitness)
    cj = np.asarray(rj.cov)
    np.testing.assert_allclose(rp.cov.numpy(), cj, atol=1e-3 * np.abs(cj).max())


# --- the slice as a whole --------------------------------------------------

L_INTR = Intrinsics.from_fov(60.0, 128, 96)


def gt_pose(angle=0.1, dirv=(1.0, 1.0, 1.0), dist=2.0):
    """tests/test_pipeline.py's pose, built with the port's look_at."""
    d = np.asarray(dirv, np.float64)
    T_gl = look_at(d / np.linalg.norm(d) * dist, [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]).numpy()
    P = np.eye(4, dtype=np.float32)
    P[:3, :3] = jtrk._so3_exp(np.array([0.0, 0.0, angle])) @ jtrk._so3_exp(
        np.array([angle * 0.5, 0.0, 0.0]))
    return (P @ (_GL_TO_CV @ T_gl)).astype(np.float32)


@pytest.fixture(scope="module")
def lshape(tmp_path_factory):
    d = tmp_path_factory.mktemp("cad")
    mesh = l_shape_mesh()
    cad = str(d / "l.ply")
    write_ply(cad, mesh.vertices, faces=mesh.faces)
    est = PoseEstimator(cad, str(d / "views"), L_INTR, target_points=100, seed=0, device="cpu")
    pts, _ = TriangleMesh.load(cad).sample_points_uniformly(20000, np.random.default_rng(0))
    return est, pts


class StubDetector:
    """The mask is the rendered depth > 0."""

    def __init__(self, camera):
        self.camera = camera

    def __call__(self, img, conf=0.7, iou=0.7):
        det = Detections(boxes=torch.zeros(1, 4), scores=torch.ones(1),
                         classes=torch.zeros(1, dtype=torch.int64), coeffs=torch.zeros(1, 32),
                         valid=torch.ones(1, dtype=torch.bool))
        return det, (self.camera.depth > 0)[None], torch.zeros(1, 4)


def _adds(T, G, pts):
    a = pts @ T[:3, :3].T + T[:3, 3]
    b = pts @ G[:3, :3].T + G[:3, 3]
    return float(torch.cdist(torch.from_numpy(a), torch.from_numpy(b)).min(1).values.mean())


def test_full_fsm_loop(lshape):
    """tests/test_pipeline.py:398-428 on the port: warm-up, the global
    search, then tracking along a moving trajectory (sparse, 300 points)."""
    est, pts = lshape
    angles = [0.1] * 12 + list(0.1 + 0.01 * np.arange(8))
    cam = SyntheticCamera(pts, np.zeros_like(pts), [gt_pose(a) for a in angles], L_INTR,
                          device="cpu")
    tracker = trk.Tracker(cam, est, StubDetector(cam), target_pts=300, icp_dist=0.05,
                          warmup_frames=3, max_init_frames=20, device="cpu")
    results = []
    while (res := tracker.step()) is not None:
        results.append(res)
    assert [r.state for r in results][0] == "init"
    tracked = [r for r in results if r.state == "track" and r.detected]
    assert len(tracked) >= 5
    diag = float(np.linalg.norm(est.mesh.extent))
    verts = np.asarray(est.mesh.vertices, np.float32)
    assert _adds(tracked[-1].T_m2c, cam.current_gt, verts) < 0.15 * diag


def test_rollout_init_recovers_wrong_first_candidate(lshape, monkeypatch):
    """tests/test_pipeline.py:349-396 on the port: the search ranks a basin
    flipped about the model's Y first; the rollout tracks both candidates
    through 3 frames and keeps the true one."""
    est, pts = lshape
    T_gt = gt_pose()
    F = np.eye(4, dtype=np.float32)
    F[:3, :3] = jtrk._so3_exp(np.array([0.0, np.pi, 0.0]))
    T_wrong = (T_gt @ F).astype(np.float32)
    P = np.eye(4, dtype=np.float32)
    P[:3, :3] = jtrk._so3_exp(np.array([0.0, 0.0, 0.03]))
    T_near = (P @ T_gt).astype(np.float32)
    T_near[:3, 3] += [0.01, -0.01, 0.01]
    cam = SyntheticCamera(pts, np.zeros_like(pts), [T_gt] * 12, L_INTR, mesh=est.mesh,
                          device="cpu")
    tracker = trk.Tracker(cam, est, StubDetector(cam), target_pts=0, icp_dist=0.05,
                          warmup_frames=2, max_init_frames=20, init_rollout=3, device="cpu")
    monkeypatch.setattr(est, "find_best_template_candidates",
                        lambda dst, keep_pre_icp=False, mask=None: (
                            T_wrong, None, [(0.10, T_wrong, 0), (0.12, T_near, 1)]))
    res = tracker.step()
    assert res is not None and res.state == "init"
    assert res.init_margin > 0.0
    verts = np.asarray(est.mesh.vertices, np.float64)
    diag = float(np.linalg.norm(est.mesh.extent))

    def add(T):
        return float(np.linalg.norm((verts @ T[:3, :3].T + T[:3, 3])
                                    - (verts @ T_gt[:3, :3].T + T_gt[:3, 3]), axis=1).mean())

    assert add(res.T_m2c) < 0.15 * diag
    assert add(res.T_m2c) < 0.3 * add(T_wrong)
    assert tracker._candidates[0][2] == 1
