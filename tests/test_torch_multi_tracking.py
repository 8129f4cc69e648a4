"""Port parity, multi-object tracking: the batched track step against the
JAX package's ``_batched_track`` (one CAD) and ``_batched_track_multi``
(a padded class stack) on a 160x120 camera with 2-3 tracks, each with its
own radius and the JAX package's own random draws (T within 1e-4, equal ICP
iterations per track); ``MultiTracker`` against the JAX ``MultiTracker`` on
scripted detections, searches and batched steps (ids, classes, misses,
radii, windows, spawn order, retirement and poses); and the init rollout,
now one batched step per frame, against its previous per-candidate loop
(bit for bit) and the JAX ``_rollout_init``.

The JAX side's nearest-neighbour pass goes through the numpy K1 of
``tests/test_torch_track_step.py`` (see there why); under ``vmap`` the
host callback runs problem by problem."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseestimator_tpu import geom3d as g3
from poseestimator_tpu.models.yolo.nms import Detections as JDetections
from poseestimator_tpu.pipeline import multi_tracking as jmt
from poseestimator_tpu.pipeline import tracking as jtrk
from poseestimator_tpu.registration import icp as j_icp_module
from poseestimator_tpu.render.raster import render_depth_mesh as j_render
from poseestimator_tpu_torch import kernel_cases as kc
from poseestimator_tpu_torch.geom3d.camera import Intrinsics
from poseestimator_tpu_torch.models.yolo.nms import Detections
from poseestimator_tpu_torch.pipeline import multi_tracking as tmt
from poseestimator_tpu_torch.pipeline import tracking as trk
from poseestimator_tpu_torch.pipeline.window import merge_windows
from poseestimator_tpu_torch.render.mesh import pad_faces

from test_torch_track_step import (J_INTR, T_INTR, W, H, WIN, _delta, _k1_numpy,
                                   jax_sampler_draws)
from torch_threads import two_threads  # noqa: F401


def _k1_callback_vmapped(query, query_valid, data, data_valid):
    n = query.shape[0]
    shapes = (jax.ShapeDtypeStruct((n,), jnp.float32), jax.ShapeDtypeStruct((n,), jnp.int32),
              jax.ShapeDtypeStruct((n,), jnp.bool_))
    return jax.pure_callback(_k1_numpy, shapes, query, query_valid, data, data_valid,
                             vmap_method="sequential")


@pytest.fixture(scope="module")
def jax_nn_as_k1():
    """The numpy K1 in the JAX ICP for the whole module (the caches are
    cleared once: a trace made with the JAX NN must not be reused)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_icp_module, "nearest_neighbor", _k1_callback_vmapped)
        jax.clear_caches()
        yield
    jax.clear_caches()


# --- the batched track step --------------------------------------------------


def _yaw(x, yaw, z):
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    T[0, 3], T[2, 3] = x, z
    return T


def _scene(meshes, T_obs):
    """Nearest-depth composite of the instances (JAX raster) and each
    instance's visible mask."""
    ds = np.stack([np.array(j_render(jnp.asarray(v), jnp.asarray(f), jnp.asarray(T), J_INTR,
                                     near=0.01, far=5.0)) for (v, f), T in zip(meshes, T_obs)])
    z = np.where(ds > 0, ds, np.inf)
    zmin = z.min(0)
    return np.where(np.isinf(zmin), 0.0, zmin).astype(np.float32), (ds > 0) & (z <= zmin)


def _jax_iters(verts, faces, mask, depth, T0, key, dist):
    """The per-track ICP iteration count of the batched step, from the same
    JAX calls unjitted around the jitted ICP (the step returns no count)."""
    _, _, k3, k4 = jax.random.split(key, 4)
    intr_r = g3.Intrinsics(fx=J_INTR.fx / 2, fy=J_INTR.fy / 2, cx=J_INTR.cx / 2,
                           cy=J_INTR.cy / 2, width=W // 2, height=H // 2)
    o = jtrk.window_origin(verts, T0, intr_r, *WIN)
    dt = j_render(verts, faces, T0, intr_r, near=0.01, far=5.0, origin=o.astype(jnp.float32),
                  out_hw=WIN)
    tpl = g3.backproject_depth(dt, intr_r, depth_min=0.01, depth_max=5.0, origin=o)
    of = o * 2
    dwin = jax.lax.dynamic_slice(depth, (of[1], of[0]), (WIN[0] * 2, WIN[1] * 2))
    mwin = jax.lax.dynamic_slice(mask, (of[1], of[0]), (WIN[0] * 2, WIN[1] * 2))
    obs = g3.backproject_depth(dwin, J_INTR, mask=mwin, depth_min=1e-6, origin=of)
    src = g3.random_sample(k3, tpl, 4096)
    dst = g3.remove_statistical_outlier(g3.random_sample(k4, obs, 4096), 20, 1.0, approx=True)
    r = j_icp_module.icp_point_to_point(src, dst, max_corr_dist=dist, max_iterations=30,
                                        with_cov=True, accel=True, accel_pose_tol=1e-4)
    return int(r.n_iters), np.asarray(r.T @ T0)


BOX = (kc.box_vertices(), pad_faces(kc.BOX_FACES, 256).astype(np.int32))
LSHAPE = (kc.lshape_mesh(0.2)[0], pad_faces(kc.lshape_mesh(0.2)[1], 256).astype(np.int32))


@pytest.mark.parametrize("multi", [False, True], ids=["one CAD, 3 tracks", "two classes"])
def test_batched_track_step_matches_jax(jax_nn_as_k1, multi):
    if multi:  # the L-shape (class 0) and the box (class 1), rows (1, 0)
        meshes = [BOX, LSHAPE]
        T_obs = [_yaw(-0.05, 0.4, 0.5), _yaw(0.07, 0.9, 0.55)]
        vs, fs = tmt.stack_class_meshes([LSHAPE, BOX])
        rows = np.array([1, 0])
        seed = 3
    else:
        meshes = [BOX] * 3
        T_obs = [_yaw(-0.09, 0.45, 0.5), _yaw(0.0, 0.3, 0.56), _yaw(0.09, 0.5, 0.62)]
        seed = 0
    B = len(T_obs)
    depth, masks = _scene(meshes, T_obs)
    T0 = np.stack([np.linalg.inv(_delta(0.03 + 0.01 * i, [0.004, -0.002, 0.002 * i])) @ T
                   for i, T in enumerate(T_obs)]).astype(np.float32)
    dists = np.array([0.05, 0.02, 0.01][:B], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    if multi:
        Tj, fitj, _, _ = jmt._batched_track_multi(
            jnp.asarray(vs), jnp.asarray(fs.astype(np.int32)), jnp.asarray(rows),
            jnp.asarray(masks), jnp.asarray(depth), jnp.asarray(T0), J_INTR, 0, keys,
            jnp.asarray(dists), win_hw=WIN)
        mesh_v, mesh_f = torch.from_numpy(vs[rows]), torch.from_numpy(fs[rows])
    else:
        Tj, fitj, _, _ = jmt._batched_track(
            jnp.asarray(BOX[0]), jnp.asarray(BOX[1]), jnp.asarray(masks), jnp.asarray(depth),
            jnp.asarray(T0), J_INTR, 0, keys, jnp.asarray(dists), win_hw=WIN)
        mesh_v, mesh_f = torch.from_numpy(BOX[0]), torch.from_numpy(BOX[1].astype(np.int64))
    res = trk.track_step_batched(mesh_v, mesh_f, torch.from_numpy(masks), torch.from_numpy(depth),
                                 torch.from_numpy(T0), T_INTR, torch.from_numpy(dists),
                                 win_hw=WIN, draws=[jax_sampler_draws(k, WIN) for k in keys])
    for i in range(B):
        v, f = meshes[i]
        n_j, T_unjit = _jax_iters(jnp.asarray(v), jnp.asarray(f), jnp.asarray(masks[i]),
                                  jnp.asarray(depth), jnp.asarray(T0[i]), keys[i],
                                  float(dists[i]))
        np.testing.assert_allclose(T_unjit, np.asarray(Tj[i]), atol=1e-6)
        assert res.n_iters[i] == n_j >= 2
        np.testing.assert_allclose(res.T[i].numpy(), np.asarray(Tj[i]), atol=1e-4)
        assert float(res.fitness[i]) == pytest.approx(float(fitj[i]), abs=1e-6)
    assert len(set(res.n_iters)) > 1  # each track exits on its own


def test_merge_windows_matches_jax():
    for wins in ([(64, 128), (128, 128), (32, 256)], [(64, 128), None], [], [(96, 384)]):
        assert merge_windows(wins) == jmt.merge_windows(wins)


# --- MultiTracker on scripted inputs -----------------------------------------

M_INTR = (640, 480)


class _Mesh:
    def __init__(self, size):
        hi = np.asarray(size, np.float32) / 2
        self.vertices = np.stack([-hi, hi])
        self.min_bound, self.max_bound = -hi, hi
        self.extent = 2 * hi


class _Estimator:
    """A CAD of the given size whose search returns the scripted pose of the
    object its mask names."""

    def __init__(self, jax_side, size, poses, nv, nf):
        W_, H_ = M_INTR
        self.intr = (g3.Intrinsics if jax_side else Intrinsics).from_fov(60.0, W_, H_)
        self.K = self.intr.K
        self.mesh = _Mesh(size)
        v = np.arange(nv * 3, dtype=np.float32).reshape(nv, 3)
        f = (np.arange(nf * 3) % nv).reshape(nf, 3)
        self._mesh_v, self._mesh_f = ((jnp.asarray(v), jnp.asarray(f)) if jax_side else
                                      (torch.from_numpy(v), torch.from_numpy(f)))
        self.poses, self.searches = poses, []

    def find_best_template_teaser(self, dst_cloud, keep_pre_icp=False, mask=None):
        obj = int(np.argmax(np.asarray(mask)[0]))
        self.searches.append(obj)
        return self.poses(obj), None


class _Camera:
    def __init__(self, jax_side, n):
        self.jax_side, self.n, self.frame = jax_side, n, -1
        self.depth = jnp.zeros((4, 4)) if jax_side else torch.zeros(4, 4)

    def get_rgbd(self):
        if self.frame + 1 >= self.n:
            return None
        self.frame += 1
        return np.zeros((4, 4, 3), np.uint8)

    def get_pcd_from_rgbd(self, mask):
        return None


def _truth(obj, frame):
    """Object ``obj``'s pose at ``frame``: three objects 0.6-0.8 m out,
    drifting 2 mm and 0.01 rad a frame."""
    T = np.eye(4, dtype=np.float32)
    a = 0.3 + 0.9 * obj + 0.01 * frame
    T[:3, :3] = jtrk._so3_exp(np.array([0.1, a, 0.0])) @ np.diag([1.0, -1.0, -1.0])
    T[:3, 3] = [(obj - 1) * 0.25 + 0.002 * frame, 0.02 * obj, 0.6 + 0.1 * obj]
    return T


def _box(T, size):
    """The scripted detection box: the CAD box projected at ``T``."""
    K = g3.Intrinsics.from_fov(60.0, *M_INTR).K
    hi = np.asarray(size, np.float32) / 2
    c = np.array([[x, y, z] for x in (-hi[0], hi[0]) for y in (-hi[1], hi[1])
                  for z in (-hi[2], hi[2])], np.float32)
    pc = c @ T[:3, :3].T + T[:3, 3]
    u = K[0, 0] * pc[:, 0] / pc[:, 2] + K[0, 2]
    v = K[1, 1] * pc[:, 1] / pc[:, 2] + K[1, 2]
    return np.array([u.min(), v.min(), u.max(), v.max()], np.float32)


SIZES = {0: (0.2, 0.1, 0.1), 1: (0.12, 0.08, 0.06)}
# per frame, the objects detected, in detection order; object 2 is class 1
SCRIPT = [[0, 1], [1, 0], [0, 1, 2], [1, 2], [2, 1], [1], [1, 2], [2, 1], [1], [2, 1], [1, 2]]
OBJ_CLASS = {0: 0, 1: 0, 2: 1}


class _Detector:
    def __init__(self, jax_side, camera, classes: bool):
        self.jax_side, self.camera, self.classes = jax_side, camera, classes

    def __call__(self, img, conf=0.7, iou=0.7):
        objs = SCRIPT[self.camera.frame]
        D, (W_, H_) = 8, M_INTR
        boxes = np.zeros((D, 4), np.float32)
        masks = np.zeros((D, 4, 8), bool)
        cls = np.zeros(D, np.int64)
        valid = np.zeros(D, bool)
        for j, o in enumerate(objs):
            c = OBJ_CLASS[o] if self.classes else 0
            boxes[j] = _box(_truth(o, self.camera.frame), SIZES[c])
            masks[j, 0, o] = True
            cls[j], valid[j] = c, True
        if self.jax_side:
            det = JDetections(boxes=jnp.asarray(boxes), scores=jnp.asarray(valid, jnp.float32),
                              classes=jnp.asarray(cls.astype(np.int32)),
                              coeffs=jnp.zeros((D, 32)), valid=jnp.asarray(valid))
            return det, jnp.asarray(masks), jnp.asarray(boxes)
        det = Detections(boxes=torch.from_numpy(boxes), scores=torch.from_numpy(valid).float(),
                         classes=torch.from_numpy(cls), coeffs=torch.zeros(D, 32),
                         valid=torch.from_numpy(valid))
        return det, torch.from_numpy(masks), torch.from_numpy(boxes)


def _scripted_batch(calls, jax_side, multi):
    """A batched step that records its inputs and moves each track 1 mm
    and 0.004 rad, with fitness 0.9 - 0.1 i."""
    D = _delta(0.004, [0.001, 0.0, 0.0])

    def step(*args, **kw):
        if jax_side:
            if multi:
                _, _, cls_idx, masks, _, Ts, *_rest = args
                dists = args[9]
            else:
                _, _, masks, _, Ts, _, _, _, dists = args
                cls_idx = None
        else:
            _, _, masks, _, Ts, _, dists = args
            cls_idx = None
        masks, Ts, dists = (np.asarray(a) for a in (masks, Ts, dists))
        calls.append(dict(objs=masks[:, 0].argmax(-1).tolist(), Ts=Ts, win=kw["win_hw"],
                          dists=np.round(dists.astype(np.float64), 7).tolist(),
                          cls=None if cls_idx is None else np.asarray(cls_idx).tolist()))
        T_new = np.stack([D @ T for T in Ts]).astype(np.float32)
        fits = np.float32(0.9) - np.float32(0.1) * np.arange(len(Ts), dtype=np.float32)
        cov = np.broadcast_to(np.eye(6, dtype=np.float32) * 1e-6, (len(Ts), 6, 6))
        if jax_side:
            return (jnp.asarray(T_new), jnp.asarray(fits), jnp.zeros(len(Ts)), jnp.asarray(cov))
        return trk.BatchedTrackResult(T=torch.from_numpy(T_new), fitness=torch.from_numpy(fits),
                                      rmse=torch.zeros(len(Ts)), cov=torch.from_numpy(cov.copy()),
                                      n_iters=[1] * len(Ts))
    return step


def _drive_multi(monkeypatch, jax_side, multi, **cfg):
    calls = []
    cam = _Camera(jax_side, len(SCRIPT))
    offset = np.eye(4, dtype=np.float32)
    offset[:3, 3] = [0.003, -0.002, 0.004]  # the search lands a few mm off
    poses = lambda o: (offset @ _truth(o, cam.frame)).astype(np.float32)  # noqa: E731
    if multi:
        est = {0: _Estimator(jax_side, SIZES[0], poses, 16, 256),
               1: _Estimator(jax_side, SIZES[1], poses, 8, 128)}
    else:
        est = _Estimator(jax_side, SIZES[0], poses, 16, 256)
    det = _Detector(jax_side, cam, classes=multi)
    if jax_side:
        monkeypatch.setattr(jmt, "_batched_track_multi" if multi else "_batched_track",
                            _scripted_batch(calls, True, multi))
        mt = jmt.MultiTracker(cam, est, det, **cfg)
    else:
        monkeypatch.setattr(tmt, "track_step_batched", _scripted_batch(calls, False, multi))
        mt = tmt.MultiTracker(cam, est, det, device="cpu", **cfg)
    log = []
    while (res := mt.step()) is not None:
        log.append(dict(n_det=res.n_detections, tracks=[
            (t.track_id, t.class_id, t.misses, t.age, t.post_init, t.win,
             round(t.icp_fitness, 6), np.asarray(t.T_m2c), np.asarray(t.T_out))
            for t in res.tracks]))
    searches = (sum((e.searches for e in est.values()), []) if multi else est.searches)
    return log, calls, searches, mt


@pytest.mark.parametrize("multi", [False, True], ids=["one CAD", "two classes"])
def test_multi_tracker_matches_jax_on_scripted_inputs(monkeypatch, multi):
    """Spawns one track a frame, associates by IoU within a class, counts a
    miss, retires object 0 after max_misses + 1 misses, runs the post-init
    ladder per track and the merged window, and smooths the reported
    poses: the same in both packages, frame by frame."""
    cfg = dict(max_objects=3, target_pts=0, max_misses=2, icp_dist=0.01, iou_match=0.2,
               smooth_alpha=0.5, smooth_beta=0.3)
    log_j, calls_j, search_j, _ = _drive_multi(monkeypatch, True, multi, **cfg)
    log_p, calls_p, search_p, mt = _drive_multi(monkeypatch, False, multi, **cfg)
    assert search_p == search_j and len(search_p) >= 3
    assert len(log_p) == len(log_j) == len(SCRIPT)
    for a, b in zip(log_p, log_j):
        assert a["n_det"] == b["n_det"]
        assert [t[:7] for t in a["tracks"]] == [t[:7] for t in b["tracks"]]
        for ta, tb in zip(a["tracks"], b["tracks"]):
            np.testing.assert_allclose(ta[7], tb[7], rtol=0, atol=1e-6)
            np.testing.assert_allclose(ta[8], tb[8], rtol=0, atol=1e-6)
    assert len(calls_p) == len(calls_j)
    for a, b in zip(calls_p, calls_j):
        assert {k: a[k] for k in ("objs", "win", "dists")} == \
            {k: b[k] for k in ("objs", "win", "dists")}
        np.testing.assert_allclose(a["Ts"], b["Ts"], rtol=0, atol=1e-6)
        if multi:
            assert [mt._cls_row[OBJ_CLASS[o]] for o in a["objs"]] == b["cls"]
    ids = [{t[0] for t in f["tracks"]} for f in log_p]
    assert 0 in ids[3] and 0 not in ids[-1]  # object 0's track retired
    assert any(len(set(c["dists"])) > 1 for c in calls_p)  # tracks on different rungs
    if multi:
        assert {t[1] for t in log_p[-1]["tracks"]} == {0, 1}


def test_multi_tracker_class_stack_and_intrinsics_check():
    """The stacked class meshes: vertices padded by their last row, faces
    by (0, 0, 0); estimators on two cameras are refused."""
    poses = lambda o: np.eye(4, dtype=np.float32)  # noqa: E731
    est = {3: _Estimator(False, SIZES[0], poses, 16, 256),
           1: _Estimator(False, SIZES[1], poses, 8, 128)}
    mt = tmt.MultiTracker(_Camera(False, 1), est, None, device="cpu")
    assert mt._cls_row == {1: 0, 3: 1}
    assert mt._mesh_v_stack.shape == (2, 16, 3) and mt._mesh_f_stack.shape == (2, 256, 3)
    assert torch.equal(mt._mesh_v_stack[0, 8:], est[1]._mesh_v[-1].expand(8, 3))
    assert (mt._mesh_f_stack[0, 128:] == 0).all()
    other = _Estimator(False, SIZES[1], poses, 8, 128)
    other.intr = Intrinsics.from_fov(50.0, *M_INTR)
    with pytest.raises(ValueError):
        tmt.MultiTracker(_Camera(False, 1), {0: est[3], 1: other}, None, device="cpu")


# --- the init rollout on the batched step ------------------------------------


class _RollCamera:
    """Serves one rendered frame over and over."""

    def __init__(self, jax_side, depth, n):
        self.depth = jnp.asarray(depth) if jax_side else torch.from_numpy(depth)
        self.n = n

    def get_rgbd(self):
        if self.n == 0:
            return None
        self.n -= 1
        return np.zeros((4, 4, 3), np.uint8)

    def get_pcd_from_rgbd(self, mask):
        return None


class _RollDetector:
    def __init__(self, jax_side, camera):
        self.jax_side, self.camera = jax_side, camera

    def __call__(self, img, conf=0.7, iou=0.7):
        m = self.camera.depth > 0
        if self.jax_side:
            det = JDetections(boxes=jnp.zeros((1, 4)), scores=jnp.ones(1),
                              classes=jnp.zeros(1, jnp.int32), coeffs=jnp.zeros((1, 32)),
                              valid=jnp.ones(1, bool))
            return det, m[None], jnp.zeros((1, 4))
        det = Detections(boxes=torch.zeros(1, 4), scores=torch.ones(1),
                         classes=torch.zeros(1, dtype=torch.int64), coeffs=torch.zeros(1, 32),
                         valid=torch.ones(1, dtype=torch.bool))
        return det, m[None], torch.zeros(1, 4)


@pytest.fixture(scope="module")
def roll_scene():
    """The L-shape (0.2 scale) 0.45 m out; the search ranks a basin turned
    pi about the model's y first and a near one second."""
    v, f = LSHAPE
    T_gt = _yaw(0.0, 0.5, 0.45)
    T_gt[:3, :3] = T_gt[:3, :3] @ jtrk._so3_exp(np.array([0.4, 0.0, 0.0]))
    depth = np.array(j_render(jnp.asarray(v), jnp.asarray(f), jnp.asarray(T_gt), J_INTR,
                              near=0.01, far=5.0))
    flip = np.eye(4, dtype=np.float32)
    flip[:3, :3] = jtrk._so3_exp(np.array([0.0, np.pi, 0.0]))
    near = _delta(0.04, [0.006, -0.004, 0.003]) @ T_gt
    cands = [(0.10, (T_gt @ flip).astype(np.float32), 0), (0.12, near.astype(np.float32), 1)]
    return T_gt, depth, cands


def _roll_tracker(jax_side, depth, cands, monkeypatch, frames=2, target_pts=0):
    v, f = LSHAPE
    mesh = SimpleNamespace(extent=v.max(0) - v.min(0))
    est = SimpleNamespace(mesh=mesh, intr=J_INTR if jax_side else T_INTR,
                          _mesh_v=jnp.asarray(v) if jax_side else torch.from_numpy(v),
                          _mesh_f=(jnp.asarray(f) if jax_side
                                   else torch.from_numpy(f.astype(np.int64))),
                          find_best_template_candidates=lambda dst, keep_pre_icp=False,
                          mask=None: (cands[0][1], None, list(cands)))
    cam = _RollCamera(jax_side, depth, 1 + frames)
    cfg = dict(target_pts=target_pts, icp_dist=0.05, warmup_frames=1, max_init_frames=3,
               init_rollout=frames)
    if jax_side:
        return jtrk.Tracker(cam, est, _RollDetector(True, cam), **cfg)
    return trk.Tracker(cam, est, _RollDetector(False, cam), device="cpu", **cfg)


def test_rollout_is_its_previous_per_candidate_loop(roll_scene, monkeypatch):
    """The batched rollout against the loop it replaced (one ``track_step``
    per candidate, drawing from the tracker's generator in turn), sparse so
    that every sampler draws: the same pose, margin and fallback order, bit
    for bit."""
    T_gt, depth, cands = roll_scene
    new = _roll_tracker(False, depth, cands, monkeypatch, target_pts=300)
    res_new = new.step()

    def per_candidate(mesh_v, mesh_f, m, depth_, Ts, intr, dist, win_hw, target_pts,
                      icp_pose_tol, generator):
        return SimpleNamespace(T=torch.stack([
            trk.track_step(mesh_v, mesh_f, m, depth_, T, intr, icp_dist=dist, win_hw=win_hw,
                           target_pts=target_pts, generator=generator).T for T in Ts]))

    old = _roll_tracker(False, depth, cands, monkeypatch, target_pts=300)
    monkeypatch.setattr(trk, "track_step_batched", per_candidate)
    res_old = old.step()
    assert res_new.state == res_old.state == "init"
    assert np.array_equal(res_new.T_m2c, res_old.T_m2c)
    assert res_new.init_margin == res_old.init_margin > 0.0
    assert [c[2] for c in new._candidates] == [c[2] for c in old._candidates] == [1, 0]


def test_rollout_matches_jax(roll_scene, monkeypatch, jax_nn_as_k1):
    """The port's rollout on the JAX rollout's own draws (its key split per
    frame, then per candidate), over one rollout frame: the same winner and
    fallback order, the winner's pose within 1e-4 and the margin within
    1e-3 relative. (Over a second frame the near candidate's track parts
    from the reference's by 1.5e-2 at an equal iteration count, from the
    same start pose and draws, while the reference agrees with itself
    vmapped and unbatched: a near-tie in the exact-parity loop at the 0.05
    radius breaks the other way on the last-bit differences that
    tests/test_torch_track_step.py describes.)"""
    T_gt, depth, cands = roll_scene
    res_j = _roll_tracker(True, depth, cands, monkeypatch, frames=1).step()
    state = {"key": jax.random.PRNGKey(0)}
    batched = trk.track_step_batched

    def with_jax_draws(*args, **kw):
        state["key"], k = jax.random.split(state["key"])
        keys = jax.random.split(k, args[4].shape[0])
        return batched(*args, **kw, draws=[jax_sampler_draws(kk, None) for kk in keys])

    monkeypatch.setattr(trk, "track_step_batched", with_jax_draws)
    tracker = _roll_tracker(False, depth, cands, monkeypatch, frames=1)
    res_p = tracker.step()
    assert tracker._win_hw is None  # the full frame: the exact Open3D-parity loop
    assert [c[2] for c in tracker._candidates] == [1, 0]
    np.testing.assert_allclose(res_p.T_m2c, np.asarray(res_j.T_m2c), atol=1e-4)
    assert res_p.init_margin == pytest.approx(res_j.init_margin, rel=1e-3)
