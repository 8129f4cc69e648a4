"""Port parity, multi-device: the port's ``parallel/`` over torch.distributed
against its own single-device paths and the JAX package's ``parallel/``.

The port runs in gloo ranks on the CPU: one launch at world 1 and one at
world 2 (``tests/torch_parallel_ranks.py``, started together), each running
every sharded path once and saving what every rank got; the single-device
references run in the world of one, or on a rank of world 2 once its
sharded work is done (the two launches then take about as long). The JAX side runs on the 8-device
virtual CPU mesh of ``tests/conftest.py`` (2 devices for the tracker), each
computation once, while the ranks work. Tolerances, stated per test:

- sharded Chamfer (1000 / 800 points, unmasked and masked): 1e-6 relative
  to the port's single-device ``chamfer_distance`` and to the JAX
  package's ``sharded_chamfer``;
- the sharded search (the synthetic fixture, 8 templates, 128x96): world 1
  bit-equal to the single-device ``search_templates`` on the same draws;
  world 2's scores within 1e-5 of world 1's (the JAX package's own bound
  across mesh sizes) with the same winner, ``good_idx``, ADD < 0.11; the
  fixture equal to the JAX package's (points 1e-6; the observed
  silhouette to a few pixels; FPFH within 1% relative L1 on most points,
  as ``tests/test_torch_search.py`` holds ``_extract_fpfh``);
- ``PoseEstimator(mesh_devices=)`` at world 2 (5 templates padded to 6)
  against the single-device estimator with ``search_final_topk=0``: the
  same first-ranked template, ADD < 0.12 diag for both;
- ``sharded_multi_track`` (B = 4, 160x120): world 2 bit-equal to world 1
  and to ``track_step_batched``; at B = 2 with the JAX package's draws,
  within 1e-4 (T) and 1e-6 (fitness) of the JAX ``sharded_multi_track`` on
  a 2-device mesh, as ``tests/test_torch_multi_tracking.py`` holds the
  batched step;
- ``ShardedDetector`` (YOLO11n-seg nc 3, imgsz 64, batch 4; the JAX
  package's flax variables, seeded, carried by the converter): against the
  port's ``predict_batch`` valid equal, scores 1e-5, boxes 1e-4 px (the
  JAX package's bounds); against the JAX ``predict_batch`` valid equal,
  boxes 5e-3 px, scores 2e-4 + 1e-3 relative (``tests/test_torch_yolo.py``);
- data-parallel training (imgsz 64, batch 4 = 2 + 2): loss parts within
  1e-4 relative of world 1 (the single-device program); BatchNorm running
  statistics within 1e-4 of each leaf's scale (train-mode BN over 2 x 2
  maps amplifies float32 rounding); the weights within 2e-5 (absolute, as
  the JAX package holds its 1- against 8-device step) where both runs know
  the gradient to 0.1% (Adam moves a rounding-level gradient by ~lr with
  an arbitrary sign), everywhere within 2.5 lr;
  weights, Adam moments and EMA bit-equal across ranks; only rank 0 saves.
"""
import os
from dataclasses import replace
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseestimator_tpu import geom3d as g3
from poseestimator_tpu import parallel as jpar
from poseestimator_tpu.geom3d import cloud as j_cloud
from poseestimator_tpu.models import yolo as Y
from poseestimator_tpu.parallel import tracking as jpar_tracking
from poseestimator_tpu.pipeline.detector import Detector as JDetector
from poseestimator_tpu.pipeline.pose_estimator import _extract_fpfh as j_extract_fpfh
from poseestimator_tpu.registration import icp as j_icp_module
from poseestimator_tpu_torch.geom3d.camera import Intrinsics, backproject_depth
from poseestimator_tpu_torch.geom3d.cloud import PointCloud, from_points
from poseestimator_tpu_torch.geom3d.fpfh import compute_fpfh
from poseestimator_tpu_torch.geom3d.knn import radius_knn
from poseestimator_tpu_torch.geom3d.metrics import add_metric, chamfer_distance
from poseestimator_tpu_torch.models.yolo import weights as tweights
from poseestimator_tpu_torch.parallel import launch, make_mesh, make_synthetic_search_inputs
from poseestimator_tpu_torch.pipeline.pose_estimator import PoseEstimator, _extract_fpfh
from poseestimator_tpu_torch.pipeline.tracking import RENDER_DOWNSCALE
from poseestimator_tpu_torch.pipeline.window import window_dims
from poseestimator_tpu_torch.render.mesh import pad_faces
from poseestimator_tpu_torch.render.raster import render_depth_mesh
from poseestimator_tpu_torch.utils.plyio import write_ply

import torch_parallel_ranks
from helpers import l_shape_mesh
from test_torch_multi_tracking import _k1_callback_vmapped
from test_torch_track_step import BOX_FACES, BOX_HALF, jax_sampler_draws
from test_torch_yolo import _randomized
from test_training import make_synthetic_dataset

W, H = 160, 120
T_INTR = Intrinsics.from_fov(60.0, W, H)
J_INTR = g3.Intrinsics.from_fov(60.0, W, H)
E_INTR = Intrinsics.from_fov(60.0, 128, 96)
GL_TO_CV = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)


def _yaw(x, yaw, z):
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    T[0, 3], T[2, 3] = x, z
    return T


def _delta(ang, t):
    c, s = np.cos(ang), np.sin(ang)
    d = np.eye(4, dtype=np.float32)
    d[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    d[:3, 3] = t
    return d


def _box():
    bx, by, bz = BOX_HALF
    v = np.array([[sx * bx, sy * by, sz * bz] for sx in (-1, 1) for sy in (-1, 1)
                  for sz in (-1, 1)], np.float32)
    return v, pad_faces(BOX_FACES, 256).astype(np.int64)


def _track_scene():
    """Four boxes side by side (nearest-depth composite through the port's
    raster) and each one's visible mask; start poses perturbed apart."""
    v, f = _box()
    T_obs = [_yaw(-0.135, 0.45, 0.5), _yaw(-0.045, 0.3, 0.56), _yaw(0.045, 0.5, 0.62),
             _yaw(0.135, 0.35, 0.53)]
    ds = np.stack([render_depth_mesh(torch.from_numpy(v), torch.from_numpy(f),
                                     torch.from_numpy(T), T_INTR, near=0.01, far=5.0).numpy()
                   for T in T_obs])
    z = np.where(ds > 0, ds, np.inf)
    zmin = z.min(0)
    depth = np.where(np.isinf(zmin), 0.0, zmin).astype(np.float32)
    masks = (ds > 0) & (z <= zmin)
    T0 = np.stack([np.linalg.inv(_delta(0.03 + 0.01 * i, [0.004, -0.002, 0.002 * i])) @ T
                   for i, T in enumerate(T_obs)]).astype(np.float32)
    dists = np.array([0.05, 0.02, 0.01, 0.03], np.float32)
    return v, f, depth, masks, T0, dists


def _estimator_scene(d):
    """The L-shape CAD and its 5-view database written by the port, and the
    exact-raster observation 2 m out near view 11 (the JAX test's pose)."""
    mesh = l_shape_mesh()
    cad = str(d / "l.ply")
    write_ply(cad, mesh.vertices, faces=mesh.faces)
    est = PoseEstimator(cad, str(d / "views"), E_INTR, target_points=100, seed=0, device="cpu")
    dv = np.array([1.0, 1.0, 1.0]) / np.sqrt(3)
    T_gt = (GL_TO_CV @ np.asarray(g3.look_at(dv * 2.0, [0, 0, 0], [0, 1, 0]))).astype(np.float32)
    depth = render_depth_mesh(est._mesh_v, est._mesh_f, torch.from_numpy(T_gt), E_INTR,
                              near=0.01, far=10.0)
    cloud = backproject_depth(depth, E_INTR, depth_min=0.01, depth_max=10.0)
    return {"cad": cad, "views": str(d / "views"), "points": cloud.points,
            "valid": cloud.valid}, T_gt, mesh


def _seeded_variables(rng):
    """The JAX package's flax variables of YOLO11n-seg (nc 3): its variable
    tree (``jax.eval_shape`` of ``init``, no compile) with seeded values,
    kernels at 1 / sqrt(fan-in), BatchNorm statistics and biases as
    ``tests/test_torch_yolo.py`` randomizes them."""
    shapes = jax.eval_shape(
        lambda x: Y.YOLO11Seg(nc=3, scale="n").init(jax.random.PRNGKey(0), x, train=False),
        jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))

    def leaf(path, x):
        if jax.tree_util.keystr(path).endswith("['kernel']"):
            std = 1.0 / np.sqrt(np.prod(x.shape[:-1]))
            return (rng.normal(size=x.shape) * std).astype(np.float32)
        return np.zeros(x.shape, np.float32)

    return _randomized(jax.tree_util.tree_map_with_path(leaf, shapes), seed=1)


def _clouds(rng):
    a = rng.normal(size=(1000, 3)).astype(np.float32)
    b = (a + rng.normal(size=(1000, 3)).astype(np.float32) * 0.01).astype(np.float32)
    am, bm = a.copy(), rng.normal(size=(800, 3)).astype(np.float32)
    av, bv = np.ones(1000, bool), np.ones(800, bool)
    av[rng.choice(1000, 200, replace=False)] = False
    bv[rng.choice(800, 100, replace=False)] = False
    t = torch.from_numpy
    return {"unmasked": (t(a), t(np.ones(1000, bool)), t(b), t(np.ones(1000, bool))),
            "masked": (t(am), t(av), t(bm), t(bv))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Writes the inputs, starts both worlds, computes the JAX side while
    they run, and returns ``(port results by (world, rank), JAX results,
    inputs)``."""
    torch.set_num_threads(2)
    io = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(0)
    est_in, T_gt, lmesh = _estimator_scene(io)
    v, f, depth, masks, T0, dists = _track_scene()
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    win = window_dims(T_INTR.scaled(RENDER_DOWNSCALE), "auto")
    jvars = _seeded_variables(rng)
    images = rng.integers(0, 255, (4, 48, 64, 3), dtype=np.uint8)
    t = torch.from_numpy
    inputs = {
        "chamfer": _clouds(rng), "estimator": est_in,
        "track": {"mesh_v": t(v), "mesh_f": t(f), "masks": t(masks), "depth": t(depth),
                  "Ts": t(T0), "intr": T_INTR, "dists": t(dists)},
        "track_jax": {"masks": t(masks[:2]), "Ts": t(T0[:2]), "dists": t(dists[:2]),
                      "draws": [jax_sampler_draws(k, win) for k in keys]},
        "detector": {"state_dict": tweights.variables_to_state_dict(jvars),
                     "images": t(images)},
        "dataset": make_synthetic_dataset(str(io / "data"), n_images=8, size=96),
    }
    torch.save(inputs, io / "inputs.pt")
    ctxs = [launch(torch_parallel_ranks.run, w, "gloo", "cpu", init_file=str(io / f"rdv{w}"),
                   args=(str(io), w), join=False) for w in (1, 2)]

    jax_out = {}
    jmesh = jpar.make_mesh("dp")
    for name, (a, av, b, bv) in inputs["chamfer"].items():
        jax_out[f"chamfer {name}"] = float(jpar.sharded_chamfer(
            jmesh, jnp.asarray(a.numpy()), jnp.asarray(av.numpy()), jnp.asarray(b.numpy()),
            jnp.asarray(bv.numpy())))
    jax_out["fixture"] = fx = jpar.make_synthetic_search_inputs(n_tpl=8, C=128, n_cad=1200)
    jax_out["fixture normals, fpfh"] = [
        tuple(np.array(a) for a in (lambda c, f: (c.normals, f))(*j_extract_fpfh(
            j_cloud.PointCloud(points=fx["tpl_points"][i], valid=fx["tpl_valid"][i]), 0.05,
            outward=True))) for i in range(8)]
    jdet = JDetector(jvars, nc=3, imgsz=64, max_det=8)
    jd, jb = jdet.predict_batch(images, conf=0.001)
    jax_out["detector"] = (np.asarray(jd.valid), np.asarray(jd.scores), np.asarray(jb))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_icp_module, "nearest_neighbor", _k1_callback_vmapped)
        jpar_tracking._sharded_track_fn.cache_clear()
        jax.clear_caches()
        m2 = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("dp",))
        Tj, fitj, _, _ = jpar.sharded_multi_track(
            m2, jnp.asarray(v), jnp.asarray(f.astype(np.int32)), jnp.asarray(masks[:2]),
            jnp.asarray(depth), jnp.asarray(T0[:2]), J_INTR, 0, keys, jnp.asarray(dists[:2]))
        jax_out["track"] = (np.asarray(Tj), np.asarray(fitj))
        jpar_tracking._sharded_track_fn.cache_clear()
    jax.clear_caches()

    for c in ctxs:
        while not c.join():
            pass
    port = {(w, r): torch.load(io / f"world{w}_rank{r}.pt", weights_only=False)
            for w in (1, 2) for r in range(w)}
    return SimpleNamespace(port=port, jax=jax_out, inputs=inputs, T_gt=T_gt, lmesh=lmesh,
                           io=io)


# --- mesh helpers ------------------------------------------------------------

def test_mesh_helpers(runs):
    x = torch.arange(24.0).reshape(8, 3)
    for w in (1, 2):
        for r in range(w):
            o = runs.port[(w, r)]
            assert o["shape"] == {"dp": w} and o["tp_shape"] == {"tp": w} and o["rank"] == r
            rows = slice(r * 8 // w, (r + 1) * 8 // w)
            assert torch.equal(o["shard"], x[rows])
            assert torch.equal(o["shard_dict"]["x"], x[rows])
            assert torch.equal(o["shard_dict"]["y"][0], x[rows, 0])
            assert torch.equal(o["replicate"], x)  # rank 0's copy everywhere
            assert o["subgroup"] == ((1, 0) if r == 0 else None)


def test_make_mesh_without_a_group():
    """No process group: a world of one on the caller's device; more
    devices, or NCCL on the CPU, raise rather than fall back."""
    m = make_mesh("tp", device="cpu")
    assert (m.size, m.rank, m.shape, m.device.type) == (1, 0, {"tp": 1}, "cpu")
    x = torch.arange(6.0)
    assert m.all_gather(x) is x and torch.equal(m.all_reduce(x), x)
    with pytest.raises(ValueError, match="no process group"):
        make_mesh("dp", n_devices=2, device="cpu")
    with pytest.raises(ValueError, match="nccl"):
        launch(torch_parallel_ranks.run, 1, "nccl", "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh("dp")


# --- sharded Chamfer ---------------------------------------------------------

@pytest.mark.parametrize("name", ["unmasked", "masked"])
def test_sharded_chamfer(runs, name):
    a, av, b, bv = runs.inputs["chamfer"][name]
    ref = float(chamfer_distance(PointCloud(a, av), PointCloud(b, bv)))
    for w in (1, 2):
        for r in range(w):
            got = runs.port[(w, r)][f"chamfer {name}"]
            assert abs(got - ref) <= 1e-6 * ref, (w, r, got, ref)
    assert abs(runs.port[(2, 0)][f"chamfer {name}"] - runs.jax[f"chamfer {name}"]) \
        <= 1e-6 * ref


# --- the sharded search ------------------------------------------------------

def test_synthetic_search_inputs_match_jax(runs):
    """Points, masks and the pose equal; the templates' features held as
    ``tests/test_torch_search.py`` holds ``_extract_fpfh``: normals equal
    wherever the neighbourhood fixes them (the blob and the rods are
    volumes and lines, whose smallest eigenvalue is mostly repeated), and
    FPFH from the same normals within 1% relative L1 at every point. The
    hollow cube shells (templates 2 and 5) are the exception: their points
    lie exactly on six planes, so coplanar pairs put the angle features on
    bin edges, and each package's rounding bins a few of them apart (5.6%
    and 6.5% at the worst point); there 85% of the points within 1% and
    every point within 10%."""
    p = make_synthetic_search_inputs(n_tpl=8, C=128, n_cad=1200, device="cpu")
    j = runs.jax["fixture"]
    assert p["good_idx"] == j["good_idx"] == 3
    np.testing.assert_allclose(p["T_gt"], j["T_gt"], atol=1e-6)
    for k in ("dst_points", "tpl_points", "cad_points"):
        np.testing.assert_allclose(p[k].numpy(), np.asarray(j[k]), atol=1e-6, err_msg=k)
    for k in ("dst_valid", "tpl_valid", "cad_valid"):
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(j[k]), err_msg=k)
    sil_p, sil_j = p["mask_sil"].numpy(), np.asarray(j["mask_sil"])
    assert (sil_p != sil_j).sum() <= 3 and sil_j.sum() > 500
    n_fixed = 0
    for i in range(8):
        pts = p["tpl_points"][i]
        tc, tf = _extract_fpfh(PointCloud(pts, p["tpl_valid"][i]), 0.05, outward=True)
        assert torch.equal(tf, p["tpl_fpfh"][i])
        jn, jf = runs.jax["fixture normals, fpfh"][i]
        _, idx, nb = radius_knn(pts, p["tpl_valid"][i], pts, p["tpl_valid"][i], 0.05, 30)
        for k in range(128):
            nbrs = pts[idx[k][nb[k]]].double().numpy()
            ev = np.linalg.eigvalsh(np.cov(nbrs.T, bias=True)) if len(nbrs) > 2 else np.zeros(3)
            if ev[1] - ev[0] > 1e-2 * ev[2]:  # a unique smallest eigenvalue
                n_fixed += 1
                assert np.dot(jn[k], tc.normals[k].numpy()) >= 1 - 1e-5
        same, _ = compute_fpfh(replace(tc, normals=torch.from_numpy(jn)),
                               radius=float(np.float32(0.05) * np.float32(5.0)), max_nn=100)
        rel = np.abs(same.numpy() - jf).sum(-1) / np.abs(jf).sum(-1)
        if i % 3 == 2:  # a cube shell
            assert (rel <= 0.01).mean() >= 0.85 and rel.max() <= 0.1, (i, np.sort(rel)[-5:])
        else:
            assert rel.max() <= 0.01, (i, np.sort(rel)[-5:])
    assert n_fixed > 0.25 * 8 * 128  # the normal check is not vacuous


def test_search_world_of_one_is_the_single_device_search(runs):
    Hp, Hr, scores = runs.port[(1, 0)]["search"]
    H_pre_best, Hr_s, scores_s = runs.port[(2, 1)]["search single"]
    assert torch.equal(scores, scores_s) and torch.equal(Hr, Hr_s)
    assert torch.equal(Hp[torch.argmin(scores)], H_pre_best)


def test_search_world_two_matches_world_one_and_recovers_the_pose(runs):
    Hp1, Hr1, s1 = runs.port[(1, 0)]["search"]
    j = runs.jax["fixture"]
    model = from_points(torch.from_numpy(np.array(j["cad_points"])), device="cpu")
    for r in range(2):
        Hp2, Hr2, s2 = runs.port[(2, r)]["search"]
        assert s2.shape == (8,)
        np.testing.assert_allclose(s2.numpy(), s1.numpy(), atol=1e-5)
        w = int(torch.argmin(s2))
        assert w == int(torch.argmin(s1)) == j["good_idx"]
        add = float(add_metric(Hr2[w], torch.from_numpy(j["T_gt"]), model))
        assert add < 0.11, f"winner ADD {add:.4f} (diag ~0.44)"
    assert all(torch.equal(a, b) for a, b in zip(runs.port[(2, 0)]["search"],
                                                  runs.port[(2, 1)]["search"]))


def test_estimator_mesh_path_matches_single_device(runs):
    """World 2 (5 templates padded to 6) against the single-device estimator
    without the final prune: the same first-ranked template, ADD < 0.12
    diag for both, the same result on both ranks."""
    T_gt = torch.from_numpy(runs.T_gt)
    model = from_points(torch.from_numpy(np.asarray(runs.lmesh.vertices, np.float32)), device="cpu")
    diag = float(np.linalg.norm(runs.lmesh.extent))
    H_s, cand_s = runs.port[(1, 0)]["estimator"]
    H_m, cand_m = runs.port[(2, 0)]["estimator"]
    assert len(cand_m) == len(cand_s) == 5
    assert cand_m[0][2] == cand_s[0][2]
    for H in (H_s, H_m):
        add = float(add_metric(torch.from_numpy(np.asarray(H, np.float32)), T_gt, model))
        assert add < 0.12 * diag, f"ADD {add:.4f}"
    np.testing.assert_array_equal(runs.port[(2, 1)]["estimator"][0], H_m)


def test_padding_tiles_when_pad_exceeds_template_count():
    """5 templates on a 16-way axis: whole copies, then a slice."""
    stub = SimpleNamespace(
        _tpl_points=torch.arange(5 * 7 * 3, dtype=torch.float32).reshape(5, 7, 3),
        _tpl_valid=torch.ones((5, 7), dtype=torch.bool),
        _tpl_fpfh=torch.arange(5 * 7 * 33, dtype=torch.float32).reshape(5, 7, 33),
        device_mesh=SimpleNamespace(shape={"tp": 16}), shard_axis="tp")
    pts, valid, fpfh, n = PoseEstimator._padded_templates(stub)
    assert n == 5 and pts.shape[0] == 16 and valid.shape[0] == 16 and fpfh.shape[0] == 16
    for i in range(16):
        assert torch.equal(pts[i], stub._tpl_points[i % 5])
        assert torch.equal(fpfh[i], stub._tpl_fpfh[i % 5])


# --- sharded multi-object tracking -------------------------------------------

def test_sharded_multi_track_is_partition_independent(runs):
    ref = runs.port[(2, 0)]["track single"]
    for key in ((1, 0), (2, 0), (2, 1)):
        for got, want in zip(runs.port[key]["track"], ref):
            assert torch.equal(got, want), key
    assert runs.port[(1, 0)]["track"][0].shape == (4, 4, 4)


def test_sharded_multi_track_matches_jax(runs):
    Tj, fitj = runs.jax["track"]
    for r in range(2):
        T, fit, _, _ = runs.port[(2, r)]["track jax draws"]
        np.testing.assert_allclose(T.numpy(), Tj, atol=1e-4)
        np.testing.assert_allclose(fit.numpy(), fitj, atol=1e-6)


# --- batch-sharded detection serving -----------------------------------------

def test_sharded_detector_matches_predict_batch(runs):
    ref_d, ref_b = runs.port[(1, 0)]["detector single"]
    assert int(ref_d.valid.sum()) > 0
    for key in ((1, 0), (2, 0), (2, 1)):
        d, b = runs.port[key]["detector"]
        assert torch.equal(d.valid, ref_d.valid), key
        np.testing.assert_allclose(d.scores.numpy(), ref_d.scores.numpy(), atol=1e-5)
        np.testing.assert_allclose(b.numpy(), ref_b.numpy(), atol=1e-4)


def test_sharded_detector_matches_jax(runs):
    jv, js, jb = runs.jax["detector"]
    d, b = runs.port[(2, 0)]["detector"]
    np.testing.assert_array_equal(d.valid.numpy(), jv)
    v = jv
    np.testing.assert_allclose(d.scores.numpy()[v], js[v], atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(b.numpy()[v], jb[v], atol=5e-3)


def test_sharded_detector_rejects_indivisible_batch(runs):
    assert runs.port[(2, 0)]["indivisible raised"] is True
    assert runs.port[(2, 1)]["indivisible raised"] is True


# --- data-parallel training --------------------------------------------------

def _rel(a, b, where=None):
    d = (a.double() - b.double()).abs()
    if where is not None:
        d = d[where]
    return (float(d.max()) if d.numel() else 0.0) / max(float(b.abs().max()), 1e-6)


def test_data_parallel_steps_match_world_one(runs):
    one, two = runs.port[(1, 0)]["train"], runs.port[(2, 0)]["train"]
    for step, (a, b) in enumerate(zip(one, two)):
        for k, v in a["parts"].items():
            assert abs(b["parts"][k] - v) <= 1e-4 * abs(v), (step, k, v, b["parts"][k])
        assert a["lr"] == b["lr"] == pytest.approx(0.0 if step == 0 else 1e-3)
        known = total = 0
        for k, mu1, mu2 in zip(a["params"], a["mu"], b["mu"]):
            sure = (mu1.abs() > 1e-6) & ((mu2 - mu1).abs() <= 1e-3 * mu1.abs())
            known, total = known + int(sure.sum()), total + sure.numel()
            d = (b["params"][k] - a["params"][k]).abs()
            assert float(d[sure].max()) <= 2e-5 if sure.any() else True, (step, k)
            assert float((b["params"][k] - a["params"][k]).abs().max()) <= 2.5 * 1e-3, k
        assert known / total > 0.5
    other = runs.port[(2, 1)]["train"]
    for a, b in zip(two, other):  # replicated, bit for bit
        assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
        assert all(torch.equal(x, y) for x, y in zip(a["mu"], b["mu"]))
        assert all(torch.equal(a["ema"][k], b["ema"][k]) for k in a["ema"])
        assert all(torch.equal(a["stats"][k], b["stats"][k]) for k in a["stats"])


def test_data_parallel_batchnorm_statistics_are_the_global_batch(runs):
    """World 1 is the single-device step on the same 4 images."""
    for a, b in zip(runs.port[(1, 0)]["train"], runs.port[(2, 0)]["train"]):
        for k, s in a["stats"].items():
            if s.is_floating_point():
                assert _rel(b["stats"][k], s) <= 1e-4, k
            else:
                assert torch.equal(b["stats"][k], s), k


def test_data_parallel_fit_writes_on_rank_zero_only(runs):
    f1, f2a, f2b = (runs.port[k]["fit"] for k in ((1, 0), (2, 0), (2, 1)))
    assert f2a["saves"] == ["last.pt", "best.pt"] and f2b["saves"] == []
    assert sorted(os.listdir(runs.io / "runs2" / "dp")) == ["best.pt", "last.pt",
                                                            "results.json"]
    h1, h2 = f1["history"][0], f2a["history"][0]
    for k in ("train/total", "val/total"):
        assert h2[k] == f2b["history"][0][k]
        assert abs(h2[k] - h1[k]) <= 1e-4 * abs(h1[k]), k
    assert h2["val/map50"] == h1["val/map50"] and h2["val/map50_95"] == h1["val/map50_95"]
