"""The port's CUDA kernels against their plain PyTorch versions on a card:
K1 indices and found flags identical and distances exact, K2 max-1/z images
identical, on random inputs and on the edge cases of
``poseestimator_tpu_torch.kernel_cases`` (ties across the data splits,
negative expanded distances, ragged sizes, boxes on tile edges, empty and
full face chunks, the 4096-face icosphere); and each wrapper counts exactly
its own launches. The ``cuda``-marked cases need a card (the kernels have no
CPU mode) and skip without one.

This file imports no JAX, so it also runs where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
import json

import numpy as np
import pytest
import torch

from poseestimator_tpu_torch import kernel_cases as kc
from poseestimator_tpu_torch.geom3d import fused_nn as tnn
from poseestimator_tpu_torch.geom3d.camera import Intrinsics
from poseestimator_tpu_torch.render import raster as traster
from poseestimator_tpu_torch.render.mesh import make_icosphere

NN_CASES = sorted(kc.nn_cases())
RASTER_CASES = sorted(kc.raster_cases())


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")


def _nn_same(q, qv, d, dv):
    before = tnn.fused_nn_stats.launches
    kd, ki, kf = tnn.fused_nn(q, qv, d, dv)
    torch.cuda.synchronize()
    assert tnn.fused_nn_stats.launches == before + 1
    pd, pi, pf = tnn.fused_nn_plain(q, qv, d, dv)
    assert torch.equal(ki, pi) and torch.equal(kf, pf)
    assert torch.equal(kd, pd)
    return ki


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,p", [(1000, 3000, 0.8), (4096, 4096, 1.0), (300, 20000, 0.5)])
def test_fused_nn_kernel_matches_plain(n, m, p):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(n + m)
    q = torch.randn(n, 3, device="cuda", generator=g)
    d = torch.randn(m, 3, device="cuda", generator=g)
    qv = torch.rand(n, device="cuda", generator=g) < 0.9
    dv = torch.rand(m, device="cuda", generator=g) < p
    _nn_same(q, qv, d, dv)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NN_CASES)
def test_fused_nn_kernel_edge_cases(name):
    _need_card()
    _nn_same(*(torch.from_numpy(a).cuda() for a in kc.nn_cases()[name]))


@pytest.mark.cuda
@pytest.mark.parametrize("make", [kc.nn_ties, kc.nn_negative_d2], ids=["ties", "negative_d2"])
def test_fused_nn_kernel_picks_the_lowest_index(make):
    _need_card()
    case, expect = make()
    ki = _nn_same(*(torch.from_numpy(a).cuda() for a in case))
    np.testing.assert_array_equal(ki.cpu().numpy(), expect)


@pytest.mark.cuda
def test_fused_nn_kernel_takes_unaligned_views():
    """Data that start off a 16-byte boundary are copied, not misread."""
    _need_card()
    q, qv, d, dv = (torch.from_numpy(a).cuda() for a in kc.nn_cases()["129x4097"])
    dd = torch.empty(d.numel() + 1, device="cuda")[1:].view_as(d).copy_(d)
    vv = torch.empty(dv.numel() + 1, dtype=torch.bool, device="cuda")[1:].copy_(dv)
    assert dd.data_ptr() % 16 and vv.data_ptr() % 16
    for a, b in zip(tnn.fused_nn(q, qv, dd, vv), tnn.fused_nn_plain(q, qv, d, dv)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_raster_kernel_matches_plain():
    _need_card()
    intr = Intrinsics(fx=300.0, fy=300.0, cx=80.0, cy=60.0, width=160, height=120)
    v, f = make_icosphere(0.08, 3)
    T = torch.eye(4, device="cuda")
    T[2, 3] = 0.5
    coef, bbox = traster.face_coeffs(torch.from_numpy(v).cuda(), torch.from_numpy(f).cuda(),
                                     T, intr, origin=torch.tensor([40.0, 20.0], device="cuda"))
    before = traster.raster_stats.launches
    izk = traster.raster(coef, bbox, 64, 96)
    torch.cuda.synchronize()
    assert traster.raster_stats.launches == before + 1
    izp = traster.raster_plain(coef, 64, 96)
    assert torch.equal(izk, izp)
    assert int((izk > 0).sum()) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("name", RASTER_CASES)
def test_raster_kernel_edge_cases(name):
    _need_card()
    c = kc.raster_cases()[name]
    coef, bbox = traster.face_coeffs(
        torch.from_numpy(c["vertices"]).cuda(), torch.from_numpy(c["faces"]).cuda(),
        torch.from_numpy(c["T"]).cuda(), c["intr"], near=0.01)
    izk = traster.raster(coef, bbox, c["H"], c["W"])
    torch.cuda.synchronize()
    izp = traster.raster_plain(coef, c["H"], c["W"], chunk=64)
    assert torch.equal(izk, izp)
    assert int((izk > 0).sum()) > 1000


@pytest.mark.cuda
def test_raster_kernel_takes_unaligned_views():
    """Rows that start off a 16-byte boundary are copied, not misread."""
    _need_card()
    c = kc.raster_cases()["61x45 window"]
    coef, bbox = traster.face_coeffs(
        torch.from_numpy(c["vertices"]).cuda(), torch.from_numpy(c["faces"]).cuda(),
        torch.from_numpy(c["T"]).cuda(), c["intr"], near=0.01)
    cv = torch.empty(coef.numel() + 1, device="cuda")[1:].view_as(coef).copy_(coef)
    bv = torch.empty(bbox.numel() + 1, device="cuda")[1:].view_as(bbox).copy_(bbox)
    assert cv.data_ptr() % 16 and bv.data_ptr() % 16
    assert torch.equal(traster.raster(cv, bv, c["H"], c["W"]),
                       traster.raster_plain(coef, c["H"], c["W"]))


def test_wrappers_raise_on_other_devices():
    """A tensor on neither the CPU nor a CUDA card is an error, never a
    silent detour through the plain version."""
    q = torch.zeros(4, 3, device="meta")
    v = torch.ones(4, dtype=torch.bool, device="meta")
    with pytest.raises(RuntimeError):
        tnn.fused_nn(q, v, q, v)
    with pytest.raises(RuntimeError):
        traster.raster(torch.zeros(8, 12, device="meta"), torch.zeros(8, 4, device="meta"), 8, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("angle", [0.1, 0.18, 0.34])
def test_raster_kernel_on_the_tracker_scene(angle):
    """K2 over the full 640 x 480 frame of the tracker scene's mesh camera:
    the L-shape's 24 faces padded to 256, turned about z as the scene
    turns."""
    _need_card()
    from poseestimator_tpu_torch.geom3d.se3 import look_at
    from poseestimator_tpu_torch.render.mesh import pad_faces

    v, f = kc.lshape_mesh()
    d = np.ones(3) / np.sqrt(3.0)
    base = kc.GL_TO_CV @ look_at(d * 2.0 * float(np.linalg.norm(v.max(0) - v.min(0))),
                                 np.zeros(3), [0.0, 1.0, 0.0]).numpy()
    P = np.eye(4)
    P[:2, :2] = [[np.cos(angle), -np.sin(angle)], [np.sin(angle), np.cos(angle)]]
    T = torch.from_numpy((P @ base).astype(np.float32)).cuda()
    coef, bbox = traster.face_coeffs(torch.from_numpy(v).cuda(),
                                     torch.from_numpy(pad_faces(f, 256)).cuda(), T,
                                     Intrinsics.from_fov(60.0, 640, 480), near=0.01)
    izk = traster.raster(coef, bbox, 480, 640)
    torch.cuda.synchronize()
    assert torch.equal(izk, traster.raster_plain(coef, 480, 640, chunk=64))
    assert int((izk > 0).sum()) > 10000


# --- the batch axis ----------------------------------------------------------


def test_batched_wrappers_raise_on_other_devices():
    """The batched entries, like the unbatched ones: a tensor on neither
    the CPU nor a CUDA card is an error."""
    q = torch.zeros(2, 4, 3, device="meta")
    v = torch.ones(2, 4, dtype=torch.bool, device="meta")
    with pytest.raises(RuntimeError):
        tnn.fused_nn_batched(q, v, q, v)
    with pytest.raises(RuntimeError):
        traster.raster_batched(torch.zeros(2, 8, 12, device="meta"),
                               torch.zeros(2, 8, 4, device="meta"), 8, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(kc.nn_batched_cases()))
def test_batched_fused_nn_kernel_per_problem(name):
    """One launch of K1's batched entry: each problem bit for bit an
    unbatched launch on its own unpadded problem and the batched plain
    version; only the batched counter moves."""
    _need_card()
    batch, sizes = kc.nn_batched_cases()[name]
    q, qv, d, dv = (torch.from_numpy(a).cuda() for a in batch)
    b0, u0 = tnn.fused_nn_batched_stats.launches, tnn.fused_nn_stats.launches
    got = tnn.fused_nn_batched(q, qv, d, dv)
    torch.cuda.synchronize()
    assert tnn.fused_nn_batched_stats.launches == b0 + 1
    assert tnn.fused_nn_stats.launches == u0
    for a, b in zip(got, tnn.fused_nn_batched_plain(q, qv, d, dv)):
        assert torch.equal(a, b)
    for b, (n, m) in enumerate(sizes):
        one = tnn.fused_nn(q[b, :n], qv[b, :n], d[b, :m], dv[b, :m])
        for a, u in zip(got, one):
            assert torch.equal(a[b, :n], u)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(kc.raster_batched_cases()))
def test_batched_raster_kernel_per_problem(name):
    """One launch of K2's batched entry: each problem bit for bit an
    unbatched launch on its rows and the batched plain version."""
    _need_card()
    c = kc.raster_batched_cases()[name]
    v, f, T, o = (torch.from_numpy(c[k]).cuda() for k in ("vertices", "faces", "T", "origin"))
    coef, bbox = traster.face_coeffs(v, f, T, c["intr"], near=0.01, origin=o)
    b0, u0 = traster.raster_batched_stats.launches, traster.raster_stats.launches
    izk = traster.raster_batched(coef, bbox, c["H"], c["W"])
    torch.cuda.synchronize()
    assert traster.raster_batched_stats.launches == b0 + 1
    assert traster.raster_stats.launches == u0
    assert torch.equal(izk, traster.raster_batched_plain(coef, c["H"], c["W"], chunk=64))
    for b in range(T.shape[0]):
        assert torch.equal(izk[b], traster.raster(coef[b], bbox[b], c["H"], c["W"]))


@pytest.mark.cuda
def test_voxel_down_sample_is_deterministic():
    """Two voxelisations of one 16384-point cloud on the card, bit-equal."""
    _need_card()
    from poseestimator_tpu_torch.geom3d.cloud import PointCloud
    from poseestimator_tpu_torch.geom3d.sampling import voxel_down_sample

    g = torch.Generator(device="cuda").manual_seed(0)
    pts = torch.randn(16384, 3, device="cuda", generator=g) * 0.1
    cloud = PointCloud(pts, torch.rand(16384, device="cuda", generator=g) < 0.95)
    a, b = (voxel_down_sample(cloud, 0.01, capacity=4096) for _ in range(2))
    assert torch.equal(a.points, b.points) and torch.equal(a.valid, b.valid)
    assert int(a.valid.sum()) > 1000


@pytest.mark.cuda
def test_batched_track_step_does_not_depend_on_the_batch():
    """Track i of a B = 3 and a B = 8 batched step (B = 8 repeats the three
    instances of the multi-object scene from other start poses) is bit for
    bit itself at B = 1 and the unbatched track step, on the same draws:
    pose, fitness, rmse, covariance and ICP iterations."""
    _need_card()
    from poseestimator_tpu_torch.camera import SyntheticCamera
    from poseestimator_tpu_torch.pipeline.tracking import (step_draws, track_step,
                                                           track_step_batched)
    from poseestimator_tpu_torch.pipeline.window import window_for_object
    from poseestimator_tpu_torch.render.mesh import pad_faces

    v, f = kc.lshape_mesh()
    diag = float(np.linalg.norm(v.max(0) - v.min(0)))
    intr = Intrinsics.from_fov(60.0, 640, 480)
    mv, mf = torch.from_numpy(v).cuda(), torch.from_numpy(pad_faces(f, 256)).cuda()
    truth = kc.multi_object_poses(3, diag, 0.05)
    cam = SyntheticCamera(v, np.zeros_like(v), [truth], intr, mesh=(mv, mf), device="cuda")
    cam.get_rgbd()
    masks = torch.from_numpy(cam.object_masks).cuda()
    rng = np.random.default_rng(0)
    starts = []
    for i in range(8):  # each start 1-2 cm and ~1 degree off its instance
        D = np.eye(4, dtype=np.float32)
        a = rng.normal(size=3) * 0.01
        D[:3, :3] = [[1, -a[2], a[1]], [a[2], 1, -a[0]], [-a[1], a[0], 1]]
        D[:3, 3] = rng.normal(size=3) * 0.01
        starts.append(D @ truth[i % 3])
    Ts = torch.from_numpy(np.stack(starts).astype(np.float32)).cuda()
    win = window_for_object(intr.scaled(2), diag, float(truth[:, 2, 3].max()))
    dists = torch.tensor([0.05, 0.02, 0.01, 0.01, 0.05, 0.02, 0.01, 0.01], device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    draws = [step_draws(intr, win, 0, g, "cuda") for _ in range(8)]
    sel = torch.arange(8, device="cuda") % 3
    run = lambda idx: track_step_batched(  # noqa: E731
        mv, mf, masks[sel[idx]], cam.depth, Ts[idx], intr, dists[idx], win_hw=win,
        draws=[draws[i] for i in idx.tolist()])
    b8 = run(torch.arange(8, device="cuda"))
    b3 = run(torch.arange(3, device="cuda"))
    for i in range(8):
        one = run(torch.tensor([i], device="cuda"))
        alone = track_step(mv, mf, masks[i % 3], cam.depth, Ts[i], intr, float(dists[i]),
                           win_hw=win, icp_pose_tol=1e-4, draws=draws[i])
        for res, k in [(b8, i), (one, 0)] + ([(b3, i)] if i < 3 else []):
            assert res.n_iters[k] == alone.n_iters
            for got, want in ((res.T[k], alone.T), (res.fitness[k], alone.fitness),
                              (res.rmse[k], alone.rmse), (res.cov[k], alone.cov)):
                assert torch.equal(got, want)
    assert max(b8.n_iters) > min(b8.n_iters)  # the tracks exit at their own iterations


OFFLINE_NN = sorted(kc.nn_offline_cases())


@pytest.mark.cuda
@pytest.mark.parametrize("name", OFFLINE_NN)
def test_fused_nn_kernel_at_the_offline_shapes(name):
    """K1 at the offline Chamfer's shapes (10k-point templates, the 16384-row
    observation, the 400-point sample, five candidate poses), single and
    batched over the candidates: bit for bit the plain version, and each
    batched problem bit for bit its unbatched launch."""
    _need_card()
    q, qv, d, dv = (torch.from_numpy(a).cuda() for a in kc.nn_offline_cases()[name])
    if q.dim() == 2:
        _nn_same(q, qv, d, dv)
        return
    got = tnn.fused_nn_batched(q, qv, d, dv)
    torch.cuda.synchronize()
    want = tnn.fused_nn_batched_plain(q, qv, d, dv)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for b in range(q.shape[0]):
        one = tnn.fused_nn(q[b], qv[b], d[b], dv[b])
        assert all(torch.equal(x[b], y) for x, y in zip(got, one))


@pytest.mark.cuda
def test_eval_bop_sweep_on_the_card_matches_the_cpu(tmp_path):
    """The port's scene sweep (offline flavour) on a 160x120 three-frame
    scene of the 0.3-scale L-shape 0.6 m out, once with ``device="cuda"``
    and once with ``"cpu"``: the draws come from one host generator, so
    the rows may differ only by rounding: ADD-S and MSSD within 0.5 mm,
    MSPD within 0.5 px, VSD at tau = 10% within 0.05, the same AR."""
    _need_card()
    import os

    from poseestimator_tpu_torch.apps import eval_bop
    from poseestimator_tpu_torch.templates.creation import render_templates
    from poseestimator_tpu_torch.utils.plyio import write_ply

    v, f = kc.lshape_mesh(0.3)
    cad = str(tmp_path / "obj_000001.ply")
    write_ply(cad, v, faces=f)
    render_templates(cad, str(tmp_path / "views"), device="cuda")
    sd = str(tmp_path / "scene")
    kc.write_bop_scene(sd, v, f, Intrinsics.from_fov(60.0, 160, 120), kc.bop_scene_poses(0.6),
                       symmetries=kc.lshape_symmetry(0.3)[None], device="cuda")
    base = ["--scene-dir", sd, "--ply", cad, "--templates", str(tmp_path / "views"),
            "--target-points", "100", "--models-info", os.path.join(sd, "models_info.json")]
    rows = {}
    for dev in ("cuda", "cpu"):
        out = str(tmp_path / f"{dev}.json")
        eval_bop.run(eval_bop.build_parser().parse_args(
            base + ["--device", dev, "--json-out", out]), quiet=True)
        with open(out) as fh:
            rows[dev] = json.load(fh)
    assert len(rows["cuda"]["frames"]) == len(rows["cpu"]["frames"]) == 3
    for rc, rp in zip(rows["cuda"]["frames"], rows["cpu"]["frames"]):
        assert abs(rc["adds_mm"] - rp["adds_mm"]) <= 0.5, (rc, rp)
        assert abs(rc["mssd_mm"] - rp["mssd_mm"]) <= 0.5, (rc, rp)
        assert abs(rc["mspd_px"] - rp["mspd_px"]) <= 0.5, (rc, rp)
        assert abs(rc["vsd_tau10"] - rp["vsd_tau10"]) <= 0.05, (rc, rp)
    for k in ("ar_mssd", "ar_mspd"):
        assert rows["cuda"]["summary"][k] == rows["cpu"]["summary"][k]


# --- the apps' shapes ---------------------------------------------------------

APPS_NN = [(12288, 4096), (26624, 2048), (33280, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", APPS_NN)
def test_fused_nn_kernel_at_the_apps_shapes(n, m):
    """K1 at the shapes only the apps launch (``main_realsense``'s default
    26-view database: its search's ICP over all templates' chains against
    the observation), on template-like clouds 2 m out with about a tenth
    of the rows invalid: bit for bit the plain version."""
    _need_card()
    rng = np.random.default_rng(n + m)
    q, d = kc._cloud(rng, n, scale=0.15, center=2.0), kc._cloud(rng, m, scale=0.15, center=2.0)
    qv, dv = rng.random(n) < 0.9, rng.random(m) < 0.9
    _nn_same(*(torch.from_numpy(a).cuda() for a in (q, qv, d, dv)))


@pytest.mark.cuda
@pytest.mark.parametrize("angle", [0.0, 0.3])
def test_raster_kernel_at_the_apps_window(angle):
    """K2 over the 96 x 128 window the apps' searches render at (the
    L-shape's 24 faces padded to 256, 2.5 diagonals out at the
    half-resolution camera), identical to the plain version."""
    _need_card()
    from poseestimator_tpu_torch.geom3d.se3 import look_at
    from poseestimator_tpu_torch.pipeline.window import window_origin
    from poseestimator_tpu_torch.render.mesh import pad_faces

    v, f = kc.lshape_mesh()
    d = np.ones(3) / np.sqrt(3.0)
    base = kc.GL_TO_CV @ look_at(d * 2.5 * float(np.linalg.norm(v.max(0) - v.min(0))),
                                 np.zeros(3), [0.0, 1.0, 0.0]).numpy()
    P = np.eye(4)
    P[:2, :2] = [[np.cos(angle), -np.sin(angle)], [np.sin(angle), np.cos(angle)]]
    T = torch.from_numpy((P @ base).astype(np.float32)).cuda()
    mesh_v = torch.from_numpy(v).cuda()
    intr_r = Intrinsics.from_fov(60.0, 640, 480).scaled(2)
    o = window_origin(mesh_v, T, intr_r, 96, 128).to(torch.float32)
    coef, bbox = traster.face_coeffs(mesh_v, torch.from_numpy(pad_faces(f, 256)).cuda(), T,
                                     intr_r, near=0.01, origin=o)
    izk = traster.raster(coef, bbox, 96, 128)
    torch.cuda.synchronize()
    assert torch.equal(izk, traster.raster_plain(coef, 96, 128, chunk=64))
    assert int((izk > 0).sum()) > 500


# --- the synthetic generator's shapes -------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("with_icosphere", [False, True])
def test_batched_raster_kernel_at_the_synth_shapes(with_icosphere):
    """K2's batched entry at the generator's mesh-instrument frames: three
    object slots over 480 x 640, the L-shape and the bench box padded to
    256 faces, and with the 0.1 m icosphere (decimated to <= 4096 faces)
    to 4096; poses drawn as the generator draws them. Bit for bit the
    batched plain version; ``_mesh_parts`` launches it once a frame, with
    an invalid slot emptied to nothing."""
    _need_card()
    from poseestimator_tpu_torch.render.mesh import TriangleMesh, decimate_to_faces, pad_faces
    from poseestimator_tpu_torch.training import synth

    meshes = [kc.lshape_mesh(), (kc.box_vertices(), kc.BOX_FACES)]
    if with_icosphere:
        dec = decimate_to_faces(TriangleMesh(*make_icosphere(radius=0.1, subdivisions=4)), 4096)
        meshes.append((dec.vertices, dec.faces))
    else:
        meshes.append(kc.lshape_mesh())
    v_cap = max(len(v) for v, _ in meshes)
    f_cap = -(-max(len(f) for _, f in meshes) // 256) * 256
    assert f_cap == (4096 if with_icosphere else 256)
    vb = torch.from_numpy(np.stack([np.pad(v, ((0, v_cap - len(v)), (0, 0)), mode="edge")
                                    for v, _ in meshes]).astype(np.float32)).cuda()
    fb = torch.from_numpy(np.stack([pad_faces(f, f_cap) for _, f in meshes])).cuda()
    rng = np.random.default_rng(int(with_icosphere))
    intr = Intrinsics.from_fov(60.0, 640, 480)
    Ts = torch.from_numpy(np.stack([
        synth._place_instance(rng, intr, float(np.linalg.norm(v.max(0) - v.min(0))))
        for v, _ in meshes])).cuda()
    coef, bbox = traster.face_coeffs(vb, fb, Ts, intr, near=0.01)
    before = traster.raster_batched_stats.launches
    izk = traster.raster_batched(coef, bbox, 480, 640)
    torch.cuda.synchronize()
    assert traster.raster_batched_stats.launches == before + 1
    assert torch.equal(izk, traster.raster_batched_plain(coef, 480, 640, chunk=64))
    assert int((izk > 0).sum()) > 1000
    ok = torch.tensor([True, True, False], device="cuda")
    colors = torch.full((3, 3), 0.5, device="cuda")
    d, rgb = synth._mesh_parts(vb, fb, ok, Ts, colors, intr)
    torch.cuda.synchronize()
    assert traster.raster_batched_stats.launches == before + 2
    assert int((d[2] > 0).sum()) == 0 and int((d[0] > 0).sum()) > 100


def _nccl_chamfer_rank(out_path):
    """Rank body of the world-1 NCCL mesh below (module level: the launcher
    re-imports it in the child)."""
    from poseestimator_tpu_torch.geom3d.cloud import PointCloud
    from poseestimator_tpu_torch.geom3d.metrics import chamfer_distance
    from poseestimator_tpu_torch.parallel import make_mesh, sharded_chamfer

    mesh = make_mesh("dp")
    g = torch.Generator(device=mesh.device).manual_seed(0)
    a = torch.randn(4096, 3, device=mesh.device, generator=g)
    b = a + 0.01 * torch.randn(4096, 3, device=mesh.device, generator=g)
    ones = torch.ones(4096, dtype=torch.bool, device=mesh.device)
    before = tnn.fused_nn_stats.launches
    got = float(sharded_chamfer(mesh, a, ones, b, ones))
    launches = tnn.fused_nn_stats.launches - before
    ref = float(chamfer_distance(PointCloud(a.cpu(), ones.cpu()), PointCloud(b.cpu(), ones.cpu())))
    with open(out_path, "w") as f:
        json.dump({"backend": mesh.backend, "size": mesh.size, "device": str(mesh.device),
                   "chamfer": got, "plain": ref, "launches": launches}, f)


@pytest.mark.cuda
def test_sharded_chamfer_on_a_world_one_nccl_mesh(tmp_path):
    """``sharded_chamfer`` on a one-rank NCCL mesh launches K1 once per
    direction and matches the plain single-device Chamfer to 1e-6."""
    _need_card()
    from poseestimator_tpu_torch.parallel import launch

    out = tmp_path / "chamfer.json"
    launch(_nccl_chamfer_rank, 1, "nccl", "cuda", init_file=str(tmp_path / "rdv"),
           args=(str(out),))
    r = json.loads(out.read_text())
    assert (r["backend"], r["size"], r["device"], r["launches"]) == ("nccl", 1, "cuda:0", 2)
    assert abs(r["chamfer"] - r["plain"]) <= 1e-6 * r["plain"]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", [(80, 128), (16, 768), (16, 2048)])
def test_batched_registration_does_not_depend_on_the_batch(B, N):
    """The template search's batched registration at its shapes (the coarse
    stage's 80 chains x 128 points, the polish stages' 16 x 768 and 16 x
    2048) on the card: ``kabsch_batched`` and ``icp_point_to_point_batched``
    give every chain the same bits in the whole batch, in its first half
    and alone (their sums over points run in ``kabsch.tree_sum``'s order;
    a plain CUDA row sum rounds a (16, 2048) row apart at B = 8)."""
    _need_card()
    from test_torch_fixed_order import _chains

    from poseestimator_tpu_torch.geom3d.cloud import PointCloud
    from poseestimator_tpu_torch.registration.icp import icp_point_to_point_batched
    from poseestimator_tpu_torch.registration.kabsch import kabsch_batched

    src, valid, dst, T0 = _chains(B, N, 2 * B + N)
    src, valid, T0 = src.cuda(), valid.cuda(), T0.cuda()
    dst = PointCloud(points=dst.points.cuda(), valid=dst.valid.cuda())
    moved = src @ T0[:, :3, :3].transpose(-1, -2) + T0[:, None, :3, 3]
    w = valid.float()
    R, t = kabsch_batched(src, moved, w)
    kw = dict(max_corr_dist=0.02, max_iterations=30, relative_fitness=1e-6, relative_rmse=1e-6)
    r = icp_point_to_point_batched(src, valid, dst, init_T=T0, **kw)
    h = B // 2
    for idx in (slice(0, h), slice(3, 4), slice(B - 1, B)):
        Rh, th = kabsch_batched(src[idx], moved[idx], w[idx])
        assert torch.equal(Rh, R[idx]) and torch.equal(th, t[idx])
        rh = icp_point_to_point_batched(src[idx], valid[idx], dst, init_T=T0[idx], **kw)
        assert torch.equal(rh.T, r.T[idx]) and torch.equal(rh.n_iters, r.n_iters[idx])
        assert torch.equal(rh.fitness, r.fitness[idx])
        assert torch.equal(rh.inlier_rmse, r.inlier_rmse[idx])
    assert int(r.n_iters.max()) >= 3


# --- the template search's batched renders ---------------------------------

def _lshape_windows(B, win, intr, seed):
    """B poses of the L-shape about the evaluation's view (2 diag out, turned
    and shifted a little each) and their window origins."""
    from poseestimator_tpu_torch.geom3d.se3 import look_at
    from poseestimator_tpu_torch.pipeline.window import window_origin

    v, f = kc.lshape_mesh()
    diag = float(np.linalg.norm(v.max(0) - v.min(0)))
    base = kc.GL_TO_CV @ look_at(np.ones(3) / np.sqrt(3) * 2 * diag, np.zeros(3),
                                 [0.0, 1.0, 0.0]).numpy()
    rng = np.random.default_rng(seed)
    Ts = []
    for _ in range(B):
        a = rng.uniform(-0.3, 0.3)
        P = np.eye(4)
        P[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        T = P @ base
        T[:3, 3] += rng.normal(0, 0.02, 3)
        Ts.append(T.astype(np.float32))
    vt = torch.from_numpy(v).cuda()
    ft = torch.from_numpy(np.pad(f, ((0, 256 - len(f)), (0, 0))).astype(np.int64)).cuda()
    Ts = torch.from_numpy(np.stack(Ts)).cuda()
    o = torch.stack([window_origin(vt, T, intr, win[0], win[1]) for T in Ts])
    return vt, ft, Ts, o


@pytest.mark.cuda
@pytest.mark.parametrize("B,win,res", [(10, (64, 128), (160, 120)), (26, (64, 128), (160, 120)),
                                       (10, (128, 128), (320, 240)),
                                       (26, (128, 128), (320, 240))])
def test_batched_raster_kernel_at_the_search_shapes(B, win, res):
    """K2's batched entry at the template search's stages (10-26 chains over
    the 64 x 128 and 128 x 128 windows): bit for bit the batched plain
    version, and each window bit for bit the single kernel's render."""
    _need_card()
    intr = Intrinsics.from_fov(60.0, *res)
    vt, ft, Ts, o = _lshape_windows(B, win, intr, B + win[0])
    coef, bbox = traster.face_coeffs(vt, ft, Ts, intr, near=0.01, origin=o.float())
    izk = traster.raster_batched(coef, bbox, *win)
    torch.cuda.synchronize()
    assert torch.equal(izk, traster.raster_batched_plain(coef, *win, chunk=64))
    for b in range(B):
        c1, b1 = traster.face_coeffs(vt, ft, Ts[b], intr, near=0.01, origin=o[b].float())
        assert torch.equal(traster.raster(c1, b1, *win), izk[b])
    assert int((izk > 0).sum()) > 100 * B


@pytest.mark.cuda
def test_batched_search_scores_do_not_depend_on_the_batch():
    """The search's view scores (``score_pose_candidates``: one batched K2
    render, exact integer counts, each window's depth sum in
    ``kabsch.tree_sum``'s order) give every pose the same bits in the whole
    batch, in its first half and alone, on the card."""
    _need_card()
    from poseestimator_tpu_torch.pipeline.pose_estimator import score_pose_candidates
    from poseestimator_tpu_torch.render.raster import render_depth_mesh

    intr = Intrinsics.from_fov(60.0, 640, 480)
    vt, ft, Ts, _ = _lshape_windows(16, (128, 128), intr.scaled(2), 7)
    depth = render_depth_mesh(vt, ft, Ts[0], intr, near=0.01, far=5.0)
    mask = depth > 0
    full = score_pose_candidates(vt, ft, Ts, depth, mask, intr, (128, 128))
    for idx in (slice(0, 8), slice(3, 4), slice(15, 16)):
        assert torch.equal(score_pose_candidates(vt, ft, Ts[idx], depth, mask, intr, (128, 128)),
                           full[idx])
    assert torch.isfinite(full).all() and float(full[0]) < float(full[1:].min())


@pytest.mark.cuda
@pytest.mark.parametrize("points", [128, 256])
def test_search_scores_on_half_the_templates_equal_the_whole(points):
    """The whole template search (PCA and TEASER hypotheses, coarse ICP,
    polish, scores) of the synthetic 16-template fixture on the card: its
    first 8 templates' poses and scores bit for bit the search of those 8
    alone. At 256 points a template the card's batched PCA rounded a
    template apart by the batch; each template's statistics are now its
    own."""
    _need_card()
    from poseestimator_tpu_torch.parallel import make_synthetic_search_inputs
    from poseestimator_tpu_torch.pipeline import pose_estimator as pe

    dev = torch.device("cuda")
    fx = make_synthetic_search_inputs(n_tpl=16, C=points, n_cad=1200, device=dev)

    def run(n):
        gen = torch.Generator(device=dev).manual_seed(0)
        draws = pe._search_draws(gen, fx["dst_points"].shape[0], 16, 1, fx["intr"], "auto", 2,
                                 False, "points", dev, None)
        prep = pe._prep_dst(fx["dst_points"], fx["dst_valid"], fx["intr"], fx["mask_sil"], True,
                            pe._f32(0.05), gen, draws, score_res=2)
        mine = {"ransac": draws["ransac"][:n],
                "views": {k: v for k, v in draws["views"].items() if k[1] < n}}
        return pe._score_templates(prep, fx["tpl_points"][:n], fx["tpl_valid"][:n],
                                   fx["tpl_fpfh"][:n], fx["cad_points"], fx["cad_valid"],
                                   fx["intr"], True, pe._f32(0.05), gen, mine, n_final=None,
                                   render_kind="points")

    whole, half = run(16), run(8)
    for a, b in zip(half, whole):
        assert torch.equal(a, b[:8])
