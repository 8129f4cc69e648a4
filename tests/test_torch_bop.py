"""Port parity, the BOP evaluation: the stdlib PNG reader against
``cv2.imread(IMREAD_UNCHANGED)`` on 8-bit grey, 16-bit grey and RGB files
that cv2 wrote (every row filter cv2 picks) and on rows of all five
filter types against the specification's byte-wise reversal, and the
writer's round trip;
the metrics of ``geom3d/metrics.py`` (Chamfer, cloud resolution, ADD,
ADD-S, MSSD and MSPD with and without a symmetry stack) to 1e-5 relative;
VSD over the BOP tau sweep (equal visibility masks, values within one pixel
of the union); the BOP helpers (``load_object_symmetries``,
``bop_average_recall``, ``load_scene_gt``, ``load_camera_intrinsics``
exactly; ``get_pointcloud`` equal once the sampler's draws are injected);
and the port's scene sweep ``apps/eval_bop.run`` on the CPU, which reports
the JAX tool's summary keys and clears bop_ar > 0.5. The scene is the one
of ``tests/test_torch_offline.py``, written by the port."""
import json
import os
import struct
import zlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseestimator_tpu import geom3d as g3
from poseestimator_tpu.render import vsd_multi_tau as j_vsd
from poseestimator_tpu.utils import bop as j_bop
from poseestimator_tpu_torch import kernel_cases as kc
from poseestimator_tpu_torch.apps import eval_bop
from poseestimator_tpu_torch.geom3d import metrics as tm
from poseestimator_tpu_torch.geom3d.cloud import PointCloud, from_points
from poseestimator_tpu_torch.render.points import vsd_metric, vsd_multi_tau
from poseestimator_tpu_torch.utils import bop
from poseestimator_tpu_torch.utils.png import read_png, write_png

from test_torch_offline import INTR, scene  # noqa: F401 (fixtures)
from torch_threads import two_threads  # noqa: F401

RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


# --- PNG ----------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["grey8", "grey16", "rgb8"])
def test_read_png_matches_cv2(tmp_path, kind):
    """Random content plus smooth ramps, so that cv2's adaptive filter
    choice meets Sub, Up, Average and Paeth rows."""
    rng = np.random.default_rng(0)
    h, w = 37, 53
    ramp = (np.add.outer(np.arange(h) * 3, np.arange(w) * 5)).astype(np.int64)
    if kind == "grey16":
        img = (rng.integers(0, 65536, (h, w)) // (1 + ramp % 7) + ramp * 97).astype(np.uint16)
    else:
        img = (rng.integers(0, 256, (h, w)) // (1 + ramp % 5) + ramp).astype(np.uint8)
        if kind == "rgb8":
            img = np.stack([img, img[::-1], np.roll(img, 3, 1)], -1)
    for level in (0, 1, 9):
        path = str(tmp_path / f"{kind}_{level}.png")
        assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        got = read_png(path)
        if kind == "rgb8":
            want = want[..., ::-1]  # cv2 decodes BGR
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _unfilter_bytewise(data, h, stride, bpp):
    """The PNG specification's filter reversal, one byte at a time."""
    out, prior = np.zeros((h, stride), np.uint8), [0] * stride
    for y in range(h):
        off = y * (stride + 1)
        ftype, line = data[off], list(data[off + 1:off + 1 + stride])
        for i in range(stride):
            a = line[i - bpp] if i >= bpp else 0
            b, c = prior[i], (prior[i - bpp] if i >= bpp else 0)
            p = a + b - c
            paeth = a if abs(p - a) <= abs(p - b) and abs(p - a) <= abs(p - c) else (
                b if abs(p - b) <= abs(p - c) else c)
            line[i] = (line[i] + (0, a, b, (a + b) >> 1, paeth)[ftype]) & 0xFF
        out[y], prior = line, line
    return out


@pytest.mark.parametrize("depth,color,ch", [(8, 0, 1), (16, 0, 1), (8, 2, 3), (16, 6, 4)])
def test_read_png_every_filter(tmp_path, depth, color, ch):
    """Rows of all five filter types in random order, runs of Average and
    Paeth included, against the byte-wise reversal of the specification."""
    from poseestimator_tpu_torch.utils.png import _SIGNATURE, _chunk

    rng = np.random.default_rng(depth + color)
    h, w = 41, 29
    stride = w * ch * depth // 8
    ftype = rng.integers(0, 5, h).astype(np.uint8)
    ftype[10:20] = rng.choice([3, 4], 10)
    data = np.concatenate([ftype[:, None], rng.integers(0, 256, (h, stride), dtype=np.uint8)],
                          axis=1).tobytes()
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b""))
    want = _unfilter_bytewise(data, h, stride, ch * depth // 8)
    if depth == 16:
        want = want.view(">u2").astype(np.uint16)
    np.testing.assert_array_equal(read_png(path), want.reshape((h, w) if ch == 1 else (h, w, ch)))


def test_write_png_round_trips(tmp_path):
    rng = np.random.default_rng(1)
    for img in (rng.integers(0, 256, (20, 30, 3), dtype=np.uint8),
                rng.integers(0, 256, (20, 30), dtype=np.uint8),
                rng.integers(0, 65536, (20, 30), dtype=np.uint16)):
        path = str(tmp_path / "x.png")
        write_png(path, img)
        np.testing.assert_array_equal(read_png(path), img)
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., ::-1]
                                      if img.ndim == 3 else cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                      img)
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "y.png"), np.zeros((4, 4), np.float32))
    rgba = str(tmp_path / "p.png")
    img = rng.integers(0, 65536, (4, 5, 4), dtype=np.uint16)
    cv2.imwrite(rgba, img)  # 16-bit BGRA
    np.testing.assert_array_equal(read_png(rgba)[..., [2, 1, 0, 3]], img)
    # the header's colour type (byte 25) and interlace method (byte 28)
    for offset, value, what in ((25, 3, "palette"), (28, 1, "interlaced")):
        bad = str(tmp_path / f"bad{offset}.png")
        with open(rgba, "rb") as f:
            blob = bytearray(f.read())
        blob[offset] = value
        with open(bad, "wb") as f:
            f.write(bytes(blob))
        with pytest.raises(ValueError, match=what):
            read_png(bad)


# --- metrics ------------------------------------------------------------------


def _clouds(rng, n=400, m=500):
    a = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    b = (a[:m] @ np.asarray(g3.axis_angle_to_R(jnp.asarray([0.1, 0.3, 1.0]), 0.05)).T
         + [0.01, -0.02, 0.005]).astype(np.float32)
    b = np.concatenate([b, (rng.normal(size=(m - len(b), 3)) * 0.1).astype(np.float32)])
    av, bv = rng.uniform(size=n) < 0.9, rng.uniform(size=m) < 0.85
    return a, av, b, bv


def test_chamfer_and_resolution_match_jax():
    rng = np.random.default_rng(2)
    a, av, b, bv = _clouds(rng)
    ja = g3.PointCloud(points=jnp.asarray(a), valid=jnp.asarray(av))
    jb = g3.PointCloud(points=jnp.asarray(b), valid=jnp.asarray(bv))
    ta, tb = PointCloud(points=_t(a), valid=_t(av)), PointCloud(points=_t(b), valid=_t(bv))
    want = float(g3.chamfer_distance(ja, jb))
    np.testing.assert_allclose(float(tm.chamfer_distance(ta, tb)), want, rtol=RTOL)
    # a batch of sources: one query pass and one batched reverse pass
    Ts = np.stack([np.eye(4, dtype=np.float32)] * 3)
    Ts[1, :3, 3] = [0.02, 0.0, 0.0]
    Ts[2, :3, :3] = np.asarray(g3.axis_angle_to_R(jnp.asarray([0.0, 1.0, 0.0]), 0.2))
    batch = PointCloud(points=_t(Ts[:, None, :3, :3] @ a[None, :, :, None])[..., 0]
                       + _t(Ts[:, None, :3, 3]), valid=_t(av).expand(3, -1))
    got = tm.chamfer_distance(batch, tb)
    for k in range(3):
        want_k = float(g3.chamfer_distance(ja.transform(jnp.asarray(Ts[k])), jb))
        np.testing.assert_allclose(float(got[k]), want_k, rtol=RTOL)
    np.testing.assert_allclose(float(tm.cloud_resolution(ta)), float(g3.cloud_resolution(ja)),
                               rtol=1e-6)
    one = np.zeros(400, bool)
    one[5] = True
    assert float(tm.cloud_resolution(PointCloud(points=_t(a), valid=_t(one)))) == \
        pytest.approx(0.005)


@pytest.mark.parametrize("with_syms", [False, True])
def test_pose_metrics_match_jax(with_syms):
    rng = np.random.default_rng(3)
    verts = (rng.normal(size=(300, 3)) * 60.0).astype(np.float32)  # mm
    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, :3] = np.asarray(g3.axis_angle_to_R(jnp.asarray([1.0, 0.2, 0.1]), 0.8))
    T_gt[:3, 3] = [20.0, -10.0, 800.0]
    T_est = T_gt.copy()
    T_est[:3, :3] = T_gt[:3, :3] @ np.asarray(g3.axis_angle_to_R(jnp.asarray([0.0, 0.3, 1.0]),
                                                                  0.07))
    T_est[:3, 3] += [3.0, 2.0, -5.0]
    K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float32)
    syms = None
    if with_syms:
        S = kc.lshape_symmetry(100.0)
        syms = np.stack([np.eye(4, dtype=np.float32), S, np.linalg.inv(S).astype(np.float32)])
    jm = g3.from_points(verts)
    tmdl = from_points(verts, device="cpu")
    jT, jG, jK = jnp.asarray(T_est), jnp.asarray(T_gt), jnp.asarray(K)
    tT, tG, tK = _t(T_est), _t(T_gt), _t(K)
    js = None if syms is None else jnp.asarray(syms)
    ts = None if syms is None else _t(syms)
    for got, want in ((tm.add_metric(tT, tG, tmdl), g3.add_metric(jT, jG, jm)),
                      (tm.adds_metric(tT, tG, tmdl), g3.adds_metric(jT, jG, jm)),
                      (tm.mssd_metric(tT, tG, tmdl, ts), g3.mssd_metric(jT, jG, jm, js)),
                      (tm.mspd_metric(tT, tG, tK, tmdl, ts),
                       g3.mspd_metric(jT, jG, jK, jm, js))):
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_vsd_matches_jax(scene):  # noqa: F811
    """VSD over the BOP tau sweep on the CAD's 150k surface samples in mm,
    occlusion-aware against a frame's measured depth: the renders' visible
    masks are equal, every value within one pixel of the union."""
    from poseestimator_tpu.render import render_depth as j_render
    from poseestimator_tpu_torch.render.mesh import TriangleMesh
    from poseestimator_tpu_torch.render.points import render_depth

    mesh = TriangleMesh(vertices=scene["verts"] * 1000.0, faces=scene["faces"])
    pts, _ = mesh.sample_points_uniformly(20_000, np.random.default_rng(0))
    T_gt = scene["poses"][0].astype(np.float64).copy()
    T_gt[:3, 3] *= 1000.0
    T_est = T_gt.copy()
    T_est[:3, :3] = T_gt[:3, :3] @ np.asarray(g3.axis_angle_to_R(jnp.asarray([0.3, 1.0, 0.0]),
                                                                  0.05))
    T_est[:3, 3] += [8.0, -4.0, 15.0]
    T_gt, T_est = T_gt.astype(np.float32), T_est.astype(np.float32)
    depth = read_png(os.path.join(scene["scene"], "depth", "000000.png")).astype(np.float32)
    diam = float(np.linalg.norm(pts.max(0) - pts.min(0)))
    taus = (bop.BOP_FRACS * diam).astype(np.float32)
    valid = np.ones(len(pts), bool)
    kw = dict(delta=15.0, near=1.0, far=100000.0)
    for sd in (None, depth):
        want = np.asarray(j_vsd(jnp.asarray(T_est), jnp.asarray(T_gt), jnp.asarray(pts),
                                jnp.asarray(valid), g3.Intrinsics.from_fov(60.0, 160, 120),
                                jnp.asarray(taus),
                                scene_depth=None if sd is None else jnp.asarray(sd), **kw))
        got = vsd_multi_tau(_t(T_est), _t(T_gt), _t(pts), _t(valid), INTR, _t(taus),
                            scene_depth=None if sd is None else _t(sd), **kw).numpy()
        n_union = 0
        for T in (T_est, T_gt):
            dj = np.asarray(j_render(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(T),
                                     g3.Intrinsics.from_fov(60.0, 160, 120), near=1.0,
                                     far=100000.0))
            dt = render_depth(_t(pts), _t(valid), _t(T), INTR, near=1.0, far=100000.0).numpy()
            np.testing.assert_array_equal(dt > 0, dj > 0)
            n_union = max(n_union, int((dt > 0).sum()))
        assert np.all(np.abs(got - want) <= 1.0 / n_union + 1e-7), (got, want)
        assert np.all((got >= 0) & (got <= 1)) and np.all(np.diff(got) <= 0)
    one = float(vsd_metric(_t(T_est), _t(T_gt), _t(pts), _t(valid), INTR, tau=float(taus[1]),
                           scene_depth=_t(depth), **kw))
    np.testing.assert_allclose(one, got[1], atol=1e-7)


# --- BOP helpers --------------------------------------------------------------


def test_bop_helpers_match_jax(scene, tmp_path):  # noqa: F811
    sd = scene["scene"]
    gt, cam = os.path.join(sd, "scene_gt.json"), os.path.join(sd, "scene_camera.json")
    for key in (None, "1", "2"):
        (Tt, ot), (Tj, oj) = bop.load_scene_gt(gt, key), j_bop.load_scene_gt(gt, key)
        np.testing.assert_array_equal(Tt, Tj)
        assert ot == oj == 1
    for fid in (0, "2"):
        it, st, kt = bop.load_camera_intrinsics(cam, fid, 160, 120)
        ij, sj, kj = j_bop.load_camera_intrinsics(cam, fid, 160, 120)
        assert (it.fx, it.fy, it.cx, it.cy, it.width, it.height) == \
            (ij.fx, ij.fy, ij.cx, ij.cy, ij.width, ij.height)
        assert st == sj and kt == kj
    with pytest.raises(ValueError):
        bop.load_camera_intrinsics(cam, 7, 160, 120)

    info = {"1": {"symmetries_discrete": [kc.lshape_symmetry(100.0).reshape(-1).tolist()]},
            "2": {"symmetries_continuous": [{"axis": [0, 0, 1], "offset": [0, 0, 5.0]}],
                  "symmetries_discrete": [np.diag([1.0, -1.0, -1.0, 1.0]).reshape(-1).tolist()]},
            "3": {"diameter": 10.0}}
    mi = str(tmp_path / "models_info.json")
    with open(mi, "w") as f:
        json.dump(info, f)
    for obj in (1, 2, 3, 4):
        for kw in ({}, {"max_sym_disc_step": 0.1, "max_syms": 40}):
            st, sj = bop.load_object_symmetries(mi, obj, **kw), \
                j_bop.load_object_symmetries(mi, obj, **kw)
            if sj is None:
                assert st is None
            else:
                np.testing.assert_array_equal(st, sj)

    rng = np.random.default_rng(4)
    vsd = rng.uniform(size=(7, 10))
    mssd, mspd = rng.uniform(0, 300, 7), rng.uniform(0, 60, 7)
    for width in (640, 160):
        assert bop.bop_average_recall(vsd, mssd, mspd, 500.0, width) == \
            j_bop.bop_average_recall(vsd, mssd, mspd, 500.0, width)
    with pytest.raises(ValueError):
        bop.bop_average_recall(vsd[:, :3], mssd, mspd, 500.0)


def test_get_pointcloud_matches_jax(scene, tmp_path):  # noqa: F811
    """The masked frame through both loaders, the JAX package's sampler
    draws injected (capacity 4096 >= the mask's pixels: every point
    kept): equal points, validity and intrinsics; and equal colours from a
    JPEG colour image (the port's decoder against cv2's, tolerance one grey
    level)."""
    sd = scene["scene"]
    depth = os.path.join(sd, "depth", "000001.png")
    rgb = os.path.join(sd, "rgb", "000001.png")
    cam = os.path.join(sd, "scene_camera.json")
    mask = read_png(os.path.join(sd, "mask_visib", "000001_000000.png"))
    assert int((mask == 255).sum()) <= 4096
    jc, jK = j_bop.get_pointcloud(depth, rgb, cam, mask, frame_id=1, capacity=4096)
    # the JAX loader samples with PRNGKey(0): 19200 pixels into 4096 rows
    # is not the stratified route, so the draws are one Gumbel vector
    g = _t(np.asarray(jax.random.gumbel(jax.random.PRNGKey(0), (160 * 120,))))
    tc, tK = bop.get_pointcloud(depth, rgb, cam, mask, frame_id=1, capacity=4096,
                                draws=(g, None), device="cpu")
    np.testing.assert_array_equal(tK, jK)
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
    np.testing.assert_allclose(tc.points.numpy(), np.asarray(jc.points), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tc.colors.numpy(), np.asarray(jc.colors), atol=1e-7)
    # a JPEG colour image (4:2:0, q95, as BlenderProc writes them): the same
    # cloud, and the JAX loader's cv2-decoded colours
    jpg = str(tmp_path / "000001.jpg")
    assert cv2.imwrite(jpg, cv2.imread(rgb), [cv2.IMWRITE_JPEG_QUALITY, 95])
    jj, _ = j_bop.get_pointcloud(depth, jpg, cam, mask, frame_id=1, capacity=4096)
    tj, _ = bop.get_pointcloud(depth, jpg, cam, mask, frame_id=1, capacity=4096,
                               draws=(g, None), device="cpu")
    assert torch.equal(tj.points, tc.points)
    np.testing.assert_allclose(tj.colors.numpy(), np.asarray(jj.colors), rtol=0,
                               atol=1.0 / 255 + 1e-7)
    # a colour path that does not exist gives no colours
    tn, _ = bop.get_pointcloud(depth, str(tmp_path / "none.jpg"), cam, mask, frame_id=1,
                               capacity=4096, draws=(g, None), device="cpu")
    assert tn.colors is None and torch.equal(tn.points, tc.points)
    assert bop.get_pointcloud(depth, None, cam, np.zeros_like(mask), device="cpu") == (None, None)


# --- the scene sweep ----------------------------------------------------------


def test_eval_bop_sweep(scene, capsys):  # noqa: F811
    """The port's ``eval_bop.run`` over the three frames on the CPU
    (offline flavour, 100 points): one row per frame, the JAX tool's
    summary keys, bop_ar and ar_mssd > 0.5; ``--mask detector`` needs
    ``--weights`` (it is run in ``tests/test_torch_apps.py``)."""
    sd = scene["scene"]
    args = ["--scene-dir", sd, "--ply", scene["cad"], "--templates", scene["views"],
            "--mask", "visib", "--target-points", "100", "--device", "cpu",
            "--models-info", os.path.join(sd, "models_info.json")]
    out = str(scene["dir"] / "sweep.json")
    summary = eval_bop.run(eval_bop.build_parser().parse_args(args + ["--json-out", out]))
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r["frame"] for r in rows[:-1]] == [0, 1, 2] and rows[-1] == summary
    # tools/eval_bop.py's summary keys (offline registration)
    assert set(summary) == {"scene", "frames", "mask", "adds_mean_mm", "mssd_mean_mm",
                            "mspd_mean_px", "ar_vsd", "ar_mssd", "ar_mspd", "bop_ar"}
    assert set(rows[0]) == {"frame", "adds_mm", "mssd_mm", "mspd_px", "vsd_tau10",
                            "chamfer_score"}
    assert summary["frames"] == 3
    assert summary["bop_ar"] > 0.5 and summary["ar_mssd"] > 0.5, summary
    with open(out) as f:
        assert json.load(f)["summary"] == summary
    depthpos = eval_bop.run(eval_bop.build_parser().parse_args(
        [a if a != "visib" else "depthpos" for a in args] + ["--max-frames", "1"]), quiet=True)
    assert depthpos["frames"] == 1 and depthpos["mask"] == "depthpos"
    with pytest.raises(SystemExit, match="--weights"):
        eval_bop.run(eval_bop.build_parser().parse_args(
            [a if a != "visib" else "detector" for a in args]))
