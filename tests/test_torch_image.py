"""Port parity, the image files and what is drawn on them: the numpy JPEG
decoder against ``cv2.imdecode`` (libjpeg-turbo) on files that
``cv2.imencode`` and PIL wrote, bit for bit (tolerance 0 grey levels);
``read_image`` against ``cv2.imread`` in its three modes and
``write_image`` against what ``cv2.imwrite`` writes; the detector mask's
polygon round trip (``masks_to_polygons`` -> ``polygon_to_mask``) against
the JAX package's OpenCV one, bit-equal, with the polygons themselves
(points and order) and their areas (``cv2.contourArea``, 1e-6); the raster
primitives against OpenCV's; ``Detector.detect_mask`` against the JAX
package's; and the overlay against the JAX package's, bit-equal."""
import io

import cv2
import numpy as np
import pytest
import torch

from poseestimator_tpu.models.yolo import masks as J
from poseestimator_tpu.pipeline.detector import Detector as JDetector
from poseestimator_tpu.utils import overlay as joverlay
from poseestimator_tpu_torch import kernel_cases as kc
from poseestimator_tpu_torch.geom3d.camera import Intrinsics
from poseestimator_tpu_torch.models.yolo import masks as T
from poseestimator_tpu_torch.models.yolo.contours import contour_area, find_external_contours
from poseestimator_tpu_torch.pipeline.detector import Detector
from poseestimator_tpu_torch.render.raster import render_depth_mesh
from poseestimator_tpu_torch.utils import draw, overlay
from poseestimator_tpu_torch.utils.image import read_image, write_image
from poseestimator_tpu_torch.utils.jpeg import decode_jpeg

from test_torch_camera import IMGSZ, yolo_variables  # noqa: F401 (fixture)
from torch_threads import two_threads  # noqa: F401


def _photo(h, w, seed=0):
    """Smooth gradients plus noise: every quantiser level and run length."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 3 + y) % 256, (y * 2 + 50) % 256, ((x + y) * 5) % 256], -1)
    return np.clip(img + rng.normal(0, 30, img.shape), 0, 255).astype(np.uint8)


_SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111}
_JPEG_CASES = [(q, s, hw) for hw in ((61, 97), (480, 640)) for q in (75, 95) for s in _SAMPLING]
# images 1-3 pixels wide or tall: libjpeg upsamples chroma planes of 2 or
# fewer samples across by replication, not by the triangle filter
_JPEG_CASES += [(95, s, hw) for hw in ((1, 1), (2, 2), (3, 3), (3, 1), (1, 3), (2, 3), (9, 3),
                                       (3, 9), (7, 4)) for s in ("422", "420")]


@pytest.mark.parametrize("q,sampling,hw", _JPEG_CASES,
                         ids=[f"q{q}-{s}-{hw[1]}x{hw[0]}" for q, s, hw in _JPEG_CASES])
def test_jpeg_matches_cv2(q, sampling, hw):
    img = _photo(*hw)
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, q,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR, _SAMPLING[sampling]])
    want = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)[..., ::-1]
    np.testing.assert_array_equal(decode_jpeg(buf.tobytes()), want)


@pytest.mark.parametrize("case", ["grey", "optimised", "restart", "pil_q95"])
def test_jpeg_coding_options_match_cv2(case):
    """Greyscale, optimised Huffman tables, a restart interval of 3 MCUs
    (restart markers mid-row), and a PIL-written q95 file (BlenderProc's
    writer), at 97x61."""
    img = _photo(61, 97, seed=1)
    if case == "pil_q95":
        from PIL import Image

        b = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(img[..., ::-1])).save(b, "JPEG", quality=95)
        data = b.getvalue()
    else:
        params = {"grey": [cv2.IMWRITE_JPEG_QUALITY, 90],
                  "optimised": [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_OPTIMIZE, 1],
                  "restart": [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 3]}
        src = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if case == "grey" else img
        data = cv2.imencode(".jpg", src, params[case])[1].tobytes()
    if case == "restart":
        assert b"\xff\xd0" in data and b"\xff\xdd" in data
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    got = decode_jpeg(data)
    np.testing.assert_array_equal(got, want if want.ndim == 2 else want[..., ::-1])


def test_jpeg_fixture_matches_cv2():
    """The 640x480 q95 4:2:0 frame in ``tests/data`` (PIL-written, the
    file ``chip_smoke.py`` times the decoder on)."""
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "frame_640x480_q95.jpg")
    with open(path, "rb") as f:
        got = decode_jpeg(f.read())
    assert got.shape == (480, 640, 3)
    np.testing.assert_array_equal(got, cv2.imread(path)[..., ::-1])


def test_jpeg_unsupported_modes_raise():
    img = _photo(61, 97, seed=2)
    prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    with pytest.raises(NotImplementedError, match="progressive"):
        decode_jpeg(prog)
    base = bytearray(cv2.imencode(".jpg", img)[1].tobytes())
    sof = base.index(b"\xff\xc0")
    base[sof + 4] = 12  # the frame's sample precision
    with pytest.raises(NotImplementedError, match="12-bit"):
        decode_jpeg(bytes(base))
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x89PNG\r\n\x1a\n")


_KINDS = {"g8": ((40, 50), np.uint8), "g16": ((40, 50), np.uint16),
          "c8": ((40, 50, 3), np.uint8), "c16": ((40, 50, 3), np.uint16),
          "a8": ((40, 50, 4), np.uint8), "a16": ((40, 50, 4), np.uint16)}


@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_read_image_matches_cv2_imread(tmp_path, kind):
    """All three modes, exactly: shape, dtype and values."""
    shape, dt = _KINDS[kind]
    rng = np.random.default_rng(3)
    img = rng.integers(0, np.iinfo(dt).max + 1, shape, dtype=dt)
    img[:4] = img[:4, :1]  # a few rows with equal channels
    path = str(tmp_path / f"{kind}.png")
    assert cv2.imwrite(path, img)
    for mode in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_GRAYSCALE, cv2.IMREAD_COLOR):
        want, got = cv2.imread(path, mode), read_image(path, mode)
        assert got.dtype == want.dtype and got.shape == want.shape, (mode, got.shape)
        np.testing.assert_array_equal(got, want)
    if kind in ("g8", "c8"):  # the same modes on a JPEG, and the writer
        jpg = str(tmp_path / f"{kind}.jpg")
        assert cv2.imwrite(jpg, img)
        for mode in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_GRAYSCALE, cv2.IMREAD_COLOR):
            np.testing.assert_array_equal(read_image(jpg, mode), cv2.imread(jpg, mode))
        out = str(tmp_path / f"{kind}_port.png")
        write_image(out, img)
        np.testing.assert_array_equal(cv2.imread(out, cv2.IMREAD_UNCHANGED), img)
    with pytest.raises(FileNotFoundError):
        read_image(str(tmp_path / "missing.png"))


# --- the detector mask's polygon round trip -----------------------------------


def _disc(h, w, cy, cx, r):
    yy, xx = np.mgrid[:h, :w]
    return (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r


def _mask_cases() -> dict:
    """The named case set: (H, W) bool masks."""
    rng = np.random.default_rng(5)
    h, w = 48, 64
    cases = {"disc": _disc(h, w, 20, 30, 12), "disc at the border": _disc(h, w, 0, 63, 15)}
    v, f = kc.lshape_mesh()
    depth = render_depth_mesh(torch.from_numpy(v), torch.from_numpy(f.astype(np.int64)),
                              torch.from_numpy(kc.bop_scene_poses(dist=1.1)[0]),
                              Intrinsics.from_fov(60.0, w, h), near=0.01, far=10.0)
    cases["L silhouette"] = depth.numpy() > 0
    L = np.zeros((h, w), bool)
    L[8:40, 10:20] = True
    L[30:40, 10:50] = True
    cases["L"] = L
    ring = _disc(h, w, 24, 32, 18) & ~_disc(h, w, 24, 32, 8)
    ring |= _disc(h, w, 24, 32, 3)  # an island in the hole
    cases["holes and an island"] = ring
    comps = np.zeros((h, w), bool)
    for cy, cx in ((8, 8), (8, 40), (30, 20), (36, 52)):  # equal areas: the tie order
        comps[cy:cy + 6, cx:cx + 6] = True
    cases["equal-area components"] = comps
    lines = np.zeros((h, w), np.uint8)
    cv2.line(lines, (2, 5), (60, 5), 1)
    cv2.line(lines, (5, 10), (5, 45), 1)
    cv2.line(lines, (10, 40), (40, 10), 1)  # a diagonal 8-connected chain
    cv2.line(lines, (20, 44), (60, 30), 1)
    lines[0, 0] = lines[47, 63] = 1  # isolated pixels in the corners
    cases["lines, chains and isolated pixels"] = lines > 0
    cases["full frame"] = np.ones((h, w), bool)
    cases["noise"] = rng.random((h, w)) < 0.55
    cases["blocks"] = cv2.resize((rng.random((8, 11)) < 0.5).astype(np.uint8), (w, h),
                                 interpolation=cv2.INTER_NEAREST) > 0
    return cases


_CASES = _mask_cases()


@pytest.mark.parametrize("name", sorted(_CASES))
def test_mask_round_trip_matches_jax(name):
    """The JAX package's ``masks_to_polygons`` (``cv2.findContours`` +
    ``contourArea`` sort) and ``polygon_to_mask`` (``cv2.fillPoly``)
    against the port's: the same polygons in the same order, areas to
    1e-6, and the round-trip mask bit-equal, for every polygon's fill."""
    m = _CASES[name]
    h, w = m.shape
    pj, pt = J.masks_to_polygons(m), T.masks_to_polygons(m)
    assert len(pt) == len(pj)
    for a, b in zip(pj, pt):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(b, a)
        assert abs(contour_area(b) - cv2.contourArea(a)) <= 1e-6
        np.testing.assert_array_equal(T.polygon_to_mask(b, h, w), J.polygon_to_mask(a, h, w))
    want = J.polygon_to_mask(pj[0], h, w) if pj else np.zeros((h, w), np.uint8)
    got = T.polygon_to_mask(pt[0], h, w) if pt else np.zeros((h, w), np.uint8)
    np.testing.assert_array_equal(got, want)
    # every border, fewer-than-3-point ones included, as findContours gives them
    raw, _ = cv2.findContours(m.astype(np.uint8), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    ours = find_external_contours(m)
    assert [c.reshape(-1, 2).tolist() for c in raw] == [c.tolist() for c in ours]


def test_assembled_masks_round_trip_matches_jax(yolo_variables):  # noqa: F811
    """The round trip of masks that seeded YOLO weights assemble (noisy,
    many components) on a 72x112 image."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 255, size=(72, 112, 3), dtype=np.uint8)
    tdet = Detector(yolo_variables, nc=5, imgsz=IMGSZ, device="cpu")
    det, masks, _ = tdet(img, conf=0.01)
    n = int(det.count())
    assert n >= 2
    for m in masks[:n].numpy():
        pj, pt = J.masks_to_polygons(m), T.masks_to_polygons(m)
        assert [p.tolist() for p in pt] == [p.tolist() for p in pj]
        if pj:
            np.testing.assert_array_equal(T.polygon_to_mask(pt[0], 72, 112),
                                          J.polygon_to_mask(pj[0], 72, 112))


def test_raster_primitives_match_cv2():
    """Random lines (thickness 1 and 2, ends in and out of the image),
    filled circles (radius 1-3, partly outside) and polygons (3-8
    vertices, self-intersecting ones included) against OpenCV's pixels,
    exactly."""
    rng = np.random.default_rng(0)
    h, w = 60, 80
    for k in range(150):
        lo, hi = (0, 1) if k % 2 else (-0.5, 1.5)  # every other line leaves the image
        p1 = (int(rng.integers(lo * w, hi * w)), int(rng.integers(lo * h, hi * h)))
        p2 = (int(rng.integers(lo * w, hi * w)), int(rng.integers(lo * h, hi * h)))
        for th in (1, 2):
            a, b = np.zeros((h, w, 3), np.uint8), np.zeros((h, w, 3), np.uint8)
            cv2.line(a, p1, p2, (0, 255, 0), th)
            draw.line(b, p1, p2, (0, 255, 0), th)
            np.testing.assert_array_equal(b, a, err_msg=f"line {p1} {p2} thickness {th}")
        c = (int(rng.integers(-3, w + 3)), int(rng.integers(-3, h + 3)))
        r = int(rng.integers(1, 4))
        a, b = np.zeros((h, w, 3), np.uint8), np.zeros((h, w, 3), np.uint8)
        cv2.circle(a, c, r, (255, 0, 0), -1)
        draw.circle(b, c, r, (255, 0, 0))
        np.testing.assert_array_equal(b, a, err_msg=f"circle {c} r {r}")
        pts = rng.integers(0, 60, (int(rng.integers(3, 9)), 2)).astype(np.int32)
        a, b = np.zeros((h, w), np.uint8), np.zeros((h, w), np.uint8)
        cv2.fillPoly(a, [pts], 255)
        draw.fill_poly(b, pts, 255)
        np.testing.assert_array_equal(b, a, err_msg=f"fillPoly {pts.tolist()}")


def test_detect_mask_matches_jax(yolo_variables):  # noqa: F811
    """``Detector.detect_mask`` on the same flax variables in both
    packages: the same detections and classes, confidences within 1e-4,
    boxes within 1e-3 px, and each round-trip mask bit-equal wherever the
    two packages' device masks agree (they may differ on a few pixels near
    the 0.5 threshold, as in ``test_torch_camera.py``)."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 255, size=(72, 112, 3), dtype=np.uint8)
    jdet = JDetector(yolo_variables, nc=5, imgsz=IMGSZ)
    tdet = Detector(yolo_variables, nc=5, imgsz=IMGSZ, device="cpu")
    rj, rt = jdet.detect_mask(img, conf=0.05), tdet.detect_mask(img, conf=0.05)
    assert len(rt) == len(rj) >= 1
    _, mj, _ = jdet(img, conf=0.05)
    _, mt, _ = tdet(img, conf=0.05)
    agreed = 0
    for i, (a, b) in enumerate(zip(rj, rt)):
        assert b["class_id"] == a["class_id"]
        assert abs(b["conf"] - a["conf"]) <= 1e-4
        np.testing.assert_allclose(b["bbox"], a["bbox"], atol=1e-3)
        assert b["mask"].dtype == np.uint8 and b["mask"].shape == (72, 112)
        if np.array_equal(mt[i].numpy(), np.asarray(mj[i])):
            np.testing.assert_array_equal(b["mask"], a["mask"])
            agreed += 1
    assert agreed >= 1


def test_overlay_matches_jax():
    """``draw_model_projection_with_axes`` (dots, then the three axes at
    thickness 2) and ``draw_correspondences`` (lines and radius-2 dots) on
    the same inputs: the projected pixels and the drawn images equal."""
    rng = np.random.default_rng(11)
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)
    pts = (rng.normal(size=(400, 3)) * 0.05).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = cv2.Rodrigues(np.array([0.3, -0.4, 0.2]))[0]
    T[:3, 3] = [0.02, -0.01, 0.6]
    base = rng.integers(0, 255, (480, 640, 3), dtype=np.uint8)
    a = joverlay.draw_model_projection_with_axes(base.copy(), pts, K, T)
    b = overlay.draw_model_projection_with_axes(base.copy(), pts, K, T)
    assert (a != base).any(-1).sum() > 1000
    np.testing.assert_array_equal(b, a)
    dst = pts @ T[:3, :3].T + T[:3, 3] + rng.normal(size=pts.shape).astype(np.float32) * 0.002
    corr = rng.random(len(pts)) < 0.5
    a = joverlay.draw_correspondences(base.copy(), pts, dst, corr, K, T_src=T, max_lines=80)
    b = overlay.draw_correspondences(base.copy(), pts, dst, corr, K, T_src=T, max_lines=80)
    np.testing.assert_array_equal(b, a)


def test_timer_print(capsys):
    import time

    assert overlay.timer_print(time.time() - 0.25, "stage") >= 0.25
    out = capsys.readouterr().out
    assert "stage: 0.2" in out and out.startswith("\x1b[32m")
