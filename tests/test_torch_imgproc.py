"""The port's host image operations against OpenCV: the INTER_LINEAR uint8
resize (bit for bit, up, down, odd ratios, 1-pixel edges, exact halving),
the INTER_CUBIC float32 resize (to 1e-4 at +-30: OpenCV's wheels route it
through IPP, whose rounding is unpublished), BGR <-> HSV on uint8 (bit for
bit, rows of every width around the 32-pixel vector blocks), the filled
rectangle and circle on float64 images, ``contourArea``, and the baseline
JPEG encoder (the very bytes of ``cv2.imencode(".jpg")`` at its defaults,
odd sizes, grey, noise, 640 x 480)."""
import cv2
import numpy as np
import pytest

from poseestimator_tpu_torch.models.yolo.contours import contour_area
from poseestimator_tpu_torch.utils import draw, imgproc, jpeg
from poseestimator_tpu_torch.utils.image import IMREAD_COLOR, read_image, write_image
from torch_threads import two_threads  # noqa: F401

RESIZE_CASES = [  # (h, w, new_h, new_w)
    (96, 128, 48, 64), (480, 640, 240, 320), (480, 640, 320, 427), (480, 640, 640, 853),
    (97, 129, 48, 64), (5, 7, 2, 3), (1, 1, 5, 9), (1, 17, 3, 40), (33, 1, 70, 2),
    (240, 320, 480, 640), (480, 640, 160, 160), (13, 29, 13, 29), (61, 63, 119, 40)]


@pytest.mark.parametrize("h,w,nh,nw", RESIZE_CASES)
@pytest.mark.parametrize("c", [1, 3])
def test_resize_linear_u8_is_opencv(h, w, nh, nw, c):
    """Bit for bit, 1- and 3-channel."""
    img = np.random.default_rng(h * 1000 + w + c).integers(0, 256, (h, w, c), dtype=np.uint8)
    want = cv2.resize(img, (nw, nh)).reshape(nh, nw, c)
    assert np.array_equal(imgproc.resize_linear_u8(img, nw, nh), want)


def test_resize_linear_u8_random_sizes():
    """200 random sizes and ratios, grey and colour: bit for bit."""
    rng = np.random.default_rng(0)
    for t in range(200):
        h, w = (int(v) for v in rng.integers(1, 80, 2))
        nh, nw = (int(v) for v in rng.integers(1, 120, 2))
        img = rng.integers(0, 256, (h, w) if t % 2 else (h, w, 3), dtype=np.uint8)
        assert np.array_equal(imgproc.resize_linear_u8(img, nw, nh),
                              cv2.resize(img, (nw, nh))), (h, w, nh, nw)


def test_resize_cubic_f32_is_opencv_to_ipp_rounding():
    """The synthetic backgrounds' blotch upsampling: within 1e-4 of OpenCV
    (values in +-30 and their overshoot) on random grids and sizes,
    including the generator's (12, 16) -> (480, 640)."""
    rng = np.random.default_rng(1)
    cases = [(12, 16, 480, 640), (2, 3, 96, 128)] + [
        (*(int(v) for v in rng.integers(1, 30, 2)), *(int(v) for v in rng.integers(1, 200, 2)))
        for _ in range(60)]
    for h, w, nh, nw in cases:
        img = rng.uniform(-30, 30, (h, w, 3)).astype(np.float32)
        want = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_CUBIC).reshape(nh, nw, 3)
        got = imgproc.resize_cubic_f32(img, nw, nh)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("h,w", [(300, 257), (64, 64), (7, 31), (9, 130), (1, 200), (33, 65)])
def test_hsv_both_ways_is_opencv(h, w):
    """BGR2HSV (integer tables) and HSV2BGR (float32: the AVX2 blocks of 32
    pixels truncate, the scalar tail rounds), bit for bit."""
    rng = np.random.default_rng(h + w)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    assert np.array_equal(imgproc.bgr_to_hsv_u8(img), cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
    hsv = img.copy()
    hsv[..., 0] %= 180
    assert np.array_equal(imgproc.hsv_to_bgr_u8(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


def test_hsv_every_hue_saturation_value():
    """Every (H, S) pair at 16 values, in rows of 180 (vector blocks and a
    20-pixel scalar tail), and every grey and primary ramp: bit for bit."""
    hs = np.stack(np.meshgrid(np.arange(180), np.arange(256), indexing="ij"), -1)
    for v in range(0, 256, 17):
        hsv = np.concatenate([hs, np.full(hs.shape[:2] + (1,), v)], -1).astype(np.uint8)
        hsv = hsv.transpose(1, 0, 2)  # (256, 180, 3)
        assert np.array_equal(imgproc.hsv_to_bgr_u8(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))
    ramp = np.arange(256, dtype=np.uint8)
    bgr = np.stack([np.stack([ramp] * 3, -1), np.stack([ramp, 0 * ramp, 0 * ramp], -1),
                    np.stack([0 * ramp, ramp, 255 - ramp], -1)]).astype(np.uint8)
    assert np.array_equal(imgproc.bgr_to_hsv_u8(bgr), cv2.cvtColor(bgr, cv2.COLOR_BGR2HSV))


def test_rectangle_and_circle_fill_as_opencv():
    """``cv2.rectangle(..., -1)`` with corners in either order and off the
    image, and ``cv2.circle(..., -1)``, on float64 images with float colours
    (the backgrounds' case)."""
    rng = np.random.default_rng(2)
    for _ in range(200):
        h, w = (int(v) for v in rng.integers(1, 50, 2))
        col = rng.uniform(0, 255, 3).tolist()
        a = rng.uniform(0, 255, (h, w, 3))
        b = a.copy()
        p0 = tuple(int(v) for v in rng.integers(-20, 70, 2))
        p1 = tuple(int(v) for v in rng.integers(-20, 70, 2))
        cv2.rectangle(a, p0, p1, col, -1)
        draw.rectangle(b, p0, p1, col)
        assert np.array_equal(a, b), (h, w, p0, p1)
        a = rng.uniform(0, 255, (h, w, 3))
        b = a.copy()
        c, r = tuple(int(v) for v in rng.integers(-10, 60, 2)), int(rng.integers(4, 30))
        cv2.circle(a, c, r, col, -1)
        draw.circle(b, c, r, col)
        assert np.array_equal(a, b)


def test_contour_area_is_opencv():
    rng = np.random.default_rng(3)
    for n in (3, 4, 7, 40):
        for _ in range(10):
            p = rng.uniform(0, 100, (n, 2)).astype(np.float32)
            assert contour_area(p) == pytest.approx(cv2.contourArea(p), rel=1e-6, abs=1e-4)
            q = np.round(p).astype(np.int32)
            assert contour_area(q) == cv2.contourArea(q)


def _first_difference(a: bytes, b: bytes) -> str:
    n = min(len(a), len(b))
    diff = np.nonzero(np.frombuffer(a[:n], np.uint8) != np.frombuffer(b[:n], np.uint8))[0]
    at = int(diff[0]) if len(diff) else n
    seg, i = "entropy data", 2
    while i < min(at, n) and a[i] == 0xFF and a[i + 1] not in (0xDA,):
        seg_len = int.from_bytes(a[i + 2:i + 4], "big")
        if at < i + 2 + seg_len:
            seg = f"marker FF{a[i + 1]:02X}"
            break
        i += 2 + seg_len
    return f"first difference at byte {at} ({seg}); lengths {len(a)} and {len(b)}"


JPEG_SHAPES = [(16, 16, 3), (8, 8, 3), (17, 23, 3), (33, 9, 3), (1, 1, 3), (3, 5, 3),
               (96, 128, 3), (121, 161, 3), (24, 24), (13, 7), (480, 640, 3)]


@pytest.mark.parametrize("shape", JPEG_SHAPES)
def test_encode_jpeg_is_opencv_bytes(shape):
    """The bytes of ``cv2.imencode(".jpg", img)``: random noise (every AC
    code, long 0xFF runs) and a smooth ramp (long zero runs, ZRL, EOB), at
    MCU-aligned and ragged sizes (dummy blocks, edge replication)."""
    rng = np.random.default_rng(sum(shape))
    noise = rng.integers(0, 256, shape, dtype=np.uint8)
    g = np.add.outer(np.arange(shape[0]), np.arange(shape[1])) * 2 % 256
    ramp = (np.stack([g, 255 - g, g // 2], -1) if len(shape) == 3 else g).astype(np.uint8)
    for img in (noise, ramp):
        want = cv2.imencode(".jpg", img)[1].tobytes()
        got = jpeg.encode_jpeg(img)
        assert got == want, _first_difference(got, want)


def test_encode_jpeg_random_sizes_and_files(tmp_path):
    """80 random sizes, grey and colour: bytes equal; ``write_image`` of a
    ``.jpg`` path writes the bytes of ``cv2.imwrite``, which both readers
    decode alike."""
    rng = np.random.default_rng(4)
    for t in range(80):
        h, w = (int(v) for v in rng.integers(1, 70, 2))
        img = rng.integers(0, 256, (h, w, 3) if t % 4 else (h, w), dtype=np.uint8)
        if t % 3 == 0:
            img = (img // 64 * 64).astype(np.uint8)
        assert jpeg.encode_jpeg(img) == cv2.imencode(".jpg", img)[1].tobytes(), (h, w)
    img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    write_image(tmp_path / "a.jpg", img)
    cv2.imwrite(str(tmp_path / "b.jpg"), img)
    assert (tmp_path / "a.jpg").read_bytes() == (tmp_path / "b.jpg").read_bytes()
    assert np.array_equal(read_image(tmp_path / "a.jpg", IMREAD_COLOR),
                          cv2.imread(str(tmp_path / "a.jpg")))
