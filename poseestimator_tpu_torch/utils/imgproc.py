"""Host image operations with OpenCV's arithmetic, without OpenCV: the
resizes and colour conversions of the training data pipeline and the
synthetic scene generator, each emulating the named ``cv2`` call (numpy;
checked against OpenCV on random inputs).

- ``resize_linear_u8``: ``cv2.resize(img, (w, h))`` (INTER_LINEAR) on
  uint8: 11-bit fixed-point weights, a horizontal then a vertical pass,
  and the vertical pass's rounding as OpenCV's vector code does it; an
  exact halving goes through INTER_AREA's 2 x 2 mean, as in OpenCV.
- ``resize_cubic_f32``: INTER_CUBIC (A = -0.75) on float32 with a
  replicated border, to OpenCV's IPP rounding (not to the bit).
- ``bgr_to_hsv_u8`` / ``hsv_to_bgr_u8``: ``cv2.cvtColor`` BGR2HSV /
  HSV2BGR on uint8 (H in [0, 180)): the forward direction through
  OpenCV's integer division tables, the inverse through float32.

``cv2.contourArea`` is ``models/yolo/contours.contour_area``, and
``cv2.rectangle`` / ``cv2.circle`` filled are in ``utils/draw.py``.
"""
from __future__ import annotations

import numpy as np

INTER_RESIZE_COEF_BITS = 11
INTER_RESIZE_COEF_SCALE = 1 << INTER_RESIZE_COEF_BITS


def _linear_taps(dst: int, src: int, clamp_weights: bool):
    """Source indices and the two fixed-point weights of each destination
    pixel along one axis (``resize.cpp``'s coefficient setup). Along x a
    tap off the image takes its edge pixel at full weight; along y the
    weights stand and only the row indices are clamped."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    if clamp_weights:
        low = s < 0
        f[low], s[low] = 0.0, 0
        high = s >= src - 1
        f[high], s[high] = 0.0, src - 1
    w0 = np.rint((np.float32(1.0) - f) * np.float32(INTER_RESIZE_COEF_SCALE)).astype(np.int64)
    w1 = np.rint(f * np.float32(INTER_RESIZE_COEF_SCALE)).astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def _area_half(img: np.ndarray) -> np.ndarray:
    """INTER_AREA's exact 2 x 2 mean, rounded half up."""
    x = img.astype(np.int32)
    h, w = img.shape[0] // 2, img.shape[1] // 2
    s = x[0:2 * h:2, 0:2 * w:2] + x[1:2 * h:2, 0:2 * w:2] + x[0:2 * h:2, 1:2 * w:2] \
        + x[1:2 * h:2, 1:2 * w:2]
    return ((s + 2) >> 2).astype(np.uint8)


def resize_linear_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height))`` of a uint8 (H, W) or (H, W, C)
    image, INTER_LINEAR, bit for bit."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError("resize_linear_u8 takes uint8 images")
    h, w = img.shape[:2]
    if (h, w) == (height, width):
        return img.copy()
    if w == 2 * width and h == 2 * height:
        return _area_half(img)
    xs0, xs1, a0, a1 = _linear_taps(width, w, True)
    ys0, ys1, b0, b1 = _linear_taps(height, h, False)
    x = img.astype(np.int64)
    # horizontal pass: 2^11-scaled ints per source row
    a0e = a0.reshape((1, -1) + (1,) * (img.ndim - 2))
    a1e = a1.reshape((1, -1) + (1,) * (img.ndim - 2))
    rows = x[:, xs0] * a0e + x[:, xs1] * a1e  # (H, width, ...)
    # vertical pass as OpenCV's vector code rounds it: each 2^11-scaled
    # value shifted down 4 bits, multiplied by its weight keeping the high
    # 16 bits, the two summed with 2 and shifted down 2
    r0 = rows[ys0] >> 4
    r1 = rows[ys1] >> 4
    b0e = b0.reshape((-1, 1) + (1,) * (img.ndim - 2))
    b1e = b1.reshape((-1, 1) + (1,) * (img.ndim - 2))
    out = (((r0 * b0e) >> 16) + ((r1 * b1e) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def _cubic_taps(dst: int, src: int):
    """Four source indices (edge-replicated) and the weights of each
    destination pixel, A = -0.75, in float64."""
    x = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    s = np.floor(x)
    x = x - s
    A = -0.75
    c0 = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A
    c1 = ((A + 2) * x - (A + 3)) * x * x + 1
    c2 = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1
    idx = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3)[None, :], 0, src - 1)
    return idx, np.stack([c0, c1, c2, 1 - c0 - c1 - c2], axis=1)


def resize_cubic_f32(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_CUBIC)`` of
    a float32 (H, W) or (H, W, C) image, horizontal then vertical, in
    float64 with a float32 result. OpenCV's wheels route this call through
    IPP, whose rounding is not published: the result agrees to ~3e-6 of
    the values' magnitude (1e-4 at +-30), not to the bit."""
    img = np.asarray(img, np.float64)
    h, w = img.shape[:2]
    xi, xw = _cubic_taps(width, w)
    yi, yw = _cubic_taps(height, h)
    tail = (1,) * (img.ndim - 2)
    rows = sum(img[:, xi[:, k]] * xw[:, k].reshape((1, -1) + tail) for k in range(4))
    out = sum(rows[yi[:, k]] * yw[:, k].reshape((-1, 1) + tail) for k in range(4))
    return out.astype(np.float32)


_HSV_SHIFT = 12


def _hsv_tables():
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    hdiv = np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << _HSV_SHIFT) / i)
    hdiv[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * i))
    return sdiv, hdiv


_SDIV, _HDIV180 = _hsv_tables()


def bgr_to_hsv_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2HSV)`` for uint8 (H, W, 3): OpenCV's
    12-bit integer division tables, H in [0, 180)."""
    x = np.asarray(img).astype(np.int64)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    vmin = np.minimum(np.minimum(b, g), r)
    diff = v - vmin
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV180[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


_SECTOR = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def _fnmadd32(a, b, c):
    """float32 ``c - a b`` with one rounding (a fused multiply-add)."""
    return (c.astype(np.float64) - a.astype(np.float64) * b.astype(np.float64)).astype(np.float32)


def _hsv_to_bgr(x: np.ndarray, vector: bool) -> np.ndarray:
    f32, one = np.float32, np.float32(1.0)
    hue = x[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = x[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = x[..., 2].astype(f32) * f32(1.0 / 255.0)
    sector = np.floor(hue)
    h = hue - sector
    sector = sector.astype(np.int64) % 6
    ones = np.ones_like(s)  # the compiler fuses 1 - s h into one multiply-add
    tab = np.stack([v, v * (one - s), v * _fnmadd32(s, h, ones),
                    v * _fnmadd32(s, one - h, ones)], axis=-1)
    bgr = np.take_along_axis(tab, _SECTOR[sector], axis=-1)
    bgr = np.where((x[..., 1] == 0)[..., None], v[..., None], bgr) * f32(255.0)
    # the vector code truncates, the scalar code rounds half to even
    return np.clip(np.trunc(bgr) if vector else np.rint(bgr), 0, 255).astype(np.uint8)


def hsv_to_bgr_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_HSV2BGR)`` for uint8 (H, W, 3) with H in
    [0, 180), through float32 as OpenCV computes it row by row: each row's
    leading multiple of 32 pixels by its AVX2 vector code (truncated to
    integers), the rest by its scalar code (rounded half to even); both
    with fused multiply-adds."""
    x = np.asarray(img)
    cut = x.shape[1] - x.shape[1] % 32
    return np.concatenate([_hsv_to_bgr(x[:, :cut], True), _hsv_to_bgr(x[:, cut:], False)],
                          axis=1)
