"""Image files without an imaging package: the port's counterparts of
``cv2.imread`` and ``cv2.imwrite`` over the stdlib PNG codec
(``utils/png.py``) and the numpy JPEG decoder (``utils/jpeg.py``).

``read_image`` follows OpenCV's conventions, so that code written against
``cv2.imread`` reads the same arrays: colour comes back in BGR order, and
the three modes convert as OpenCV's PNG and JPEG readers do:

- ``IMREAD_UNCHANGED``: the file's own channels and depth (grey (H, W),
  BGR, BGRA; 8 or 16 bit);
- ``IMREAD_COLOR``: always (H, W, 3) uint8 BGR: grey is replicated, 16-bit
  samples keep their high byte, alpha is dropped;
- ``IMREAD_GRAYSCALE``: (H, W) uint8: a colour PNG mixes its channels as
  libpng does for OpenCV (9797 R + 19234 G + 3737 B over 2^15, rounded
  at 16 bits), a colour JPEG gives its luma plane.

The format is read from the file's signature, not its name. A missing file
raises ``FileNotFoundError``, an unknown format ``ValueError`` (where
``cv2.imread`` returns None). ``write_image`` writes PNG the way
``cv2.imwrite`` does (BGR in memory, RGB on disk), and a ``.jpg`` /
``.jpeg`` path as the very bytes of ``cv2.imwrite`` at its defaults
(``jpeg.encode_jpeg``).
"""
from __future__ import annotations

import numpy as np

from .jpeg import decode_jpeg, encode_jpeg
from .png import read_png, write_png

# cv2's flag values
IMREAD_UNCHANGED, IMREAD_GRAYSCALE, IMREAD_COLOR = -1, 0, 1


def _png_to_grey(img: np.ndarray) -> np.ndarray:
    sixteen = img.dtype == np.uint16
    if img.ndim == 3:  # libpng's rgb_to_gray with OpenCV's 0.299 / 0.587
        c = img[..., :3].astype(np.int64)
        img = (9797 * c[..., 0] + 19234 * c[..., 1] + 3737 * c[..., 2]
               + (16384 if sixteen else 0)) >> 15
    return (img >> 8 if sixteen else img).astype(np.uint8)


def read_image(path, mode: int = IMREAD_COLOR) -> np.ndarray:
    """The image in ``path`` as ``cv2.imread(path, mode)`` returns it (see
    the module docstring)."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head[:2] == b"\xff\xd8":
        with open(path, "rb") as f:
            data = f.read()
        if mode == IMREAD_GRAYSCALE:
            return decode_jpeg(data, grey=True)
        img = decode_jpeg(data)
        if img.ndim == 2:
            return img if mode == IMREAD_UNCHANGED else np.repeat(img[..., None], 3, -1)
        return np.ascontiguousarray(img[..., ::-1])
    if head != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: neither a PNG nor a JPEG file")
    img = read_png(str(path))
    if mode == IMREAD_UNCHANGED:
        if img.ndim == 2:
            return img
        order = [2, 1, 0, 3][:img.shape[2]]
        return np.ascontiguousarray(img[..., order])
    if mode == IMREAD_GRAYSCALE:
        return _png_to_grey(img)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, -1)
    return np.ascontiguousarray(img[..., 2::-1])


def write_image(path, img: np.ndarray) -> None:
    """Write a (H, W, 3) uint8 BGR image or an (H, W) uint8 / uint16 grey
    image as ``cv2.imwrite`` writes it: JPEG (quality 95) for a ``.jpg`` or
    ``.jpeg`` path, PNG otherwise."""
    img = np.asarray(img)
    if str(path).lower().endswith((".jpg", ".jpeg")):
        with open(path, "wb") as f:
            f.write(encode_jpeg(img))
        return
    if img.ndim == 3:
        if img.shape[2] != 3:
            raise ValueError(f"write_image: expected 3 channels, got {img.shape}")
        img = np.ascontiguousarray(img[..., ::-1])
    write_png(str(path), img)
