"""PNG reading and writing from the standard library (``zlib`` + ``struct``):
the template images, and a BOP scene's depth, mask and colour images, need
no imaging package.

``read_png`` decodes 8- and 16-bit greyscale, RGB and RGBA files with any of
the five row filters; 16-bit samples are big-endian in the file and come
back as ``uint16``. Palette images, other bit depths and interlaced files
raise ``ValueError`` naming what is unsupported. ``write_png`` writes 8-bit
RGB, 8-bit grey and 16-bit grey (BOP depth in millimetres), rows
Paeth-filtered, so that whatever the port writes is read back through the
hardest of the five filters.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (0 grey, 2 RGB, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 6: 4}
_COLOR_NAMES = {3: "palette", 4: "grey + alpha"}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of left ``a``, up ``b`` and up-left ``c`` (int16)."""
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB image, an (H, W) uint8 grey image or an
    (H, W) uint16 grey image, every row Paeth-filtered (as encoders such as
    libpng choose for smooth depth)."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8:
        h, w, _ = img.shape
        depth, color, bpp, raw = 8, 2, 3, img.reshape(h, w * 3)
    elif img.ndim == 2 and img.dtype == np.uint8:
        h, w = img.shape
        depth, color, bpp, raw = 8, 0, 1, img
    elif img.ndim == 2 and img.dtype == np.uint16:
        h, w = img.shape
        depth, color, bpp = 16, 0, 2
        raw = img.astype(">u2").view(np.uint8).reshape(h, w * 2)
    else:
        raise ValueError(f"write_png: expected (H, W, 3) uint8, (H, W) uint8 or (H, W) "
                         f"uint16, got {img.shape} {img.dtype}")
    # the neighbours of every byte, zero beyond the image's top and left edge
    pad = np.zeros((h + 1, raw.shape[1] + bpp), np.int16)
    pad[1:, bpp:] = raw
    a, b, c = pad[1:, :-bpp], pad[:-1, bpp:], pad[:-1, :-bpp]
    filtered = ((pad[1:, bpp:] - _paeth(a, b, c)) & 0xFF).astype(np.uint8)
    rows = np.concatenate([np.full((h, 1), 4, np.uint8), filtered], axis=1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _unfilter_wavefront(lines: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Undo a run of (n, 1 + stride) Average and Paeth scanlines below the
    decoded row ``prior``. A byte needs its decoded left, up and up-left
    neighbours, so the pixels go in anti-diagonals, each one vectorised: the
    image is held skewed, pixel (r, x) at [r + x + 2, r + 1], so that an
    anti-diagonal and its three neighbour sets are contiguous slices (row 0
    holds ``prior``; the cells never written are the zeros left of the
    image)."""
    n, w = len(lines), (lines.shape[1] - 1) // bpp
    avg = (lines[:, 0] == 3)[:, None]
    any_avg = bool(avg.any())
    r, x = np.divmod(np.arange(n * w), w)
    raw = np.zeros((n + w, n, bpp), np.int16)
    raw[r + x, r] = lines[:, 1:].reshape(n * w, bpp)
    out = np.zeros((n + w + 2, n + 1, bpp), np.int16)
    out[1:w + 1, 0] = prior.reshape(w, bpp)
    for t in range(n + w - 1):
        lo, hi = max(0, t - w + 1), min(n, t + 1)
        a, b, c = out[t + 1, lo + 1:hi + 1], out[t + 1, lo:hi], out[t, lo:hi]
        pred = _paeth(a, b, c)
        if any_avg:
            pred = np.where(avg[lo:hi], (a + b) >> 1, pred)
        np.bitwise_and(raw[t, lo:hi] + pred, 0xFF, out=out[t + 2, lo + 1:hi + 1])
    return out[r + x + 2, r + 1].reshape(n, w * bpp).astype(np.uint8)


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The (h, stride) bytes of the image from its filtered scanlines. None,
    Sub and Up rows are undone a row at a time; a run of Average and Paeth
    rows, whose bytes wait on their decoded left neighbour, as a wavefront."""
    if len(data) < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    lines = np.frombuffer(data, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    ftype = lines[:, 0]
    if (ftype > 4).any():
        y = int(np.argmax(ftype > 4))
        raise ValueError(f"PNG row {y}: unknown filter type {ftype[y]}")
    out = np.zeros((h + 1, stride), np.uint8)  # row 0 is the zero row above the image
    y = 0
    while y < h:
        if ftype[y] >= 3:
            end = y
            while end < h and ftype[end] >= 3:
                end += 1
            out[y + 1:end + 1] = _unfilter_wavefront(lines[y:end], out[y], bpp)
            y = end
            continue
        line = lines[y, 1:]
        if ftype[y] == 0:
            out[y + 1] = line
        elif ftype[y] == 1:  # Sub: a running sum, modulo 256, per byte of a pixel
            out[y + 1] = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        else:  # Up
            out[y + 1] = line + out[y]
        y += 1
    return out[1:]


def read_png(path: str) -> np.ndarray:
    """The image of a PNG file: (H, W) for grey, (H, W, 3) RGB or (H, W, 4)
    RGBA, ``uint8`` or ``uint16`` by the file's bit depth."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(blob):
        n, tag = struct.unpack(">I4s", blob[pos:pos + 8])
        body = blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"{path}: unsupported PNG colour type {color} "
                         f"({_COLOR_NAMES.get(color, 'unknown')}); grey, RGB and RGBA are read")
    if depth not in (8, 16):
        raise ValueError(f"{path}: unsupported PNG bit depth {depth}; 8 and 16 are read")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not supported")
    ch, nbytes = _CHANNELS[color], depth // 8
    raw = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch * nbytes, ch * nbytes)
    img = raw.view(">u2").astype(np.uint16) if depth == 16 else raw
    return img.reshape((h, w) if ch == 1 else (h, w, ch))
