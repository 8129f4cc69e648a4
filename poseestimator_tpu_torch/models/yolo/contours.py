"""Outer borders of a binary mask without OpenCV: Suzuki and Abe's border
following as ``cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)``
runs it, point for point and in its order.

The mask is padded with a zero border (so components touching the image
edge are closed), scanned in raster order, and each outer border that does
not lie inside an already traced border is followed from its first pixel
(8-connected foreground, the trace turning counter-clockwise through the
neighbours in screen coordinates). Visited border pixels are marked 2, or
-126 where the pixel right of them is background, exactly as OpenCV marks
them: the marks decide whether a later border lies inside a traced one.
``CHAIN_APPROX_SIMPLE`` keeps a point only where the chain code changes, so
horizontal, vertical and diagonal runs collapse to their ends. OpenCV
returns the borders last found first.
"""
from __future__ import annotations

import numpy as np

# chain code -> (dx, dy): right, up-right, up, up-left, left, down-left, down,
# down-right (y grows downwards)
_CODE_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_CODE_DY = (0, -1, -1, -1, 0, 1, 1, 1)
_RIGHT_BORDER = -126  # the mark of a border pixel whose right neighbour is background


def _follow(img: np.ndarray, i0: int, deltas: list, x: int, y: int) -> list:
    """Follow the outer border that starts at flat index ``i0`` (pixel
    ``(x, y)`` of the unpadded mask), marking its pixels; the chain's
    corner points."""
    s = s_end = 4
    while True:
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if img[i1] != 0 or s == s_end:
            break
    if s == s_end:  # an isolated pixel
        img[i0] = _RIGHT_BORDER
        return [(x, y)]
    pts = []
    i3, prev_s = i0, s ^ 4
    while True:
        s_end = s
        while s < 15:
            s += 1
            i4 = i3 + deltas[s]
            if img[i4] != 0:
                break
        s &= 7
        if 1 <= s <= s_end:
            img[i3] = _RIGHT_BORDER
        elif img[i3] == 1:
            img[i3] = 2
        if s != prev_s:
            pts.append((x, y))
            prev_s = s
        x += _CODE_DX[s]
        y += _CODE_DY[s]
        if i4 == i0 and i3 == i1:
            return pts
        i3 = i4
        s = (s + 4) & 7


def find_external_contours(mask: np.ndarray) -> list[np.ndarray]:
    """``cv2.findContours(mask != 0, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)[0]``:
    a list of (K, 2) int32 (x, y) point arrays, in OpenCV's order."""
    m = np.asarray(mask) != 0
    h, w = m.shape
    img = np.zeros((h + 2, w + 2), np.int8)
    img[1:-1, 1:-1] = m
    step = w + 2
    deltas = [1, 1 - step, -step, -1 - step, -1, step - 1, step, step + 1] * 2
    flat = img.reshape(-1)
    found = []
    for y in range(1, h + 1):
        row = img[y]
        x, prev, lnbd = 1, 0, y * step
        while x <= w:
            nxt = np.flatnonzero(row[x:w + 1] != prev)
            if not nxt.size:
                break
            x += int(nxt[0])
            p = int(row[x])
            if prev == 0 and p == 1:  # an outer border starts here
                if flat[lnbd] <= 0:  # not inside a border traced before
                    found.append(_follow(flat, y * step + x, deltas, x - 1, y - 1))
                    prev = int(row[x])
                    x += 1
                    continue
            elif p == 0 and prev >= 1 and prev & -2:  # a hole border: only moves lnbd
                lnbd = y * step + x - 1
            prev = p
            if prev & -2:
                lnbd = y * step + x
            x += 1
    return [np.asarray(c, np.int32).reshape(-1, 2) for c in reversed(found)]


def contour_area(pts: np.ndarray) -> float:
    """``cv2.contourArea``: the shoelace area, unsigned (exact for integer
    vertices)."""
    p = np.asarray(pts, np.float64).reshape(-1, 2)
    q = np.roll(p, 1, axis=0)
    return abs(0.5 * float(np.sum(q[:, 0] * p[:, 1] - q[:, 1] * p[:, 0])))
