"""Raster primitives with OpenCV's pixel rules, without OpenCV: the lines,
filled circles and filled polygons that the overlays and the detector's
mask round trip and the synthetic backgrounds draw (``cv2.line`` at
thickness 1 and 2, ``cv2.circle`` and ``cv2.rectangle`` filled,
``cv2.fillPoly``), all 8-connected (``LINE_8``) on integer points.

The algorithms are OpenCV's ``drawing.cpp``: Bresenham's line walked left to
right (``LineIterator``); a thick line as the convex quadrilateral around
it in 16.16 fixed point (``FillConvexPoly``) capped by a filled circle at
each end; the midpoint circle of
horizontal spans; and the polygon fill as an even-odd scanline fill of edge
crossings (``FillEdgeCollection``) over the polygon's outline
(``CollectPolyEdges`` draws each edge as a line). The fill's rounding is
the one OpenCV 5 shows: an edge's crossing at row y is x0 + 1/2 + (y - y0)
dx in 16.16 with dx floored, and a span runs from the floor of its left
crossing to the last pixel strictly left of its right one, and a thick
line is first clipped to the image grown by its thickness. Checked pixel
for pixel against OpenCV on random lines (ends in and out of the image),
circles and (self-intersecting) polygons. Images are numpy arrays
(H, W) or (H, W, C), drawn in place; ``color`` is a scalar or a per-channel
sequence.
"""
from __future__ import annotations

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _tdiv(a: int, b: int) -> int:
    """C's integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def clip_line(w: int, h: int, p1, p2):
    """OpenCV's ``clipLine`` of the segment p1-p2 to [0, w) x [0, h):
    ``(visible, p1, p2)``."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def line_pixels(w: int, h: int, p1, p2) -> list:
    """The pixels of ``LineIterator(img, p1, p2, 8, leftToRight=True)``:
    Bresenham from the left end, clipped to the image first."""
    p1, p2 = (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1]))
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h and 0 <= p2[1] < h):
        ok, p1, p2 = clip_line(w, h, p1, p2)
        if not ok:
            return []
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    if dx < 0:
        dx, dy, p1 = -dx, -dy, p2
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err, plus, minus = dx - 2 * dy, 2 * dx, -2 * dy
    x, y = p1
    out = []
    for _ in range(dx + 1):
        out.append((x, y))
        diag = err < 0
        err += minus + (plus if diag else 0)
        if vert:  # the major step is along y
            y += sy
            x += sx if diag else 0
        else:
            x += sx
            y += sy if diag else 0
    return out


def _put(img: np.ndarray, pts, color) -> None:
    if pts:
        p = np.asarray(pts, np.int64).reshape(-1, 2)
        img[p[:, 1], p[:, 0]] = color


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    img[y, x1:x2 + 1] = color


def _line2(img: np.ndarray, p1, p2, color) -> None:
    """OpenCV's ``Line2``: a line between 16.16 fixed-point points."""
    h, w = img.shape[:2]
    ok, (x1, y1), (x2, y2) = clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if not ok:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    pts = []
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        y_step = _tdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step = _tdiv(dx << XY_SHIFT, ay | 1)
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    pts.append(((x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT))
    if ax > ay:
        x1 >>= XY_SHIFT
        for _ in range(ecount + 1):
            pts.append((x1, y1 >> XY_SHIFT))
            x1 += 1
            y1 += y_step
    else:
        y1 >>= XY_SHIFT
        for _ in range(ecount + 1):
            pts.append((x1 >> XY_SHIFT, y1))
            x1 += x_step
            y1 += 1
    _put(img, [(x, y) for x, y in pts if 0 <= x < w and 0 <= y < h], color)


def _fill_convex_poly(img: np.ndarray, v: list, color) -> None:
    """OpenCV's ``FillConvexPoly`` for LINE_8 on 16.16 fixed-point
    vertices, its outline drawn by ``Line2``."""
    h, w = img.shape[:2]
    npts = len(v)
    half = XY_ONE >> 1
    p0 = v[-1]
    for p in v:
        _line2(img, p0, p, color)
        p0 = p
    ys = [p[1] for p in v]
    imin = ys.index(min(ys))
    xmin, xmax = (min(p[0] for p in v) + half) >> XY_SHIFT, (max(p[0] for p in v) + half) >> XY_SHIFT
    ymin, ymax = (min(ys) + half) >> XY_SHIFT, (max(ys) + half) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [dict(idx=imin, di=1, x=-XY_ONE, dx=0, ye=ymin),
            dict(idx=imin, di=npts - 1, x=-XY_ONE, dx=0, ye=ymin)]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0, di = e["idx"], e["di"]
                idx = (idx0 + di) % npts
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[idx][1] + half) >> XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e.update(ye=ty, x=xs, idx=idx,
                                 dx=_tdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y)))
                        break
                    idx0, idx = idx, (idx + di) % npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (edge[1], edge[0]) if edge[0]["x"] > edge[1]["x"] else (edge[0], edge[1])
            xx1, xx2 = (left["x"] + half) >> XY_SHIFT, (right["x"] + half) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, max(xx1, 0), min(xx2, w - 1), color)
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def circle(img: np.ndarray, center, radius: int, color) -> None:
    """``cv2.circle(img, center, radius, color, -1)``: the filled midpoint
    circle, clipped to the image."""
    h, w = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        for yy, xa, xb in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                           (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)):
            if 0 <= yy < h and xa < w and xb >= 0:
                _hline(img, yy, max(xa, 0), min(xb, w - 1), color)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2


def rectangle(img: np.ndarray, p1, p2, color) -> None:
    """``cv2.rectangle(img, p1, p2, color, -1)``: the filled rectangle with
    corners p1 and p2 (in either order) inclusive, clipped to the image."""
    h, w = img.shape[:2]
    x0, x1 = sorted((int(p1[0]), int(p2[0])))
    y0, y1 = sorted((int(p1[1]), int(p2[1])))
    x0, x1, y0, y1 = max(x0, 0), min(x1, w - 1), max(y0, 0), min(y1, h - 1)
    if x0 <= x1 and y0 <= y1:
        img[y0:y1 + 1, x0:x1 + 1] = color


def line(img: np.ndarray, p1, p2, color, thickness: int = 1) -> None:
    """``cv2.line(img, p1, p2, color, thickness)`` with LINE_8 on integer
    points."""
    p1, p2 = (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1]))
    h, w = img.shape[:2]
    if thickness <= 1:
        _put(img, line_pixels(w, h, p1, p2), color)
        return
    # OpenCV 5 first clips a thick line to the image grown by its thickness
    m = thickness
    ok, p1, p2 = clip_line(w + 2 * m, h + 2 * m, (p1[0] + m, p1[1] + m), (p2[0] + m, p2[1] + m))
    if not ok:
        return
    p1, p2 = (p1[0] - m, p1[1] - m), (p2[0] - m, p2[1] - m)
    x0, y0 = p1[0] << XY_SHIFT, p1[1] << XY_SHIFT
    x1, y1 = p2[0] << XY_SHIFT, p2[1] << XY_SHIFT
    dx, dy = (x0 - x1) / XY_ONE, (y1 - y0) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    half = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half + odd * XY_ONE * 0.5) / np.sqrt(r)
        ddx, ddy = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex_poly(img, [(x0 + ddx, y0 + ddy), (x0 - ddx, y0 - ddy),
                                (x1 - ddx, y1 - ddy), (x1 + ddx, y1 + ddy)], color)
    rad = (half + (XY_ONE >> 1)) >> XY_SHIFT
    for c in (p1, p2):
        circle(img, c, rad, color)


def fill_poly(img: np.ndarray, pts, color) -> None:
    """``cv2.fillPoly(img, [pts], color)`` for one polygon of integer
    vertices, LINE_8: the outline's lines, then the spans between each
    pair of edge crossings at every row (even-odd)."""
    v = np.asarray(pts, np.int64).reshape(-1, 2)
    h, w = img.shape[:2]
    n = len(v)
    if n == 0:
        return
    prev = v[-1]
    for cur in v:
        _put(img, line_pixels(w, h, prev, cur), color)
        prev = cur
    # edges: from each vertex to the next, x in 16.16 at the pixel centre
    a, b = np.roll(v, 1, axis=0), v
    keep = a[:, 1] != b[:, 1]
    a, b = a[keep], b[keep]
    if len(a) < 2:
        return
    xa, xb = (a[:, 0] << XY_SHIFT) + (XY_ONE >> 1), (b[:, 0] << XY_SHIFT) + (XY_ONE >> 1)
    dy = b[:, 1] - a[:, 1]
    num = xb - xa
    dxe = num // dy  # floored, as OpenCV 5 steps the edges
    down = dy > 0
    y0 = np.where(down, a[:, 1], b[:, 1])
    y1 = np.where(down, b[:, 1], a[:, 1])
    x0 = np.where(down, xa, xb)
    # every row an edge is active in: [y0, y1), x advancing by dx a row
    rows = y1 - y0
    e = np.repeat(np.arange(len(a)), rows)
    k = np.arange(rows.sum()) - np.repeat(np.cumsum(rows) - rows, rows)
    ys = y0[e] + k
    xs = x0[e] + k * dxe[e]
    inside = (ys >= 0) & (ys < h)
    ys, xs = ys[inside], xs[inside]
    order = np.lexsort((xs, ys))
    ys, xs = ys[order], xs[order]
    # crossings pair up within a row (a closed outline crosses each row an
    # even number of times): the span runs between the two crossings
    ya, xl, xr = ys[0::2], xs[0::2] >> XY_SHIFT, (xs[1::2] - 1) >> XY_SHIFT
    ok = (xl < w) & (xr >= 0)
    for y, x1, x2 in zip(ya[ok].tolist(), np.maximum(xl[ok], 0).tolist(),
                         np.minimum(xr[ok], w - 1).tolist()):
        _hline(img, y, x1, x2, color)
