"""Seeded CAD models: a closed icosphere, displaced and stretched so that it
has no symmetry, scaled to a published object diameter.

The shape comes from a shape seed that the configuration fixes (a deployment
tracks one known CAD), never from the run's ``--seed``: every seed then
tracks the same object, and only the noise, the weights and the order of the
requests change with it.
"""
from __future__ import annotations

import numpy as np

_T = (1.0 + 5.0 ** 0.5) / 2.0
_ICO_V = np.array([[-1, _T, 0], [1, _T, 0], [-1, -_T, 0], [1, -_T, 0], [0, -1, _T], [0, 1, _T],
                   [0, -1, -_T], [0, 1, -_T], [_T, 0, -1], [_T, 0, 1], [-_T, 0, -1], [-_T, 0, 1]],
                  np.float64)
_ICO_F = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9],
                   [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2],
                   [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10],
                   [8, 6, 7], [9, 8, 1]], np.int64)


def icosphere(subdivisions: int) -> tuple[np.ndarray, np.ndarray]:
    """Unit icosphere: 20 * 4**subdivisions outward-wound faces."""
    v = _ICO_V / np.linalg.norm(_ICO_V, axis=1, keepdims=True)
    f = _ICO_F
    for _ in range(subdivisions):
        verts = list(v)
        cache: dict[tuple[int, int], int] = {}

        def mid(a: int, b: int) -> int:
            key = (a, b) if a < b else (b, a)
            if key not in cache:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                cache[key] = len(verts) - 1
            return cache[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v, f = np.asarray(verts), np.asarray(nf, np.int64)
    return v, f


def diameter(v: np.ndarray) -> float:
    """Largest distance between two vertices (BOP's object diameter)."""
    best = 0.0
    for s in range(0, len(v), 512):
        d = np.linalg.norm(v[s:s + 512, None, :] - v[None, :, :], axis=-1)
        best = max(best, float(d.max()))
    return best


def make_cad(shape_seed: int, diameter_mm: float, subdivisions: int = 4,
             stretch=(1.0, 0.6, 0.4), bumps: int = 8, amplitude: float = 0.2,
             freq=(1.5, 4.0)):
    """``(vertices (V, 3) float32 metres, faces (F, 3) int32)`` of a closed
    displaced icosphere: radius 1 + amplitude * a sum of ``bumps`` random
    plane waves over the direction (spatial frequencies in ``freq``),
    stretched along the axes, rotated at random, centred and scaled to
    ``diameter_mm``. The defaults give a rock-like body whose axes differ
    (1 : 0.6 : 0.4) and whose bumps pin its rotation: a rounder one leaves
    the rotation about the view axis so loose that dense ICP on 2.5 mm noise
    slides along it."""
    rng = np.random.default_rng(shape_seed)
    v, f = icosphere(subdivisions)
    w = rng.normal(size=(bumps, 3)) * rng.uniform(freq[0], freq[1], size=(bumps, 1))
    phase = rng.uniform(0.0, 2 * np.pi, size=bumps)
    weight = rng.uniform(0.5, 1.0, size=bumps)
    r = 1.0 + amplitude * (weight * np.sin(v @ w.T + phase)).sum(1) / weight.sum() * 2.0
    v = v * r[:, None] * np.asarray(stretch)[None, :]
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    v = v @ q.T
    v = v - 0.5 * (v.max(0) + v.min(0))
    v = v * (diameter_mm * 1e-3 / diameter(v))
    return v.astype(np.float32), f.astype(np.int32)


def write_ply(path: str, v: np.ndarray, f: np.ndarray) -> None:
    """Binary little-endian PLY with float vertices and int face lists."""
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(v)}\nproperty float x\nproperty float y\nproperty float z\n"
              f"element face {len(f)}\nproperty list uchar int vertex_indices\nend_header\n")
    rows = np.empty(len(f), dtype=[("n", "u1"), ("i", "<i4", (3,))])
    rows["n"] = 3
    rows["i"] = f
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        fh.write(np.ascontiguousarray(v, "<f4").tobytes())
        fh.write(rows.tobytes())


def surface_points(v: np.ndarray, f: np.ndarray, n: int, seed: int) -> np.ndarray:
    """``n`` points uniform on the surface (area-weighted faces), float32:
    the model points of ADD and ADD-S."""
    rng = np.random.default_rng(seed)
    tri = v[f].astype(np.float64)
    area = 0.5 * np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    idx = rng.choice(len(f), size=n, p=area / area.sum())
    a, b = rng.random(n), rng.random(n)
    flip = a + b > 1
    a[flip], b[flip] = 1 - a[flip], 1 - b[flip]
    t = tri[idx]
    return (t[:, 0] + a[:, None] * (t[:, 1] - t[:, 0])
            + b[:, None] * (t[:, 2] - t[:, 0])).astype(np.float32)
