"""Mesh helpers the tracking slice needs (counterpart of ``pad_faces`` and
``make_icosphere`` in ``poseestimator_tpu/render/mesh.py``; host-side numpy)."""
from __future__ import annotations

import numpy as np


def pad_faces(faces: np.ndarray, capacity: int) -> np.ndarray:
    """Pad a face list to a fixed capacity with degenerate (0, 0, 0) triples:
    zero-area faces never cover a pixel, so padded rasterization is exact."""
    if len(faces) > capacity:
        raise ValueError(f"{len(faces)} faces exceed capacity {capacity}")
    out = np.zeros((capacity, 3), np.int32)
    out[: len(faces)] = faces
    return out


def make_icosphere(radius: float = 1.0, subdivisions: int = 3,
                   center=(0.0, 0.0, 0.0)) -> tuple[np.ndarray, np.ndarray]:
    """Subdivided icosahedron: ``(vertices (V, 3) f32, faces (20 * 4^s, 3)
    i32)``. Four subdivisions give 5120 faces."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array(
        [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
         [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
         [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
        np.float64,
    )
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
        np.int64,
    )
    for _ in range(subdivisions):
        cache: dict[tuple[int, int], int] = {}
        verts = list(v)

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                cache[key] = len(verts) - 1
            return cache[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.asarray(verts)
        f = np.asarray(nf, np.int64)
    v = (v * radius + np.asarray(center, np.float64)).astype(np.float32)
    return v, f.astype(np.int32)
