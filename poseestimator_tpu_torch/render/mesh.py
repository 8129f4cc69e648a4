"""Triangle meshes on the host (counterpart of
``poseestimator_tpu/render/mesh.py``; numpy): PLY loading (``load_geometry``
takes a face-less PLY as a point set), bounds,
area-weighted surface sampling, vertex-clustering decimation to a face
budget, face padding, and the icosphere test mesh."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..utils.plyio import read_ply


@dataclass
class TriangleMesh:
    vertices: np.ndarray  # (V, 3) float32
    faces: np.ndarray  # (F, 3) int32
    vertex_normals: Optional[np.ndarray] = None  # (V, 3)

    @classmethod
    def load(cls, path: str) -> "TriangleMesh":
        m = load_geometry(path)
        if not isinstance(m, TriangleMesh):
            raise ValueError(f"{path}: no faces, not a triangle mesh")
        return m

    def compute_vertex_normals(self) -> None:
        v, f = self.vertices, self.faces
        fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        vn = np.zeros_like(v)
        for k in range(3):
            np.add.at(vn, f[:, k], fn)
        norms = np.linalg.norm(vn, axis=1, keepdims=True)
        self.vertex_normals = (vn / np.maximum(norms, 1e-12)).astype(np.float32)

    @property
    def extent(self) -> np.ndarray:
        return self.vertices.max(axis=0) - self.vertices.min(axis=0)

    def get_center(self) -> np.ndarray:
        """Mean of the vertices (Open3D ``get_center``)."""
        return self.vertices.mean(axis=0)

    def scale(self, s: float, center=None) -> "TriangleMesh":
        c = np.zeros(3, np.float32) if center is None else np.asarray(center, np.float32)
        return TriangleMesh(vertices=((self.vertices - c) * s + c).astype(np.float32),
                            faces=self.faces, vertex_normals=self.vertex_normals)

    def translate(self, t) -> "TriangleMesh":
        return TriangleMesh(vertices=(self.vertices + np.asarray(t, np.float32)).astype(np.float32),
                            faces=self.faces, vertex_normals=self.vertex_normals)

    def sample_points_uniformly(self, number_of_points: int,
                                rng: Optional[np.random.Generator] = None):
        """Area-weighted uniform surface samples ``(points (N, 3), normals
        (N, 3))`` float32, Open3D's sampling law; the same ``rng`` gives the
        JAX package's samples."""
        rng = rng or np.random.default_rng(0)
        v, f = self.vertices, self.faces
        areas = 0.5 * np.linalg.norm(np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]]),
                                     axis=1)
        total = areas.sum()
        if total <= 0:
            raise ValueError("mesh has zero surface area")
        fidx = rng.choice(len(f), size=number_of_points, p=areas / total)
        r1 = np.sqrt(rng.random(number_of_points))
        r2 = rng.random(number_of_points)
        w0, w1, w2 = 1.0 - r1, r1 * (1.0 - r2), r1 * r2
        tri = f[fidx]
        pts = (v[tri[:, 0]] * w0[:, None] + v[tri[:, 1]] * w1[:, None]
               + v[tri[:, 2]] * w2[:, None]).astype(np.float32)
        if self.vertex_normals is None:
            self.compute_vertex_normals()
        vn = self.vertex_normals
        nrm = vn[tri[:, 0]] * w0[:, None] + vn[tri[:, 1]] * w1[:, None] + vn[tri[:, 2]] * w2[:, None]
        nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
        return pts, nrm.astype(np.float32)


def simplify_vertex_clustering(mesh: TriangleMesh, voxel: float) -> TriangleMesh:
    """Snap vertices to a ``voxel`` grid and merge each cell into its mean
    (Open3D ``simplify_vertex_clustering``); faces that collapse are
    dropped."""
    keys = np.floor(mesh.vertices / voxel).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    inv = inv.reshape(-1)
    reps = np.zeros((len(counts), 3), np.float64)
    np.add.at(reps, inv, mesh.vertices.astype(np.float64))
    reps = (reps / counts[:, None]).astype(np.float32)
    f = inv[mesh.faces]
    keep = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
    out = TriangleMesh(vertices=reps, faces=f[keep].astype(np.int32))
    if len(out.faces):
        out.compute_vertex_normals()
    return out


def decimate_to_faces(mesh: TriangleMesh, max_faces: int, iters: int = 12) -> TriangleMesh:
    """Vertex-clustering decimation, bisecting the voxel size geometrically,
    until the face count fits ``max_faces`` (the raster's cost is linear in
    faces)."""
    if len(mesh.faces) <= max_faces:
        return mesh
    diag = float(np.linalg.norm(mesh.extent))
    lo, hi = diag * 1e-3, diag * 0.5
    best = None
    for _ in range(iters):
        mid = float(np.sqrt(lo * hi))
        dec = simplify_vertex_clustering(mesh, mid)
        if len(dec.faces) > max_faces:
            lo = mid  # too fine: coarser voxel
        else:
            if len(dec.faces) > 0:
                best = dec
            hi = mid  # fits (or collapsed): try finer
    if best is None:
        raise ValueError(f"could not decimate to <= {max_faces} faces")
    return best


def pad_faces(faces: np.ndarray, capacity: int) -> np.ndarray:
    """Pad a face list to a fixed capacity with degenerate (0, 0, 0) triples:
    zero-area faces never cover a pixel, so padded rasterization is exact."""
    if len(faces) > capacity:
        raise ValueError(f"{len(faces)} faces exceed capacity {capacity}")
    out = np.zeros((capacity, 3), np.int32)
    out[: len(faces)] = faces
    return out


def load_geometry(path: str):
    """A PLY as a ``TriangleMesh`` (vertex normals computed when the file
    has none) when it has faces, else its ``PlyData`` point set: CAD models
    and template clouds share the format."""
    ply = read_ply(path)
    if ply.faces is not None and len(ply.faces) > 0:
        m = TriangleMesh(vertices=ply.vertices, faces=ply.faces, vertex_normals=ply.normals)
        if m.vertex_normals is None:
            m.compute_vertex_normals()
        return m
    return ply


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
