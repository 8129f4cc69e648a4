"""Seeded inputs that reach the edges of the kernels K1 (``fused_nn``) and K2
(``raster``): ties across the kernels' data splits, a distance form that
cancels below zero, ragged sizes, and faces whose boxes end on tile edges.

Every case is numpy, made from a seed, so one case goes through the JAX
reference, the plain PyTorch versions and the CUDA kernels alike
(``chip_smoke.py``, ``tests/test_torch_kernels_cuda.py`` and the CPU parity
tests use them).

K1 splits its data across the blocks of a cluster, the warps of a block and
the lane groups of a warp (neighbouring points go to different groups), each
part a multiple of 16 points long; K2 culls 32 faces per ballot against 8 x 8
pixel tiles. The cases below put their edges on every multiple of 8.
"""
from __future__ import annotations

import numpy as np

from .geom3d.camera import Intrinsics
from .geom3d.se3 import look_at
from .render.mesh import make_icosphere, pad_faces

# the bench box CAD: half extents (m) and its 12 faces
BOX_HALF = (0.06, 0.04, 0.025)
BOX_FACES = np.array(
    [[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
     [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
# OpenGL camera (look_at output) to vision camera
GL_TO_CV = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)


def box_vertices(half=BOX_HALF) -> np.ndarray:
    bx, by, bz = half
    return np.array([[sx * bx, sy * by, sz * bz] for sx in (-1, 1) for sy in (-1, 1)
                     for sz in (-1, 1)], np.float32)


def box_mesh(size, center=(0.0, 0.0, 0.0)) -> tuple[np.ndarray, np.ndarray]:
    """A box of full extents ``size`` at ``center``: 8 vertices, 12 faces,
    triangulated as the JAX package's test fixtures triangulate it."""
    v = box_vertices(tuple(0.5 * np.asarray(size, np.float64))) + np.asarray(center, np.float32)
    quads = ((0, 1, 3, 2), (6, 7, 5, 4), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3))
    f = np.array([t for a, b, c, d in quads for t in ((a, b, c), (a, c, d))], np.int32)
    return v.astype(np.float32), f


def lshape_mesh(scale: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """The evaluation L-shape of the JAX package's tests (two fused boxes,
    0.6 x 0.2 x 0.2 at the origin and 0.2 x 0.4 x 0.2 at (-0.2, 0.3, 0),
    times ``scale``): 16 vertices, 24 faces."""
    s = float(scale)
    v1, f1 = box_mesh((0.6 * s, 0.2 * s, 0.2 * s))
    v2, f2 = box_mesh((0.2 * s, 0.4 * s, 0.2 * s), (-0.2 * s, 0.3 * s, 0.0))
    return np.concatenate([v1, v2]), np.concatenate([f1, f2 + len(v1)])


def lshape_symmetry(scale: float = 1.0) -> np.ndarray:
    """The L-shape's one non-trivial symmetry (4, 4), model frame: both arms
    are 0.6 long outside and 0.2 thick, so swapping x and y, flipping z and
    shifting by (-0.2, 0.2, 0) maps the solid onto itself. A pose T and
    T @ lshape_symmetry() render the same depth from every view."""
    S = np.eye(4, dtype=np.float32)
    S[:3, :3] = [[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, -1.0]]
    S[:3, 3] = np.float32(scale) * np.array([-0.2, 0.2, 0.0], np.float32)
    return S


NNCase = tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def _cloud(rng, n, scale=0.03, center=0.5):
    return (rng.normal(size=(n, 3)) * scale + [0.0, 0.0, center]).astype(np.float32)


def _lattice(rng, m, step=0.01, center=0.5):
    """m points of a cubic lattice of ``step`` around (0, 0, center), each
    jittered by up to a tenth of a step: every pair of points is more than
    0.8 steps apart."""
    side = int(np.ceil(m ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)[:m]
    pts = (g - side / 2) * step + rng.uniform(-0.1, 0.1, size=(m, 3)) * step
    return (pts + [0.0, 0.0, center]).astype(np.float32)


def nn_ties(m: int = 4096, seed: int = 0) -> tuple[NNCase, np.ndarray]:
    """Exact ties that straddle every split edge of K1, and the lowest index
    each query must get.

    Data: a jittered 1 cm lattice 0.5 m out. For every edge e (each multiple
    of 8), points e - 1 and e are made one point; so are 0 and m - 1; and one
    point is copied to every index 3 + 64 k, across all warps and slices.
    One query sits 0.1 mm from each such point. In every fourth pair the
    lower copy is invalid, so the upper one must win.
    """
    rng = np.random.default_rng(seed)
    d = _lattice(rng, m)
    dv = np.ones(m, bool)
    groups = [[0, m - 1]] + [[e - 1, e] for e in range(8, m, 8) if e != m - 1]
    groups.append(list(range(3, m, 64)))
    groups = [g for g in groups if len(set(g)) > 1]
    q, expect = [], []
    for k, g in enumerate(groups):
        d[g] = d[g[0]]
        if k % 4 == 3 and len(g) == 2:
            dv[g[0]] = False
        expect.append(min(j for j in g if dv[j]))
        q.append(d[g[0]] + np.float32(1e-4) * rng.normal(size=3).astype(np.float32))
    q = np.asarray(q, np.float32)
    return (q, np.ones(len(q), bool), d, dv), np.asarray(expect, np.int64)


def nn_negative_d2(n: int = 512, m: int = 4096, seed: int = 1) -> tuple[NNCase, np.ndarray]:
    """Queries 10 um from data points 0.5 m out, where the expanded squared
    distance of that pair (~1e-10) rounds to about +-6e-8, often below zero;
    every other point is more than 8 mm away, so that pair is the neighbour
    under any rounding. Returns the case and each query's index."""
    rng = np.random.default_rng(seed)
    d = _lattice(rng, m)
    idx = rng.choice(m, size=n, replace=False).astype(np.int64)
    q = d[idx] + np.float32(1e-5) * rng.normal(size=(n, 3)).astype(np.float32)
    return (q, np.ones(n, bool), d, np.ones(m, bool)), idx


def expanded_d2(q: np.ndarray, d: np.ndarray) -> np.ndarray:
    """K1's selection distance in float32, in its order of operations:
    ``(q2 + b2) + ((qx bx' + qy by') + qz bz')`` with ``b' = -2 b``."""
    q2 = (q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1]) + q[:, 2] * q[:, 2]
    b2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    b = np.float32(-2.0) * d
    cross = (q[:, :1] * b[:, 0] + q[:, 1:2] * b[:, 1]) + q[:, 2:] * b[:, 2]
    return (q2[:, None] + b2) + cross


def nn_cases(seed: int = 1) -> dict[str, NNCase]:
    """Every K1 case by name: the main path's 4096 x 4096, the edge cases
    above, ragged sizes (1 x 1, M = 5 below the number of slices,
    129 x 4097, 1000 x 3000, 300 x 20000), masks, a 16k x 16k problem that
    streams its data through several tiles, and the sparse track step's
    300 x 300."""
    rng = np.random.default_rng(seed)
    ones = lambda n: np.ones(n, bool)  # noqa: E731
    mask = lambda n, p: rng.uniform(size=n) < p  # noqa: E731
    unit = lambda n: _cloud(rng, n, 1.0, 0.0)  # noqa: E731
    return {
        "4096x4096": (_cloud(rng, 4096), ones(4096), _cloud(rng, 4096), ones(4096)),
        "ties across split edges": nn_ties()[0],
        "negative d2 0.5 m out": nn_negative_d2()[0],
        "1x1": (unit(1), ones(1), unit(1), ones(1)),
        "37x5 (M below the slice count)": (unit(37), ones(37), unit(5), mask(5, 0.8)),
        "129x4097": (_cloud(rng, 129), ones(129), _cloud(rng, 4097), mask(4097, 0.9)),
        "ragged 1000x3000": (unit(1000), ones(1000), unit(3000), ones(3000)),
        "300x20000": (unit(300), mask(300, 0.9), unit(20000), mask(20000, 0.5)),
        "random invalid masks": (_cloud(rng, 4096), mask(4096, 0.8), _cloud(rng, 4096),
                                 mask(4096, 0.6)),
        "all data invalid": (_cloud(rng, 500), ones(500), _cloud(rng, 2000), np.zeros(2000, bool)),
        "16k x 16k invalid masks": (_cloud(rng, 16384, 0.2), mask(16384, 0.95),
                                    _cloud(rng, 16384, 0.2), mask(16384, 0.95)),
        "300x300 sparse track": (_cloud(rng, 300), mask(300, 0.95), _cloud(rng, 300),
                                 mask(300, 0.95)),
    }


# screen-space camera: a vertex (x z, y z, z) with z a power of two lands
# on pixel (x, y) exactly
_SCREEN = dict(fx=1.0, fy=1.0, cx=0.0, cy=0.0)


def _screen_mesh(tri_xy: np.ndarray, z: np.ndarray):
    """Triangles given in pixels (F, 3, 2) at depths z (F, 3), each a power
    of two, as camera-frame vertices and faces."""
    v = np.concatenate([tri_xy * z[..., None], z[..., None]], -1).reshape(-1, 3)
    f = np.arange(v.shape[0], dtype=np.int32).reshape(-1, 3)
    return v.astype(np.float32), f


def _depths(rng, n):
    return rng.choice(np.array([0.5, 1.0, 2.0, 4.0], np.float32), size=(n, 3))


def _edge_triangles(rng, n, H, W):
    """Triangles whose corners sit on, or one pixel or half a pixel off, the
    multiples of 8, spanning one to three tiles."""
    def coord(size, shape):
        k = rng.integers(0, size // 8 + 1, size=shape)
        return 8 * k + rng.choice(np.array([-1.0, -0.5, 0.0, 0.5, 1.0]), size=shape)

    corner = np.stack([coord(W, n), coord(H, n)], -1)[:, None, :]
    span = (8.0 * rng.integers(1, 4, size=(n, 2, 2)) - rng.choice(
        np.array([0.0, 1.0]), size=(n, 2, 2))) * rng.choice(np.array([-1.0, 1.0]), size=(n, 2, 1))
    tri = np.concatenate([corner, corner + span * [[1, 0], [0, 1]]], 1)
    return tri.astype(np.float32)


def _random_triangles(rng, n, H, W, size=12.0):
    c = rng.uniform([0, 0], [W, H], size=(n, 1, 2))
    return (c + rng.uniform(-size, size, size=(n, 3, 2))).astype(np.float32)


def raster_cases(seed: int = 2) -> dict[str, dict]:
    """Every K2 edge case by name, as ``dict(vertices, faces, T, intr, H, W)``
    for ``face_coeffs(vertices, faces, T, intr, near=0.01)``:

    * boxes ending exactly on, and one or half a pixel off, the tile edges;
    * a chunk of 32 faces none of which touches the window, then a chunk all
      of whose faces cover it whole, then a ragged tail;
    * a 61 x 45 window (neither side a multiple of the tile);
    * the 4096-face icosphere over the 320 x 240 half-resolution frame;
    * a template view of the bench box: its 12 faces over a full 640 x 480
      frame from twice its diagonal, as the template database renders it;
    * the L-shape's 24 faces padded to 256 over a full 640 x 480 frame from
      twice its diagonal along (1, 1, 1), as the tracking scene's mesh camera
      renders it.
    """
    rng = np.random.default_rng(seed)
    eye = np.eye(4, dtype=np.float32)
    out = {}

    H, W = 64, 64
    tri = _edge_triangles(rng, 300, H, W)
    v, f = _screen_mesh(tri, _depths(rng, len(tri)))
    out["boxes on tile edges"] = dict(vertices=v, faces=f, T=eye, H=H, W=W)

    H, W = 48, 40
    away = _random_triangles(rng, 32, H, W) + np.float32(1000.0)
    whole = np.broadcast_to(np.array([[-64, -64], [256, -64], [-64, 256]], np.float32),
                            (32, 3, 2)).copy()
    tail = _random_triangles(rng, 39, H, W)
    tri = np.concatenate([away, whole, tail])
    v, f = _screen_mesh(tri, _depths(rng, len(tri)))
    out["empty chunk, full chunk, ragged tail"] = dict(vertices=v, faces=f, T=eye, H=H, W=W)

    H, W = 45, 61
    tri = np.concatenate([_random_triangles(rng, 150, H, W), _edge_triangles(rng, 50, H, W)])
    v, f = _screen_mesh(tri, _depths(rng, len(tri)))
    out["61x45 window"] = dict(vertices=v, faces=f, T=eye, H=H, W=W)

    for case in out.values():
        case["intr"] = Intrinsics(**_SCREEN, width=case["W"], height=case["H"])

    sv, sf = make_icosphere(0.1, 4)
    T = np.eye(4, dtype=np.float32)
    T[2, 3] = 0.45
    intr = Intrinsics.from_fov(60.0, 640, 480).scaled(2)
    out["icosphere 4096 faces, 240x320 frame"] = dict(
        vertices=sv, faces=sf[:4096], T=T, intr=intr, H=intr.height, W=intr.width)

    bv = box_vertices()
    eye_dir = np.array([0.0, 1.0, 1.0]) / np.sqrt(2.0)
    dist = 2.0 * float(np.linalg.norm(bv.max(0) - bv.min(0)))
    T = GL_TO_CV @ look_at(eye_dir * dist, np.zeros(3), [0.0, 1.0, 0.0]).numpy()
    intr = Intrinsics.from_fov(60.0, 640, 480)
    out["bench box template view, 480x640 frame"] = dict(
        vertices=bv, faces=BOX_FACES, T=T.astype(np.float32), intr=intr, H=480, W=640)

    lv, lf = lshape_mesh()
    eye_dir = np.ones(3) / np.sqrt(3.0)
    dist = 2.0 * float(np.linalg.norm(lv.max(0) - lv.min(0)))
    T = GL_TO_CV @ look_at(eye_dir * dist, np.zeros(3), [0.0, 1.0, 0.0]).numpy()
    out["L-shape 24 faces (256 padded), 480x640 frame"] = dict(
        vertices=lv, faces=pad_faces(lf, 256), T=T.astype(np.float32), intr=intr, H=480, W=640)
    return out


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """``a`` with rows of zeros (False) appended up to ``n``."""
    return np.concatenate([a, np.zeros((n - len(a),) + a.shape[1:], a.dtype)])


def stack_nn_problems(problems: list) -> NNCase:
    """K1 problems of any sizes as one batch: each padded with invalid
    points (zeros) to the common N and M."""
    n = max(len(p[0]) for p in problems)
    m = max(len(p[2]) for p in problems)
    return tuple(np.stack([_pad_rows(p[k], n if k < 2 else m) for p in problems])
                 for k in range(4))


def nn_batched_cases(seed: int = 3) -> dict[str, tuple[NNCase, list]]:
    """Batched K1 cases by name, as ``(batch, sizes)``: the batch (B, N, 3) /
    (B, N) / (B, M, 3) / (B, M) and each problem's own ``(n, m)``.

    * a ragged batch: 129 x 4097, 37 x 5, 1 x 1 and a problem whose data
      are all invalid, padded to 500 x 4097 (each problem's found flags
      must follow its own data's validity);
    * three 4096 x 4096 problems with their own clouds, the dense
      multi-object step's shape;
    * three 300 x 300 problems, the sparse step's.
    """
    rng = np.random.default_rng(seed)
    base = nn_cases(seed)
    mask = lambda n, p: rng.uniform(size=n) < p  # noqa: E731
    ragged = [base["129x4097"], base["37x5 (M below the slice count)"], base["1x1"],
              base["all data invalid"]]
    dense = [(_cloud(rng, 4096), mask(4096, 0.9), _cloud(rng, 4096), mask(4096, 0.9))
             for _ in range(3)]
    sparse = [(_cloud(rng, 300), mask(300, 0.95), _cloud(rng, 300), mask(300, 0.95))
              for _ in range(3)]
    return {name: (stack_nn_problems(ps), [(len(p[0]), len(p[2])) for p in ps])
            for name, ps in (("ragged with an all-invalid problem", ragged),
                             ("3 x 4096x4096", dense), ("3 x 300x300", sparse))}


def multi_object_poses(n_obj: int, diag: float, angle: float) -> np.ndarray:
    """(n_obj, 4, 4) poses of the multi-object scene of the JAX package's
    tracking evaluation (``_run_multi_mode``) at turn ``angle``: instance i
    seen from ``diag * (2.3 + 0.12 i)`` along (1, 1, 1) (up +Y), turned
    ``0.1 + 1.1 i + angle`` about the camera's z and shifted
    ``(i - (n_obj - 1) / 2) * 0.65 diag`` along its x."""
    eye_dir = np.ones(3) / np.sqrt(3.0)
    out = []
    for i in range(n_obj):
        base = GL_TO_CV @ look_at(eye_dir * diag * (2.3 + 0.12 * i), np.zeros(3),
                                  [0.0, 1.0, 0.0]).numpy()
        a = 0.1 + 1.1 * i + angle
        P = np.eye(4)
        P[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        T = (P @ base).astype(np.float32)
        T[0, 3] += (i - (n_obj - 1) / 2) * 0.65 * diag
        out.append(T)
    return np.stack(out)


def raster_batched_cases() -> dict[str, dict]:
    """Batched K2 cases by name, as ``dict(vertices, faces, T, origin, intr,
    H, W)`` for the batched ``face_coeffs(vertices, faces, T, intr,
    near=0.01, origin=origin)``: per-problem poses (B, 4, 4) and window
    origins (B, 2) at the 320 x 240 half-resolution view of the tracking
    camera, on

    * a mixed-class stack, classes (0, 1, 0): the L-shape (16 vertices, 24
      faces) and a 0.5 x 0.3 x 0.2 box (8 vertices, 12 faces, padded with
      degenerate faces), the rows gathered per problem;
    * eight poses of the L-shape padded to 256 faces, the largest batch of
      the multi-object step.
    """
    intr = Intrinsics.from_fov(60.0, 640, 480).scaled(2)
    lv, lf = lshape_mesh()
    diag = float(np.linalg.norm(lv.max(0) - lv.min(0)))

    def poses(n):
        return multi_object_poses(n, diag, 0.0)

    def origins(Ts, h, w):  # each window around its object, as the track step places it
        import torch

        from .pipeline.window import window_origin

        return np.stack([window_origin(torch.from_numpy(lv), torch.from_numpy(T), intr, h,
                                       w).numpy() for T in Ts])

    from .pipeline.multi_tracking import stack_class_meshes

    vs, fs = stack_class_meshes([(lv, pad_faces(lf, 256)), box_mesh((0.5, 0.3, 0.2))])
    rows = np.array([0, 1, 0])
    lfp = pad_faces(lf, 256).astype(np.int64)
    return {
        "mixed-class stack (0, 1, 0), 128x256 window": dict(
            vertices=vs[rows], faces=fs[rows], T=poses(3), origin=origins(poses(3), 128, 256),
            intr=intr, H=128, W=256),
        "8 x L-shape, 192x256 window": dict(
            vertices=lv, faces=lfp, T=poses(8), origin=origins(poses(8), 192, 256), intr=intr,
            H=192, W=256),
    }


# --- BOP scenes: the offline path's inputs ------------------------------------


def bop_scene_poses(dist: float = 2.0, angles=(0.12, 0.2, 0.28)) -> list[np.ndarray]:
    """The scene-sweep poses of the JAX package's BOP tests: a camera
    ``dist`` (m) from the object along (1, 1, 1) looking at it, turned about
    its optical axis by each angle (rad). (4, 4) float32 model-to-camera."""
    d = np.ones(3) / np.sqrt(3.0)
    T_cv = GL_TO_CV @ look_at(d * dist, [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]).numpy()
    out = []
    for a in angles:
        P = np.eye(4, dtype=np.float32)
        P[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        out.append((P @ T_cv).astype(np.float32))
    return out


def write_bop_scene(scene_dir: str, vertices: np.ndarray, faces: np.ndarray, intr: Intrinsics,
                    poses, obj_id: int = 1, symmetries=None, device="cpu") -> None:
    """A canonical BOP scene of one object: per pose (metres) the exact
    triangle-raster depth (``depth/NNNNNN.png``, uint16 mm), its silhouette
    (``mask_visib/NNNNNN_000000.png``) and a flat-coloured RGB
    (``rgb/NNNNNN.png``), with ``scene_camera.json`` and ``scene_gt.json``
    (mm); and ``models_info.json`` (BOP keeps it beside the CAD: pass it
    with ``--models-info``) with the object's diameter and ``symmetries``
    ((S, 4, 4), metres) as ``symmetries_discrete`` in mm.
    The depth renders through K2 on a CUDA ``device``."""
    import json
    import os

    import torch

    from .render.raster import render_depth_mesh
    from .utils.png import write_png

    for sub in ("depth", "rgb", "mask_visib"):
        os.makedirs(os.path.join(scene_dir, sub), exist_ok=True)
    mesh_v = torch.from_numpy(np.asarray(vertices, np.float32)).to(device)
    mesh_f = torch.from_numpy(pad_faces(faces, -(-len(faces) // 256) * 256).astype(np.int64))
    mesh_f = mesh_f.to(device)
    cam, gt = {}, {}
    for i, T in enumerate(poses):
        depth = render_depth_mesh(mesh_v, mesh_f, torch.from_numpy(np.asarray(T)).to(device),
                                  intr, near=0.01, far=10.0).cpu().numpy()
        stem = f"{i:06d}"
        write_png(os.path.join(scene_dir, "depth", f"{stem}.png"),
                  (depth * 1000.0).astype(np.uint16))
        rgb = np.full((intr.height, intr.width, 3), 30, np.uint8)
        rgb[depth > 0] = (200, 160, 90)
        write_png(os.path.join(scene_dir, "rgb", f"{stem}.png"), rgb)
        write_png(os.path.join(scene_dir, "mask_visib", f"{stem}_000000.png"),
                  ((depth > 0) * 255).astype(np.uint8))
        cam[str(i)] = {"cam_K": [intr.fx, 0, intr.cx, 0, intr.fy, intr.cy, 0, 0, 1],
                       "depth_scale": 1.0}
        T_mm = np.asarray(T, np.float64).copy()
        T_mm[:3, 3] *= 1000.0
        gt[str(i)] = [{"cam_R_m2c": T_mm[:3, :3].reshape(-1).tolist(),
                       "cam_t_m2c": T_mm[:3, 3].tolist(), "obj_id": obj_id}]
    with open(os.path.join(scene_dir, "scene_camera.json"), "w") as f:
        json.dump(cam, f)
    with open(os.path.join(scene_dir, "scene_gt.json"), "w") as f:
        json.dump(gt, f)
    v = np.asarray(vertices, np.float64)
    info = {"diameter": float(np.linalg.norm(v.max(0) - v.min(0))) * 1000.0}
    if symmetries is not None:
        syms = []
        for S in np.asarray(symmetries, np.float64):
            S_mm = S.copy()
            S_mm[:3, 3] *= 1000.0
            syms.append(S_mm.reshape(-1).tolist())
        info["symmetries_discrete"] = syms
    with open(os.path.join(scene_dir, "models_info.json"), "w") as f:
        json.dump({str(obj_id): info}, f)


def nn_offline_cases(n_tpl: int = 10_000, n_down: int = 400, n_obs: int = 16_384,
                     n_cand: int = 5, seed: int = 4) -> dict:
    """K1 at the offline path's shapes, on a template-like cloud 2 m out
    (``n_tpl`` points), its observation (``n_obs`` rows, about a tenth
    valid as a masked frame's sample is) and a farthest-point-like subset
    of it (``n_down``): the Chamfer ranking of ``n_cand`` candidate poses
    (all candidates' points as one query set against the subset, and the
    subset against each candidate as one batched problem) and the full
    Chamfer (template against observation and back). Unbatched cases map
    a name to (q, qv, d, dv); the batched one to the (B, N, 3) / (B, M, 3)
    stack."""
    rng = np.random.default_rng(seed)
    tpl = _cloud(rng, n_tpl, scale=0.15, center=2.0)
    obs = np.zeros((n_obs, 3), np.float32)
    n_val = n_obs // 10
    obs[:n_val] = _cloud(rng, n_val, scale=0.15, center=2.0)
    obs_v = np.arange(n_obs) < n_val
    down = obs[rng.choice(n_val, n_down, replace=False)]
    cands = np.stack([tpl + rng.normal(size=3).astype(np.float32) * 0.01
                      for _ in range(n_cand)])
    ones = lambda n: np.ones(n, bool)  # noqa: E731
    return {
        f"rank {n_cand * n_tpl}x{n_down}": (cands.reshape(-1, 3), ones(n_cand * n_tpl), down,
                                            ones(n_down)),
        f"full {n_tpl}x{n_obs}": (tpl, ones(n_tpl), obs, obs_v),
        f"full {n_obs}x{n_tpl}": (obs, obs_v, tpl, ones(n_tpl)),
        f"rank batched {n_cand} x {n_down}x{n_tpl}": (
            np.broadcast_to(down, (n_cand, n_down, 3)).copy(), np.ones((n_cand, n_down), bool),
            cands, np.ones((n_cand, n_tpl), bool)),
    }
