"""The bench scene (counterpart of ``tools/_scene.py``): the bench box CAD
observed one camera-period motion delta from the tracked pose.

The per-frame programs are content-dependent (the ICP loops exit early), so
only the product operating point times truthfully: random clouds either
never converge and run to the iteration caps, or find no inliers and exit
at once. ``apps/profile_stages.py`` and ``apps/profile_search.py
--realistic`` build this scene, as the JAX package's profilers and its
``bench.py`` build theirs.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernel_cases as kc
from ..device import resolve_device

BOX_HALF = kc.BOX_HALF  # ~8 cm diagonal box CAD
N_SURFACE = 40_000  # surface samples of the box


@dataclass
class BenchScene:
    cad_pts: torch.Tensor  # (40k, 3) surface samples of the box
    cad_valid: torch.Tensor
    mesh_v: torch.Tensor  # raster assets of the box: vertices (8, 3), faces padded to 256
    mesh_f: torch.Tensor
    T0: torch.Tensor  # tracked pose (z = 0.5 m)
    T_obs: torch.Tensor  # T0 and one motion delta (0.01 rad, 2 mm and 1 mm)
    depth: torch.Tensor  # the observation at T_obs from the exact raster, (H, W)
    obj_sil: torch.Tensor  # depth > 0
    estimator: object  # PoseEstimator over the rendered 5-view template database
    dst_cloud: object  # the 4096-point sampled observation
    cad_ply: str


def box_surface(rng: np.random.Generator, n: int, half=BOX_HALF) -> np.ndarray:
    """Uniform samples on the box shell (the bench CAD)."""
    half = np.asarray(half, np.float32)
    face = rng.integers(0, 6, size=n)
    pts = rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32) * half[None, :]
    ax = face // 2
    pts[np.arange(n), ax] = np.where(face % 2 == 0, 1.0, -1.0).astype(np.float32) * half[ax]
    return pts


def box_mesh_arrays(half=BOX_HALF) -> tuple[np.ndarray, np.ndarray]:
    """(vertices (8, 3) float32, faces (12, 3) int32) of the bench box CAD."""
    return kc.box_vertices(half), kc.BOX_FACES.copy()


def motion_delta() -> np.ndarray:
    """One camera period of motion: 0.01 rad about z plus (2, 0, 1) mm."""
    c, s = np.cos(0.01), np.sin(0.01)
    d = np.eye(4, dtype=np.float32)
    d[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    d[:3, 3] = [0.002, 0.0, 0.001]
    return d


def make_light_scene(intr, rng: np.random.Generator | None = None, device="cuda"):
    """The scene without the template database (track-step profiling):
    ``(cad_pts, cad_valid, mesh_v, mesh_f, T0, T_obs, depth, obj_sil)`` on
    ``device``. The observation comes from the exact triangle raster (K2);
    ``mesh_v`` / ``mesh_f`` are the raster assets the predicted views
    take."""
    from ..render.mesh import pad_faces
    from ..render.raster import render_depth_mesh

    dev = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    cad_pts = torch.from_numpy(box_surface(rng, N_SURFACE)).to(dev)
    cad_valid = torch.ones(N_SURFACE, dtype=torch.bool, device=dev)
    verts, faces = box_mesh_arrays()
    mesh_v = torch.from_numpy(verts).to(dev)
    mesh_f = torch.from_numpy(pad_faces(faces, 256)).to(dev)
    T0 = np.eye(4, dtype=np.float32)
    T0[2, 3] = 0.5
    T_obs = torch.from_numpy(motion_delta() @ T0).to(dev)
    T0 = torch.from_numpy(T0).to(dev)
    depth = render_depth_mesh(mesh_v, mesh_f, T_obs, intr, near=0.01, far=5.0)
    return cad_pts, cad_valid, mesh_v, mesh_f, T0, T_obs, depth, depth > 0


def make_scene(intr, rng: np.random.Generator | None = None, device="cuda",
               work_dir: str | None = None) -> BenchScene:
    """The full scene: the box written as a PLY into ``work_dir`` (default:
    a new temporary directory), the port's ``PoseEstimator`` over its
    5-view database (rendered there on first use) and the observation
    sampled to 4096 points by a generator seeded 2."""
    from ..geom3d.camera import backproject_depth
    from ..geom3d.sampling import random_sample
    from ..pipeline.pose_estimator import PoseEstimator
    from ..utils.plyio import write_ply

    dev = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    (cad_pts, cad_valid, mesh_v, mesh_f, T0, T_obs, depth,
     sil) = make_light_scene(intr, rng, dev)
    work = work_dir or tempfile.mkdtemp(prefix="bench_scene_")
    os.makedirs(work, exist_ok=True)
    verts, faces = box_mesh_arrays()
    cad_ply = os.path.join(work, "box.ply")
    write_ply(cad_ply, verts, faces=faces)
    estimator = PoseEstimator(cad_ply, os.path.join(work, "views"), intr, device=dev)
    dst_cloud = random_sample(backproject_depth(depth, intr, depth_min=0.01, depth_max=5.0),
                              4096, torch.Generator(device=dev).manual_seed(2))
    return BenchScene(cad_pts=cad_pts, cad_valid=cad_valid, mesh_v=mesh_v, mesh_f=mesh_f, T0=T0,
                      T_obs=T_obs, depth=depth, obj_sil=sil, estimator=estimator,
                      dst_cloud=dst_cloud, cad_ply=cad_ply)
