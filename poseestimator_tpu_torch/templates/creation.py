"""Template database generation (counterpart of
``poseestimator_tpu/templates/creation.py``): render canonical views of a
CAD mesh with the exact triangle raster (kernel K2 on the card) and
back-project each to a point-cloud template in the model frame.

The disk contract is the JAX package's, so either package loads a database
the other wrote: ``pcd_cam_{i:02d}_{type}.ply`` (at most 10k points) and
``rgb_{i:02d}_{type}.png`` per view, and a ``view_set.txt`` sidecar. The CAD
is scaled from millimetres to metres when its extent reaches 1, centred at
its vertex mean, and viewed from twice its bounding-box diagonal by a 640x480
camera with a 60 degree field of view.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..geom3d.camera import Intrinsics, backproject_depth
from ..geom3d.sampling import random_sample
from ..geom3d.se3 import inv_T, look_at, transform_points
from ..render.mesh import TriangleMesh, decimate_to_faces
from ..render.raster import render_depth_mesh, shade_depth_image
from ..utils.plyio import write_ply
from ..utils.png import write_png

# OpenGL camera (look_at output, -z forward) to vision camera (+z forward)
_GL_TO_CV = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)

TEMPLATE_IMAGE_SIZE = (640, 480)
TEMPLATE_FOV_DEG = 60.0
TEMPLATE_MAX_POINTS = 10_000
TEMPLATE_FACE_CAP = 16_384


def _positions_from_dirs(dirs, distance):
    out = []
    for d, name in dirs:
        d = np.asarray(d, np.float64)
        d = d / np.linalg.norm(d)
        # up +Y, except at the poles where +Y is degenerate
        up = np.array([0.0, 0.0, 1.0]) if abs(d[1]) > 0.99 else np.array([0.0, 1.0, 0.0])
        out.append({"eye": d * distance, "target": np.zeros(3), "up": up, "type": name})
    return out


def get_reduced_camera_positions(distance: float):
    """The reference's 5 views: 3 edge and 2 corner directions of the view
    cube, target at the origin."""
    dirs = [([0.0, 1.0, 1.0], "6"), ([0.0, -1.0, 1.0], "7"), ([1.0, 0.0, 1.0], "8"),
            ([1.0, 1.0, 1.0], "11"), ([1.0, -1.0, 1.0], "12")]
    return _positions_from_dirs(dirs, distance)


def get_full_camera_positions(distance: float):
    """26 views: the 6 faces, 12 edges and 8 corners of the view cube."""
    dirs = []
    for x in (-1, 0, 1):
        for y in (-1, 0, 1):
            for z in (-1, 0, 1):
                if x == y == z == 0:
                    continue
                dirs.append(([float(x), float(y), float(z)], f"f{len(dirs)}"))
    return _positions_from_dirs(dirs, distance)


VIEW_SETS = {"reduced": get_reduced_camera_positions, "full": get_full_camera_positions}


@torch.no_grad()
def render_templates(mesh_path: str, output_dir: str, seed: int = 0, view_set: str = "reduced",
                     device: str | torch.device = "cuda") -> list[str]:
    """Write the template database of ``mesh_path`` into ``output_dir``;
    returns the written .ply paths in view order."""
    if not os.path.exists(mesh_path):
        raise FileNotFoundError(f"Could not find {mesh_path}")
    dev = resolve_device(device)
    mesh = TriangleMesh.load(mesh_path)
    if np.max(mesh.extent) >= 1.0:  # millimetres -> metres
        mesh = mesh.scale(0.001, center=np.zeros(3))
    distance = float(np.linalg.norm(mesh.extent)) * 2.0
    center = mesh.get_center()
    mesh = mesh.translate(-center)
    rmesh = decimate_to_faces(mesh, TEMPLATE_FACE_CAP)
    mesh_v = torch.from_numpy(rmesh.vertices).to(dev)
    mesh_f = torch.from_numpy(rmesh.faces.astype(np.int64)).to(dev)

    w, h = TEMPLATE_IMAGE_SIZE
    intr = Intrinsics.from_fov(TEMPLATE_FOV_DEG, w, h)
    near, far = 0.001, distance * 3.0
    gl_to_cv = torch.from_numpy(_GL_TO_CV).to(dev)
    center_t = torch.from_numpy(np.asarray(center, np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    os.makedirs(output_dir, exist_ok=True)
    written = []
    for i, cam in enumerate(VIEW_SETS[view_set](distance)):
        T_cv = gl_to_cv @ look_at(cam["eye"], cam["target"], cam["up"]).to(dev)  # world -> vision cam
        depth = render_depth_mesh(mesh_v, mesh_f, T_cv, intr, near=near, far=far)
        cloud = backproject_depth(depth, intr, depth_min=near, depth_max=far)
        # sampled from the full back-projection: a compaction first would
        # keep only the raster top of close-up views
        cloud = random_sample(cloud, TEMPLATE_MAX_POINTS, gen)
        pts = transform_points(inv_T(T_cv), cloud.points) + center_t  # back to the model frame
        name = f"{i:02d}_{cam['type']}"
        ply_path = os.path.join(output_dir, f"pcd_cam_{name}.ply")
        write_ply(ply_path, pts[cloud.valid].cpu().numpy())
        written.append(ply_path)
        rgb = shade_depth_image(depth, intr).cpu().numpy()
        write_png(os.path.join(output_dir, f"rgb_{name}.png"),
                  (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
    # the sidecar names the view set, so a request for another set re-renders
    with open(os.path.join(output_dir, "view_set.txt"), "w") as f:
        f.write(view_set + "\n")
    return written


# synthetic depth-noise injectors: fault-injection fixtures for tests


def add_depth_noise(depth, sigma: float = 0.002, prob_missing: float = 0.0,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Gaussian depth noise plus optional random dropouts (holes), clipped
    at 0; float32. Draws from ``rng`` (default: seeded 0) as the JAX package
    does, so both give the same array from the same generator state."""
    rng = rng or np.random.default_rng(0)
    d = np.asarray(depth, np.float32)
    noisy = d + rng.normal(0.0, sigma, d.shape)
    if prob_missing > 0:
        noisy = np.where(rng.random(d.shape) < prob_missing, 0.0, noisy)
    return np.clip(noisy, 0.0, None).astype(np.float32)


def add_depth_dependent_noise(depth, base_sigma: float = 0.001,
                              rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Noise whose sigma grows with the square of the depth (a stereo
    camera's error model), clipped at 0; float32."""
    rng = rng or np.random.default_rng(0)
    d = np.asarray(depth, np.float32)
    noisy = d + rng.normal(0.0, 1.0, d.shape) * (base_sigma * d * d)
    return np.clip(noisy, 0.0, None).astype(np.float32)
