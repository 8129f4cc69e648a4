"""Template database on disk and its padded stack on the device
(counterpart of ``poseestimator_tpu/templates/db.py``): the ``*.ply`` files
of the template directory sorted by name, rendered from the CAD first when
there are none, stacked into ``(T, N_max, 3)`` with a validity mask, N_max
the largest template rounded up to a multiple of 1024."""
from __future__ import annotations

import glob
import os
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..geom3d.cloud import PointCloud
from ..utils.plyio import read_ply
from .creation import render_templates


@dataclass
class TemplateDB:
    points: torch.Tensor  # (T, N_max, 3)
    valid: torch.Tensor  # (T, N_max)
    paths: list[str]

    @property
    def count(self) -> int:
        return self.points.shape[0]

    def cloud(self, i: int) -> PointCloud:
        return PointCloud(points=self.points[i], valid=self.valid[i])


def load_templates(pcd_path: str, cad_path: str, capacity: int | None = None,
                   view_set: str = "reduced", device: str | torch.device = "cuda") -> TemplateDB:
    """Load the template database, rendering it first if it is missing or
    was rendered for another view set (the ``view_set.txt`` sidecar).
    ``capacity``: padded points per template."""
    dev = resolve_device(device)
    ply_files = sorted(glob.glob(os.path.join(pcd_path, "*.ply")))
    sidecar = os.path.join(pcd_path, "view_set.txt")
    if ply_files and os.path.exists(sidecar):
        with open(sidecar) as f:
            have = f.read().strip()
        if have != view_set:
            # a database rendered for another view set: drop only the
            # rendered files and render again
            for pat in ("pcd_cam_*.ply", "rgb_*.png"):
                for p in glob.glob(os.path.join(pcd_path, pat)):
                    os.remove(p)
            os.remove(sidecar)
            ply_files = sorted(glob.glob(os.path.join(pcd_path, "*.ply")))
    if not ply_files:
        render_templates(cad_path, pcd_path, view_set=view_set, device=dev)
        ply_files = sorted(glob.glob(os.path.join(pcd_path, "*.ply")))
    if not ply_files:
        raise FileNotFoundError(f"no templates in {pcd_path} and rendering produced none")
    expected = {"reduced": 5, "full": 26}.get(view_set)
    if expected is not None and len(ply_files) != expected and not os.path.exists(sidecar):
        warnings.warn(f"{pcd_path}: {len(ply_files)} templates found but view_set="
                      f"{view_set!r} implies {expected}; loading the files as-is", stacklevel=2)

    clouds = []
    for f in ply_files:
        v = read_ply(f).vertices
        if len(v) == 0:
            raise ValueError(f"Empty point cloud: {f}")
        clouds.append(v)
    n_max = max(len(c) for c in clouds)
    if capacity is None:
        capacity = -(-n_max // 1024) * 1024
    if capacity < n_max:
        raise ValueError(f"capacity {capacity} < largest template {n_max}")
    pts = np.zeros((len(clouds), capacity, 3), np.float32)
    val = np.zeros((len(clouds), capacity), bool)
    for i, c in enumerate(clouds):
        pts[i, : len(c)] = c
        val[i, : len(c)] = True
    return TemplateDB(points=torch.from_numpy(pts).to(dev), valid=torch.from_numpy(val).to(dev),
                      paths=ply_files)
