"""Template-axis parallel registration: the product search distributed over
a mesh (counterpart of ``poseestimator_tpu/parallel/registration.py``).

Each rank scores its slice of templates against the replicated
observation with the same ``pipeline.pose_estimator._score_templates`` the
single-device search runs, and the results are all-gathered. Each rank
draws the search's random numbers whole and takes its templates' share, so
the scores do not depend on the partition.

Entry points: ``PoseEstimator(..., mesh_devices=mesh)``, and
``sharded_template_search`` below on raw tensors.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..geom3d.camera import Intrinsics
from ..geom3d.cloud import PointCloud
from ..geom3d.se3 import look_at
from ..pipeline.pose_estimator import _extract_fpfh, _search_templates_sharded
from ..render.points import render_depth
from .mesh import Mesh


def sharded_template_search(mesh: Mesh, dst_points, dst_valid, tpl_points, tpl_valid,
                            tpl_fpfh, cad_points, cad_valid, intr: Intrinsics,
                            generator: Optional[torch.Generator] = None, mask_sil=None,
                            voxel: float = 0.05, axis: str = "tp", cad_faces=None,
                            draws: Optional[dict] = None):
    """The product template search (5 hypotheses a template, coarse ICP,
    render-ICP polish, depth and silhouette scores) with the template axis
    (T divisible by the mesh size) sharded over ``axis``. Returns ``(H_pre
    (T, 4, 4), H_ref (T, 4, 4), scores (T,))`` on every rank; the argmin is
    the caller's. ``generator`` (on the mesh's device; default seed 0) or
    ``draws`` supply the random numbers, as in ``search_templates``.

    ``cad_faces`` switches the predicted views to the exact triangle raster
    (``cad_points`` is then the vertex array); without it the point splat
    renders ``(cad_points, cad_valid)``, the mode of point-cloud CADs like
    the synthetic fixtures below."""
    dev = mesh.device
    t = lambda a, dt: torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,  # noqa: E731
                                      dtype=dt).to(dev)
    have_mask = mask_sil is not None
    mask = (torch.zeros((intr.height, intr.width), dtype=torch.bool, device=dev)
            if mask_sil is None else t(mask_sil, torch.bool))
    if cad_faces is not None:
        render = ("mesh", t(cad_points, torch.float32), t(cad_faces, torch.int64))
    else:
        render = ("points", t(cad_points, torch.float32), t(cad_valid, torch.bool))
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return _search_templates_sharded(
        mesh, t(dst_points, torch.float32), t(dst_valid, torch.bool),
        t(tpl_points, torch.float32), t(tpl_valid, torch.bool), t(tpl_fpfh, torch.float32),
        *render, intr, mask, have_mask, voxel, generator, axis=axis, draws=draws)


def make_synthetic_search_inputs(n_tpl: int = 8, C: int = 256, n_cad: int = 3000,
                                 seed: int = 0, intr: Optional[Intrinsics] = None,
                                 good_idx: int = 3, device="cuda") -> dict:
    """Inputs for the (sharded) product search without CAD files: an
    L-shaped model-frame point blob observed 1.2 m out, the matching
    template at ``good_idx`` (clamped to ``n_tpl - 1``), decoys (rods,
    plates, cube shells) elsewhere, and the observed silhouette as the
    detection mask. Numpy from ``seed``, as the JAX package's fixture draws
    it; tensors on ``device`` (default the card). Returns the keyword arguments of
    ``sharded_template_search`` (no mesh, no generator) plus ``"T_gt"``
    (numpy) and ``"good_idx"``. The meaningful check is the winner's pose
    (ADD of ``H_ref[argmin scores]`` against ``T_gt``), not its index."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    if intr is None:
        intr = Intrinsics.from_fov(60.0, 128, 96)

    def blob(r, n):
        a = r.uniform([-0.15, -0.05, -0.05], [0.15, 0.05, 0.05], (n // 2, 3))
        b = r.uniform([-0.15, -0.05, -0.05], [-0.05, 0.25, 0.05], (n - n // 2, 3))
        return np.concatenate([a, b]).astype(np.float32)

    def decoy(r, n, kind):
        if kind == 0:  # thin rod
            return r.uniform([-0.3, -0.02, -0.02], [0.3, 0.02, 0.02], (n, 3)).astype(np.float32)
        if kind == 1:  # flat plate
            return r.uniform([-0.2, -0.2, -0.01], [0.2, 0.2, 0.01], (n, 3)).astype(np.float32)
        p = r.uniform(-0.12, 0.12, (n, 3)).astype(np.float32)  # hollow cube shell
        ax = r.integers(0, 3, n)
        sgn = np.where(r.random(n) < 0.5, -0.12, 0.12).astype(np.float32)
        p[np.arange(n), ax] = sgn
        return p

    cad = blob(rng, n_cad)
    # the true pose: 1.2 m out along (1, 1, 1), OpenGL look-at to OpenCV
    F = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    d = np.array([1.0, 1.0, 1.0]) / np.sqrt(3)
    T_gt = (F @ look_at(d * 1.2, [0, 0, 0], [0, 1, 0]).numpy()).astype(np.float32)
    dst = (cad @ T_gt[:3, :3].T + T_gt[:3, 3]).astype(np.float32)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    obs_depth = render_depth(as_t(dst), torch.ones(len(dst), dtype=torch.bool, device=device),
                             torch.eye(4, device=device), intr, near=0.01, far=5.0)
    good_idx = min(good_idx, n_tpl - 1)
    tpls, valids, fpfhs = [], [], []
    for t in range(n_tpl):
        if t == good_idx:
            pts = cad[rng.choice(n_cad, C, replace=False)]
        else:
            pts = decoy(np.random.default_rng(seed + 100 + t), C, t % 3)
        cl = PointCloud(points=as_t(pts), valid=torch.ones(C, dtype=torch.bool, device=device))
        cl, f = _extract_fpfh(cl, 0.05, outward=True)
        tpls.append(cl.points)
        valids.append(cl.valid)
        fpfhs.append(f)
    ones = lambda n: torch.ones(n, dtype=torch.bool, device=device)  # noqa: E731
    return {"dst_points": as_t(dst), "dst_valid": ones(len(dst)),
            "tpl_points": torch.stack(tpls), "tpl_valid": torch.stack(valids),
            "tpl_fpfh": torch.stack(fpfhs), "cad_points": as_t(cad), "cad_valid": ones(n_cad),
            "intr": intr, "mask_sil": obs_depth > 0, "T_gt": T_gt, "good_idx": good_idx}

