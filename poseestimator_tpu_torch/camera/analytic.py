"""Closed-form ray-cast depth camera (the port's numpy copy of
``poseestimator_tpu/camera/analytic.py``): an observation instrument that
shares no code with the render stack. Per-pixel ray / axis-aligned-box
(slab) intersection in float64, exact up to rounding.

Convention (that of ``geom3d.backproject_depth``): pixel (u, v) samples the
ray through ((u - cx)/fx, (v - cy)/fy, 1); ``depth`` is the camera z of the
first hit.
"""
from __future__ import annotations

import numpy as np

from ..geom3d.camera import Intrinsics


def raycast_boxes_depth(intr: Intrinsics, T_m2c: np.ndarray, boxes) -> np.ndarray:
    """(H, W) float32 depth of a union of axis-aligned model-frame boxes
    ``[(center (3,), half (3,)), ...]`` under pose ``T_m2c``; 0 where no box
    is hit."""
    T = np.asarray(T_m2c, np.float64)
    R, t = T[:3, :3], T[:3, 3]
    H, W = intr.height, intr.width
    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    dirs_c = np.stack([(u - intr.cx) / intr.fx, (v - intr.cy) / intr.fy, np.ones_like(u)],
                      axis=-1)  # (H, W, 3), z-normalised
    # camera ray -> model frame: p_m(t) = R^T (t d_c - t_vec)
    o_m = -R.T @ t
    d_m = dirs_c @ R

    depth = np.full((H, W), np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_d = 1.0 / d_m
        for center, half in boxes:
            lo = np.asarray(center, np.float64) - np.asarray(half, np.float64)
            hi = np.asarray(center, np.float64) + np.asarray(half, np.float64)
            t1 = (lo - o_m) * inv_d
            t2 = (hi - o_m) * inv_d
            # parallel rays give (-inf, inf) inside a slab and an empty
            # interval outside; nan-max/min resolve 0 * inf on a slab face
            t_near = np.nanmax(np.minimum(t1, t2), axis=-1)
            t_far = np.nanmin(np.maximum(t1, t2), axis=-1)
            hit = (t_far >= t_near) & (t_far > 1e-9)
            t_enter = np.where(t_near > 1e-9, t_near, t_far)
            depth = np.where(hit, np.minimum(depth, t_enter), depth)
    return np.where(np.isfinite(depth), depth, 0.0).astype(np.float32)


def l_shape_boxes(scale: float = 1.0):
    """The evaluation L-shape as two fused boxes: full extents 0.6 x 0.2 x
    0.2 at the origin and 0.2 x 0.4 x 0.2 at (-0.2, 0.3, 0), times
    ``scale``."""
    s = float(scale)
    return [
        (np.array([0.0, 0.0, 0.0]) * s, np.array([0.3, 0.1, 0.1]) * s),
        (np.array([-0.2, 0.3, 0.0]) * s, np.array([0.1, 0.2, 0.1]) * s),
    ]


def make_lshape_raycaster(intr: Intrinsics, scale: float = 1.0):
    """``depth_fn`` for ``SyntheticCamera``: T_m2c -> (H, W) analytic depth of
    the L-shape."""
    boxes = l_shape_boxes(scale)

    def depth_fn(T_m2c: np.ndarray) -> np.ndarray:
        return raycast_boxes_depth(intr, T_m2c, boxes)

    return depth_fn
