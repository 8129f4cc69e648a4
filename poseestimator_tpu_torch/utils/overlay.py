"""Host-side visualisation (counterpart of
``poseestimator_tpu/utils/overlay.py``): the CAD's projection with its axes
drawn into a BGR image, correspondence lines between two projected clouds,
and the green per-stage timer line. The projection is the port's
``project_points`` on the CPU; the drawing is ``utils/draw.py``'s cv2-free
copy of OpenCV's dots (``cv2.circle``, filled) and lines (``cv2.line``,
LINE_8), so the pixels are the JAX package's.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..geom3d.camera import project_points
from . import draw

_GREEN, _RESET = "\x1b[32m", "\x1b[0m"  # colorama's Fore.GREEN and Style.RESET_ALL


def timer_print(start_time: float, label: str) -> float:
    """Print ``label: <seconds since start_time>`` in green; returns the
    seconds."""
    elapsed = time.time() - start_time
    print(f"{_GREEN}  {label}: {elapsed:.3f}s{_RESET}")
    return elapsed


def _project(points, K, T):
    """Pixels (truncated toward zero, as numpy's ``astype(int)``) and the
    in-front flags of (N, 3) points under T, in float32 on the CPU."""
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    uv, front = project_points(f32(points), f32(K), f32(T))
    return uv.numpy().astype(int), front.numpy()


def draw_correspondences(color: np.ndarray, src_pts: np.ndarray, dst_pts: np.ndarray,
                         corr_mask: np.ndarray, K: np.ndarray, T_src=None,
                         max_lines: int = 200) -> np.ndarray:
    """Green lines from the projected ``src_pts`` (moved by ``T_src``) to
    their matched ``dst_pts``, a red dot at the source end and a blue one
    at the destination, for pairs where ``corr_mask`` holds and both ends
    are in front of the camera and in the image; at most ``max_lines``.
    Draws in place and returns the image."""
    T_src = np.eye(4, dtype=np.float32) if T_src is None else np.asarray(T_src)
    uv_s, f_s = _project(src_pts, K, T_src)
    uv_d, f_d = _project(dst_pts, K, np.eye(4, dtype=np.float32))
    ok = np.asarray(corr_mask) & f_s & f_d
    h, w = color.shape[:2]
    drawn = 0
    for i in np.flatnonzero(ok):
        a, b = uv_s[i], uv_d[i]
        if 0 <= a[0] < w and 0 <= a[1] < h and 0 <= b[0] < w and 0 <= b[1] < h:
            draw.line(color, a, b, (0, 255, 0), 1)
            draw.circle(color, a, 2, (0, 0, 255))
            draw.circle(color, b, 2, (255, 0, 0))
            drawn += 1
            if drawn >= max_lines:
                break
    return color


def draw_model_projection_with_axes(color: np.ndarray, cad_points: np.ndarray, K: np.ndarray,
                                    T_m2c: np.ndarray, axis_length: float = 0.05) -> np.ndarray:
    """Red dots at the projected CAD points and the model's axes (X red, Y
    green, Z blue, thickness 2) in the BGR image, in place (a copy when the
    image is not contiguous); returns the image."""
    if not color.flags["C_CONTIGUOUS"]:
        color = np.ascontiguousarray(color)
    uv, front = _project(cad_points, K, T_m2c)
    h, w = color.shape[:2]
    for (u, v), ok in zip(uv.tolist(), front.tolist()):
        if ok and 0 <= u < w and 0 <= v < h:
            draw.circle(color, (u, v), 1, (0, 0, 255))
    axes = np.array([[0, 0, 0], [axis_length, 0, 0], [0, axis_length, 0], [0, 0, axis_length]],
                    np.float32)
    auv, afront = _project(axes, K, T_m2c)
    if afront.all():
        o = auv[0]
        draw.line(color, o, auv[1], (0, 0, 255), 2)  # X red
        draw.line(color, o, auv[2], (0, 255, 0), 2)  # Y green
        draw.line(color, o, auv[3], (255, 0, 0), 2)  # Z blue
    return color
