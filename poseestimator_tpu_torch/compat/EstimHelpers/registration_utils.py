"""The reference's offline registration helpers (what its ``main_image``
consumes) on the port: numpy in, numpy out, computed on ``device`` (the
card unless the caller passes ``device="cpu"``). ``find_best_template_teaser``,
``get_pointcloud`` and ``load_camera_intrinsics`` are the port's own."""
import numpy as np

from ...geom3d import se3
from ...geom3d.metrics import chamfer_distance as _chamfer_distance
from ...pipeline.offline import find_best_template_teaser
from ...utils.bop import get_pointcloud, load_camera_intrinsics
from ...utils.metrics_log import TemplateMetrics
from .HelpersRealtime import _f32, as_cloud, cloud_resolution

__all__ = [
    "TemplateMetrics",
    "get_angular_error",
    "load_camera_intrinsics",
    "get_pointcloud",
    "find_best_template_teaser",
    "chamfer_distance",
    "initial_align_centroid_pca",
    "pca_axes",
    "centroid_of",
    "cloud_resolution",
]


def get_angular_error(R_exp, R_est, device="cuda") -> float:
    """Geodesic distance of two rotations, radians."""
    return float(se3.angular_error(_f32(R_exp, device), _f32(R_est, device)))


def chamfer_distance(src, dst, device="cuda") -> float:
    """Symmetric mean nearest-neighbour distance of two clouds."""
    return float(_chamfer_distance(as_cloud(src, device), as_cloud(dst, device)))


def centroid_of(pcd, device="cuda") -> np.ndarray:
    """Mean of the valid points."""
    return as_cloud(pcd, device).centroid().cpu().numpy()


def pca_axes(pcd, device="cuda"):
    """``(R (3, 3), s (3,))``: principal axes by decreasing variance (det
    +1) and the singular values."""
    c = as_cloud(pcd, device)
    R, s = se3.pca_axes(c.points, c.valid)
    return R.cpu().numpy(), s.cpu().numpy()


def initial_align_centroid_pca(src, dst, device="cuda") -> np.ndarray:
    """The rigid (4, 4) taking ``src``'s centroid and principal axes onto
    ``dst``'s."""
    return se3.initial_align_centroid_pca(as_cloud(src, device),
                                          as_cloud(dst, device)).cpu().numpy()
