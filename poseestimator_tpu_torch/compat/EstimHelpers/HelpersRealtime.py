"""The free functions of the reference's ``HelpersRealtime`` (which its
``main_realsense`` star-imports) on the port: numpy in, numpy out, computed
on ``device`` (the card unless the caller passes ``device="cpu"``)."""
import numpy as np
import torch

from ...device import resolve_device
from ...geom3d import se3
from ...geom3d.camera import project_points as _project_points
from ...geom3d.cloud import PointCloud, from_points
from ...geom3d.metrics import alignment_score as _alignment_score
from ...geom3d.metrics import cloud_resolution as _cloud_resolution
from ...geom3d.metrics import nn_residuals as _nn_residuals
from ...geom3d.sampling import voxel_coverage as _voxel_coverage
from ...utils.overlay import draw_model_projection_with_axes

__all__ = [
    "enforce_upright_pose_y_up",
    "camera_eye_lookat_up_from_H",
    "project_points",
    "draw_model_projection_with_axes",
    "alignment_score",
    "nn_residuals",
    "voxel_coverage",
    "cloud_resolution",
]


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=resolve_device(device))


def as_cloud(x, device="cuda") -> PointCloud:
    """A port ``PointCloud`` as it is, or (N, 3) points as one on ``device``."""
    if isinstance(x, PointCloud):
        return x
    return from_points(np.asarray(x, np.float32), device=device)


def enforce_upright_pose_y_up(T, device="cuda") -> np.ndarray:
    """The pose with the model's +Y snapped toward world -Y (quarter turns
    about the model's Z)."""
    return se3.enforce_upright_pose_y_up(_f32(T, device)).cpu().numpy()


def camera_eye_lookat_up_from_H(H, device="cuda"):
    """Model->camera ``H`` -> ``(eye, target, up)`` in model coordinates."""
    return tuple(a.cpu().numpy() for a in se3.camera_eye_lookat_up_from_H(_f32(H, device)))


def project_points(points_3d, K, T_m2c, device="cuda") -> np.ndarray:
    """Integer pixel coordinates of the points in front of the camera."""
    uv, front = _project_points(_f32(points_3d, device), _f32(K, device), _f32(T_m2c, device))
    return uv.cpu().numpy()[front.cpu().numpy()].astype(int)


def nn_residuals(src_aligned, dst_cloud, device="cuda") -> np.ndarray:
    """Each valid source point's distance to its nearest destination point."""
    d, m = _nn_residuals(as_cloud(src_aligned, device), as_cloud(dst_cloud, device))
    return d.cpu().numpy()[m.cpu().numpy()]


def voxel_coverage(points, voxel_size, device="cuda") -> int:
    """Occupied voxels of a grid anchored at the origin."""
    pts = _f32(points, device)
    return int(_voxel_coverage(pts, torch.ones(len(pts), dtype=torch.bool, device=pts.device),
                               voxel_size))


def alignment_score(src_aligned, src_down, dst_down, voxel_size, device="cuda") -> float:
    """The search's alignment score of an aligned source against the
    destination (lower is better)."""
    return float(_alignment_score(as_cloud(src_aligned, device), as_cloud(src_down, device),
                                  as_cloud(dst_down, device), voxel_size))


def cloud_resolution(pcd, k=8, device="cuda") -> float:
    """Median distance to the k nearest neighbours."""
    return float(_cloud_resolution(as_cloud(pcd, device), k=k))
