"""SE(3) helpers (counterpart of ``poseestimator_tpu/geom3d/se3.py``: the
subset the tracking step uses). Float32 throughout; matrix products run in
full float32 under the numeric policy of ``device.py``."""
from __future__ import annotations

import torch


def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.eye(4, dtype=R.dtype, device=R.device)
    T[:3, :3] = R
    T[:3, 3] = t.reshape(3)
    return T


def inv_T(T: torch.Tensor) -> torch.Tensor:
    R = T[:3, :3]
    t = T[:3, 3]
    return make_T(R.T, -(R.T @ t))


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 transform to (..., 3) points."""
    return pts @ T[:3, :3].T + T[:3, 3]


def axis_angle_to_R(axis: torch.Tensor, angle) -> torch.Tensor:
    """Rodrigues' formula."""
    axis = axis / torch.clamp(torch.linalg.vector_norm(axis), min=1e-12)
    kx, ky, kz = axis[0], axis[1], axis[2]
    z = torch.zeros_like(kx)
    K = torch.stack([
        torch.stack([z, -kz, ky]),
        torch.stack([kz, z, -kx]),
        torch.stack([-ky, kx, z]),
    ])
    angle = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    return eye + torch.sin(angle) * K + (1 - torch.cos(angle)) * (K @ K)


def quat_to_R(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) to rotation matrix."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
    ])
