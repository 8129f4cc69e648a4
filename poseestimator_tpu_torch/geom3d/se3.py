"""SE(3) helpers (counterpart of ``poseestimator_tpu/geom3d/se3.py``).
Float32 throughout; matrix products run in full float32 under the numeric
policy of ``device.py``."""
from __future__ import annotations

import numpy as np
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
    """Apply a (..., 4, 4) transform to (..., N, 3) points."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def angular_error(R_exp: torch.Tensor, R_est: torch.Tensor) -> torch.Tensor:
    """Geodesic distance of two rotations in radians, as atan2 of the
    skew part's norm over the cosine (arccos near 1 floors at ~1e-3 rad in
    float32; atan2 is exact to rounding)."""
    R = R_exp.T @ R_est
    cos = (torch.trace(R) - 1.0) / 2.0
    skew = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    sin = 0.5 * torch.linalg.vector_norm(skew)
    return torch.atan2(sin, cos).abs()


def rot_x(a) -> torch.Tensor:
    c, s = float(np.cos(a)), float(np.sin(a))
    return torch.tensor([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]], dtype=torch.float32)


def rot_y(a) -> torch.Tensor:
    c, s = float(np.cos(a)), float(np.sin(a))
    return torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], dtype=torch.float32)


def rot_z(a) -> torch.Tensor:
    c, s = float(np.cos(a)), float(np.sin(a))
    return torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], dtype=torch.float32)


def euler_xyz_to_R(rpy) -> torch.Tensor:
    """Extrinsic x-y-z Euler angles (roll, pitch, yaw) -> R = Rz Ry Rx, as
    ``scipy.spatial.transform.Rotation.from_euler("xyz", rpy)``."""
    r, p, y = (float(a) for a in rpy)
    return rot_z(y) @ rot_y(p) @ rot_x(r)


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
    """Quaternion (..., 4) as (w, x, y, z) to rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def random_rotation(generator: torch.Generator | None = None,
                    draw: torch.Tensor | None = None) -> torch.Tensor:
    """A uniform random rotation: a standard normal quaternion, normalised.
    ``draw`` is that (4,) normal sample given instead of drawn from
    ``generator`` (whose device the rotation takes)."""
    if draw is None:
        dev = generator.device if generator is not None else None
        draw = torch.randn(4, generator=generator, device=dev)
    q = draw.to(torch.float32)
    return quat_to_R(q / torch.linalg.vector_norm(q))


def pca_axes(points: torch.Tensor, valid: torch.Tensor):
    """Principal axes of the valid rows of (..., N, 3) points: ``(R (..., 3,
    3), s (..., 3))``, R's columns sorted by decreasing variance with
    det(R) = +1, s the singular values. Column signs are the eigensolver's
    (they may differ from LAPACK-through-XLA's)."""
    w = valid.to(points.dtype)
    n = w.sum(-1)
    c = (points * w[..., None]).sum(-2) / torch.clamp(n, min=1.0)[..., None]
    X = (points - c[..., None, :]) * w[..., None]
    cov = (X.transpose(-1, -2) @ X) / torch.clamp(n - 1.0, min=1.0)[..., None, None]
    vals, vecs = torch.linalg.eigh(cov)  # ascending
    vals = vals.flip(-1)
    R = vecs.flip(-1)
    flip = torch.where(torch.linalg.det(R) < 0, -1.0, 1.0).to(R.dtype)
    R = torch.cat([R[..., :2], R[..., 2:] * flip[..., None, None]], dim=-1)
    return R, torch.sqrt(torch.clamp(vals, min=0.0))


def initial_align_centroid_pca(src, dst) -> torch.Tensor:
    """Rigid T0 moving the centroid and principal axes of the cloud ``src``
    onto those of ``dst``, each src axis signed to agree with its dst axis
    and the third flipped for det = +1. Flipping an eigenvector's sign on
    either side flips its dot product too, so T0 does not depend on the
    eigensolver's column signs."""
    c_s, c_d = src.centroid(), dst.centroid()
    R_s, _ = pca_axes(src.points, src.valid)
    R_d, _ = pca_axes(dst.points, dst.valid)
    signs = torch.where((R_s * R_d).sum(0) < 0, -1.0, 1.0)
    R_s_adj = R_s * signs[None, :]
    flip = torch.where(torch.linalg.det(R_s_adj) < 0, -1.0, 1.0)
    R_s_adj = torch.cat([R_s_adj[:, :2], R_s_adj[:, 2:] * flip], dim=1)
    R0 = R_d @ R_s_adj.T
    return make_T(R0, c_d - R0 @ c_s)


def enforce_upright_pose_y_up(T: torch.Tensor, tol_deg: float = 30.0) -> torch.Tensor:
    """Snap the model's local +Y axis toward world -Y by repeated 90-degree
    rotations about the model's Z: the first of R, R Rz, R Rz^2, R Rz^3 whose
    column 1 is within ``tol_deg`` of (0, -1, 0), else R unchanged."""
    R = T[:3, :3]
    rz90 = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                        dtype=R.dtype, device=R.device)
    Rs = [R]
    for _ in range(3):
        Rs.append(Rs[-1] @ rz90)
    Rs = torch.stack(Rs)
    up = Rs[:, :, 1]
    c = -up[:, 1] / torch.clamp(torch.linalg.vector_norm(up, dim=1), min=1e-12)
    ok = c >= torch.cos(torch.deg2rad(torch.tensor(tol_deg, dtype=R.dtype)))
    out = T.clone()
    out[:3, :3] = Rs[torch.argmax(ok.to(torch.uint8))]  # 0 when none qualifies
    return out


def look_at(eye, target, up) -> torch.Tensor:
    """World-to-camera transform of a right-handed camera with +Z pointing
    back toward the viewer (OpenGL convention)."""
    eye, target, up = (torch.as_tensor(a, dtype=torch.float32) for a in (eye, target, up))
    z = eye - target
    z = z / torch.clamp(torch.linalg.vector_norm(z), min=1e-12)
    x = torch.linalg.cross(up, z)
    x = x / torch.clamp(torch.linalg.vector_norm(x), min=1e-12)
    y = torch.linalg.cross(z, x)
    R = torch.stack([x, y, z])
    return make_T(R, -(R @ eye))


def camera_eye_lookat_up_from_H(H: torch.Tensor):
    """Model->camera ``H`` -> ``(eye, target, up)`` in model coordinates:
    the camera centre, one unit along its viewing axis, and its up (-y)
    axis, unit length."""
    R, t = H[:3, :3], H[:3, 3]
    eye = -(R.T @ t)
    forward = R.T @ torch.tensor([0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    up = R.T @ torch.tensor([0.0, -1.0, 0.0], dtype=R.dtype, device=R.device)
    up = up / (torch.linalg.vector_norm(up) + 1e-12)
    return eye, eye + forward, up
