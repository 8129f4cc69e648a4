"""LiDAR + RGB 6D pose estimation with an extrinsic calibration
(counterpart of ``poseestimator_tpu/apps/main_seibersdorf.py``): load the
calibration YAML (``K``, ``D``, and ``T`` or ``xyz`` + ``rpy``), project
the LiDAR cloud into the image with Brown-Conrady distortion, keep the
points inside the detector's mask, clean them with statistical outlier
removal, move them into the camera frame and run ``PoseEstimator``'s
template search; the pose is model -> camera.

The port opens no windows: run it with ``--headless`` (and
``--save-overlay FILE`` to keep the overlay image); without ``--headless``
it exits at once saying so.

Run:
    python -m poseestimator_tpu_torch.apps.main_seibersdorf --headless \\
        --image frame.png --cloud lidar.ply --calib calib.yaml \\
        --weights W.pt --cad-path cad.ply --ply-path views/ [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..geom3d.camera import Intrinsics, project_points_distorted
from ..geom3d.cloud import from_points
from ..geom3d.outliers import remove_statistical_outlier
from ..geom3d.se3 import euler_xyz_to_R
from ..pipeline.detector import Detector
from ..pipeline.pose_estimator import PoseEstimator
from ..utils import yaml_subset
from ..utils.image import IMREAD_COLOR, read_image, write_image
from ..utils.overlay import draw_model_projection_with_axes
from ..utils.plyio import read_ply

NO_WINDOWS = ("the PyTorch port opens no windows: run with --headless "
              "(and --save-overlay FILE to keep the overlay image)")


def load_calib(path):
    """``(K (3, 3), D (n,), T (4, 4))`` of a calibration YAML: ``T``, or the
    translation ``xyz`` and extrinsic x-y-z Euler angles ``rpy``."""
    c = yaml_subset.load(path)
    K = np.asarray(c["K"], float).reshape(3, 3)
    D = np.asarray(c.get("D", []), float).reshape(-1)
    if "T" in c:
        T = np.asarray(c["T"], float).reshape(4, 4)
    else:
        if "xyz" not in c or "rpy" not in c:
            raise ValueError("calib.yaml must have T or (xyz+rpy)")
        T = np.eye(4)
        T[:3, :3] = euler_xyz_to_R(c["rpy"]).numpy().astype(np.float64)
        T[:3, 3] = np.asarray(c["xyz"], float)
    return K, D, T


def project_count(pts, R, t, K, D, W, H):
    """Distorted projection of the (N, 3) points under (R, t), in float32:
    ``(points in the image, in front (N,), rounded pixels (N, 2), in the
    image (N,))``; in front means z > 0.1 m, and a D of other than 4, 5 or
    8 terms counts as no distortion."""
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    uv, front = project_points_distorted(
        f32(pts), f32(K), f32(D if D.size in (4, 5, 8) else np.zeros(5)), f32(T))
    uv = uv.numpy()
    front = front.numpy() & (pts @ R.T[:, 2] + t[2] > 0.1)
    uvi = np.round(uv).astype(np.int64)
    in_img = front & (uvi[:, 0] >= 0) & (uvi[:, 0] < W) & (uvi[:, 1] >= 0) & (uvi[:, 1] < H)
    return int(in_img.sum()), front, uvi, in_img


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--weights", default="./data/best.pt")
    p.add_argument("--ply-path", default="./data/seibersdorf_views/")
    p.add_argument("--cad-path", default="./data/_Daten_Seibersdorf_Patrick/ConcreteBlock.ply")
    p.add_argument("--image", required=True)
    p.add_argument("--cloud", required=True)
    p.add_argument("--calib", required=True)
    p.add_argument("--max-points", type=int, default=250000)
    p.add_argument("--target-points", type=int, default=500)
    p.add_argument("--nc", type=int, default=5)
    p.add_argument("--headless", action="store_true", help="required: the port opens no windows")
    p.add_argument("--save-overlay", default=None)
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.headless:
        raise SystemExit(NO_WINDOWS)
    dev = resolve_device(args.device)

    K, D, T = load_calib(args.calib)
    img_bgr = read_image(args.image, IMREAD_COLOR)
    H_img, W_img = img_bgr.shape[:2]

    intr = Intrinsics.from_K(K, W_img, H_img)
    estimator = PoseEstimator(args.cad_path, args.ply_path, intr, K, args.target_points,
                              device=dev)
    detector = Detector(args.weights, nc=args.nc, device=dev)
    cad_points, _ = estimator.mesh.sample_points_uniformly(1000)

    detections = detector.detect_mask(img_bgr)
    print(f"{len(detections)} detections")
    if len(detections) == 0:
        raise SystemExit("no detections")
    mask = detections[0]["mask"]

    pts = read_ply(args.cloud).vertices.astype(np.float64)
    if args.max_points and len(pts) > args.max_points:
        pts = pts[np.random.default_rng(0).choice(len(pts), args.max_points, replace=False)]

    T_inv = np.linalg.inv(T)
    n_in, front, uv, in_img = project_count(pts, T_inv[:3, :3], T_inv[:3, 3], K, D, W_img, H_img)
    print(f"[inverse] front-facing: {int(front.sum())}  in-image: {n_in}")
    if n_in == 0:
        raise SystemExit("No projected points landed inside the image with any transform.")
    idx = np.flatnonzero(in_img)
    uv_in = uv[in_img]
    inside = mask.astype(bool)[uv_in[:, 1], uv_in[:, 0]]
    pts_col = pts[idx[inside]]
    print(f"masked cloud: {len(pts_col)} points")

    dst = from_points(pts_col.astype(np.float32), device=dev)
    dst = remove_statistical_outlier(dst, nb_neighbors=30, std_ratio=1.0)
    # the cloud is in the LiDAR frame: the search runs in the camera frame,
    # so its pose is model -> camera already
    dst_cam = dst.transform(torch.as_tensor(T_inv, dtype=torch.float32, device=dev))
    T_m2c, _ = estimator.find_best_template_teaser(dst_cam)
    print(T_m2c)

    overlay = draw_model_projection_with_axes(img_bgr.copy(), cad_points, K,
                                              np.asarray(T_m2c, np.float32))
    if args.save_overlay:
        write_image(args.save_overlay, overlay)
    return 0


if __name__ == "__main__":
    sys.exit(main())
