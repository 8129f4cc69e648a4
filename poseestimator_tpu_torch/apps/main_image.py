"""Offline single-frame 6D pose evaluation against BOP ground truth
(counterpart of ``poseestimator_tpu/apps/main_image.py``): detect the
object's mask with YOLO, build the masked cloud from the BOP depth and
``scene_camera.json``, register it against the template clouds (the offline
flavour, ``pipeline/offline.py``), report the angular error against
``scene_gt.json`` with the BOP metric family and the frame's Average
Recall, and project the CAD into the image.

The port opens no windows: run it with ``--headless`` (and
``--save-overlay FILE`` to keep the overlay image); without ``--headless``
it exits at once saying so.

Run:
    python -m poseestimator_tpu_torch.apps.main_image --headless \\
        --weights W.pt --rgb 000000.jpg --depth 000000.png \\
        --scene-camera scene_camera.json --scene-gt scene_gt.json \\
        --templates views/ --ply obj.ply [--save-overlay out.png] [--device cpu]
"""
from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..geom3d.camera import Intrinsics
from ..geom3d.cloud import from_points
from ..geom3d.se3 import angular_error
from ..pipeline.detector import detect_mask
from ..pipeline.offline import find_best_template_teaser
from ..utils.bop import (bop_average_recall, frame_metrics, get_pointcloud,
                         load_camera_intrinsics, load_object_symmetries, load_scene_gt)
from ..utils.image import IMREAD_COLOR, IMREAD_UNCHANGED, read_image, write_image
from ..utils.overlay import draw_model_projection_with_axes
from ..utils.plyio import read_ply

NO_WINDOWS = ("the PyTorch port opens no windows: run with --headless "
              "(and --save-overlay FILE to keep the overlay image)")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--weights", default="./data/best.pt")
    p.add_argument("--rgb", default="./data/000000.jpg")
    p.add_argument("--depth", default="./data/000000.png")
    p.add_argument("--scene-camera", default="./data/scene_camera.json")
    p.add_argument("--templates", default="./data/lego_views/")
    p.add_argument("--scene-gt", default="./data/scene_gt.json")
    p.add_argument("--ply", default="./data/obj_000001.ply")
    p.add_argument("--target-points", type=int, default=400)
    p.add_argument("--nc", type=int, default=5)
    p.add_argument("--class-id", type=int, default=0)
    p.add_argument("--headless", action="store_true", help="required: the port opens no windows")
    p.add_argument("--save-overlay", default=None, help="write the overlay PNG here")
    p.add_argument("--models-info", default=None,
                   help="BOP models_info.json for symmetry-aware MSSD/MSPD "
                        "(default: next to --ply)")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.headless:
        raise SystemExit(NO_WINDOWS)
    dev = resolve_device(args.device)

    mask = detect_mask(args.weights, args.rgb, class_id=args.class_id, nc=args.nc, device=dev)
    color = read_image(args.rgb, IMREAD_COLOR)

    src_clouds = []
    for f in sorted(glob.glob(os.path.join(args.templates, "*.ply"))):
        v = read_ply(f).vertices
        src_clouds.append(from_points(v, device=dev))
        print(f"Loaded: {f} with {len(v)} points")

    dst_cloud, K = get_pointcloud(args.depth, args.rgb, args.scene_camera, mask=mask, device=dev)
    if dst_cloud is None or int(dst_cloud.count()) == 0:
        print("Failed to generate scene point cloud!")
        return 1
    K = np.asarray(K).reshape(3, 3)

    best_idx, H, best_score, all_metrics = find_best_template_teaser(
        dst_cloud, src_clouds, target_points=args.target_points)
    for m in all_metrics:
        print(f"Template {m['template_idx']}: Chamfer = {m['score']:.6f}")
    print(best_idx)

    T_est = np.asarray(H, np.float64).copy()
    T_est[:3, 3] *= 1000.0  # m -> mm, the BOP convention
    if os.path.exists(args.scene_gt):
        T_gt, gt_obj_id = load_scene_gt(args.scene_gt)
        print("Homogeneous Transformation:\n", T_gt)
        print("Estimated: ", T_est)
        ang = float(angular_error(torch.as_tensor(T_gt[:3, :3], dtype=torch.float32),
                                  torch.as_tensor(T_est[:3, :3], dtype=torch.float32)))
        print("Difference = ", ang)
        mi_path = args.models_info or os.path.join(
            os.path.dirname(os.path.abspath(args.ply)), "models_info.json")
        syms = None
        if os.path.exists(mi_path):
            syms = load_object_symmetries(mi_path, gt_obj_id)
            if syms is not None:
                print(f"Symmetry set: {len(syms)} transforms "
                      f"(obj {gt_obj_id}, {os.path.basename(mi_path)})")
        verts = np.asarray(read_ply(args.ply).vertices, np.float32)
        if float(np.max(verts.max(0) - verts.min(0))) < 1.0:
            verts = verts * 1000.0  # a metre-scale CAD -> BOP's mm
        depth_raw = read_image(args.depth, IMREAD_UNCHANGED)
        h_img, w_img = depth_raw.shape[:2]
        _, depth_scale, _ = load_camera_intrinsics(args.scene_camera, 0, w_img, h_img)
        intr = Intrinsics.from_K(K, w_img, h_img)
        fm = frame_metrics(T_est, T_gt, K, verts, intr,
                           scene_depth_mm=depth_raw.astype(np.float32) * depth_scale,
                           symmetries_mm=syms, device=dev)
        print(f"ADD = {fm['add_mm']:.3f} mm, ADD-S = {fm['adds_mm']:.3f} mm, "
              f"MSSD = {fm['mssd_mm']:.3f} mm, MSPD = {fm['mspd_px']:.2f} px")
        ar = bop_average_recall(fm["vsd"][None], np.asarray([fm["mssd_mm"]]),
                                np.asarray([fm["mspd_px"]]), diameter=fm["diameter_mm"],
                                image_width=w_img)
        print(f"VSD(tau=10%) = {fm['vsd'][1]:.4f}, BOP AR = {ar['bop_ar']:.4f} "
              f"(VSD {ar['ar_vsd']:.4f} / MSSD {ar['ar_mssd']:.4f} / "
              f"MSPD {ar['ar_mspd']:.4f})")

    cad = read_ply(args.ply)
    overlay = draw_model_projection_with_axes(color.copy(), cad.vertices, K,
                                              T_est.astype(np.float32), axis_length=50.0)
    if args.save_overlay:
        write_image(args.save_overlay, overlay)
    return 0


if __name__ == "__main__":
    sys.exit(main())
