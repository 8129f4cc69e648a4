"""BOP scene-directory evaluation (counterpart of ``tools/eval_bop.py``):
every frame listed in ``scene_gt.json`` goes mask -> masked cloud
(``utils/bop.get_pointcloud``) -> registration -> the BOP metric family
against the ground truth (``utils/bop.frame_metrics``), and the scene's
BOP19 Average Recall is reported (``bop_average_recall``).

Scene layout: the canonical BOP tree (``rgb/NNNNNN.{png,jpg}``,
``depth/NNNNNN.png``, ``mask_visib/NNNNNN_000000.png``) or the flat
single-directory form (``NNNNNN.{png,jpg}``); frames come from the
``scene_gt.json`` keys.

Mask sources (--mask):
  visib     the ground-truth visible mask (``mask_visib/``, BOP's own)
  depthpos  depth > 0 (single-object synthetic scenes)
  detector  the YOLO detector's mask (``--weights``): one ``Detector`` for
            the sweep, and per frame ``detect_mask`` on the colour image,
            the first detection of ``--class-id`` (its polygon round trip:
            the largest outer border, filled); an empty mask when none

Registration (--registration): ``offline``, the single-frame flavour of
``pipeline/offline.py``; ``product``, the template search of
``PoseEstimator`` (5 hypotheses a template, coarse ICP, render-ICP polish,
depth and silhouette scores through the exact raster), one estimator for the
sweep, built again only when (CAD, templates, view set, intrinsics, score
resolution, polish width) changes between frames.

Run:
    python -m poseestimator_tpu_torch.apps.eval_bop --scene-dir scenes/000001 \\
        --ply obj.ply --templates views/ --mask visib [--device cuda] \\
        [--json-out out.json]

Prints one JSON line per frame and a summary line with the scene's AR.
Colour images are read as PNG or JPEG (``utils/image.read_image``).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..geom3d.camera import Intrinsics
from ..geom3d.cloud import from_points
from ..pipeline.detector import Detector
from ..pipeline.offline import find_best_template_teaser
from ..pipeline.pose_estimator import PoseEstimator
from ..utils import bop
from ..utils.image import IMREAD_COLOR, read_image
from ..utils.plyio import read_ply
from ..utils.png import read_png


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scene-dir", required=True, help="BOP scene directory")
    p.add_argument("--ply", required=True, help="CAD model (.ply)")
    p.add_argument("--templates", required=True, help="template views dir")
    p.add_argument("--mask", default="visib", choices=["visib", "depthpos", "detector"])
    p.add_argument("--weights", default=None, help="detector weights for --mask detector")
    p.add_argument("--nc", type=int, default=5, help="the detector's class count")
    p.add_argument("--class-id", type=int, default=0, help="the object's detector class")
    p.add_argument("--obj-index", type=int, default=0,
                   help="GT instance index within each frame")
    p.add_argument("--target-points", type=int, default=400)
    p.add_argument("--registration", default="offline", choices=["offline", "product"],
                   help="'offline' = FPS + fixed-radius FPFH + TEASER (pipeline/offline.py); "
                        "'product' = the template search of PoseEstimator")
    p.add_argument("--max-frames", type=int, default=0, help="0 = all")
    p.add_argument("--view-set", default="reduced", choices=["reduced", "full"],
                   help="--registration product template coverage: the 5-view upper-arc "
                        "ring or the 26-view sphere (rendered on first use into "
                        "--templates)")
    p.add_argument("--score-res", type=int, default=2, choices=[2, 1],
                   help="product-search scoring-view downscale")
    p.add_argument("--polish", type=int, default=1,
                   help="product-search polished hypotheses per template")
    p.add_argument("--ambig-margin", type=float, default=0.02,
                   help="frames whose best-vs-next distinct-basin score gap is below this "
                        "are counted ambiguous in the summary")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    p.add_argument("--json-out", default=None)
    p.add_argument("--models-info", default=None,
                   help="BOP models_info.json for symmetry-aware MSSD/MSPD "
                        "(default: next to --ply)")
    return p


def _find(scene, sub, stem, exts):
    """A frame file in the canonical (sub/stem.ext) or the flat layout."""
    for base in (os.path.join(scene, sub), scene):
        for ext in exts:
            c = os.path.join(base, stem + ext)
            if os.path.exists(c):
                return c
    return None


def _margin(cands, verts_mm) -> float | None:
    """Score gap between the best candidate and the next one in a distinct
    basin (more than 10 degrees or 5% of the diagonal away)."""
    Tw = np.asarray(cands[0][1])
    diam = float(np.linalg.norm(np.ptp(verts_mm, axis=0))) / 1000.0
    for s_c, T_c, _ in cands[1:]:
        Tc = np.asarray(T_c)
        R = Tc[:3, :3] @ Tw[:3, :3].T
        ang = np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))
        if ang > 0.17 or np.linalg.norm(Tc[:3, 3] - Tw[:3, 3]) > 0.05 * diam:
            return float(s_c - cands[0][0])
    return None


def run(args, quiet: bool = False):
    """Sweep the scene; returns the summary dict (None when no frame was
    evaluated)."""
    dev = resolve_device(args.device)
    detector = None
    if args.mask == "detector":
        if not args.weights:
            raise SystemExit("--mask detector needs --weights")
        detector = Detector(args.weights, nc=args.nc, device=dev)
    scene = args.scene_dir
    gt_path = os.path.join(scene, "scene_gt.json")
    cam_path = os.path.join(scene, "scene_camera.json")
    with open(gt_path) as f:
        frame_keys = sorted(json.load(f).keys(), key=int)
    if args.max_frames:
        frame_keys = frame_keys[: args.max_frames]

    src_clouds = [from_points(read_ply(f).vertices, device=dev)
                  for f in sorted(glob.glob(os.path.join(args.templates, "*.ply")))]
    if not src_clouds and args.registration == "offline":
        # the product path renders its template database on first use
        raise SystemExit(f"no template .ply files in {args.templates}")

    verts = np.asarray(read_ply(args.ply).vertices, np.float32)
    if float(np.max(verts.max(0) - verts.min(0))) < 1.0:
        verts = verts * 1000.0  # a metre-scale CAD -> BOP's mm

    mi_path = args.models_info or os.path.join(os.path.dirname(os.path.abspath(args.ply)),
                                               "models_info.json")
    sym_cache: dict = {}

    def syms_for(obj_id):
        if obj_id not in sym_cache:
            sym_cache[obj_id] = (bop.load_object_symmetries(mi_path, obj_id)
                                 if os.path.exists(mi_path) else None)
        return sym_cache[obj_id]

    rows, vsds, mssds, mspds = [], [], [], []
    est, est_key = None, None  # the product estimator, kept while its key holds
    diam_mm = None
    for k in frame_keys:
        stem = f"{int(k):06d}"
        depth_path = _find(scene, "depth", stem, (".png",))
        rgb_path = _find(scene, "rgb", stem, (".jpg", ".png"))
        if depth_path is None:
            print(f"frame {k}: no depth image", file=sys.stderr)
            continue
        depth_raw = read_png(depth_path)
        if args.mask == "visib":
            mp = (_find(scene, "mask_visib", f"{stem}_{args.obj_index:06d}", (".png",))
                  or _find(scene, "mask_visib", stem, (".png",)))
            if mp is None:
                print(f"frame {k}: no mask_visib", file=sys.stderr)
                continue
            mask = read_png(mp)
            if mask.ndim != 2:
                raise ValueError(f"{mp}: a mask must be a greyscale PNG")
        elif args.mask == "depthpos":
            mask = ((depth_raw > 0) * 255).astype(np.uint8)
        else:
            if rgb_path is None:
                print(f"frame {k}: no colour image for the detector", file=sys.stderr)
                continue
            img = read_image(rgb_path, IMREAD_COLOR)
            hits = [r["mask"] for r in detector.detect_mask(img, class_id=args.class_id, conf=0.7)
                    if r["class_id"] == args.class_id]
            mask = hits[0] if hits else np.zeros(img.shape[:2], np.uint8)

        cloud, K = bop.get_pointcloud(depth_path, rgb_path, cam_path, mask, frame_id=int(k),
                                      device=dev)
        if cloud is None or int(cloud.count()) == 0:
            print(f"frame {k}: empty masked cloud", file=sys.stderr)
            continue
        h_img, w_img = depth_raw.shape[:2]
        intr = Intrinsics.from_K(K, w_img, h_img)

        margin = None
        if args.registration == "product":
            key = (os.path.abspath(args.ply), os.path.abspath(args.templates), args.view_set,
                   intr, args.score_res, args.polish)
            if est_key != key:
                est = PoseEstimator(
                    args.ply, args.templates, intr, view_set=args.view_set,
                    search_score_res=args.score_res, search_polish=args.polish, device=dev)
                est_key = key
            H, _, cands = est.find_best_template_candidates(
                cloud, mask=torch.from_numpy(mask > 0).to(dev))
            score = -1.0  # the product search reports no Chamfer score
            if len(cands) > 1:
                margin = _margin(cands, verts)
        else:
            _, H, score, _ = find_best_template_teaser(cloud, src_clouds,
                                                       target_points=args.target_points)
        T_est = np.asarray(H, np.float64).copy()
        T_est[:3, 3] *= 1000.0  # m -> mm
        T_gt, gt_obj_id = bop.load_scene_gt(gt_path, frame_key=k, obj_index=args.obj_index)
        _, depth_scale, _ = bop.load_camera_intrinsics(cam_path, int(k), w_img, h_img)
        fm = bop.frame_metrics(T_est, T_gt, K, verts, intr,
                               scene_depth_mm=depth_raw.astype(np.float32) * depth_scale,
                               symmetries_mm=syms_for(gt_obj_id), device=dev)
        diam_mm = fm["diameter_mm"]
        vsds.append(fm["vsd"])
        mssds.append(fm["mssd_mm"])
        mspds.append(fm["mspd_px"])
        row = {"frame": int(k), "adds_mm": round(fm["adds_mm"], 3),
               "mssd_mm": round(fm["mssd_mm"], 3), "mspd_px": round(fm["mspd_px"], 2),
               "vsd_tau10": round(float(fm["vsd"][1]), 4),
               "chamfer_score": round(float(score), 6)}
        if margin is not None:
            row["init_margin"] = round(margin, 4)
            row["ambiguous"] = bool(margin < args.ambig_margin)
        rows.append(row)
        if not quiet:
            print(json.dumps(row), flush=True)

    if not rows:
        print("no frames evaluated", file=sys.stderr)
        return None
    ar = bop.bop_average_recall(np.stack(vsds), np.asarray(mssds), np.asarray(mspds),
                                diameter=diam_mm, image_width=w_img)
    summary = {"scene": scene, "frames": len(rows), "mask": args.mask,
               "adds_mean_mm": round(float(np.mean([r["adds_mm"] for r in rows])), 3),
               "mssd_mean_mm": round(float(np.mean(mssds)), 3),
               "mspd_mean_px": round(float(np.mean(mspds)), 2), **ar}
    if any("init_margin" in r for r in rows):
        summary["ambiguous_frames"] = sum(1 for r in rows if r.get("ambiguous"))
    if not quiet:
        print(json.dumps(summary), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"frames": rows, "summary": summary}, f, indent=2)
    return summary


def main(argv=None):
    return 0 if run(build_parser().parse_args(argv)) else 1


if __name__ == "__main__":
    sys.exit(main())
