"""BOP-format I/O and evaluation (counterpart of
``poseestimator_tpu/utils/bop.py``): ``scene_camera.json`` intrinsics,
``scene_gt.json`` poses, ``models_info.json`` symmetries, the masked depth
-> point cloud loader of the offline path, the BOP metric family of one
pose estimate (ADD, ADD-S, MSSD, MSPD, VSD) and the BOP19 Average Recall.

Images are read without an imaging package: the depth PNG with
``utils/png.read_png``, the colour image (PNG or JPEG, grey or colour, 8 or
16 bit) with ``utils/image.read_image`` as ``cv2.imread`` reads it, then
turned to RGB, as the JAX package does. A colour path that does not exist
gives ``colors=None``.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..geom3d.camera import Intrinsics, backproject_depth
from ..geom3d.cloud import from_points
from ..geom3d.metrics import add_metric, adds_metric, mspd_metric, mssd_metric
from ..geom3d.outliers import remove_statistical_outlier
from ..geom3d.sampling import make_draws, random_sample
from ..render.points import vsd_multi_tau
from .image import IMREAD_COLOR, read_image
from .png import read_png

# BOP19 (Hodan et al., ECCV 2020 §2.3): the correctness thresholds and the
# VSD tolerances both sweep 5%..50% in 5% steps; MSPD's are in pixels of a
# 640-wide image
BOP_FRACS = np.arange(0.05, 0.501, 0.05)


def load_camera_intrinsics(scene_camera_path: str, frame_id, image_width, image_height):
    """``(Intrinsics, depth_scale, cam_K list)`` of one frame."""
    frame_id = f"{frame_id}"
    with open(scene_camera_path) as f:
        cam_data = json.load(f)
    if frame_id not in cam_data:
        raise ValueError(f"Frame ID {frame_id} not found in scene_camera.json")
    cam_K = cam_data[frame_id]["cam_K"]
    intr = Intrinsics(fx=float(cam_K[0]), fy=float(cam_K[4]), cx=float(cam_K[2]),
                      cy=float(cam_K[5]), width=int(image_width), height=int(image_height))
    return intr, float(cam_data[frame_id]["depth_scale"]), cam_K


def get_pointcloud(depth_path, rgb_path, scene_camera_path, mask, frame_id=0,
                   capacity: int = 16384, generator: Optional[torch.Generator] = None,
                   draws: Optional[tuple] = None, device: str | torch.device = "cuda"):
    """Masked BOP frame -> ``(PointCloud, K (3, 3))``, or ``(None, None)``
    when the mask (255 = object) selects nothing: depth / 1000 x the
    frame's depth_scale, clipped to 0.01-10 m, a uniform sample of
    ``capacity`` points, then statistical outlier removal. The sample's
    draws are injected (``draws``, as ``random_sample`` takes them) or made
    on ``generator``'s device (default: a host generator seeded 0, so the
    card and the CPU draw alike) and moved to ``device``."""
    dev = resolve_device(device)
    depth_m = read_png(str(depth_path)).astype(np.float32) / 1000.0
    binary = (np.asarray(mask) == 255).astype(np.uint8)
    if binary.sum() == 0:
        print("WARNING: No pixels selected by mask!")
        return None, None
    h, w = depth_m.shape
    intr, depth_scale, cam_K = load_camera_intrinsics(scene_camera_path, frame_id, w, h)
    depth_m = depth_m * depth_scale

    color = None
    if rgb_path is not None and os.path.exists(str(rgb_path)):
        rgb = read_image(str(rgb_path), IMREAD_COLOR)[..., ::-1]
        color = torch.from_numpy(np.ascontiguousarray(rgb)).to(dev)
    cloud = backproject_depth(torch.from_numpy(depth_m).to(dev), intr,
                              mask=torch.from_numpy(binary).to(dev), depth_min=0.01,
                              depth_max=10.0, color=color)
    if draws is None:
        generator = torch.Generator().manual_seed(0) if generator is None else generator
        draws = tuple(None if d is None else d.to(dev) for d in make_draws(
            cloud.capacity, min(capacity, cloud.capacity), generator, generator.device))
    # a sample, not a compaction: a mask larger than ``capacity`` pixels
    # would otherwise lose its raster-bottom rows
    cloud = random_sample(cloud, capacity, draws=draws)
    cloud = remove_statistical_outlier(cloud, nb_neighbors=20, std_ratio=1.0)
    return cloud, np.asarray(cam_K, np.float64).reshape(3, 3)


def load_scene_gt(scene_gt_path: str, frame_key: Optional[str] = None, obj_index: int = 0):
    """The first (or ``frame_key``'s) GT pose of ``scene_gt.json``: ``(T
    (4, 4) model-to-camera, translation in the file's unit (mm), obj_id)``."""
    with open(scene_gt_path) as f:
        data = json.load(f)
    key = frame_key if frame_key is not None else sorted(data.keys())[0]
    obj = data[key][obj_index]
    T = np.eye(4)
    T[:3, :3] = np.asarray(obj["cam_R_m2c"], np.float64).reshape(3, 3)
    T[:3, 3] = np.asarray(obj["cam_t_m2c"], np.float64).reshape(3)
    return T, int(obj.get("obj_id", -1))


def load_object_symmetries(models_info_path: str, obj_id: int, max_sym_disc_step: float = 0.01,
                           max_syms: int = 512) -> Optional[np.ndarray]:
    """The object's symmetry transforms from ``models_info.json`` -> (S, 4,
    4) float32 in mm, or None for an object listed without symmetries (or
    absent). ``symmetries_discrete`` entries are flattened 4x4 transforms;
    each ``symmetries_continuous`` {axis, offset} is discretised so that one
    step moves a point at the object's radius by at most
    ``max_sym_disc_step`` of the diameter (step angle 2 asin(step / 2)).
    The two groups compose as Tc @ Td over their product, identity included,
    cut to ``max_syms``."""
    with open(models_info_path) as f:
        info = json.load(f)
    key = str(int(obj_id))
    if key not in info:
        return None
    info = info[key]
    disc = [np.eye(4)]
    for s in info.get("symmetries_discrete", []):
        disc.append(np.asarray(s, np.float64).reshape(4, 4))
    cont = [np.eye(4)]
    for s in info.get("symmetries_continuous", []):
        axis = np.asarray(s["axis"], np.float64)
        axis = axis / max(np.linalg.norm(axis), 1e-12)
        offset = np.asarray(s.get("offset", [0.0, 0.0, 0.0]), np.float64)
        step = 2.0 * np.arcsin(min(max_sym_disc_step, 2.0) / 2.0)
        n = max(2, int(np.ceil(2.0 * np.pi / step)))
        n = min(n, max(2, max_syms // max(len(disc), 1)))
        for i in range(1, n):
            ang = 2.0 * np.pi * i / n
            c, s_, C = np.cos(ang), np.sin(ang), 1.0 - np.cos(ang)
            x, y, z = axis
            R = np.array([
                [c + x * x * C, x * y * C - z * s_, x * z * C + y * s_],
                [y * x * C + z * s_, c + y * y * C, y * z * C - x * s_],
                [z * x * C - y * s_, z * y * C + x * s_, c + z * z * C],
            ])
            T = np.eye(4)
            T[:3, :3] = R
            T[:3, 3] = offset - R @ offset
            cont.append(T)
    if len(disc) == 1 and len(cont) == 1:
        return None  # asymmetric: the identity alone
    syms = [tc @ td for tc in cont for td in disc]
    return np.asarray(syms[:max_syms], np.float32)


@torch.no_grad()
def frame_metrics(T_est_mm: np.ndarray, T_gt_mm: np.ndarray, K: np.ndarray,
                  verts_mm: np.ndarray, intr: Intrinsics,
                  scene_depth_mm: Optional[np.ndarray] = None,
                  symmetries_mm: Optional[np.ndarray] = None,
                  device: str | torch.device = "cuda") -> dict:
    """The BOP metric family of one pose estimate, in mm: ``{add_mm,
    adds_mm, mssd_mm, mspd_px, vsd (10,), diameter_mm}``. ``verts_mm``: the
    CAD's points; ``scene_depth_mm``: the measured depth for VSD's
    occlusion test (None: render-only visibility); ``symmetries_mm``: (S,
    4, 4) from ``load_object_symmetries`` for MSSD and MSPD (None: the
    identity; VSD is symmetry-agnostic by design). VSD renders with the BOP
    visibility delta of 15 mm and mm clips (1, 1e5)."""
    dev = resolve_device(device)
    verts_mm = np.asarray(verts_mm, np.float32)
    model = from_points(verts_mm, device=dev)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)  # noqa: E731
    Te, Tg, Kt = f32(T_est_mm), f32(T_gt_mm), f32(K)
    diam_mm = float(np.linalg.norm(verts_mm.max(0) - verts_mm.min(0)))
    vsd = vsd_multi_tau(Te, Tg, model.points, model.valid, intr, f32(BOP_FRACS * diam_mm),
                        scene_depth=None if scene_depth_mm is None else f32(scene_depth_mm),
                        delta=15.0, near=1.0, far=100000.0)
    syms = None if symmetries_mm is None else f32(symmetries_mm)
    return {
        "add_mm": float(add_metric(Te, Tg, model)),
        "adds_mm": float(adds_metric(Te, Tg, model)),
        "mssd_mm": float(mssd_metric(Te, Tg, model, symmetries=syms)),
        "mspd_px": float(mspd_metric(Te, Tg, Kt, model, symmetries=syms)),
        "vsd": vsd.cpu().numpy(),
        "diameter_mm": diam_mm,
    }


def bop_average_recall(vsd: np.ndarray, mssd: np.ndarray, mspd: np.ndarray, diameter: float,
                       image_width: int = 640) -> dict:
    """BOP19 Average Recall over F pose estimates: ``vsd`` (F, 10) at the
    tau sweep, ``mssd`` (F,) in the unit of ``diameter``, ``mspd`` (F,) in
    pixels. AR_VSD is the recall of VSD < theta over every (tau, theta),
    AR_MSSD of MSSD < theta x diameter, AR_MSPD of MSPD < theta x 100 x
    image_width / 640 px, theta in 5%..50%; ``bop_ar`` is their mean. All
    four are rounded to 4 decimals."""
    vsd = np.asarray(vsd, np.float64)
    if vsd.ndim != 2 or vsd.shape[1] != len(BOP_FRACS):
        raise ValueError(f"vsd must be (F, {len(BOP_FRACS)}) — one column per BOP tau; "
                         f"got {vsd.shape}")
    mssd = np.asarray(mssd, np.float64)
    mspd = np.asarray(mspd, np.float64)
    ar_vsd = float(np.mean(vsd[:, :, None] < BOP_FRACS[None, None, :]))
    ar_mssd = float(np.mean(mssd[:, None] < BOP_FRACS[None, :] * diameter))
    r = image_width / 640.0
    ar_mspd = float(np.mean(mspd[:, None] < BOP_FRACS[None, :] * 100.0 * r))
    return {"ar_vsd": round(ar_vsd, 4), "ar_mssd": round(ar_mssd, 4),
            "ar_mspd": round(ar_mspd, 4),
            "bop_ar": round((ar_vsd + ar_mssd + ar_mspd) / 3.0, 4)}
