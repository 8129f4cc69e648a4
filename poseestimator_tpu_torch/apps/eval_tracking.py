"""Synthetic-ground-truth streaming tracking evaluation (the counterpart of
``tools/eval_tracking.py``): the L-shaped CAD turns at a fixed rate, the
whole INIT -> TRACK loop runs, and every tracked frame's pose is scored
against the camera's true pose with ADD-S, MSSD, MSPD, VSD and the BOP19
Average Recall.

Modes compare sparse-sampling ICP (``target_pts`` 300, 100) with dense ICP
(``target_pts=0``). ``--detector``: ``perfect`` (the true visible
silhouette), ``degraded:<px>`` (that silhouette eroded or dilated by up to
px pixels with boundary jitter, ``camera.masks.degrade_mask``), ``trained``
(YOLO11n-seg fine-tuned by the port's trainer on renders of the object) or
``trained-ckpt`` (those weights saved as an fp16 Ultralytics-style
checkpoint and read back through ``Detector``). ``--objects N`` runs the
``MultiTracker`` on N instances.

Runs on the card unless ``--cpu`` or ``--device cpu`` is given:

    python -m poseestimator_tpu_torch.apps.eval_tracking              # 100 frames, 300 vs 0
    python -m poseestimator_tpu_torch.apps.eval_tracking --modes 0 --detector degraded:2
    python -m poseestimator_tpu_torch.apps.eval_tracking --cpu --res 128x96 --frames 20

Prints one JSON line per mode and a markdown table.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from .. import kernel_cases as kc
from ..device import resolve_device

RENDER_SAMPLES = 150_000  # the splat instrument's CAD samples (the estimator's in the JAX package)
WARMUP_FRAMES = 12  # static frames before the object turns


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--frames", type=int, default=100, help="tracked frames per mode")
    p.add_argument("--modes", default="300,0",
                   help="comma list of target_pts values (0 = dense ICP)")
    p.add_argument("--rot-per-frame", type=float, default=0.008,
                   help="object rotation per frame, radians")
    p.add_argument("--scale", type=float, default=1.0, help="object scale (m)")
    p.add_argument("--res", default="640x480", help="camera WxH")
    p.add_argument("--icp-dist", type=float, default=0.01,
                   help="tracking ICP correspondence distance")
    p.add_argument("--icp-variant", default="p2p", choices=["p2p", "p2l"])
    p.add_argument("--icp-kernel", default="none", choices=["none", "huber", "tukey"])
    p.add_argument("--motion-model", default="none", choices=["none", "constant_velocity"])
    p.add_argument("--smooth-alpha", type=float, default=1.0,
                   help="SE(3) alpha-beta output pose filter gain (1 = off)")
    p.add_argument("--smooth-beta", type=float, default=0.3)
    p.add_argument("--detector", default="perfect",
                   help="perfect | degraded:<px> | trained | trained-ckpt")
    p.add_argument("--detector-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="YOLO compute dtype for the trained detectors")
    p.add_argument("--conf", default="0.7",
                   help="trained detector confidence; 'auto' = half the weakest "
                        "validation view's top score")
    p.add_argument("--train-epochs", type=int, default=120)
    p.add_argument("--train-images", type=int, default=48)
    p.add_argument("--train-lr", type=float, default=0.004)
    p.add_argument("--train-imgsz", type=int, default=0,
                   help="training letterbox size; 0 = camera width rounded up to 32")
    p.add_argument("--observation", default="splat", choices=["splat", "mesh", "analytic"],
                   help="the camera's instrument: point splat, exact triangle raster, "
                        "or the closed-form ray cast of the L-shape")
    p.add_argument("--noise-sigma", type=float, default=0.0, help="depth noise (m)")
    p.add_argument("--kidnap", type=int, default=0,
                   help="teleport the object after this many turning frames (0 = off)")
    p.add_argument("--kidnap-angle", type=float, default=1.2)
    p.add_argument("--kidnap-shift", type=float, default=0.5)
    p.add_argument("--reinit-fitness", type=float, default=0.0)
    p.add_argument("--reinit-patience", type=int, default=8)
    p.add_argument("--occlude", type=float, default=0.0,
                   help="occluding plate over this fraction of the object's width")
    p.add_argument("--background-depth", type=float, default=0.0,
                   help="background wall depth in units of the object distance (0 = none)")
    p.add_argument("--objects", type=int, default=1,
                   help="object instances; > 1 runs the MultiTracker")
    p.add_argument("--mixed-cad", action="store_true",
                   help="with --objects > 1: odd instances are a box CAD (class 1)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (--device cpu)")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    p.add_argument("--json-out", default=None, help="also write the rows here")
    return p


def _device(args) -> torch.device:
    return resolve_device("cpu" if args.cpu else args.device)


def _parse_px(spec: str) -> int:
    return int(spec.split(":", 1)[1]) if ":" in spec else 2


def _one_detection(dev, mask):
    from ..models.yolo.nms import Detections

    det = Detections(boxes=torch.zeros(1, 4, device=dev), scores=torch.ones(1, device=dev),
                     classes=torch.zeros(1, dtype=torch.int64, device=dev),
                     coeffs=torch.zeros(1, 32, device=dev),
                     valid=torch.ones(1, dtype=torch.bool, device=dev))
    return det, mask[None], torch.zeros(1, 4, device=dev)


class PerfectMaskDetector:
    """The camera's true visible silhouette (``object_mask``, else depth >
    0) as the one detection: isolates tracking from detection."""

    def __init__(self, camera, device):
        self.camera, self.device = camera, device

    def __call__(self, img, conf=0.7, iou=0.7):
        om = getattr(self.camera, "object_mask", None)
        mask = (torch.from_numpy(np.asarray(om)).to(self.device) if om is not None
                else self.camera.depth > 0)
        return _one_detection(self.device, mask)


class DegradedMaskDetector(PerfectMaskDetector):
    """The perfect mask through ``degrade_mask`` (``px`` pixels, numpy
    generator seeded ``seed``): the error of a real segmentation model."""

    def __init__(self, camera, device, px: int, seed: int = 0):
        super().__init__(camera, device)
        self.px, self.rng = int(px), np.random.default_rng(seed)

    def __call__(self, img, conf=0.7, iou=0.7):
        from ..camera.masks import degrade_mask

        det, masks, boxes = super().__call__(img, conf, iou)
        return det, degrade_mask(masks[0], self.px, self.rng)[None], boxes


class PerfectMultiMaskDetector:
    """One detection per visible instance from the camera's
    ``object_masks`` (degraded per instance when ``degrade_px > 0``); a
    fully hidden instance yields none that frame. ``classes``: each
    instance's class id."""

    def __init__(self, camera, device, max_det: int = 8, degrade_px: int = 0, seed: int = 0,
                 classes=None):
        self.camera, self.device = camera, device
        self.max_det, self.px = max_det, int(degrade_px)
        self.rng = np.random.default_rng(seed)
        self.classes = classes

    def __call__(self, img, conf=0.7, iou=0.7):
        from ..camera.masks import degrade_mask
        from ..models.yolo.nms import Detections

        ms = np.asarray(self.camera.object_masks)
        if self.px > 0:
            ms = np.stack([degrade_mask(torch.from_numpy(m), self.px, self.rng).numpy()
                           for m in ms])
        Hm, Wm = ms.shape[1:]
        masks = np.zeros((self.max_det, Hm, Wm), bool)
        boxes = np.zeros((self.max_det, 4), np.float32)
        valid = np.zeros(self.max_det, bool)
        cls = np.zeros(self.max_det, np.int64)
        j = 0
        for i in range(min(ms.shape[0], self.max_det)):
            ys, xs = np.where(ms[i])
            if len(xs) == 0:
                continue
            masks[j], boxes[j], valid[j] = ms[i], (xs.min(), ys.min(), xs.max(), ys.max()), True
            if self.classes is not None:
                cls[j] = self.classes[i]
            j += 1
        t = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        det = Detections(boxes=t(boxes), scores=t(valid.astype(np.float32)), classes=t(cls),
                         coeffs=torch.zeros(self.max_det, 32, device=self.device), valid=t(valid))
        return det, t(masks), t(boxes)


def frame_metrics(T_e, T_g, model_pts, cad_pts, cad_valid, intr, diag: float):
    """One tracked frame's scores against the truth: ``(ADD-S, MSSD (m),
    MSPD (px), VSD (10,) over BOP_FRACS x diag)``."""
    from ..geom3d.metrics import adds_metric, mspd_metric, mssd_metric
    from ..render.points import vsd_multi_tau
    from ..utils.bop import BOP_FRACS

    dev = model_pts.points.device
    T_e = torch.as_tensor(np.asarray(T_e, np.float32), device=dev)
    T_g = torch.as_tensor(np.asarray(T_g, np.float32), device=dev)
    K = torch.as_tensor(np.asarray(intr.K, np.float32), device=dev)
    taus = torch.as_tensor(np.asarray(BOP_FRACS * diag, np.float32), device=dev)
    return (float(adds_metric(T_e, T_g, model_pts)), float(mssd_metric(T_e, T_g, model_pts)),
            float(mspd_metric(T_e, T_g, K, model_pts)),
            vsd_multi_tau(T_e, T_g, cad_pts, cad_valid, intr, taus).cpu().numpy())


def series_row(adds, mssds, mspds, vsds, diag: float, width: int, est_poses=None,
               gt_poses=None, frames=None, sig_t=(), sig_r=()) -> dict:
    """The accuracy fields of a single-object row from per-frame series:
    ADD-S, MSSD (m), MSPD (px), VSD (F, 10); and, from the reported and
    true poses with their camera frame numbers, the motion-compensated
    jitter (consecutive frames only) and its ratio to the tracker's sigmas
    (``sig_t`` mm, ``sig_r`` deg)."""
    from ..utils.bop import bop_average_recall

    adds = np.asarray(adds)
    vsds = np.asarray(vsds)
    head = adds[: max(len(adds) // 10, 1)]
    tail = adds[-max(len(adds) // 10, 1):]
    jit_t, jit_r = [], []
    prev = None
    for Te, Tg, f in zip(est_poses or (), gt_poses or (), frames or ()):
        Te, Tg = np.asarray(Te, np.float64), np.asarray(Tg, np.float64)
        if prev is not None and f == prev[2] + 1:
            E = (Te @ np.linalg.inv(prev[0])) @ np.linalg.inv(Tg @ np.linalg.inv(prev[1]))
            jit_t.append(float(np.linalg.norm(E[:3, 3])))
            jit_r.append(float(np.arccos(np.clip((np.trace(E[:3, :3]) - 1) / 2, -1, 1))))
        prev = (Te, Tg, f)
    sig_t, sig_r = list(sig_t), list(sig_r)
    return {
        "adds_mean_cm": round(float(adds.mean()) * 100, 2),
        "adds_p95_cm": round(float(np.percentile(adds, 95)) * 100, 2),
        "adds_first10pct_cm": round(float(head.mean()) * 100, 2),
        "adds_last10pct_cm": round(float(tail.mean()) * 100, 2),
        "adds_mean_vs_diag_pct": round(float(adds.mean()) / diag * 100, 2),
        "mssd_mean_cm": round(float(np.mean(mssds)) * 100, 2),
        "mssd_p95_cm": round(float(np.percentile(mssds, 95)) * 100, 2),
        "mspd_mean_px": round(float(np.mean(mspds)), 2),
        "mspd_p95_px": round(float(np.percentile(mspds, 95)), 2),
        "vsd_mean": round(float(np.mean(vsds[:, 1])), 4),
        "vsd_recall_03": round(float(np.mean(vsds[:, 1] < 0.3)), 4),
        **bop_average_recall(vsds, np.asarray(mssds), np.asarray(mspds), diameter=diag,
                             image_width=width),
        "jitter_t_mm": round(float(np.mean(jit_t)) * 1000, 3) if jit_t else None,
        "jitter_r_mrad": round(float(np.mean(jit_r)) * 1000, 3) if jit_r else None,
        "sigma_t_mean_mm": round(float(np.mean(sig_t)), 3) if sig_t else None,
        "sigma_r_mean_deg": round(float(np.mean(sig_r)), 4) if sig_r else None,
        "cov_calib_jitter_ratio": round(
            float(np.sqrt(np.mean(np.square(jit_t))) * 1000.0
                  / max(np.sqrt(2.0 * np.mean(np.square(sig_t))), 1e-9)), 2)
        if jit_t and sig_t else None,
    }


def _look_at_cv(eye) -> np.ndarray:
    from ..geom3d.se3 import look_at

    return kc.GL_TO_CV @ look_at(np.asarray(eye, np.float64), np.zeros(3),
                                 [0.0, 1.0, 0.0]).numpy().astype(np.float64)


def _rot_z(a: float) -> np.ndarray:
    P = np.eye(4, dtype=np.float32)
    P[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    return P


def _cad_samples(mesh, seed: int) -> np.ndarray:
    """The splat instrument's RENDER_SAMPLES surface points of ``mesh``, as
    the JAX package's estimator samples them with its ``seed``."""
    return mesh.sample_points_uniformly(RENDER_SAMPLES, np.random.default_rng(seed))[0]


def _model_points(mesh, seed: int, dev):
    from ..geom3d.cloud import from_points

    return from_points(mesh.sample_points_uniformly(512, np.random.default_rng(seed))[0],
                       device=dev)


def _run_multi_mode(args, dev, estimator, model_pts, diag, intr, mode, mixed=None):
    """One ``--objects N`` row: N instances turn in one scene, the
    ``MultiTracker`` steps them in one batched step, and each track is
    scored every frame against its nearest true instance of its class."""
    from ..camera import SyntheticCamera
    from ..geom3d.metrics import adds_metric
    from ..pipeline.multi_tracking import MultiTracker

    if args.detector != "perfect" and not args.detector.startswith("degraded"):
        raise SystemExit("--objects >1 supports --detector perfect|degraded:<px>")
    n_obj = args.objects
    cls_of_inst = [i % 2 if mixed else 0 for i in range(n_obj)]
    models = {0: model_pts}
    est2 = None
    if mixed is not None:
        est2, models[1] = mixed
    d = np.array([1.0, 1.0, 1.0]) / np.sqrt(3)
    offs = [(i - (n_obj - 1) / 2) * 0.65 * diag for i in range(n_obj)]
    dists = [diag * (2.3 + 0.12 * i) for i in range(n_obj)]
    phases = [0.1 + 1.1 * i for i in range(n_obj)]
    bases = [_look_at_cv(d * dists[i]) for i in range(n_obj)]

    def stack_at(a):
        Ts = []
        for i in range(n_obj):
            T = (_rot_z(phases[i] + a) @ bases[i]).astype(np.float32)
            T[0, 3] += offs[i]
            Ts.append(T)
        return np.stack(Ts)

    def poses():
        for _ in range(n_obj + 2):  # one spawn a frame: N frames and slack to acquire
            yield stack_at(0.0)
        a = 0.0
        for _ in range(args.frames):
            a += args.rot_per_frame
            yield stack_at(a)

    use_mesh = args.observation == "mesh"
    pts = _cad_samples(estimator.mesh, 0)
    inst_geoms = None
    if mixed is not None:
        pts2 = _cad_samples(est2.mesh, 1)
        inst_geoms = [(pts, np.zeros_like(pts)), (pts2, np.zeros_like(pts2))]
    cam = SyntheticCamera(
        pts, np.zeros_like(pts), poses(), intr, noise_sigma=args.noise_sigma,
        filter_depth=args.noise_sigma > 0, instance_geoms=inst_geoms,
        mesh=estimator.mesh if use_mesh else None,
        instance_meshes=[estimator.mesh, est2.mesh] if (use_mesh and mixed is not None) else None,
        device=dev)
    deg_px = _parse_px(args.detector) if args.detector.startswith("degraded") else 0
    detector = PerfectMultiMaskDetector(cam, dev, max_det=max(8, n_obj), degrade_px=deg_px,
                                        classes=cls_of_inst)
    tracker = MultiTracker(cam, {0: estimator, 1: est2} if mixed is not None else estimator,
                           detector, max_objects=n_obj, target_pts=mode, icp_dist=args.icp_dist,
                           conf=0.7, iou_match=0.2, smooth_alpha=args.smooth_alpha,
                           smooth_beta=args.smooth_beta, device=dev)
    per_frame, assign, step_ms = [], {}, []
    distinct_frames = id_switches = fidx = 0
    acquired_at = None
    while (res := tracker.step()) is not None:
        fidx += 1
        if "track_batch" in res.timings and len(res.tracks) == n_obj:
            step_ms.append(res.timings["track_batch"] * 1000)
        if len(res.tracks) < n_obj:
            continue
        if acquired_at is None:
            acquired_at = fidx
        gts = np.asarray(cam.current_gt)
        frame_errs, seen = [], set()
        for tr in res.tracks:
            cand = [i for i in range(n_obj) if cls_of_inst[i] == tr.class_id]
            T_out = torch.as_tensor(np.asarray(tr.T_out, np.float32), device=dev)
            errs = [float(adds_metric(T_out, torch.from_numpy(gts[i]).to(dev),
                                      models[tr.class_id])) for i in cand]
            jbest = cand[int(np.argmin(errs))]
            prev = assign.get(tr.track_id)
            if prev is not None and prev != jbest:
                id_switches += 1
            assign[tr.track_id] = jbest
            seen.add(jbest)
            frame_errs.append(min(errs))
        distinct_frames += len(seen) == n_obj
        per_frame.append(frame_errs)
    if not per_frame:
        print(f"objects={n_obj} mode={mode}: never acquired all instances", file=sys.stderr)
        return None
    per_frame = np.asarray(per_frame)  # (F, N)
    adds = per_frame.reshape(-1)
    tail = per_frame[-max(len(per_frame) // 10, 1):].reshape(-1)
    return {
        "mode": "dense" if mode == 0 else f"{mode}pt", "target_pts": mode, "objects": n_obj,
        "frames_scored": int(len(per_frame)), "acquired_at_frame": acquired_at,
        "adds_mean_cm": round(float(adds.mean()) * 100, 2),
        "adds_p95_cm": round(float(np.percentile(adds, 95)) * 100, 2),
        "adds_last10pct_cm": round(float(tail.mean()) * 100, 2),
        "adds_mean_vs_diag_pct": round(float(adds.mean()) / diag * 100, 2),
        "per_object_adds_cm": [round(float(v) * 100, 2) for v in per_frame.mean(0)],
        "mixed_cad": bool(mixed is not None),
        "classes_of_instances": cls_of_inst if mixed is not None else None,
        "id_switches": id_switches,
        "frames_distinct": round(distinct_frames / len(per_frame), 4),
        "track_batch_ms_median": round(float(np.median(step_ms)), 2) if step_ms else None,
        "icp_dist": args.icp_dist, "smooth_alpha": args.smooth_alpha,
        "detector": "perfect-multi" if deg_px == 0 else f"degraded-multi:{deg_px}",
        "rot_per_frame": args.rot_per_frame, "noise_sigma": args.noise_sigma,
    }


def train_object_detector(args, dev, estimator, intr, tmp: str, quiet: bool = False):
    """Fine-tune YOLO11n-seg on renders of the evaluation object by the
    camera's own instrument (written as JPEG, labelled by the silhouette's
    polygon) with the port's trainer; returns ``(Detector, box mAP50, the
    weakest validation view's top score at conf 0.001)``.

    The splat instrument's colour (``render_shaded`` over normal-less CAD
    samples, as the JAX package renders them) shades only points within
    0.1 mm of the splat's nearest depth: a couple of pixels of the object,
    the rest white, in both packages. With ``--observation mesh`` the
    renders are the mesh camera's own depth-gradient shading, which shows
    the object, and the detector sees at training what it sees at
    tracking."""
    from ..geom3d.se3 import look_at
    from ..models.yolo.masks import masks_to_polygons
    from ..pipeline.detector import Detector
    from ..render.points import render_shaded
    from ..render.raster import render_depth_mesh, shade_depth_image
    from ..training.trainer import TrainConfig, Trainer
    from ..utils.image import read_image, write_image

    W, H = intr.width, intr.height
    root = os.path.join(tmp, "detset")
    rng = np.random.default_rng(0)
    diag = float(np.linalg.norm(estimator.mesh.extent))
    cad = torch.from_numpy(_cad_samples(estimator.mesh, 0)).to(dev)
    cad_valid = torch.ones(len(cad), dtype=torch.bool, device=dev)
    mesh_v = torch.from_numpy(np.asarray(estimator.mesh.vertices, np.float32)).to(dev)
    mesh_f = torch.from_numpy(np.asarray(estimator.mesh.faces, np.int64)).to(dev)
    n_train = args.train_images
    n_val = max(n_train // 4, 3)  # the val views double as the auto-conf calibration set
    for split, n_imgs in (("train_d", n_train), ("val_d", n_val)):
        os.makedirs(os.path.join(root, split, "images"), exist_ok=True)
        os.makedirs(os.path.join(root, split, "labels"), exist_ok=True)
        for i in range(n_imgs):
            az = rng.uniform(0, 2 * np.pi)
            el = rng.uniform(-0.3, 1.2)
            d = np.array([np.cos(el) * np.cos(az), np.sin(el), np.cos(el) * np.sin(az)])
            dist = diag * rng.uniform(1.6, 2.6)
            T = (kc.GL_TO_CV @ look_at(d * dist, np.zeros(3), [0.0, 1.0, 0.0]).numpy()
                 ).astype(np.float32)
            Tt = torch.from_numpy(T).to(dev)
            if args.observation == "mesh":
                depth = render_depth_mesh(mesh_v, mesh_f, Tt, intr, near=0.01, far=10.0)
                rgb = shade_depth_image(depth, intr)
            else:
                depth, rgb = render_shaded(cad, torch.zeros_like(cad), cad_valid, Tt, intr,
                                           near=0.01, far=10.0)
            img = np.ascontiguousarray((rgb.cpu().numpy()[..., ::-1] * 255).astype(np.uint8))
            polys = masks_to_polygons(depth.cpu().numpy() > 0)
            if not polys:
                continue
            poly = polys[0].astype(np.float32)
            poly[:, 0] /= W
            poly[:, 1] /= H
            write_image(os.path.join(root, split, "images", f"{i:04d}.jpg"), img)
            with open(os.path.join(root, split, "labels", f"{i:04d}.txt"), "w") as f:
                f.write("0 " + " ".join(f"{v:.5f}" for v in poly.reshape(-1)))
    yml = os.path.join(root, "dataset.yaml")
    with open(yml, "w") as f:
        f.write(f"path: {root}\ntrain: train_d\nval: val_d\nnames:\n    0: \"object\"\n")
    imgsz = args.train_imgsz or ((W + 31) // 32 * 32)
    cfg = TrainConfig(data=yml, epochs=args.train_epochs, imgsz=imgsz, batch=min(8, n_train),
                      lr0=args.train_lr, warmup_epochs=3.0, patience=max(args.train_epochs, 10),
                      project=os.path.join(tmp, "runs"), name="evalobj", workers=2,
                      augment=False, max_instances=4, device=dev)
    tr = Trainer(cfg)
    state, _ = tr.fit(log=lambda *a: None, tensorboard=False)
    det = Detector(tr.export_variables(state), nc=1, imgsz=imgsz, dtype=args.detector_dtype,
                   device=dev)
    m = tr.evaluate_map(state)
    # calibrated on the weakest validation view, so that every view clears it
    tops = []
    for name in sorted(os.listdir(os.path.join(root, "val_d", "images"))):
        probe, _, _ = det(read_image(os.path.join(root, "val_d", "images", name)), conf=0.001)
        tops.append(float(probe.scores.max()))
    top = min(tops)
    if not quiet:
        print(f"trained detector: box mAP50 {m['map50']:.3f}, top conf {top:.3f} (min over "
              f"{len(tops)} val views; {n_train} synthetic renders, {args.train_epochs} epochs, "
              f"imgsz {imgsz})")
    return det, m["map50"], top


def ckpt_roundtrip_detector(args, det, tmp: str):
    """``det``'s network saved as an Ultralytics-style artifact (the fp16
    module under ``{"model": ...}``) and read back through ``Detector``'s
    checkpoint loader: every weight it runs went through fp16."""
    from ..models.yolo.model import YOLO11Seg
    from ..pipeline.detector import Detector

    model = YOLO11Seg(nc=det.nc, scale=det.scale)
    model.load_state_dict({k: v.cpu() for k, v in det.variables.items()}, strict=True)
    path = os.path.join(tmp, "best_roundtrip.pt")
    torch.save({"model": model.half(), "epoch": 0, "train_args": {"imgsz": det.imgsz}}, path)
    return Detector(path, nc=det.nc, scale=det.scale, imgsz=det.imgsz, dtype=args.detector_dtype,
                    device=det.device)


def make_camera(args, dev, estimator, intr, n_frames: int):
    """The single-object stream: WARMUP_FRAMES static frames at 0.1 rad,
    then ``n_frames`` turning ``--rot-per-frame``, with the kidnap jump."""
    from ..camera import SyntheticCamera
    from ..camera.analytic import make_lshape_raycaster

    diag = float(np.linalg.norm(estimator.mesh.extent))
    dist = diag * 2.0
    base = _look_at_cv(np.array([1.0, 1.0, 1.0]) / np.sqrt(3) * dist)

    def poses():
        a = 0.1
        for _ in range(WARMUP_FRAMES):
            yield (_rot_z(a) @ base).astype(np.float32)
        shift = 0.0
        for i in range(n_frames):
            a += args.rot_per_frame
            if args.kidnap and i == args.kidnap:
                # an in-plane roll and an approach beyond the correspondence gate
                a += args.kidnap_angle
                shift = args.kidnap_shift
            T = (_rot_z(a) @ base).astype(np.float32)
            T[2, 3] -= shift
            yield T

    pts = _cad_samples(estimator.mesh, 0)
    occluder = None
    if args.occlude > 0:
        half = 0.5 * args.occlude * intr.fx * diag / dist
        occluder = (max(0, int(intr.cx - half)), min(intr.width, int(intr.cx + half)), 0.5 * dist)
    return SyntheticCamera(
        pts, np.zeros_like(pts), poses(), intr, noise_sigma=args.noise_sigma,
        background_depth=args.background_depth * dist, occluder=occluder,
        filter_depth=args.noise_sigma > 0,  # noisy streams take the RealSense chain
        mesh=estimator.mesh if args.observation == "mesh" else None,
        depth_fn=(make_lshape_raycaster(intr, args.scale)
                  if args.observation == "analytic" else None),
        device=dev)


def run(args, quiet: bool = False):
    """Every mode's row (a list of dicts); prints them unless ``quiet``."""
    from ..geom3d.camera import Intrinsics
    from ..pipeline import PoseEstimator, Tracker
    from ..utils.plyio import write_ply

    dev = _device(args)
    W, H = (int(v) for v in args.res.split("x"))
    intr = Intrinsics.from_fov(60.0, W, H)
    tmp = tempfile.mkdtemp(prefix="eval_tracking_")
    cad = os.path.join(tmp, "l.ply")
    verts, faces = kc.lshape_mesh(args.scale)
    write_ply(cad, verts, faces=faces)

    trained = {"det": None, "map50": None}
    eff_conf = None if args.conf == "auto" else float(args.conf)

    def make_detector(camera, estimator):
        nonlocal eff_conf
        spec = args.detector
        if spec == "perfect":
            return PerfectMaskDetector(camera, dev)
        if spec.startswith("degraded"):
            return DegradedMaskDetector(camera, dev, _parse_px(spec))
        if spec in ("trained", "trained-ckpt"):
            if trained["det"] is None:  # trained once, used by every mode
                det, trained["map50"], top = train_object_detector(args, dev, estimator, intr,
                                                                   tmp, quiet)
                trained["det"] = ckpt_roundtrip_detector(args, det, tmp) if spec == "trained-ckpt" \
                    else det
                if eff_conf is None:
                    eff_conf = float(np.clip(0.5 * top, 0.005, 0.7))
                    if not quiet:
                        print(f"auto conf -> {eff_conf:.3f}")
                elif top < eff_conf and not quiet:
                    print(f"WARNING: --conf {eff_conf} exceeds the trained model's top score "
                          f"{top:.3f}; detection will never fire (use --conf auto)")
            return trained["det"]
        raise ValueError(f"unknown --detector {spec!r}")

    results = []
    for mode in [int(m) for m in args.modes.split(",")]:
        estimator = PoseEstimator(cad, os.path.join(tmp, "views"), intr,
                                  target_points=mode or 100, seed=0, device=dev)
        model_pts = _model_points(estimator.mesh, 0, dev)
        diag = float(np.linalg.norm(estimator.mesh.extent))
        if args.objects > 1:
            mixed = None
            if args.mixed_cad:
                cad2 = os.path.join(tmp, "b.ply")
                s = args.scale
                v2, f2 = kc.box_mesh((0.5 * s, 0.3 * s, 0.2 * s))
                write_ply(cad2, v2, faces=f2)
                est2 = PoseEstimator(cad2, os.path.join(tmp, "views_b"), intr,
                                     target_points=mode or 100, seed=1, device=dev)
                mixed = (est2, _model_points(est2.mesh, 1, dev))
            row = _run_multi_mode(args, dev, estimator, model_pts, diag, intr, mode, mixed)
            if row is not None:
                results.append(row)
                if not quiet:
                    print(json.dumps(row))
            continue
        cam = make_camera(args, dev, estimator, intr, args.frames)
        detector = make_detector(cam, estimator)  # may resolve the auto confidence
        tracker = Tracker(cam, estimator, detector, target_pts=mode, icp_dist=args.icp_dist,
                          icp_variant=args.icp_variant, icp_kernel=args.icp_kernel,
                          motion_model=args.motion_model, smooth_alpha=args.smooth_alpha,
                          smooth_beta=args.smooth_beta, reinit_fitness=args.reinit_fitness,
                          reinit_patience=args.reinit_patience,
                          conf=0.7 if eff_conf is None else eff_conf, class_id=0,
                          warmup_frames=3, max_init_frames=20, device=dev)
        cad_pts = torch.from_numpy(_cad_samples(estimator.mesh, 0)).to(dev)
        cad_valid = torch.ones(len(cad_pts), dtype=torch.bool, device=dev)
        adds, mssds, mspds, vsds = [], [], [], []
        est_poses, gt_poses, frames, sig_t, sig_r = [], [], [], [], []
        # the camera frame of the kidnap (frames_served counts delivered frames)
        kidnap_frame = (WARMUP_FRAMES + args.kidnap + 1) if args.kidnap else None
        recovery_frames = None
        while (res := tracker.step()) is not None:
            if not (res.state == "track" and res.detected and res.T_m2c is not None):
                continue
            m = frame_metrics(res.T_m2c, cam.current_gt, model_pts, cad_pts, cad_valid, intr,
                              diag)
            for lst, v in zip((adds, mssds, mspds, vsds), m):
                lst.append(v)
            if (kidnap_frame is not None and recovery_frames is None
                    and cam.frames_served >= kidnap_frame and adds[-1] < 0.03 * diag):
                recovery_frames = cam.frames_served - kidnap_frame
            est_poses.append(np.asarray(res.T_m2c, np.float64))
            gt_poses.append(np.asarray(cam.current_gt, np.float64))
            frames.append(cam.frames_served)
            if res.pose_cov is not None:
                sig_t.append(res.sigma_t_mm)
                sig_r.append(res.sigma_rot_deg)
        if not adds:
            print(f"mode target_pts={mode}: tracking never started", file=sys.stderr)
            continue
        acc = series_row(adds, mssds, mspds, vsds, diag, intr.width, est_poses, gt_poses, frames,
                         sig_t, sig_r)
        row = {"mode": "dense" if mode == 0 else f"{mode}pt", "target_pts": mode,
               "motion_frames": int(args.frames), "camera_frames": int(WARMUP_FRAMES + args.frames),
               "frames_tracked": len(adds)}
        row.update({k: acc[k] for k in ("adds_mean_cm", "adds_p95_cm", "adds_first10pct_cm",
                                        "adds_last10pct_cm", "adds_mean_vs_diag_pct",
                                        "mssd_mean_cm", "mssd_p95_cm", "mspd_mean_px",
                                        "mspd_p95_px", "vsd_mean", "vsd_recall_03", "ar_vsd",
                                        "ar_mssd", "ar_mspd", "bop_ar")})
        row.update({"icp_dist": args.icp_dist, "icp_variant": args.icp_variant,
                    "icp_kernel": args.icp_kernel, "motion_model": args.motion_model,
                    "smooth_alpha": args.smooth_alpha})
        row.update({k: acc[k] for k in ("jitter_t_mm", "jitter_r_mrad", "sigma_t_mean_mm",
                                        "sigma_r_mean_deg", "cov_calib_jitter_ratio")})
        row.update({"detector": args.detector,
                    "conf": None if eff_conf is None else round(eff_conf, 4),
                    "rot_per_frame": args.rot_per_frame, "occlude": args.occlude,
                    "background_depth": args.background_depth})
        if args.kidnap:
            row.update({"kidnap_frame": kidnap_frame, "kidnap_shift": args.kidnap_shift,
                        "reinit_fitness": args.reinit_fitness,
                        "recovery_frames": recovery_frames})
        if trained["map50"] is not None:
            row["detector_map50"] = round(trained["map50"], 4)
        results.append(row)
        if not quiet:
            print(json.dumps(row))

    if results and not quiet:
        print_table(results, args.objects > 1)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(results, f, indent=2)
    return results


def print_table(results, multi: bool) -> None:
    if multi:
        print("\n| ICP mode | objects | ADD-S mean | p95 | acquired@ | id switches |")
        print("|---|---|---|---|---|---|")
        for r in results:
            print(f"| {r['mode']} | {r['objects']} | {r['adds_mean_cm']} cm "
                  f"({r['adds_mean_vs_diag_pct']}% diag) | {r['adds_p95_cm']} cm "
                  f"| frame {r['acquired_at_frame']} | {r['id_switches']} |")
        return
    print("\n| ICP mode | ADD-S mean | p95 | first 10% -> last 10% |")
    print("|---|---|---|---|")
    for r in results:
        print(f"| {r['mode']} | {r['adds_mean_cm']} cm ({r['adds_mean_vs_diag_pct']}% diag) "
              f"| {r['adds_p95_cm']} cm | {r['adds_first10pct_cm']} -> "
              f"{r['adds_last10pct_cm']} cm |")


def main(argv=None):
    return 0 if run(build_parser().parse_args(argv)) else 1


if __name__ == "__main__":
    sys.exit(main())
