"""Real-time 6D pose tracking at camera rate (counterpart of
``poseestimator_tpu/apps/main_realsense.py``): warm-up detection, the
template search for the first pose, then the render-predict-ICP loop of
``Tracker`` (or ``MultiTracker`` with ``--multi``) with re-initialisation
when the detection is lost; the per-stage times of each tracked frame and
the CAD overlay on every frame.

Sources (``--source``): ``realsense`` (a live camera), ``replay:<dir>``
(``color_*.png`` + ``depth_*.npy`` + ``intrinsics.npy``, as
``camera/record.py`` writes them) or ``synthetic`` (the CAD rendered by the
point-splat ``SyntheticCamera`` at 640x480, 2.5 diagonals out along (1, 1,
1), turning 0.01 rad a frame about the optical axis). A replay takes the
recorded depth as it is: ``record`` saves the camera's depth after the
live camera's RealSense filters ran, so they do not run a second time (the
JAX app runs them again), and a replay of a recorded session gives its
poses bit for bit.

The port opens no windows: run it with ``--headless``; without it the app
exits at once saying so. ``--detector-dtype bfloat16`` runs the detector's
network in bfloat16 inside the fused frame (its parameters, and all the
geometry, stay float32).

Run:
    python -m poseestimator_tpu_torch.apps.main_realsense --headless \\
        --source synthetic --cad-path obj.ply --pcd-path views/ \\
        --weights W.pt [--max-frames 40] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from ..camera import RealSenseCamera, ReplayCamera, SyntheticCamera
from ..device import resolve_device
from ..geom3d.camera import Intrinsics
from ..geom3d.se3 import look_at, rot_z
from ..pipeline import Detector, MultiTracker, PoseEstimator, Tracker
from ..render.mesh import TriangleMesh
from ..utils.image import IMREAD_COLOR, read_image
from ..utils.metrics_log import MetricsLogger
from ..utils.overlay import draw_model_projection_with_axes, timer_print

NO_WINDOWS = "the PyTorch port opens no windows: run with --headless"


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--weights", default="./data/best.pt")
    p.add_argument("--pcd-path", default="./data/lego_views/")
    p.add_argument("--cad-path", default="./data/obj_000001.ply")
    p.add_argument("--target-pts", type=int, default=0,
                   help="points per cloud for the tracking ICP; 0 = dense (the compacted "
                        "4096-point clouds)")
    p.add_argument("--track-every", type=int, default=1)
    p.add_argument("--source", default="realsense",
                   help="realsense | replay:<dir with color_*.png/depth_*.npy> | synthetic")
    p.add_argument("--nc", type=int, default=5)
    p.add_argument("--detector-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="the detector network's compute dtype inside the fused frame; "
                        "bfloat16 runs its convs on the tensor cores' format (geometry "
                        "stays float32: only the detection mask is affected)")
    p.add_argument("--conf", type=float, default=0.7)
    p.add_argument("--max-frames", type=int, default=0, help="0 = unlimited")
    p.add_argument("--headless", action="store_true", help="required: the port opens no windows")
    p.add_argument("--icp-dist", type=float, default=0.01)
    p.add_argument("--icp-variant", default="p2p", choices=["p2p", "p2l"],
                   help="tracking ICP: point-to-point or point-to-plane on observed normals")
    p.add_argument("--icp-kernel", default="none", choices=["none", "huber", "tukey"],
                   help="IRLS robust kernel on the ICP residuals")
    p.add_argument("--motion-model", default="none", choices=["none", "constant_velocity"],
                   help="render-predict pose: the last estimate or a constant-velocity "
                        "extrapolation")
    p.add_argument("--smooth-alpha", type=float, default=1.0,
                   help="SE(3) alpha-beta output filter gain (1 = off)")
    p.add_argument("--smooth-beta", type=float, default=0.3)
    p.add_argument("--reinit-fitness", type=float, default=0.0,
                   help="ICP fitness below this for --reinit-patience frames re-runs the "
                        "global search (0 = off)")
    p.add_argument("--reinit-patience", type=int, default=8)
    p.add_argument("--min-fitness", type=float, default=0.25,
                   help="ICP fitness below this moves to the next ranked init candidate "
                        "(0 = off)")
    p.add_argument("--cad-overlay-points", type=int, default=200)
    p.add_argument("--view-set", default="full", choices=["reduced", "full"],
                   help="template views of the init search: the 26-view sphere or the "
                        "5-view upper-arc ring")
    p.add_argument("--init-rollout", type=int, default=2,
                   help="track the top candidate basins this many extra frames at init and "
                        "keep the best render score (0 = single-frame winner)")
    p.add_argument("--multi-cad", action="append", default=None, metavar="ID:CAD:VIEWS",
                   help="with --multi: an extra class as '<class_id>:<cad.ply>:<views_dir>' "
                        "(repeatable); --cad-path/--pcd-path serve class 0")
    p.add_argument("--multi", action="store_true",
                   help="track every detected instance (MultiTracker)")
    p.add_argument("--metrics", default=None, help="write per-frame JSONL metrics here")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    return p


def make_camera(args, intr_fallback):
    """The camera source of ``args.source`` (``intr_fallback``: the
    synthetic camera's intrinsics, and a replay's without intrinsics.npy)."""
    dev = resolve_device(args.device)
    if args.source == "realsense":
        return RealSenseCamera(device=dev)
    if args.source.startswith("replay:"):
        d = args.source.split(":", 1)[1]
        frames = []
        for f in sorted(os.listdir(d)):
            if f.startswith("color_") and f.endswith(".png"):
                idx = f[len("color_"):-len(".png")]
                frames.append((read_image(os.path.join(d, f), IMREAD_COLOR),
                               np.load(os.path.join(d, f"depth_{idx}.npy"))))
        intr_file = os.path.join(d, "intrinsics.npy")
        if os.path.exists(intr_file):
            K, w, h = np.load(intr_file, allow_pickle=True)
            intr = Intrinsics.from_K(K, int(w), int(h))
        else:
            intr = intr_fallback
        return ReplayCamera(frames, intr, filter_depth=False, loop=False, device=dev)
    if args.source == "synthetic":
        mesh = TriangleMesh.load(args.cad_path)
        if np.max(mesh.extent) >= 1.0:
            mesh = mesh.scale(0.001, center=np.zeros(3))
        pts, nrm = mesh.sample_points_uniformly(100_000)
        diag = float(np.linalg.norm(mesh.extent))
        d = np.array([1.0, 1.0, 1.0]) / np.sqrt(3)
        F = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
        base = F @ look_at(d * diag * 2.5, [0, 0, 0], [0, 1, 0]).numpy()

        def poses():
            a = 0.0
            while True:
                P = np.eye(4, dtype=np.float32)
                P[:3, :3] = rot_z(a).numpy()
                yield P @ base
                a += 0.01

        return SyntheticCamera(pts, nrm, poses(), intr_fallback, device=dev)
    raise ValueError(f"unknown source {args.source}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.headless:
        raise SystemExit(NO_WINDOWS)
    dev = resolve_device(args.device)
    cam = make_camera(args, Intrinsics.from_fov(60.0, 640, 480))
    intr, K = cam.rs_get_intrinsics()

    estimator = PoseEstimator(args.cad_path, args.pcd_path, intr, K, args.target_pts or 200,
                              view_set=args.view_set, device=dev)
    detector = Detector(args.weights, nc=args.nc, dtype=args.detector_dtype, device=dev)
    cad_points, _ = estimator.mesh.sample_points_uniformly(args.cad_overlay_points)
    cad_points_by_cls = {0: cad_points}  # per-class overlay clouds (--multi-cad)

    metrics = MetricsLogger(args.metrics) if args.metrics else None
    if args.multi:
        est_arg = estimator
        if args.multi_cad:
            ests = {0: estimator}
            for spec in args.multi_cad:
                cid, cad_p, views_p = spec.split(":", 2)
                ests[int(cid)] = PoseEstimator(cad_p, views_p, intr, K, args.target_pts or 200,
                                               view_set=args.view_set, device=dev)
                cad_points_by_cls[int(cid)], _ = ests[int(cid)].mesh.sample_points_uniformly(
                    args.cad_overlay_points)
            est_arg = ests
        tracker = MultiTracker(cam, est_arg, detector, target_pts=args.target_pts,
                               conf=args.conf, icp_dist=args.icp_dist,
                               smooth_alpha=args.smooth_alpha, smooth_beta=args.smooth_beta,
                               metrics=metrics, device=dev)
    else:
        tracker = Tracker(cam, estimator, detector, target_pts=args.target_pts,
                          track_every=args.track_every, conf=args.conf, icp_dist=args.icp_dist,
                          icp_variant=args.icp_variant, icp_kernel=args.icp_kernel,
                          motion_model=args.motion_model, smooth_alpha=args.smooth_alpha,
                          smooth_beta=args.smooth_beta, min_fitness=args.min_fitness,
                          reinit_fitness=args.reinit_fitness,
                          reinit_patience=args.reinit_patience,
                          init_rollout=args.init_rollout, metrics=metrics, device=dev)

    n = 0
    try:
        while True:
            t_all = time.time()
            res = tracker.step()
            if res is None:
                break
            n += 1
            if args.multi:
                for tr in res.tracks:
                    draw_model_projection_with_axes(
                        res.color, cad_points_by_cls.get(tr.class_id, cad_points), K, tr.T_out)
            else:
                if res.state == "track" and res.detected:
                    for k, v in res.timings.items():
                        timer_print(time.time() - v, k)
                    print(res.T_m2c)
                    print("=" * 50)
                    timer_print(t_all, "Full Time")
                if res.T_m2c is not None:
                    draw_model_projection_with_axes(res.color, cad_points, K, res.T_m2c)
            if args.max_frames and n >= args.max_frames:
                break
    except KeyboardInterrupt:
        print("Stopped by user")
    finally:
        cam.stop()
        if metrics is not None:
            print(metrics.summary())
            metrics.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
