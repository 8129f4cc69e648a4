#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's hand-written kernels from ``poseestimator_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, then drives the
port's two paths and checks their accuracy against ground truth:

- the main path, the fused detect + track frame (YOLO11n-seg at a 640
  letterbox, mesh render, dense point-to-point ICP), for 30 frames of the
  bench box scene;
- the init path, the global template search of ``PoseEstimator``: the bench
  box CAD written as a PLY, its 5-view template database rendered on the
  card, and the search run on two observations (the bench scene, and a pose
  near a template view), with the kernels held against their plain versions
  at the shapes the search gives them;
- the ``Tracker`` a user drives with ``step()``, on the L-shape scene of the
  JAX package's tracking evaluation (640x480, the exact-raster mesh camera,
  12 static frames then 30 turning 0.008 rad a frame): (a) dense and (b)
  sparse tracking with a perfect-mask detector, each to its ADD-S budget
  with every motion frame tracked (the L-shape is two-fold symmetric, so
  ADD-S is taken against the nearer of the true pose's two twins; the
  plain figure is printed beside it); (c) the fused detect + track frame with
  the full-width YOLO11n-seg on seeded random weights, through a scripted
  run of misses (TRACK -> LOST -> INIT with a second search -> TRACK) and
  the multi-frame init rollout; the kernels held against their plain
  versions at the shapes the tracker gives them; (d) dense with the
  evaluation's degraded masks (2 px, ``degrade_mask``) and (e) dense through
  the point-splat camera (the splat-stress row), each to the JAX package's
  bench budget; then point-to-plane ICP and the Huber and Tukey kernels once
  each on a view of the bench box that shows three faces;
- multi-object tracking, ``MultiTracker``, on the scene of the JAX
  package's ``tools/eval_tracking.py --objects 3`` (three L-shapes offset
  0.65 diag apart, 2.3 + 0.12 i diag away, turned 0.1 + 1.1 i rad; 5 static
  frames, then 0.008 rad a frame; the exact-raster camera; a perfect
  per-instance-mask detector; dense tracking): (m1) 320x240, 40 frames;
  (m2) the same with classes (0, 1, 0), the second class a 0.5 x 0.3 x 0.2
  box; (m3) 640x480, 30 frames; (m4) the batched step alone at 640x480 for
  B = 1, 3, 8. Each of (m1)-(m3) prints one ``{"multi": {...}}`` line:
  ADD-S mean and p95 over the frames with all three tracks (against the
  nearer symmetric twin of the track's instance; the plain figure beside
  it), identity switches, the frame all three were acquired, the median
  frame with a full batch, and the batched K1 and K2 launches per tracked
  frame, which must be max(n_iters) + 1 and 1 (the camera's renders
  launch the unbatched entries; the spawn searches' batched renders are
  counted apart). Each holds
  its first full batch's tracks bit for bit to themselves run alone (B =
  1) and through the unbatched track step, on the same draws; (m4) does so
  at B = 3 and 8. The gates: ADD-S mean <= 1.5 cm and no identity switch.
  Then the batched K1 and K2 are held bit for bit against their batched
  plain versions at every batched shape the phase gave them, and timed;
- the offline single-frame path and its BOP evaluation: the port writes a
  BOP scene of the L-shape (three 640x480 frames 2 m out at the poses of
  the JAX package's scene-sweep test, K2 depth in uint16 mm, masks, RGB,
  ``models_info.json`` with the L-shape's two-fold symmetry) and its 5-view
  template database, then ``apps/eval_bop.run`` sweeps it with the offline
  registration (400 points, the native exact clique) and with the product
  search on two frames. Printed: the per-frame rows and the summaries (ADD-S,
  MSSD, MSPD, VSD, the Average Recalls), per frame the synchronised
  registration ms, its K1 launches (single and batched) and the cliques
  that ran, ADD plain and against the nearer symmetric twin; per sweep the
  wall ms per frame and the ms per frame of reading the PNGs (the port's
  writer Paeth-filters every row, so the reader undoes the hardest filter
  throughout). The gates: bop_ar > 0.5 and ar_mssd >
  0.5 offline, bop_ar > 0.5 for the product search, every offline frame's
  ADD against the nearer twin < 0.15 x diag, the exact clique on every
  scored template (a failed g++ build fails the phase). K1 is then held bit
  for bit against its plain version at the offline shapes, single and
  batched over the five candidate poses, and timed;
- the user-facing apps, driven through their ``main(argv)`` on the offline
  phase's CAD and scene, with the port's ``Detector`` on seeded random
  YOLO11n-seg weights saved as a ``.pt`` and loaded through ``--weights``
  (no trained checkpoint exists here). The harness puts it in each app
  module's place wrapped so that its forward runs on the card at confidence
  0 and its top detection carries the true silhouette (the flat-coloured
  image's object pixels, or the camera's depth > 0). One ``{"apps": ...}``
  line each: the JPEG decoder's host ms on the 640x480 q95 4:2:0 frame of
  ``tests/data``; (a1) ``main_image`` on scene frame 0 (ADD against the
  nearer twin < 0.15 x diag, the overlay PNG); (a2) ``main_realsense
  --source synthetic`` at the app's defaults (the 26-view database rendered
  on first use, 2-frame init rollout, dense) for 40 frames, ADD-S mean
  against the nearer twin < 1.5 cm with every frame after acquisition
  tracked; (a3) the first 20 frames of that camera recorded by
  ``camera/record.py`` and replayed, poses equal to the live run's (max abs
  diff <= 1e-5); (a4) ``--multi`` for 10 frames, its one track acquired;
  (a5) ``main_seibersdorf`` on a 300 000-point LiDAR frame (xyz + rpy
  calibration, 5-term D), ADD-S < 0.1 x diag; (a6) ``eval_bop --mask
  detector`` over the scene, bop_ar equal to ``--mask visib``'s. K1 and K2
  at the apps' new shapes are then held against their plain versions and
  timed;
- detector training and synthetic data, one ``{"train": ...}`` line a part:
  (t1) ``training/synth.generate`` with the exact-raster instrument on
  three CADs written as PLY (the L-shape, the bench box, a 0.1 m
  subdivision-4 icosphere), 32 train + 8 val frames at 640x480 with the
  other defaults and ``bop=True`` (after 2 frames of the L-shape and box
  alone, their 256-face capacity): frames, skipped instances, host ms a
  frame by stage, one batched K2 launch a frame; every label file parses,
  each frame's labels match its ``scene_gt.json`` entries, each polygon's
  shoelace area is at least half its ``mask_visib`` pixels. (t2)
  ``apps/train.py`` at the operating point (640, batch 16, Adam lr0 1e-3,
  augmentation and mosaic on, EMA) for 2 epochs from seeded weights, then
  ``--resume`` to 3 (the history restarts at epoch 2), then
  ``apps/val.py`` on ``best.pt``: train step ms between CUDA events
  (loading excluded), loader ms a batch, images/s, peak allocated memory,
  losses, mAP; the port's ``Detector`` loads ``best.pt``. (t3) the JAX
  package's single-image overfit test at full width: one batch of 16 at
  640, augmentation off, Adam 6e-3, 250 steps, cuDNN's deterministic
  algorithms (the recipe's loss spikes make the last step's luck decide
  otherwise); image 0's top class score > 0.3 and its box's IoU with a GT
  box > 0.5, and the 16 images' mAP. (t4) two train steps from identical
  weights on one batch of 4 at 640, on the card and on the CPU, the CPU's
  TAL assignment pinned to the card's: the first step's loss parts,
  gradients and BN statistics each within 4x the float32 CPU's error
  against a float64 CPU reference, the second step's weights and EMA
  within 1e-5 of the leaf's scale where both know the gradient. The
  batched K2 is then held bit for bit against its plain version at the
  generator's two shapes and timed;
- the multi-device paths (``parallel/``), the port's counterpart of the
  JAX package's ``dryrun_multichip``, each at world 1 over NCCL and at
  world 2 as two processes sharing the card over gloo, launched through
  ``parallel.launch`` (a rank's failure fails the run); the launch counts
  are set to 0 in each rank just before each part and read just after.
  One ``{"parallel": ...}`` line per part and world: (p1)
  ``sharded_chamfer`` at 16384 x 16384, within 1e-6 of the single-device
  Chamfer, 2 K1 launches a rank; (p2) ``PoseEstimator(view_set="full",
  mesh_devices=)``, the 26-view search of the offline scene's first pose
  with the apps phase's database: world 1 bit-equal to the single-device
  estimator without the final prune (``search_final_topk=0``), world 2
  the same winner and scores within 1e-5, winner ADD-S < 1.5 cm; then
  ``sharded_template_search`` on the 16-template synthetic fixture, both
  worlds bit-equal to ``search_templates`` (the batched registration's
  sums over points run in an order fixed by the point count);
  (p3) ``sharded_multi_track``: four tracks of the L-shape from perturbed
  poses, three steps on one frame, bit-equal to the unsharded batched
  step at both world sizes, each track's ADD below 0.85 of its start and
  the mean below 0.7 (the dry run's gates), one batched K2 a rank and
  frame; (p4) ``ShardedDetector`` on 8 images at 640, valid equal, scores
  within 1e-5, boxes within 1e-4 px of ``predict_batch`` (deterministic
  cuDNN); (p5) two data-parallel train steps at batch 16 and 640 (world 2:
  8 + 8), loss parts within 1e-4 relative, weights within 2e-5 where both
  runs know the gradient, BN statistics within 1e-4 of the leaf's scale
  (world 2 hands gloo CUDA tensors for every collective). Every time
  there is that of processes sharing one card, not a speed-up. K1 and K2
  at the phase's new per-rank shapes are then held bit for bit against
  their plain versions and timed.

The search phase also runs one search twice from one generator state on
observation (b) and demands bit-equal poses and rankings. After it, the
16-template synthetic search's four batched ICPs (80 chains x 128 points,
16 x 768, 16 x 768, 16 x 2048) are run again on half their chains and on
single chains, and ``kabsch_batched`` on their final poses: every chain
bit-equal to itself in the whole batch.

The bfloat16 detector and training: (b1) the main path's 30 frames again
through ``FusedFrame`` over ``Detector(dtype="bfloat16")`` (the same
seeded weights), ADD-S < 1.5 cm, K2 once a frame and K1 sum(n_iters + 1),
printed beside the float32 run, and the network's forward device ms,
float32 and bfloat16, at 640 with batch 1 and 8; (b2) bfloat16 against
float32 detections on 8 images at confidence 0, sorted scores within 0.03,
and per anchor before NMS the decoded boxes within 1 px, the class
probabilities within 0.03 and the masks of the 8 best anchors differing at
<= 1% of their pixels; (b3) after the training phase, two train steps at 640 and batch 16 on
(t1)'s data in float32 and in bfloat16 from one init (finite bfloat16
parts; step ms and peak memory); (b4) in the apps phase, ``main_image``
again through ``poseestimator_tpu_torch.compat.main_image``, equal to
(a1) (pose, Chamfers, metrics, overlay).

The evaluation harnesses, last, through the port's ``apps/`` as their
users run them, one ``{"eval": ...}`` line each with its gates, wall s and
launches: ``eval_tracking`` at 640x480 over 100 turning frames, (e1)
sparse 300 and dense through the mesh camera (ADD-S <= 2.5 and 1.5 cm),
(e2) 2 px degraded masks (3.0), (e3) the splat camera (3.0), (e4) 3 mm
depth noise through the RealSense filters (3.0, >= 90 frames tracked);
(e5) ``--objects 3`` at 320x240 for 40 frames, one CAD and mixed CADs (no
identity switch, every frame's tracks distinct, acquired by frame 3, 3.0
cm; the JAX package's records printed beside); (e6) ``--detector
trained-ckpt`` at the JAX test's size (mAP50 > 0.5, >= 5 frames tracked,
0 < ADD-S < 15 cm, no drift); then ``eval_init`` (reduced:1:2 and
full:1:2, bop_ar >= 0.2), ``clique_sweep`` (greedy never above exact),
``scaling_eval`` at world 1 and 2 on the card (scores bit-equal) and
``predict --folder`` on (t1)'s validation images.

The tools, after them, one ``{"tools": ...}`` line each with the card's
name and power limit: ``apps/profile_stages.py --frames 30`` in float32 and
bfloat16 (prefix 10 bit-equal to ``FusedFrame`` on the same frame and
draws; K2 once a frame from ``render_depth(win)`` on and never before; K1
sum(n_iters + 1) in ``icp_dense`` and never before; every marginal time
finite; every prefix traced), ``apps/profile_search.py`` on the random
worst case (10 reps) and on the bench scene with the 5 and the 26 views (5
reps; the full prefix bit-equal to ``search_templates`` on the same draws),
and ``apps/ab_mosaic.py`` cut to 3 epochs of 16 + 8 images at 160. K1 and
K2 at the searches' new shapes are then held against their plain versions.

Any failed phase exits nonzero.

Output: progress lines (one JSON line per tracker part), then the card's
name and power limit, a JSON summary, a JSON line of the kernels, and as
the last line
``{"ok": true, "device": {...}}``.

Kernel times: ``device_ms`` is the device time of one call (50 calls
captured in a CUDA graph, replayed, divided by 50); ``call_ms`` is one
Python call timed by CUDA events, host cost included. The kernels line's
``ms`` is ``call_ms``.

Run from the repository root:
    python3 chip_smoke.py  [--out FILE.json] [--profile FILE.txt] [--offline-dir DIR]

``--offline-dir`` also keeps the apps phase's files (weights, the 26-view
database, the replay recording, the LiDAR frame); the training phase
writes into a temporary directory.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

FRAMES = 30
ADDS_BUDGET_CM = 1.5  # dense tracking budget of the JAX package's bench
SPARSE_BUDGET_CM = 2.5  # its sparse (300-point) budget
DEGRADED_BUDGET_CM = 3.0  # its degraded-mask budget
SPLAT_BUDGET_CM = 3.0  # its splat-stress budget
SEARCH_REPS = 5  # timed warm searches per observation
# the tracker scene: static warm-up frames, then frames turning about z
TRACK_WARM, TRACK_MOTION, TRACK_ROT = 12, 30, 0.008
ROLLOUT = 2  # init rollout frames of the tracker's part (c)
# the multi-object scene: instances, frames after the static ones, turn a frame
MULTI_OBJ = 3
MULTI_FRAMES = {"m1": 40, "m2": 40, "m3": 30}
MULTI_ROT = 0.008
# the offline phase: points of the offline registration (the one-image
# app's default), frames of the product search, and the ADD gate (x diag)
OFFLINE_POINTS = 400
OFFLINE_PRODUCT_FRAMES = 2
OFFLINE_ADD_DIAG = 0.15
# the apps phase: frames of the synthetic session (a2), frames recorded and
# replayed (a3), frames of the multi-object session (a4), the LiDAR frame's
# points (a5) and its ADD-S gate (x diag)
APPS_FRAMES, APPS_RECORD, APPS_MULTI = 40, 20, 10
LIDAR_POINTS = 300_000
LIDAR_ADDS_DIAG = 0.1
# non-tensor float32 peak, HBM rate, and single instructions a second
# (132 SMs x 128 lanes x 1.98 GHz): the rate of an FMA-free kernel
H100 = {"f32_ops": 67e12, "bytes": 3.35e12, "lane_instr": 132 * 128 * 1.98e9}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def box_surface(rng: np.random.Generator, n: int, half) -> np.ndarray:
    """Uniform samples on the box shell (the ADD-S model points): the bench
    scene's (``apps/_scene.py``)."""
    from poseestimator_tpu_torch.apps import _scene

    return _scene.box_surface(rng, n, half)


def view_pose(dirv, dist: float, angle: float, look_at, gl_to_cv) -> np.ndarray:
    """Model-to-camera pose of a camera looking at the origin from ``dist``
    along ``dirv`` (up +Y), perturbed by ``angle`` about z and ``angle / 2``
    about x: the construction of tests/test_pipeline.py's ``gt_pose``."""
    d = np.asarray(dirv, np.float64)
    T_gl = look_at(d / np.linalg.norm(d) * dist, np.zeros(3), [0.0, 1.0, 0.0]).numpy()
    c, s = np.cos(angle), np.sin(angle)
    ch, sh = np.cos(angle * 0.5), np.sin(angle * 0.5)
    P = np.eye(4)
    P[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ np.array(
        [[1, 0, 0], [0, ch, -sh], [0, sh, ch]])
    return (P @ (gl_to_cv @ T_gl)).astype(np.float32)


def motion_delta() -> np.ndarray:
    """One camera period of motion: 0.01 rad about z plus (2, 0, 1) mm (the
    bench scene's, ``apps/_scene.py``)."""
    from poseestimator_tpu_torch.apps import _scene

    return _scene.motion_delta()


def call_ms(torch, fn, reps: int = 100, warmup: int = 10) -> float:
    """Median time of one Python call, from CUDA events around each call:
    the host's cost of the call whenever it exceeds the device's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def device_ms(torch, fn, launches: int = 50, reps: int = 20) -> float:
    """Device time of one call: ``launches`` calls captured in a CUDA graph,
    the graph replayed between two events, the median replay divided by
    ``launches``. A replay issues no host work, so this is the time the
    card spends, launch gaps included."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / launches)
    del graph
    return float(np.median(times))


def bound_ms(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / H100["f32_ops"], nbytes / H100["bytes"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def nn_bound(n: int, m: int) -> tuple[float, str]:
    # 8 float32 operations and one compare per pair; each input read once
    # (points 12 B + mask 1 B), outputs 4 + 8 + 1 B per query
    return bound_ms(9.0 * n * m, 13 * (n + m) + 13 * n)


def nn_issue_ms(n: int, m: int) -> float:
    """K1's ceiling without fused multiply-adds: 7 float32 instructions and
    one minimum per pair, one instruction per lane and clock."""
    return 8.0 * n * m / H100["lane_instr"] * 1e3


def raster_pairs(bbox, H: int, W: int) -> float:
    """(pixel, face) pairs that the bbox cull keeps."""
    b = bbox.double().cpu().numpy()
    live = b[:, 0] <= b[:, 1]
    x0 = np.clip(np.ceil(b[live, 0]), 0, W)
    x1 = np.clip(np.floor(b[live, 1]) + 1, 0, W)
    y0 = np.clip(np.ceil(b[live, 2]), 0, H)
    y1 = np.clip(np.floor(b[live, 3]) + 1, 0, H)
    return float((np.clip(x1 - x0, 0, None) * np.clip(y1 - y0, 0, None)).sum())


def raster_bound(bbox, H: int, W: int) -> tuple[float, str]:
    # ~20 float32 operations per (pixel, face) pair that the bbox cull keeps
    # (four planes at 2 mul + 2 add, three compares, a max); 64 B per face
    # read once, 4 B per pixel written once
    return bound_ms(20.0 * raster_pairs(bbox, H, W), 64 * bbox.shape[0] + 4 * H * W)


def check_fused_nn(torch, fnn, dev) -> dict:
    """K1 against its plain version on every case of ``kernel_cases``, and
    the expected index on the tie and negative-d2 cases. Times at the main
    path's 4096 x 4096 and at 16k x 16k."""
    from poseestimator_tpu_torch import kernel_cases as kc

    to_dev = lambda arrays: tuple(torch.from_numpy(a).to(dev) for a in arrays)  # noqa: E731
    cases = {name: to_dev(c) for name, c in kc.nn_cases().items()}
    expect = {"ties across split edges": kc.nn_ties()[1],
              "negative d2 0.5 m out": kc.nn_negative_d2()[1]}
    worst = 0.0
    for name, (q, qv, d, dv) in cases.items():
        kd, ki, kf = fnn.fused_nn(q, qv, d, dv)
        torch.cuda.synchronize()
        pd, pi, pf = fnn.fused_nn_plain(q, qv, d, dv)
        if not torch.equal(ki, pi):
            fail(f"K1 {name}: {(ki != pi).sum().item()} indices differ from the plain version")
        if not torch.equal(kf, pf):
            fail(f"K1 {name}: found flags differ from the plain version")
        if name in expect and not np.array_equal(ki.cpu().numpy(), expect[name]):
            fail(f"K1 {name}: indices differ from the expected (lowest) ones")
        err = float((kd - pd).abs().max())
        if err > 0.0:
            fail(f"K1 {name}: distance error {err} > 0")
        worst = max(worst, err)
        log(f"K1 {name}: indices identical, max |d| err {err:.3g}, found {int(kf.sum())}")
    q, qv, d, dv = cases["4096x4096"]
    out = {"max_abs_err": worst,
           "device_ms": device_ms(torch, lambda: fnn.fused_nn(q, qv, d, dv)),
           "call_ms": call_ms(torch, lambda: fnn.fused_nn(q, qv, d, dv)),
           "plain_ms": call_ms(torch, lambda: fnn.fused_nn_plain(q, qv, d, dv), reps=20),
           "library_ms": device_ms(torch, lambda: torch.cdist(q, d).min(1)),
           "bound": nn_bound(4096, 4096), "issue_ms": nn_issue_ms(4096, 4096)}
    # cost model at N = 4096: device time against M, t = fixed + pairs / rate
    d16 = cases["16k x 16k invalid masks"][2]
    t_at = {}
    for m in (512, 1024, 2048, 4096, 8192, 16384):
        dm, dvm = d16[:m].contiguous(), torch.ones(m, dtype=torch.bool, device=dev)
        t_at[m] = device_ms(torch, lambda: fnn.fused_nn(q, qv, dm, dvm), 20)
    ms_per_pair, fixed = np.polyfit([4096.0 * m for m in t_at], list(t_at.values()), 1)
    rate = 1e3 / ms_per_pair  # pairs a second
    one = torch.zeros(1, device=dev)
    out["cost_model"] = {"n": 4096, "device_ms_by_m": t_at, "fixed_ms": float(fixed),
                         "pairs_per_s": float(rate),
                         "share_of_issue_ceiling": float(8.0 * rate / H100["lane_instr"]),
                         "launch_floor_ms": device_ms(torch, lambda: one.zero_())}
    q, qv, d, dv = cases["16k x 16k invalid masks"]
    out["16384x16384"] = {"device_ms": device_ms(torch, lambda: fnn.fused_nn(q, qv, d, dv), 10),
                          "call_ms": call_ms(torch, lambda: fnn.fused_nn(q, qv, d, dv), 20),
                          "plain_ms": call_ms(torch, lambda: fnn.fused_nn_plain(q, qv, d, dv), 3,
                                              1),
                          "bound_ms": nn_bound(16384, 16384)[0],
                          "issue_ms": nn_issue_ms(16384, 16384),
                          # a 1 GiB distance matrix per call
                          "library_ms": device_ms(torch, lambda: torch.cdist(q, d).min(1), 4)}
    return out


def check_raster(torch, rs, window_origin, mesh_v, mesh_f, T0, intr_r, win, dev) -> dict:
    """K2 against its plain version at the main path's window and on every
    case of ``kernel_cases``; times at the window and at the 4096-face
    sphere over the full half-resolution frame."""
    from poseestimator_tpu_torch import kernel_cases as kc

    o = window_origin(mesh_v, T0, intr_r, *win).to(torch.float32)
    main = f"bench box, {win[0]}x{win[1]} window at origin {o.tolist()}"
    cases = {main: (*rs.face_coeffs(mesh_v, mesh_f, T0, intr_r, near=0.01, origin=o), *win)}
    for name, c in kc.raster_cases().items():
        cases[name] = (*rs.face_coeffs(
            torch.from_numpy(c["vertices"]).to(dev), torch.from_numpy(c["faces"]).to(dev),
            torch.from_numpy(c["T"]).to(dev), c["intr"], near=0.01), c["H"], c["W"])
    worst, timings = 0.0, {}
    for name, (coef, bbox, H, W) in cases.items():
        izk = rs.raster(coef, bbox, H, W)
        torch.cuda.synchronize()
        izp = rs.raster_plain(coef, H, W, chunk=64)
        if not torch.equal(izk > 0, izp > 0):
            fail(f"K2 {name}: coverage differs on {((izk > 0) != (izp > 0)).sum().item()} px")
        if not torch.equal(izk, izp):
            fail(f"K2 {name}: max 1/z differs on {(izk != izp).sum().item()} px")
        dk, dp = rs.izmax_to_depth(izk, 0.01, 5.0), rs.izmax_to_depth(izp, 0.01, 5.0)
        err = float((dk - dp).abs().max())
        worst = max(worst, err)
        log(f"K2 {name}: {coef.shape[0]} faces, coverage and depth identical "
            f"({int((izk > 0).sum())} px covered)")
        if name == main or name.startswith(("icosphere", "bench box template", "L-shape")):
            timings[name] = {
                "faces": coef.shape[0], "hw": [H, W], "covered_px": int((izk > 0).sum()),
                "device_ms": device_ms(torch, lambda: rs.raster(coef, bbox, H, W)),
                "call_ms": call_ms(torch, lambda: rs.raster(coef, bbox, H, W)),
                "plain_ms": call_ms(torch, lambda: rs.raster_plain(coef, H, W, chunk=64), reps=20),
                "bound": raster_bound(bbox, H, W)}
            t = timings[name]
            log(f"K2 {name}: device {t['device_ms']:.5f} ms, call {t['call_ms']:.4f} ms, "
                f"plain {t['plain_ms']:.4f} ms, bound {t['bound'][0]:.3g} ms ({t['bound'][1]})")
    return {"max_abs_err": worst, "main": main, "shapes": timings}


def check_search_shapes(torch, fnn, rs, nn_inputs: dict, raster_inputs: dict,
                        where: str = "the search's") -> dict:
    """K1 and K2 against their plain versions on the inputs a path gave
    them (the first call of each shape), with device times and bounds."""
    out = {"K1": {}, "K2": {}}
    for (n, m), (q, qv, d, dv) in sorted(nn_inputs.items()):
        kd, ki, kf = fnn.fused_nn(q, qv, d, dv)
        torch.cuda.synchronize()
        pd, pi, pf = fnn.fused_nn_plain(q, qv, d, dv)
        if not (torch.equal(ki, pi) and torch.equal(kf, pf) and torch.equal(kd, pd)):
            fail(f"K1 at {where} {n}x{m}: differs from the plain version")
        b = nn_bound(n, m)
        out["K1"][f"{n}x{m}"] = {
            "device_ms": device_ms(torch, lambda: fnn.fused_nn(q, qv, d, dv)),
            "call_ms": call_ms(torch, lambda: fnn.fused_nn(q, qv, d, dv)),
            "plain_ms": call_ms(torch, lambda: fnn.fused_nn_plain(q, qv, d, dv), reps=10),
            "library_ms": device_ms(torch, lambda: torch.cdist(q, d).min(1)),
            "bound_ms": b[0], "bound_by": b[1]}
    for (H, W, F), (coef, bbox, _, _) in sorted(raster_inputs.items()):
        izk = rs.raster(coef, bbox, H, W)
        torch.cuda.synchronize()
        if not torch.equal(izk, rs.raster_plain(coef, H, W, chunk=64)):
            fail(f"K2 at {where} {H}x{W}: differs from the plain version")
        b = raster_bound(bbox, H, W)
        out["K2"][f"{H}x{W}, {F} faces"] = {
            "device_ms": device_ms(torch, lambda: rs.raster(coef, bbox, H, W)),
            "call_ms": call_ms(torch, lambda: rs.raster(coef, bbox, H, W)),
            "plain_ms": call_ms(torch, lambda: rs.raster_plain(coef, H, W, chunk=64), reps=10),
            "bound_ms": b[0], "bound_by": b[1]}
    for k in ("K1", "K2"):
        for shape, t in out[k].items():
            log(f"{k} at {where} {shape}: identical to the plain version; device "
                f"{t['device_ms']:.5f} ms, call {t['call_ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, bound "
                f"{t['bound_ms']:.3g} ms ({t['bound_by']})"
                + (f", library {t['library_ms']:.5f} ms" if "library_ms" in t else ""))
    return out


def _first_call_recorder(torch, store: dict, fn, key):
    """``fn`` that also keeps a copy of the arguments of its first call of
    each ``key(*args)``."""
    def wrapped(*args):
        k = key(*args)
        if k not in store:
            store[k] = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
        return fn(*args)
    return wrapped


def search_phase(torch, dev, kc, fnn, rs, intr, tmp: str, profile_path=None) -> dict:
    """The init path: ``PoseEstimator`` on the bench box CAD (its template
    database rendered on the card), searched on two observations. Per
    observation: K1 and K2 launches of one search (counts set to 0 just
    before it), the median wall time of SEARCH_REPS warm searches, the
    winning template and ADD-S against the true pose. Also returns the
    kernels' inputs by shape from the first search. ``profile_path``: also
    trace 2 searches of the last observation there."""
    from poseestimator_tpu_torch.geom3d import knn as knn_mod
    from poseestimator_tpu_torch.geom3d.camera import backproject_depth
    from poseestimator_tpu_torch.geom3d.sampling import random_sample
    from poseestimator_tpu_torch.geom3d.se3 import look_at
    from poseestimator_tpu_torch.pipeline import pose_estimator as pe
    from poseestimator_tpu_torch.render.mesh import pad_faces
    from poseestimator_tpu_torch.utils.plyio import write_ply

    verts = kc.box_vertices()
    cad = os.path.join(tmp, "box.ply")
    write_ply(cad, verts, faces=kc.BOX_FACES)
    rs.raster_stats.launches = 0
    t = time.perf_counter()
    est = pe.PoseEstimator(cad, os.path.join(tmp, "views"), intr, device=dev)
    torch.cuda.synchronize()
    build = {"ms": (time.perf_counter() - t) * 1e3, "k2_launches": rs.raster_stats.launches,
             "templates": int(est._tpl_points.shape[0]), "tpl_cap": int(est._tpl_points.shape[1]),
             "dst_cap": est._search_cap}
    log(f"search: estimator built in {build['ms']:.1f} ms ({build['templates']} templates "
        f"rendered by {build['k2_launches']} K2 launches at 640x480, template capacity "
        f"{build['tpl_cap']}, observation capacity {build['dst_cap']})")
    if build["k2_launches"] != build["templates"]:
        fail(f"template database: {build['k2_launches']} K2 launches for "
             f"{build['templates']} views")

    mesh_v = torch.from_numpy(verts).to(dev)
    mesh_f = torch.from_numpy(pad_faces(kc.BOX_FACES, 256)).to(dev)
    T0 = np.eye(4, dtype=np.float32)
    T0[2, 3] = 0.5
    scenes = {"a: bench scene": motion_delta() @ T0,
              "b: near template view 11": view_pose((1.0, 1.0, 1.0), 0.5, 0.1, look_at,
                                                   kc.GL_TO_CV)}
    model_pts = torch.from_numpy(box_surface(np.random.default_rng(1), 2000, kc.BOX_HALF)).to(dev)
    diag_cm = float(np.linalg.norm(verts.max(0) - verts.min(0))) * 100.0
    gen = torch.Generator(device=dev).manual_seed(2)
    evals = []  # (chains, batched evaluations) of each ICP of a search
    nn_inputs, raster_inputs, raster_batched_inputs = {}, {}, {}
    orig_icp, orig_nn, orig_raster = pe.icp_point_to_point_batched, knn_mod.fused_nn, rs.raster
    orig_rb = rs.raster_batched
    scorings = []  # the batch of each view_scores / score_pose_candidates render
    orig_scores = pe.window_scores

    def scores_recorded(dep, *args, **kw):
        scorings.append(dep.shape[0])
        return orig_scores(dep, *args, **kw)

    def icp_recorded(*args, **kw):
        r = orig_icp(*args, **kw)
        evals.append((args[0].shape[0], r.n_evals))
        return r

    results = {}
    pe.icp_point_to_point_batched = icp_recorded
    pe.window_scores = scores_recorded
    try:
        for name, T_np in scenes.items():
            T = torch.from_numpy(T_np).to(dev)
            depth = rs.render_depth_mesh(mesh_v, mesh_f, T, intr, near=0.01, far=5.0)
            cloud = random_sample(backproject_depth(depth, intr, depth_min=0.01, depth_max=5.0),
                                  4096, gen)
            mask = depth > 0

            def search():
                return est.find_best_template_candidates(cloud, mask=mask)

            if not nn_inputs:  # warm-up; the first one keeps the kernels' inputs
                knn_mod.fused_nn = _first_call_recorder(
                    torch, nn_inputs, orig_nn, lambda q, qv, d, dv: (q.shape[0], d.shape[0]))
                rs.raster = _first_call_recorder(
                    torch, raster_inputs, orig_raster, lambda c, b, H, W: (H, W, c.shape[0]))
                rs.raster_batched = _first_call_recorder(
                    torch, raster_batched_inputs, orig_rb,
                    lambda c, b, H, W: (c.shape[0], H, W, c.shape[1]))
            try:
                search()
            finally:
                knn_mod.fused_nn, rs.raster, rs.raster_batched = orig_nn, orig_raster, orig_rb
            torch.cuda.synchronize()

            evals.clear()
            scorings.clear()
            fnn.fused_nn_stats.launches = 0
            rs.raster_stats.launches = rs.raster_batched_stats.launches = 0
            H, _, cands = search()
            torch.cuda.synchronize()
            k1, k2, k2b = (fnn.fused_nn_stats.launches, rs.raster_stats.launches,
                           rs.raster_batched_stats.launches)
            chain_evals = list(evals)
            # one launch per batched evaluation (and one for alignment_score);
            # one batched K2 per polish stage and per view-score call, none single
            want_k1 = sum(e for _, e in chain_evals) + 1
            batches = [b for b, _ in chain_evals[1:]] + list(scorings)
            want_k2b = len(batches)
            if k1 != want_k1:
                fail(f"search {name}: K1 launched {k1} times for {want_k1} batched evaluations")
            if k2 != 0 or k2b != want_k2b:
                fail(f"search {name}: K2 launched {k2} single and {k2b} batched times for "
                     f"the batches {batches} (polish stages, then scorings)")
            times = []
            for _ in range(SEARCH_REPS):
                t = time.perf_counter()
                search()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            if not np.isfinite(H).all():
                fail(f"search {name}: non-finite pose")
            adds = adds_cm(torch, model_pts, torch.from_numpy(H).to(dev), T)
            results[name] = {
                "search_ms_median": float(np.median(times)), "search_ms": times,
                "k1_launches": k1, "k2_launches": k2, "k2_batched_launches": k2b,
                "k2_batches": batches,
                "batched_icp": [{"chains": b, "evaluations": e} for b, e in chain_evals],
                "winner_template": cands[0][2], "scores": [c[0] for c in cands],
                "adds_cm": adds}
            if name.startswith("b"):
                # voxel means, RANSAC draws and all: one search's pose and
                # ranking again, bit for bit, from the same generator state
                again = []
                for _ in range(2):
                    est.generator.manual_seed(0)
                    again.append(search())
                (H1, _, c1), (H2, _, c2) = again
                if not (np.array_equal(H1, H2) and len(c1) == len(c2) and all(
                        a[0] == b[0] and a[2] == b[2] and np.array_equal(a[1], b[1])
                        for a, b in zip(c1, c2))):
                    fail(f"search {name}: two searches from one state differ")
                results[name]["repeat_bit_equal"] = True
            if profile_path and name == list(scenes)[-1]:
                results[name]["profile"] = profile_calls(torch, search, 2, profile_path, "search")
            log(f"search {name}: median {np.median(times):.2f} ms over {SEARCH_REPS} warm calls "
                f"(min {min(times):.2f}), K1 launches {k1}, K2 launches {k2} single, {k2b} "
                f"batched (batches {results[name]['k2_batches']}), winner template "
                f"{cands[0][2]}, ADD-S {adds:.4f} cm (diag {diag_cm:.2f} cm)")
    finally:
        pe.icp_point_to_point_batched, pe.window_scores = orig_icp, orig_scores
    b = results["b: near template view 11"]["adds_cm"]
    if not b <= 0.1 * diag_cm:
        fail(f"search near a template view: ADD-S {b:.4f} cm > 0.1 x diag ({0.1 * diag_cm:.3f} cm)")
    return {"build": build, "scenes": results, "diag_cm": diag_cm,
            "nn_inputs": nn_inputs, "raster_inputs": raster_inputs,
            "raster_batched_inputs": raster_batched_inputs}


def forward_ms(torch, model, x) -> dict:
    """Device ms of one no-grad forward of ``model`` on ``x``: from a
    replayed CUDA graph (``device_ms``), or, should the capture fail, the
    median of CUDA events around single calls (host gaps included)."""
    with torch.no_grad():
        try:
            return {"ms": device_ms(torch, lambda: model(x), launches=10, reps=10),
                    "method": "graph replay"}
        except RuntimeError as e:
            torch.cuda.synchronize()
            return {"ms": call_ms(torch, lambda: model(x), reps=20, warmup=3),
                    "method": f"events (graph capture failed: {str(e)[:80]})"}


def bf16_phase(torch, dev, fnn, rs, model, verts, faces, intr, win, color, depths, T0, T_true,
               pts, f32: dict, card: str) -> dict:
    """(b1) The main path's frames again through ``FusedFrame`` over
    ``Detector(dtype="bfloat16")`` built from the same seeded weights, the
    launch counts set to 0 just before and read just after: ADD-S within its
    budget, K2 once a frame, K1 sum(n_iters + 1), every frame detected;
    printed beside the float32 run's ``f32`` (frame ms, launches, ADD-S).
    Then the network's forward alone, float32 and bfloat16, at 640 with
    batch 1 and 8. (b2) bfloat16 against float32 detections on 8 images at
    640 and confidence 0, of the seeded weights with their BatchNorm
    statistics and biases drawn from a numpy seed: each image's sorted
    scores within 0.03 (the JAX package's own bfloat16-to-float32 bound).
    These scores sit near 0.56 and tie in bfloat16 (its step there is
    2^-8), so the detection that leads is the tie order's choice, and the
    top detections' boxes are printed, not gated. Per anchor instead, before
    NMS, on the same letterboxed images: the decoded boxes within 1 px (the
    JAX package's own bfloat16-to-float32 gap at 640, on the CPU: 0.80 px)
    and the class probabilities within 0.03; and the masks of each image's
    8 best float32 anchors, each dtype from its own coefficients, boxes and
    prototypes, differing at <= 1% of their pixels, their probabilities
    before the threshold within 0.01."""
    from poseestimator_tpu_torch.pipeline.detector import Detector
    from poseestimator_tpu_torch.pipeline.tracking import FusedFrame

    sd = model.state_dict()
    dets = {dt: Detector(sd, nc=5, imgsz=640, dtype=dt, device=dev)
            for dt in ("float32", "bfloat16")}
    frame = FusedFrame(dets["bfloat16"].model, verts, faces, intr, win_hw=win, imgsz=640,
                       max_det=32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    frame(color, depths[0], T0, mask_union=depths[0] > 0, generator=gen)  # warm-up
    torch.cuda.synchronize()
    fnn.fused_nn_stats.launches = 0
    rs.raster_stats.launches = 0
    T_est, frame_ms, n_iters, oks, poses = T0, [], [], [], []
    for k in range(FRAMES):
        t = time.perf_counter()
        res = frame(color, depths[k], T_est, conf=0.25, icp_dist=0.01,
                    mask_union=depths[k] > 0, generator=gen)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1e3)
        T_est = res.T
        poses.append(T_est)
        n_iters.append(res.n_iters)
        oks.append(bool(res.ok))
    k1, k2 = fnn.fused_nn_stats.launches, rs.raster_stats.launches
    adds = [adds_cm(torch, pts, Te, Tt) for Te, Tt in zip(poses, T_true)]
    rng = np.random.default_rng(5)
    fwd = {}
    for B in (1, 8):
        x = torch.from_numpy(rng.uniform(0, 1, (B, 3, 640, 640)).astype(np.float32)).to(dev)
        for dt, det in dets.items():
            fwd[f"{dt} B={B}"] = forward_ms(torch, det.model, x)
    b1 = {"part": "b1 main path, Detector(dtype=bfloat16)", "card": card, "frames": FRAMES,
          "frame_ms_median": float(np.median(frame_ms)), "frame_ms_min": float(min(frame_ms)),
          "frame_ms_median_float32": f32["frame_ms_median"],
          "frame_ms_min_float32": f32["frame_ms_min"],
          "adds_mean_cm": float(np.mean(adds)), "adds_max_cm": float(max(adds)),
          "adds_mean_cm_float32": f32["adds_mean_cm"], "adds_budget_cm": ADDS_BUDGET_CM,
          "icp_n_iters_mean": float(np.mean(n_iters)), "k1_launches": k1, "k2_launches": k2,
          "k1_launches_float32": f32["k1_launches"], "k2_launches_float32": f32["k2_launches"],
          "ok": sum(oks), "detector_forward_device_ms_640": fwd}
    log(json.dumps({"bf16": b1}))
    if k2 != FRAMES or k1 != sum(n + 1 for n in n_iters):
        fail(f"(b1): K1 {k1} (want {sum(n + 1 for n in n_iters)}), K2 {k2} (want {FRAMES})")
    if not all(oks) or not np.isfinite(np.asarray([P.cpu().numpy() for P in poses])).all():
        fail(f"(b1): {FRAMES - sum(oks)} frames undetected, or a non-finite pose")
    if not b1["adds_mean_cm"] <= ADDS_BUDGET_CM:
        fail(f"(b1): mean ADD-S {b1['adds_mean_cm']:.4f} cm > {ADDS_BUDGET_CM} cm")

    imgs = torch.from_numpy(rng.integers(0, 255, (7,) + tuple(color.shape),
                                         dtype=np.uint8)).to(dev)
    imgs = torch.cat([color[None], imgs])
    spread = {}
    for k, v in sd.items():
        if k.endswith(("running_var", "bn.weight")):
            spread[k] = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        elif k.endswith(("running_mean", "bias")):
            spread[k] = torch.from_numpy((rng.normal(size=v.shape) * 0.1).astype(np.float32))
        else:
            spread[k] = v.cpu()
    out = {dt: Detector(spread, nc=5, imgsz=640, dtype=dt, device=dev).predict_batch(
        imgs, conf=0.0) for dt in dets}
    (d32, _), (d16, _) = out["float32"], out["bfloat16"]
    gaps = [float((torch.sort(d16.scores[i][d16.valid[i]]).values
                   - torch.sort(d32.scores[i][d32.valid[i]]).values).abs().max())
            for i in range(len(imgs))]
    per = per_anchor_gaps(torch, spread, imgs)
    b2 = {"part": "b2 bfloat16 vs float32 detections, 8 images at 640, conf 0", "card": card,
          "max_score_gap": max(gaps), "score_gap_per_image": gaps, "gate": 0.03,
          "valid_equal": bool(torch.equal(d16.valid, d32.valid)),
          "top_class_equal": int((d16.classes[:, 0] == d32.classes[:, 0]).sum()),
          "scores_dtype": str(d16.scores.dtype).replace("torch.", ""),
          "top_score_float32": float(d32.scores[:, 0].max()),
          "top_box_max_px_diff": float((d16.boxes[:, 0] - d32.boxes[:, 0]).abs().max()),
          "bfloat16_scores_tied_with_top": int((d16.scores == d16.scores[:, :1]).sum(1).min()),
          **per, "anchor_box_gate_px": 1.0, "anchor_cls_gate": 0.03, "mask_pixel_gate": 0.01,
          "mask_prob_gate": 0.01}
    log(json.dumps({"bf16": b2}))
    if not (d16.valid.sum(1) == d32.valid.sum(1)).all() or not max(gaps) <= 0.03 \
            or d16.scores.dtype != torch.float32 or not per["anchor_box_max_px"] <= 1.0 \
            or not per["anchor_cls_max"] <= 0.03 or not per["mask_pixel_disagreement"] <= 0.01 \
            or not per["mask_prob_max"] <= 0.01:
        fail(f"(b2): bfloat16 against float32 detections {b2}")
    return {"b1": b1, "b2": b2}


def per_anchor_gaps(torch, sd: dict, imgs) -> dict:
    """bfloat16 against float32 before NMS, where no tie decides anything:
    ``sd``'s network in each dtype on the letterboxed ``imgs`` (B, H, W, 3),
    the largest gap of a decoded box (px) and of a class probability over
    every anchor, and the share of pixels on which the masks of each image's
    8 best float32 anchors disagree (each dtype's own coefficients, boxes
    and prototypes), with the share of those pixels that are set."""
    from poseestimator_tpu_torch.models.yolo.decode import decode_boxes
    from poseestimator_tpu_torch.models.yolo.masks import assemble_masks
    from poseestimator_tpu_torch.models.yolo.model import YOLO11Seg
    from poseestimator_tpu_torch.models.yolo.preprocess import letterbox

    dev = imgs.device
    lbs, metas = zip(*(letterbox(im, 640) for im in imgs))
    x = torch.stack(lbs).permute(0, 3, 1, 2)
    out = {}
    for dt in ("float32", "bfloat16"):
        m = YOLO11Seg(nc=5, scale="n", dtype=dt)
        m.load_state_dict(sd)
        m = m.to(dev).eval()
        with torch.no_grad():
            raw = m(x)
            out[dt] = (*decode_boxes(raw), raw["proto"])
    (b32, c32, m32, p32), (b16, c16, m16, p16) = out["float32"], out["bfloat16"]
    h, w = imgs.shape[1:3]
    ones = torch.ones(8, dtype=torch.bool, device=dev)
    dis = on = prob = 0.0
    for i, meta in enumerate(metas):
        top = torch.sort(-c32[i].max(-1).values, stable=True).indices[:8]
        k32 = assemble_masks(p32[i], m32[i][top], b32[i][top], ones, meta, h, w)
        k16 = assemble_masks(p16[i], m16[i][top], b16[i][top], ones, meta, h, w)
        dis += float((k32 != k16).float().mean()) / len(metas)
        on += float(k32.float().mean()) / len(metas)
        # the probabilities before the threshold (random weights' masks may
        # come out empty), at the prototypes' resolution
        q32, q16 = (torch.sigmoid(torch.einsum("dn,hwn->dhw", m[i][top], p[i]).float())
                    for m, p in ((m32, p32), (m16, p16)))
        prob = max(prob, float((q16 - q32).abs().max()))
    return {"anchor_box_max_px": float((b16 - b32).abs().max()),
            "anchor_cls_max": float((c16.float() - c32).abs().max()),
            "mask_pixel_disagreement": dis, "mask_pixels_set": on, "mask_prob_max": prob}


def search_b_independence(torch, dev) -> dict:
    """The template search's batched registration at its shapes, on the
    card, in ``check_b_independence``'s style: the 16-template synthetic
    search (the parallel phase's fixture) is run once recording its four
    batched ICPs (the coarse stage's 80 chains x 128 points, the polish
    stages' 16 x 768, 768 and 2048); each is run again on its first half of
    chains and on chains 0, 3 and B - 1 alone, and ``kabsch_batched`` on
    its chains at their final poses likewise: every chain's pose, fitness,
    rmse and iterations (R and t) must be the batch's bit for bit."""
    from poseestimator_tpu_torch.parallel import make_synthetic_search_inputs
    from poseestimator_tpu_torch.pipeline import pose_estimator as pe
    from poseestimator_tpu_torch.registration.kabsch import kabsch_batched

    fx = make_synthetic_search_inputs(n_tpl=PAR_SYNTH_TEMPLATES, C=128, n_cad=1200, device=dev)
    calls, icp = [], pe.icp_point_to_point_batched

    def recorded(*a, **k):
        r = icp(*a, **k)
        calls.append((a, k, r))
        return r

    pe.icp_point_to_point_batched = recorded
    try:
        pe.search_templates(fx["dst_points"], fx["dst_valid"], fx["tpl_points"],
                            fx["tpl_valid"], fx["tpl_fpfh"], fx["cad_points"], fx["cad_valid"],
                            fx["intr"], fx["mask_sil"], True, 0.05,
                            torch.Generator(device=dev).manual_seed(0), n_final=None,
                            render_kind="points")
    finally:
        pe.icp_point_to_point_batched = icp
    out = []
    for stage, (a, k, r) in enumerate(calls):
        src, valid, dst = a[0], a[1], a[2]
        B, N = src.shape[:2]
        init = a[4] if len(a) > 4 else torch.eye(4, device=dev).expand(B, 4, 4)
        moved = src @ r.T[:, :3, :3].transpose(-1, -2) + r.T[:, None, :3, 3]
        R, t = kabsch_batched(src, moved, valid.float())
        for sel in (slice(0, B // 2), slice(0, 1), slice(3, 4), slice(B - 1, B)):
            part = icp(src[sel], valid[sel], dst, a[3], init[sel], **k)
            Rs, ts = kabsch_batched(src[sel], moved[sel], valid[sel].float())
            same = (torch.equal(part.T, r.T[sel]) and torch.equal(part.fitness, r.fitness[sel])
                    and torch.equal(part.inlier_rmse, r.inlier_rmse[sel])
                    and torch.equal(part.n_iters, r.n_iters[sel])
                    and torch.equal(Rs, R[sel]) and torch.equal(ts, t[sel]))
            if not same:
                fail(f"search ICP {stage} ({B} chains x {N} points): chains {sel.start}:"
                     f"{sel.stop} differ from themselves in the whole batch")
        out.append({"stage": stage, "chains": B, "points": N,
                    "n_iters": [int(x) for x in r.n_iters],
                    "bit_equal": ["first half", "chain 0", "chain 3", f"chain {B - 1}"]})
    if [(o["chains"], o["points"]) for o in out] != [(80, 128), (16, 768), (16, 768),
                                                     (16, 2048)]:
        fail(f"search B-independence: unexpected batched ICP shapes {out}")
    log(json.dumps({"search_b_independence": out}))
    return {"icps": out}


def bf16_train_part(torch, dev, yml: str, tmp: str, card: str, imgsz: int = 640,
                    batch: int = 16) -> dict:
    """(b3) Two train steps at the training point (``imgsz`` 640, ``batch``
    16, Adam 1e-3, EMA; augmentation off) on (t1)'s data from one seeded
    init, in float32 and in bfloat16 (``TrainConfig(dtype=)``): the loss
    parts of each step (finite in bfloat16), step ms between CUDA events and
    the peak allocated memory of each."""
    from poseestimator_tpu_torch.training import trainer as trainer_mod
    from poseestimator_tpu_torch.training.data import DataLoader

    kw = dict(data=yml, imgsz=imgsz, batch=batch, augment=False, warmup_epochs=0.0,
              project=os.path.join(tmp, "b3"), device=str(dev))
    rec = {"part": f"b3 bfloat16 train steps, {batch} at {imgsz}", "card": card}
    sd = images = None
    for dt in ("float32", "bfloat16"):
        tr = trainer_mod.Trainer(trainer_mod.TrainConfig(**kw, dtype=dt, name=dt))
        if sd is None:
            st = tr.init_state()
            sd = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
            images = next(iter(DataLoader(tr.train_samples, batch, imgsz, 32, shuffle=False)))
        else:
            st = tr.init_state(sd)
        tensors = tr._tensors(images)
        parts, ms = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            st, p = tr._train_step(st, *tensors)
            e.record()
            e.synchronize()
            ms.append(s.elapsed_time(e))
            parts.append({k: float(v) for k, v in p.items()})
        rec[dt] = {"parts": parts, "step_ms": ms,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                   "params_float32": all(v.dtype == torch.float32 for v in st.params.values())}
        del tr, st, tensors
    log(json.dumps({"bf16": rec}))
    b = rec["bfloat16"]
    if not all(np.isfinite(v) for p in b["parts"] for v in p.values()) or not b["params_float32"]:
        fail(f"(b3): bfloat16 train steps {rec}")
    return rec


def tracker_scene(look_at, gl_to_cv, diag: float) -> list:
    """The poses of the JAX package's tracking evaluation: the camera
    2 diag away along (1, 1, 1) (up +Y), TRACK_WARM static frames at 0.1 rad
    about z, then TRACK_MOTION frames turning TRACK_ROT a frame."""
    d = np.ones(3) / np.sqrt(3.0)
    base = gl_to_cv @ look_at(d * diag * 2.0, np.zeros(3), [0.0, 1.0, 0.0]).numpy()
    angles = [0.1] * TRACK_WARM + [0.1 + TRACK_ROT * (i + 1) for i in range(TRACK_MOTION)]
    poses = []
    for a in angles:
        P = np.eye(4)
        P[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        poses.append((P @ base).astype(np.float32))
    return poses


def tracker_phase(torch, dev, kc, fnn, rs, tmp: str, width: int = 640, height: int = 480,
                  imgsz: int = 640) -> dict:
    """The ``Tracker`` on the L-shape scene, in three parts (see the module
    docstring). Per part: ADD-S over the tracked frames against the
    camera's true pose (mean and p95, cm), frames tracked, time to first
    pose (the init step's global registration), the median ``step()`` of
    tracked frames, and K1 / K2 launches per tracked frame and per init
    (counts set to 0 just before each step and read just after). Also
    returns the kernels' inputs at every shape of parts (a) and (b) (among
    them K1 300 x 300 and K2 over the camera's full frame). ``width`` x
    ``height`` is the camera, ``imgsz`` the detector's letterbox."""
    from poseestimator_tpu_torch.camera import SyntheticCamera, degrade_mask
    from poseestimator_tpu_torch.geom3d import knn as knn_mod
    from poseestimator_tpu_torch.geom3d.camera import Intrinsics
    from poseestimator_tpu_torch.geom3d.se3 import look_at
    from poseestimator_tpu_torch.models.yolo.model import YOLO11Seg, init_random_
    from poseestimator_tpu_torch.models.yolo.nms import Detections
    from poseestimator_tpu_torch.pipeline import Detector, PoseEstimator
    from poseestimator_tpu_torch.pipeline import tracking as trk
    from poseestimator_tpu_torch.utils.plyio import write_ply

    verts, faces = kc.lshape_mesh()
    cad = os.path.join(tmp, "lshape.ply")
    write_ply(cad, verts, faces=faces)
    intr = Intrinsics.from_fov(60.0, width, height)
    diag = float(np.linalg.norm(verts.max(0) - verts.min(0)))
    poses = tracker_scene(look_at, kc.GL_TO_CV, diag)
    # the L-shape is two-fold symmetric: ADD-S is taken against the nearer
    # twin of the true pose, once the two are shown to render alike here
    S = kc.lshape_symmetry()
    syms = [torch.eye(4, device=dev), torch.from_numpy(S).to(dev)]
    v_t, f_t = torch.from_numpy(verts).to(dev), torch.from_numpy(faces.astype(np.int64)).to(dev)
    for T in (poses[0], poses[-1]):
        d0, d1 = (rs.render_depth_mesh(v_t, f_t, torch.from_numpy(P).to(dev), intr, near=0.01,
                                       far=10.0) for P in (T, (T @ S).astype(np.float32)))
        if not torch.equal(d0 > 0, d1 > 0) or float((d0 - d1).abs().max()) > 1e-3:
            fail("tracker: the L-shape's twin pose does not render as the pose does")

    class PerfectMaskDetector:
        """The camera's true visible silhouette as the one detection."""

        def __init__(self, camera):
            self.camera = camera

        def __call__(self, img, conf=0.7, iou=0.7):
            det = Detections(boxes=torch.zeros(1, 4, device=dev),
                             scores=torch.ones(1, device=dev),
                             classes=torch.zeros(1, dtype=torch.int64, device=dev),
                             coeffs=torch.zeros(1, 32, device=dev),
                             valid=torch.ones(1, dtype=torch.bool, device=dev))
            mask = torch.from_numpy(self.camera.object_mask).to(dev)
            return det, mask[None], torch.zeros(1, 4, device=dev)

    # (c) only: YOLO11n-seg on seeded random weights. Its masks are noise on
    # this synthetic frame, so, as the JAX package's bench does, the true
    # silhouette is OR-ed into the top mask and the confidence gate is 0:
    # every detection op stays live while the tracker sees an
    # object-dominated mask (the depth is 0 off the object, so extra mask
    # pixels give no points). On the scripted miss frames the gate is set
    # above any score and nothing is OR-ed in: a real miss of the detector.
    class SilhouetteDetector(Detector):
        def __init__(self, weights, camera, miss_frames, **kw):
            super().__init__(weights, **kw)
            self.camera, self.miss_frames = camera, miss_frames

        def scripted_miss(self) -> bool:
            return self.camera.frames_served in self.miss_frames

        def silhouette(self):
            return torch.from_numpy(self.camera.object_mask).to(dev)

        def __call__(self, img, conf=0.25, iou=0.7, with_masks=True):
            if self.scripted_miss():
                return super().__call__(img, 2.0, iou, with_masks)
            det, masks, boxes = super().__call__(img, conf, iou, with_masks)
            masks[0] |= self.silhouette()
            return det, masks, boxes

    class SmokeTracker(trk.Tracker):
        """Routes the fused frame's mask through the SilhouetteDetector's
        rule, and records each init rollout."""

        def _build_fused_step(self, win_hw):
            frame = super()._build_fused_step(win_hw)
            det = self.detector

            def fused(color, depth, T, conf, icp_dist, generator):
                self.fused_calls += 1
                if det.scripted_miss():
                    return frame(color, depth, T, conf=2.0, icp_dist=icp_dist,
                                 generator=generator)
                return frame(color, depth, T, conf=conf, icp_dist=icp_dist,
                             mask_union=det.silhouette(), generator=generator)
            return fused

        def _rollout_init(self, H, candidates):
            n0, c0 = steps["n"], steps["calls"]
            out = super()._rollout_init(H, candidates)
            self.rollouts.append({"basins": len(self._distinct_basins(candidates)),
                                  "track_steps": steps["n"] - n0,
                                  "batched_steps": steps["calls"] - c0, "margin": out[1]})
            return out

    steps = {"n": 0, "calls": 0}
    orig_batched = trk.track_step_batched

    def counted_batched(*args, **kw):  # the rollout: one batched step per frame
        steps["n"] += args[4].shape[0]
        steps["calls"] += 1
        return orig_batched(*args, **kw)

    class DegradedMaskDetector(PerfectMaskDetector):
        """The perfect mask through the evaluation's segmentation-error
        model (``degrade_mask``, 2 px, seed 0)."""

        def __init__(self, camera, px=2):
            super().__init__(camera)
            self.px, self.rng = px, np.random.default_rng(0)

        def __call__(self, img, conf=0.7, iou=0.7):
            det, mask, boxes = super().__call__(img, conf, iou)
            return det, degrade_mask(mask[0], self.px, self.rng)[None], boxes

    model_pts = None
    nn_inputs, raster_inputs = {}, {}
    orig_nn, orig_raster = knn_mod.fused_nn, rs.raster

    def run(name, target_pts, fused=False, detector=None, splat=False):
        nonlocal model_pts
        est = PoseEstimator(cad, os.path.join(tmp, "lviews"), intr, target_points=target_pts or 100,
                            seed=0, device=dev)
        if model_pts is None:  # the ADD-S model points of the evaluation
            model_pts = torch.from_numpy(
                est.mesh.sample_points_uniformly(512, np.random.default_rng(0))[0]).to(dev)
        if splat:  # the point-splat instrument over the evaluation's 150k CAD samples
            pts = est.mesh.sample_points_uniformly(150_000, np.random.default_rng(0))[0]
            cam = SyntheticCamera(pts, np.zeros_like(pts), poses, intr, device=dev)
        else:
            cam = SyntheticCamera(model_pts.cpu().numpy(), np.zeros((512, 3), np.float32), poses,
                                  intr, mesh=(est._mesh_v, est._mesh_f), device=dev)
        cfg = dict(target_pts=target_pts, icp_dist=0.01, warmup_frames=3, max_init_frames=20,
                   device=dev)
        if fused:
            weights = init_random_(YOLO11Seg(nc=5, scale="n"),
                                   torch.Generator().manual_seed(0)).state_dict()
            # frames 8..13: max_misses + 1 = 6 misses in a row while tracking
            det = SilhouetteDetector(weights, cam, set(range(8, 14)), nc=5, imgsz=imgsz,
                                     device=dev)
            tracker = SmokeTracker(cam, est, det, conf=0.0, init_rollout=ROLLOUT, max_misses=5,
                                   **cfg)
            tracker.fused_calls, tracker.rollouts = 0, []
        else:
            tracker = trk.Tracker(cam, est, (detector or PerfectMaskDetector)(cam), **cfg)
        rows = []
        while True:
            fnn.fused_nn_stats.launches = 0
            rs.raster_stats.launches = rs.raster_batched_stats.launches = 0
            t = time.perf_counter()
            res = tracker.step()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            if res is None:
                break
            row = {"state": res.state, "ms": ms, "frame": cam.frames_served,
                   "k1": fnn.fused_nn_stats.launches, "k2": rs.raster_stats.launches,
                   "k2_batched": rs.raster_batched_stats.launches,
                   "fused": "frame" in res.timings}
            if res.state == "init":
                row["ttfp_ms"] = res.timings["global_registration"] * 1e3
                row["init_margin"] = res.init_margin
            if res.state == "track" and res.detected:
                T = torch.from_numpy(np.asarray(res.T_m2c, np.float32)).to(dev)
                G = torch.from_numpy(cam.current_gt).to(dev)
                row["adds_cm"], row["twin"] = adds_sym_cm(torch, model_pts, T, G, syms)
                row["adds_plain_cm"] = adds_cm(torch, model_pts, T, G)
            rows.append(row)
        tracked = [r for r in rows if "adds_cm" in r]
        inits = [r for r in rows if r["state"] == "init"]
        if not tracked or not inits:
            fail(f"tracker {name}: {len(inits)} inits, {len(tracked)} tracked frames")
        adds = [r["adds_cm"] for r in tracked]
        plain = [r["adds_plain_cm"] for r in tracked]
        out = {"part": name, "target_pts": target_pts,
               "adds_mean_cm": float(np.mean(adds)), "adds_p95_cm": float(np.percentile(adds, 95)),
               "adds_plain_mean_cm": float(np.mean(plain)),
               "frames_on_the_twin": sum(r["twin"] for r in tracked),
               "frames_tracked": len(tracked),
               "motion_frames_tracked": sum(r["frame"] > TRACK_WARM for r in tracked),
               "time_to_first_pose_ms": inits[0]["ttfp_ms"],
               "init_step_ms": [r["ms"] for r in inits],
               "step_ms_median_tracked": float(np.median([r["ms"] for r in tracked])),
               "k1_per_tracked_frame": float(np.mean([r["k1"] for r in tracked])),
               "k2_per_tracked_frame": float(np.mean([r["k2"] for r in tracked])),
               "k1_per_init": [r["k1"] for r in inits], "k2_per_init": [r["k2"] for r in inits],
               "k2_batched_per_init": [r["k2_batched"] for r in inits],
               "k1_launches": sum(r["k1"] for r in rows), "k2_launches": sum(r["k2"] for r in rows),
               "states": "".join(r["state"][0] for r in rows)}
        if out["k1_launches"] == 0 or out["k2_launches"] == 0:
            fail(f"tracker {name}: a kernel was never launched ({out['k1_launches']} K1, "
                 f"{out['k2_launches']} K2)")
        if fused:
            out["fused_calls"] = tracker.fused_calls
            out["fused_on_tracked_frames"] = all(r["fused"] for r in tracked)
            out["rollouts"] = tracker.rollouts
            out["init_margins"] = [r["init_margin"] for r in inits]
        log(json.dumps({"tracker": {k: v for k, v in out.items() if k != "init_step_ms"}}))
        return out

    parts = {}
    try:
        # the kernels' inputs at the tracker's new shapes, from their first call
        knn_mod.fused_nn = _first_call_recorder(
            torch, nn_inputs, orig_nn, lambda q, qv, d, dv: (q.shape[0], d.shape[0]))
        rs.raster = _first_call_recorder(
            torch, raster_inputs, orig_raster, lambda c, b, H, W: (H, W, c.shape[0]))
        parts["a"] = run("a: dense", 0)
        parts["b"] = run("b: sparse, 300 points", 300)
        knn_mod.fused_nn, rs.raster = orig_nn, orig_raster
        trk.track_step_batched = counted_batched
        parts["c"] = run("c: fused frame, misses and re-init", 0, fused=True)
        trk.track_step_batched = orig_batched
        parts["d"] = run("d: dense, degraded mask (2 px)", 0, detector=DegradedMaskDetector)
        parts["e"] = run("e: dense, splat-stress observation", 0, splat=True)
    finally:
        knn_mod.fused_nn, rs.raster, trk.track_step_batched = orig_nn, orig_raster, orig_batched

    for key, budget in (("a", ADDS_BUDGET_CM), ("b", SPARSE_BUDGET_CM),
                        ("d", DEGRADED_BUDGET_CM), ("e", SPLAT_BUDGET_CM)):
        p = parts[key]
        if p["motion_frames_tracked"] != TRACK_MOTION:
            fail(f"tracker {p['part']}: {p['motion_frames_tracked']} of {TRACK_MOTION} motion "
                 f"frames tracked")
        if not p["adds_mean_cm"] <= budget:
            fail(f"tracker {p['part']}: mean ADD-S {p['adds_mean_cm']:.4f} cm > {budget} cm")
    c = parts["c"]
    # TRACK -> LOST -> INIT -> TRACK: a lost run, then a second search, then tracking
    seq = c["states"]
    i_lost = seq.find("t" + "l" * 6)
    if i_lost < 0 or "i" not in seq[i_lost:] or "t" not in seq[seq.index("i", i_lost):]:
        fail(f"tracker {c['part']}: no TRACK -> LOST -> INIT -> TRACK cycle in {seq}")
    if seq.count("i") < 2:
        fail(f"tracker {c['part']}: {seq.count('i')} searches, expected a second one")
    if not c["fused_on_tracked_frames"] or c["fused_calls"] == 0:
        fail(f"tracker {c['part']}: tracked frames did not take the fused frame")
    # each rollout tracks every distinct basin through every rollout frame;
    # a search whose candidates are one basin leaves nothing to roll out
    if len(c["rollouts"]) != seq.count("i"):
        fail(f"tracker {c['part']}: {len(c['rollouts'])} rollouts for {seq.count('i')} inits")
    for r in c["rollouts"]:
        if r["basins"] < 2:
            log(f"tracker {c['part']}: a search gave one basin; its rollout had nothing to run")
        elif r["track_steps"] != ROLLOUT * r["basins"] or r["batched_steps"] != ROLLOUT:
            fail(f"tracker {c['part']}: a rollout of {r['basins']} basins ran "
                 f"{r['track_steps']} tracks in {r['batched_steps']} batched steps, not "
                 f"{ROLLOUT * r['basins']} in {ROLLOUT}")
    if not any(r["basins"] >= 2 for r in c["rollouts"]):
        log(f"tracker {c['part']}: no search gave two basins: the rollout never ran")
    if (300, 300) not in nn_inputs or not any(k[:2] == (height, width) for k in raster_inputs):
        fail(f"tracker: no K1 300x300 ({sorted(nn_inputs)}) or full-frame K2 "
             f"({sorted(raster_inputs)}) input recorded")
    return {"parts": parts, "nn_inputs": nn_inputs, "raster_inputs": raster_inputs}


def icp_options_phase(torch, dev, kc, fnn, rs, track_step) -> dict:
    """Point-to-plane ICP and the Huber and Tukey kernels, once each, on a
    view of the bench box that shows three faces (0.3 m out, 640x480, the
    box turned 0.6 rad about x and 0.7 rad about y), from a start one
    motion of 0.05 rad and 7 mm off. Per option: ADD before and after (mm,
    over 2000 surface points), ICP iterations and K1 launches (counts set
    to 0 just before each step)."""
    from poseestimator_tpu_torch.geom3d.camera import Intrinsics
    from poseestimator_tpu_torch.render.mesh import pad_faces

    def rot(w):
        th = float(np.linalg.norm(w))
        k = np.asarray(w) / th
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K

    intr = Intrinsics.from_fov(60.0, 640, 480)
    T0 = np.eye(4)
    T0[:3, :3] = rot([0.6, 0.0, 0.0]) @ rot([0.0, 0.7, 0.0])
    T0[2, 3] = 0.3
    D = np.eye(4)
    D[:3, :3] = rot([0.0, 0.0, 0.05])
    D[:3, 3] = [0.006, -0.003, 0.002]
    T0, T_obs = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (T0, D @ T0))
    mv = torch.from_numpy(kc.box_vertices()).to(dev)
    mf = torch.from_numpy(pad_faces(kc.BOX_FACES, 256).astype(np.int64)).to(dev)
    depth = rs.render_depth_mesh(mv, mf, T_obs, intr, near=0.01, far=5.0)
    pts = torch.from_numpy(box_surface(np.random.default_rng(1), 2000, kc.BOX_HALF)).to(dev)

    def add_mm(T):
        return float((pts @ (T[:3, :3] - T_obs[:3, :3]).T + (T[:3, 3] - T_obs[:3, 3]))
                     .norm(dim=1).mean()) * 1e3

    gen = torch.Generator(device=dev).manual_seed(5)
    out = {"start_add_mm": add_mm(T0), "options": {}}
    for variant, kernel in (("p2l", "none"), ("p2l", "huber"), ("p2l", "tukey"),
                            ("p2p", "huber"), ("p2p", "tukey")):
        fnn.fused_nn_stats.launches = 0
        r = track_step(mv, mf, depth > 0, depth, T0, intr, 0.02, icp_variant=variant,
                       icp_kernel=kernel, generator=gen)
        torch.cuda.synchronize()
        k1 = fnn.fused_nn_stats.launches
        row = {"add_mm": add_mm(r.T), "n_iters": r.n_iters, "k1_launches": k1,
               "fitness": float(r.fitness)}
        out["options"][f"{variant}/{kernel}"] = row
        if k1 != r.n_iters + 1:
            fail(f"ICP {variant}/{kernel}: {k1} K1 launches for {r.n_iters} iterations")
        if not row["add_mm"] < out["start_add_mm"]:
            fail(f"ICP {variant}/{kernel}: ADD {row['add_mm']:.4f} mm, no better than the "
                 f"start's {out['start_add_mm']:.4f} mm")
    log(json.dumps({"icp_options": out}))
    return out


def multi_phase(torch, dev, kc, fnn, rs, tmp: str, small=(320, 240), full=(640, 480),
                profile_path=None) -> dict:
    """Multi-object tracking on the scene of the JAX package's
    ``tools/eval_tracking.py --objects 3`` (``kernel_cases.multi_object_poses``;
    the exact-raster mesh camera; MULTI_OBJ + 2 static frames, then frames
    turning MULTI_ROT a frame; a perfect per-instance-mask detector; dense
    tracking, max_objects 3, conf 0.7, iou_match 0.2, icp_dist 0.01):
    (m1) one CAD at 320x240, (m2) two classes at 320x240, (m3) one CAD at
    640x480, (m4) the batched step alone at 640x480 for B = 1, 3, 8. See the
    module docstring for what each part prints and is held to.
    ``profile_path``: also trace 3 batched steps at B = 3 there."""
    from poseestimator_tpu_torch.camera import SyntheticCamera, degrade_mask
    from poseestimator_tpu_torch.geom3d import knn as knn_mod
    from poseestimator_tpu_torch.geom3d.camera import Intrinsics
    from poseestimator_tpu_torch.models.yolo.nms import Detections
    from poseestimator_tpu_torch.pipeline import PoseEstimator
    from poseestimator_tpu_torch.pipeline import multi_tracking as tmt
    from poseestimator_tpu_torch.pipeline import tracking as trk
    from poseestimator_tpu_torch.pipeline.window import window_dims
    from poseestimator_tpu_torch.utils.plyio import write_ply

    lv, lf = kc.lshape_mesh()
    bv, bf = kc.box_mesh((0.5, 0.3, 0.2))
    diag = float(np.linalg.norm(lv.max(0) - lv.min(0)))
    write_ply(os.path.join(tmp, "mlshape.ply"), lv, faces=lf)
    write_ply(os.path.join(tmp, "mbox.ply"), bv, faces=bf)
    flips = [np.diag([1.0, -1.0, -1.0, 1.0]), np.diag([-1.0, 1.0, -1.0, 1.0]),
             np.diag([-1.0, -1.0, 1.0, 1.0])]
    syms = {0: [np.eye(4), kc.lshape_symmetry()], 1: [np.eye(4)] + flips}
    syms = {c: [torch.from_numpy(np.asarray(S, np.float32)).to(dev) for S in v]
            for c, v in syms.items()}

    class MultiMaskDetector:
        """One detection per visible instance, from the camera's
        per-instance silhouettes (the evaluation's perfect multi-mask
        detector); ``degrade_px`` puts each through ``degrade_mask``."""

        def __init__(self, camera, classes, max_det=8, degrade_px=0, seed=0):
            self.camera, self.classes, self.max_det = camera, classes, max_det
            self.px, self.rng = degrade_px, np.random.default_rng(seed)

        def __call__(self, img, conf=0.7, iou=0.7):
            ms = torch.from_numpy(self.camera.object_masks).to(dev)
            if self.px > 0:
                ms = torch.stack([degrade_mask(m, self.px, self.rng) for m in ms])
            D = self.max_det
            masks = torch.zeros((D,) + tuple(ms.shape[1:]), dtype=torch.bool, device=dev)
            boxes = np.zeros((D, 4), np.float32)
            cls = np.zeros(D, np.int64)
            j = 0
            for i, m in enumerate(ms[:D]):
                ys, xs = np.nonzero(m.cpu().numpy())
                if len(xs) == 0:
                    continue
                masks[j] = m
                boxes[j] = (xs.min(), ys.min(), xs.max(), ys.max())
                cls[j] = self.classes[i]
                j += 1
            valid = torch.arange(D, device=dev) < j
            det = Detections(boxes=torch.from_numpy(boxes).to(dev), scores=valid.float(),
                             classes=torch.from_numpy(cls).to(dev),
                             coeffs=torch.zeros(D, 32, device=dev), valid=valid)
            return det, masks, torch.from_numpy(boxes).to(dev)

    calls = []  # one entry per batched step: B, n_iters, and the first full batch's inputs
    orig_step = tmt.track_step_batched
    from poseestimator_tpu_torch.pipeline import pose_estimator as pe
    orig_windows = pe.render_windows
    search_renders = [0]  # the spawn searches' batched K2 renders

    def counted_windows(*args, **kw):
        search_renders[0] += 1
        return orig_windows(*args, **kw)

    def recorded_step(mesh_v, mesh_f, masks, depth, Ts, intr, dists, win_hw="auto",
                      target_pts=0, icp_pose_tol=1e-4, generator=None, draws=None):
        # the draws the step would make, made here so that it can be run again
        win = window_dims(intr.scaled(2), win_hw)
        draws = [trk.step_draws(intr, win, target_pts, generator, depth.device)
                 for _ in range(Ts.shape[0])]
        args = (mesh_v, mesh_f, masks, depth, Ts, intr, dists)
        kw = dict(win_hw=win_hw, target_pts=target_pts, icp_pose_tol=icp_pose_tol)
        res = orig_step(*args, **kw, draws=draws)
        entry = {"B": Ts.shape[0], "n_iters": list(res.n_iters)}
        if Ts.shape[0] == MULTI_OBJ and not any("inputs" in c for c in calls):
            entry["inputs"] = ([a.clone() if torch.is_tensor(a) else a for a in args], kw,
                               draws, res)
        calls.append(entry)
        return res

    nn_inputs, raster_inputs = {}, {}
    orig_nn, orig_raster = knn_mod.fused_nn_batched, rs.raster_batched

    def run(name, intr, frames, classes, est_by_cls):
        cams = {c: (e._mesh_v, e._mesh_f) for c, e in est_by_cls.items()}
        models = {c: torch.from_numpy(e.mesh.sample_points_uniformly(
            512, np.random.default_rng(c))[0]).to(dev) for c, e in est_by_cls.items()}
        poses = ([kc.multi_object_poses(MULTI_OBJ, diag, 0.0)] * (MULTI_OBJ + 2)
                 + [kc.multi_object_poses(MULTI_OBJ, diag, MULTI_ROT * (k + 1))
                    for k in range(frames)])
        cam = SyntheticCamera(lv, np.zeros_like(lv), poses, intr,
                              instance_meshes=[cams[c] for c in classes], device=dev)
        est = est_by_cls if len(est_by_cls) > 1 else est_by_cls[0]
        mt = tmt.MultiTracker(cam, est, MultiMaskDetector(cam, classes), max_objects=MULTI_OBJ,
                              target_pts=0, conf=0.7, iou_match=0.2, icp_dist=0.01, seed=0,
                              device=dev)
        calls.clear()
        rows, assign, switches, acquired = [], {}, 0, None
        for k in range(len(poses)):
            for c in (fnn.fused_nn_batched_stats, rs.raster_batched_stats):
                c.launches = 0
            search_renders[0] = 0
            n_calls = len(calls)
            t = time.perf_counter()
            res = mt.step()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            row = {"frame": k + 1, "ms": ms, "k1": fnn.fused_nn_batched_stats.launches,
                   "k2": rs.raster_batched_stats.launches - search_renders[0],
                   "k2_search": search_renders[0], "tracks": len(res.tracks),
                   "steps": calls[n_calls:], "spawned": "init" in res.timings}
            if len(row["steps"]) > 1:
                fail(f"multi {name}: {len(row['steps'])} batched steps in one frame")
            if row["steps"]:
                want = max(row["steps"][0]["n_iters"]) + 1
                if row["k1"] != want or row["k2"] != 1:
                    fail(f"multi {name} frame {k + 1}: {row['k1']} K1 / {row['k2']} K2 "
                         f"batched launches, expected {want} / 1")
            if len(res.tracks) == MULTI_OBJ:
                acquired = acquired or k + 1
                gts = torch.from_numpy(cam.current_gt).to(dev)
                errs, plain = [], []
                for tr in res.tracks:
                    cand = [i for i in range(MULTI_OBJ) if classes[i] == tr.class_id]
                    T = torch.from_numpy(np.asarray(tr.T_out, np.float32)).to(dev)
                    e = [adds_sym_cm(torch, models[tr.class_id], T, gts[i],
                                     syms[tr.class_id])[0] for i in cand]
                    j = cand[int(np.argmin(e))]
                    if assign.get(tr.track_id, j) != j:
                        switches += 1
                    assign[tr.track_id] = j
                    errs.append(min(e))
                    plain.append(adds_cm(torch, models[tr.class_id], T, gts[j]))
                row["adds_cm"], row["adds_plain_cm"] = errs, plain
            rows.append(row)
        scored = [r for r in rows if "adds_cm" in r]
        batched = [r for r in rows if r["steps"]]
        if not scored:
            fail(f"multi {name}: the {MULTI_OBJ} instances were never all tracked")
        adds = np.concatenate([r["adds_cm"] for r in scored])
        full = [r for r in batched if r["steps"][0]["B"] == MULTI_OBJ and not r["spawned"]]
        out = {"part": name, "camera": [intr.width, intr.height], "classes": classes,
               "frames": len(rows), "frames_scored": len(scored), "acquired_at_frame": acquired,
               "adds_mean_cm": float(adds.mean()), "adds_p95_cm": float(np.percentile(adds, 95)),
               "adds_plain_mean_cm": float(np.concatenate([r["adds_plain_cm"]
                                                           for r in scored]).mean()),
               "per_object_adds_cm": np.mean([r["adds_cm"] for r in scored], 0).tolist(),
               "id_switches": switches,
               "step_ms_median": float(np.median([r["ms"] for r in full])),
               "batch_ms_median_per_object": float(np.median([r["ms"] for r in full])) / MULTI_OBJ,
               "k1_per_tracked_frame": float(np.mean([r["k1"] for r in batched])),
               "k2_per_tracked_frame": float(np.mean([r["k2"] for r in batched])),
               "max_n_iters_plus_1_mean": float(np.mean([max(r["steps"][0]["n_iters"]) + 1
                                                         for r in batched])),
               "sum_n_iters_plus_1_mean": float(np.mean(
                   [sum(n + 1 for n in r["steps"][0]["n_iters"]) for r in batched])),
               "k1_launches": sum(r["k1"] for r in rows), "k2_launches": sum(r["k2"] for r in rows)}
        first = next(c for c in calls if "inputs" in c)
        out["b_independence"] = check_b_independence(torch, trk, *first["inputs"])
        log(json.dumps({"multi": out}))
        if not out["adds_mean_cm"] <= ADDS_BUDGET_CM:
            fail(f"multi {name}: mean ADD-S {out['adds_mean_cm']:.4f} cm > {ADDS_BUDGET_CM} cm")
        if switches:
            fail(f"multi {name}: {switches} identity switches")
        return out, mt, cam

    parts = {}
    tmt.track_step_batched, pe.render_windows = recorded_step, counted_windows
    knn_mod.fused_nn_batched = _first_call_recorder(
        torch, nn_inputs, orig_nn, lambda q, qv, d, dv: tuple(q.shape[:2]) + (d.shape[1],))
    rs.raster_batched = _first_call_recorder(
        torch, raster_inputs, orig_raster, lambda c, b, H, W: (c.shape[0], H, W, c.shape[1]))
    try:
        i320, i640 = Intrinsics.from_fov(60.0, *small), Intrinsics.from_fov(60.0, *full)
        mk = lambda cad, intr, views, seed: PoseEstimator(  # noqa: E731
            os.path.join(tmp, cad), os.path.join(tmp, views), intr, target_points=100,
            seed=seed, device=dev)
        l320 = mk("mlshape.ply", i320, "mviews320", 0)
        parts["m1"] = run(f"m1: one CAD, {small[0]}x{small[1]}", i320, MULTI_FRAMES["m1"],
                          [0, 0, 0], {0: l320})[0]
        b320 = mk("mbox.ply", i320, "mboxviews320", 1)
        parts["m2"] = run(f"m2: two classes (0, 1, 0), {small[0]}x{small[1]}", i320,
                          MULTI_FRAMES["m2"], [0, 1, 0], {0: l320, 1: b320})[0]
        l640 = mk("mlshape.ply", i640, "mviews640", 0)
        parts["m3"], mt3, cam3 = run(f"m3: one CAD, {full[0]}x{full[1]}", i640, MULTI_FRAMES["m3"],
                                     [0, 0, 0], {0: l640})
        tmt.track_step_batched, pe.render_windows = orig_step, orig_windows
        parts["m4"] = batch_sizes_part(torch, dev, fnn, rs, trk, mt3, cam3, l640,
                                       profile_path)
    finally:
        tmt.track_step_batched, pe.render_windows = orig_step, orig_windows
        knn_mod.fused_nn_batched, rs.raster_batched = orig_nn, orig_raster
    return {"parts": parts, "nn_inputs": nn_inputs, "raster_inputs": raster_inputs}


def offline_phase(torch, dev, kc, fnn, rs, out_dir: str, profile_path=None) -> dict:
    """The offline single-frame path and its BOP evaluation (see the module
    docstring): the port writes the scene into ``out_dir`` and runs
    ``apps/eval_bop.run`` over it, first with the offline registration, then
    with the product search. Per frame: the registration's synchronised
    ms and K1 launches (single and batched), the cliques that ran, and ADD
    plain and against the nearer symmetric twin. Returns the summaries and
    the K1 inputs of the offline run by shape (first call of each).
    ``profile_path``: also trace 2 offline registrations of the last frame
    there."""
    from poseestimator_tpu_torch.apps import eval_bop
    from poseestimator_tpu_torch.geom3d import knn as knn_mod
    from poseestimator_tpu_torch.geom3d.camera import Intrinsics
    from poseestimator_tpu_torch.geom3d.cloud import from_points
    from poseestimator_tpu_torch.geom3d.metrics import add_metric
    from poseestimator_tpu_torch.pipeline.pose_estimator import PoseEstimator
    from poseestimator_tpu_torch.registration import native
    from poseestimator_tpu_torch.templates.creation import render_templates
    from poseestimator_tpu_torch.utils import bop
    from poseestimator_tpu_torch.utils.plyio import write_ply

    t = time.perf_counter()
    try:
        lib = native.build()
    except RuntimeError as e:
        fail(f"offline: the exact max-clique library did not build: {e}")
    native_s = time.perf_counter() - t
    if not native.available():
        fail(f"offline: {lib} did not load")
    v, f = kc.lshape_mesh()
    sym = kc.lshape_symmetry()
    diag_mm = float(np.linalg.norm(v.max(0) - v.min(0))) * 1e3
    os.makedirs(out_dir, exist_ok=True)
    cad = os.path.join(out_dir, "obj_000001.ply")
    write_ply(cad, v, faces=f)
    views, scene = os.path.join(out_dir, "views"), os.path.join(out_dir, "scene")
    rs.raster_stats.launches = 0
    render_templates(cad, views, device=dev)
    kc.write_bop_scene(scene, v, f, Intrinsics.from_fov(60.0, 640, 480), kc.bop_scene_poses(),
                       symmetries=sym[None], device=dev)
    torch.cuda.synchronize()
    log(f"offline: native clique library {os.path.basename(str(lib))} in {native_s:.2f} s; "
        f"CAD, 5-view template database and 3-frame 640x480 scene written to {out_dir} "
        f"({rs.raster_stats.launches} K2 launches)")

    frames, last_call = [], {}

    def k1_now():
        return fnn.fused_nn_stats.launches, fnn.fused_nn_batched_stats.launches

    def timed(fn, kind):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            (k1, k1b), t0 = k1_now(), time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            last_call[kind] = (a, kw)
            rec = {"kind": kind, "ms": (time.perf_counter() - t0) * 1e3,
                   "k1": k1_now()[0] - k1, "k1_batched": k1_now()[1] - k1b}
            if kind == "offline":
                rec["cliques"] = [m.get("clique", m.get("note")) for m in out[3]]
                rec["winner"] = out[0]
            frames.append(rec)
            return out
        return wrapped

    def metrics_recorded(T_est_mm, T_gt_mm, K, verts_mm, intr, **kw):
        out = orig_fm(T_est_mm, T_gt_mm, K, verts_mm, intr, **kw)
        model = from_points(verts_mm, device=dev)
        Te = torch.as_tensor(T_est_mm, dtype=torch.float32, device=dev)
        Tg = torch.as_tensor(T_gt_mm, dtype=torch.float32, device=dev)
        S_mm = sym.astype(np.float64).copy()
        S_mm[:3, 3] *= 1e3
        twins = [float(add_metric(Te, Tg @ torch.as_tensor(S, dtype=torch.float32, device=dev),
                                  model)) for S in (np.eye(4), S_mm)]
        frames[-1].update(add_mm=out["add_mm"], add_twin_mm=twins[1],
                          add_nearer_mm=min(twins), nearer="twin" if twins[1] < twins[0] else
                          "identity")
        return out

    png_ms = [0.0]

    def read_timed(path):
        t0 = time.perf_counter()
        img = orig_read(path)
        png_ms[0] += (time.perf_counter() - t0) * 1e3
        return img

    base = ["--scene-dir", scene, "--ply", cad, "--templates", views, "--mask", "visib",
            "--models-info", os.path.join(scene, "models_info.json"), "--device", str(dev)]
    nn_inputs, nn_batched_inputs = {}, {}
    orig_off, orig_cands = eval_bop.find_best_template_teaser, \
        PoseEstimator.find_best_template_candidates
    orig_fm, orig_nn, orig_nnb = bop.frame_metrics, knn_mod.fused_nn, knn_mod.fused_nn_batched
    orig_read = eval_bop.read_png
    out = {"diag_mm": diag_mm, "native_build_s": native_s}
    try:
        eval_bop.find_best_template_teaser = timed(orig_off, "offline")
        PoseEstimator.find_best_template_candidates = timed(orig_cands, "product")
        bop.frame_metrics = metrics_recorded
        eval_bop.read_png = bop.read_png = read_timed
        for name, extra in (("offline", ["--target-points", str(OFFLINE_POINTS)]),
                            ("product", ["--registration", "product", "--max-frames",
                                         str(OFFLINE_PRODUCT_FRAMES)])):
            if name == "offline":  # keeps the kernels' inputs at the offline shapes
                knn_mod.fused_nn = _first_call_recorder(
                    torch, nn_inputs, orig_nn, lambda q, qv, d, dv: (q.shape[0], d.shape[0]))
                knn_mod.fused_nn_batched = _first_call_recorder(
                    torch, nn_batched_inputs, orig_nnb,
                    lambda q, qv, d, dv: (q.shape[0], q.shape[1], d.shape[1]))
            frames.clear()
            png_ms[0] = 0.0
            fnn.fused_nn_stats.launches = 0
            fnn.fused_nn_batched_stats.launches = 0
            rs.raster_stats.launches = rs.raster_batched_stats.launches = 0
            t = time.perf_counter()
            summary = eval_bop.run(eval_bop.build_parser().parse_args(base + extra))
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t
            knn_mod.fused_nn, knn_mod.fused_nn_batched = orig_nn, orig_nnb
            k1, k1b = fnn.fused_nn_stats.launches, fnn.fused_nn_batched_stats.launches
            k2, k2b = rs.raster_stats.launches, rs.raster_batched_stats.launches
            if summary is None:
                fail(f"offline {name}: no frame evaluated")
            n_frames = max(len(frames), 1)
            part = {"summary": summary, "frames": list(frames), "wall_s": wall_s,
                    "wall_ms_per_frame": wall_s * 1e3 / n_frames,
                    "png_read_ms_per_frame": png_ms[0] / n_frames,
                    "k1_launches": k1, "k1_batched_launches": k1b, "k2_launches": k2,
                    "k2_batched_launches": k2b,
                    "k1_per_frame": k1 / n_frames, "k1_batched_per_frame": k1b / n_frames,
                    "ms_per_frame": [r["ms"] for r in frames]}
            out[name] = part
            log(json.dumps({"offline": {"registration": name, **{
                k: v for k, v in part.items() if k != "frames"}, "frames": frames}}))
    finally:
        eval_bop.find_best_template_teaser = orig_off
        PoseEstimator.find_best_template_candidates = orig_cands
        bop.frame_metrics = orig_fm
        eval_bop.read_png = bop.read_png = orig_read
        knn_mod.fused_nn, knn_mod.fused_nn_batched = orig_nn, orig_nnb

    off, prod = out["offline"], out["product"]
    if off["summary"]["frames"] != 3 or prod["summary"]["frames"] != OFFLINE_PRODUCT_FRAMES:
        fail(f"offline: {off['summary']['frames']} offline and {prod['summary']['frames']} "
             f"product frames evaluated")
    if off["k1_launches"] == 0 or off["k1_batched_launches"] == 0:
        fail("offline: K1 (single or batched) was not launched by the offline path")
    if prod["k1_launches"] == 0 or prod["k2_batched_launches"] == 0:
        fail("offline: the product search launched no K1 or no K2")
    for key in ("bop_ar", "ar_mssd"):
        if not off["summary"][key] > 0.5:
            fail(f"offline: {key} {off['summary'][key]} <= 0.5")
    if not prod["summary"]["bop_ar"] > 0.5:
        fail(f"offline product search: bop_ar {prod['summary']['bop_ar']} <= 0.5")
    for r in off["frames"]:
        if not r["add_nearer_mm"] < OFFLINE_ADD_DIAG * diag_mm:
            fail(f"offline frame: ADD {r['add_nearer_mm']:.2f} mm against the nearer twin >= "
                 f"{OFFLINE_ADD_DIAG} x diag ({OFFLINE_ADD_DIAG * diag_mm:.1f} mm)")
        scored = [c for c in r["cliques"] if c != "few_corr"]
        if not scored or any(c != "exact" for c in scored):
            fail(f"offline frame: cliques {r['cliques']}, expected 'exact' for every scored "
                 f"template")
    if profile_path:
        a, kw = last_call["offline"]
        off["profile"] = profile_calls(torch, lambda: orig_off(*a, **kw), 2, profile_path,
                                       "registration")
    out["nn_inputs"], out["nn_batched_inputs"] = nn_inputs, nn_batched_inputs
    return out


def apps_phase(torch, dev, kc, fnn, rs, off_dir: str, visib: dict, card: str) -> dict:
    """The user-facing apps on the card (see the module docstring), parts
    (a1)-(a6), on the offline phase's L-shape CAD, template database and
    scene in ``off_dir``; ``visib`` is that phase's ``--mask visib``
    summary. The detector is the port's on seeded random weights, saved as
    a ``.pt`` and loaded through each app's ``--weights``: the harness puts
    it in each app module's place (``SilhouetteDetector``). Each part prints
    one ``{"apps": ...}`` line; returns them, and the kernels' inputs by
    shape (first call of each) for the shape checks."""
    import argparse
    import dataclasses

    from poseestimator_tpu_torch.apps import eval_bop, main_image, main_realsense
    from poseestimator_tpu_torch.apps import main_seibersdorf
    from poseestimator_tpu_torch.camera.record import record
    from poseestimator_tpu_torch.geom3d import knn as knn_mod
    from poseestimator_tpu_torch.geom3d.camera import Intrinsics
    from poseestimator_tpu_torch.geom3d.cloud import from_points
    from poseestimator_tpu_torch.geom3d.metrics import add_metric
    from poseestimator_tpu_torch.models.yolo.model import YOLO11Seg, init_random_
    from poseestimator_tpu_torch.pipeline import detector as det_mod
    from poseestimator_tpu_torch.pipeline import multi_tracking, tracking
    from poseestimator_tpu_torch.render.mesh import TriangleMesh
    from poseestimator_tpu_torch.templates import db as tdb
    from poseestimator_tpu_torch.utils.jpeg import decode_jpeg
    from poseestimator_tpu_torch.utils.png import read_png, write_png

    cad, views = os.path.join(off_dir, "obj_000001.ply"), os.path.join(off_dir, "views")
    scene = os.path.join(off_dir, "scene")
    v, f = kc.lshape_mesh()
    diag = float(np.linalg.norm(v.max(0) - v.min(0)))
    S = kc.lshape_symmetry()
    syms = [torch.eye(4, device=dev), torch.from_numpy(S).to(dev)]
    pts = torch.from_numpy(TriangleMesh(vertices=v, faces=f).sample_points_uniformly(
        2000, np.random.default_rng(1))[0]).to(dev)
    intr = Intrinsics.from_fov(60.0, 640, 480)
    weights = os.path.join(off_dir, "yolo11n_seg_seed0.pt")
    torch.save(init_random_(YOLO11Seg(nc=5, scale="n"), torch.Generator().manual_seed(0))
               .state_dict(), weights)
    dev_s = str(dev)
    RealDetector = det_mod.Detector

    class SilhouetteDetector:
        """The port's ``Detector`` on the seeded weights, its forward on the
        card with the confidence gate at 0, keeping the top detection only:
        class 0, its mask replaced by ``silhouette(image)`` and its box the
        silhouette's. It has no ``model`` attribute, so the ``Tracker``
        takes its detect + ``track_step`` path through this call;
        ``detect_mask`` is ``Detector``'s own (the polygon round trip)."""

        silhouette = None
        made = 0

        def __init__(self, weights, nc=5, scale="n", device="cuda", **kw):
            self.inner = RealDetector(weights, nc=nc, scale=scale, device=device)
            type(self).made += 1

        def __call__(self, img, conf=0.25, iou=0.7, with_masks=True):
            det, masks, boxes = self.inner(img, 0.0, iou, with_masks)
            sil = torch.as_tensor(type(self).silhouette(img), device=dev).bool()
            ys, xs = torch.nonzero(sil, as_tuple=True)
            boxes = boxes.clone()
            if len(xs):
                boxes[0] = torch.stack([xs.min(), ys.min(), xs.max(), ys.max()]).float()
            valid = torch.zeros_like(det.valid)
            valid[0] = det.valid[0] & bool(len(xs))
            classes = det.classes.clone()
            classes[0] = 0
            det = dataclasses.replace(det, valid=valid, classes=classes)
            if masks is not None:
                masks = masks.clone()
                masks[0] = sil
            return det, masks, boxes

        detect_mask = RealDetector.detect_mask

    colour_sil = lambda img: (np.asarray(img) != 30).any(-1)  # noqa: E731 (flat-coloured images)

    def counts():
        return {"k1": fnn.fused_nn_stats.launches, "k1_batched": fnn.fused_nn_batched_stats.launches,
                "k2": rs.raster_stats.launches, "k2_batched": rs.raster_batched_stats.launches}

    def zero():
        fnn.fused_nn_stats.launches = fnn.fused_nn_batched_stats.launches = 0
        rs.raster_stats.launches = rs.raster_batched_stats.launches = 0

    def since(c0):
        return {k: v - c0[k] for k, v in counts().items()}

    def add_nearer_mm(T_est_mm, T_gt_mm):
        model = from_points(v * 1000.0, device=dev)
        Te = torch.as_tensor(T_est_mm, dtype=torch.float32, device=dev)
        S_mm = S.astype(np.float64).copy()
        S_mm[:3, 3] *= 1e3
        return min(float(add_metric(Te, torch.as_tensor(T_gt_mm @ Sx, dtype=torch.float32,
                                                         device=dev), model))
                   for Sx in (np.eye(4), S_mm))

    def emit(part: str, rec: dict) -> dict:
        log(json.dumps({"apps": {"part": part, "card": card, **rec}}))
        return rec

    nn_in, nnb_in, k2_in, k2b_in = {}, {}, {}, {}
    orig = {"nn": knn_mod.fused_nn, "nnb": knn_mod.fused_nn_batched, "k2": rs.raster,
            "k2b": rs.raster_batched, "make": main_realsense.make_camera,
            "step": tracking.Tracker.step, "mstep": multi_tracking.MultiTracker.step,
            "render": tdb.render_templates, "det_mod": det_mod.Detector,
            "image_reg": main_image.find_best_template_teaser,
            "image_fm": main_image.frame_metrics, "image_ar": main_image.bop_average_recall,
            "seiber_det": main_seibersdorf.Detector, "seiber_est": main_seibersdorf.PoseEstimator,
            "seiber_sor": main_seibersdorf.remove_statistical_outlier,
            "seiber_pts": main_seibersdorf.from_points, "rs_det": main_realsense.Detector,
            "bop_det": eval_bop.Detector}
    knn_mod.fused_nn = _first_call_recorder(torch, nn_in, orig["nn"],
                                            lambda q, qv, d, dv: (q.shape[0], d.shape[0]))
    knn_mod.fused_nn_batched = _first_call_recorder(
        torch, nnb_in, orig["nnb"], lambda q, qv, d, dv: tuple(q.shape[:2]) + (d.shape[1],))
    rs.raster = _first_call_recorder(torch, k2_in, orig["k2"],
                                     lambda c, b, H, W: (H, W, c.shape[0]))
    rs.raster_batched = _first_call_recorder(
        torch, k2b_in, orig["k2b"], lambda c, b, H, W: (c.shape[0], H, W, c.shape[1]))
    det_mod.Detector = main_seibersdorf.Detector = main_realsense.Detector = \
        eval_bop.Detector = SilhouetteDetector
    parts = {}
    try:
        # JPEG: the host cost of a BlenderProc-style 640x480 q95 4:2:0 frame
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                               "frame_640x480_q95.jpg"), "rb") as fh:
            blob = fh.read()
        jms = []
        for _ in range(3):
            t = time.perf_counter()
            img = decode_jpeg(blob)
            jms.append((time.perf_counter() - t) * 1e3)
        if img.shape != (480, 640, 3):
            fail(f"apps: the JPEG frame decoded to {img.shape}")
        parts["jpeg"] = emit("jpeg decode", {"bytes": len(blob), "host_ms": jms,
                                             "host_ms_median": float(np.median(jms))})

        # (a1) main_image on frame 0 of the BOP scene
        SilhouetteDetector.silhouette = staticmethod(colour_sil)
        rec = {}

        def timed_reg(*a, **k):
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), counts()
            out = orig["image_reg"](*a, **k)
            torch.cuda.synchronize()
            rec.update(reg_ms=(time.perf_counter() - t0) * 1e3, reg_launches=since(c0),
                       H=np.asarray(out[1]), chamfers=[m["score"] for m in out[3]])
            return out

        main_image.find_best_template_teaser = timed_reg
        main_image.frame_metrics = lambda *a, **k: rec.setdefault("fm", orig["image_fm"](*a, **k))
        main_image.bop_average_recall = lambda *a, **k: rec.setdefault(
            "ar", orig["image_ar"](*a, **k))
        overlay = os.path.join(off_dir, "a1_overlay.png")
        zero()
        torch.cuda.synchronize()
        t = time.perf_counter()
        rc = main_image.main([
            "--weights", weights, "--rgb", os.path.join(scene, "rgb", "000000.png"),
            "--depth", os.path.join(scene, "depth", "000000.png"),
            "--scene-camera", os.path.join(scene, "scene_camera.json"),
            "--scene-gt", os.path.join(scene, "scene_gt.json"), "--templates", views,
            "--ply", cad, "--models-info", os.path.join(scene, "models_info.json"),
            "--headless", "--save-overlay", overlay, "--device", dev_s])
        torch.cuda.synchronize()
        main_ms, launches = (time.perf_counter() - t) * 1e3, counts()
        with open(os.path.join(scene, "scene_gt.json")) as fh:
            g = json.load(fh)["0"][0]
        T_gt = np.eye(4)
        T_gt[:3, :3] = np.asarray(g["cam_R_m2c"]).reshape(3, 3)
        T_gt[:3, 3] = g["cam_t_m2c"]
        T_est = rec["H"].astype(np.float64).copy()
        T_est[:3, 3] *= 1e3
        ov = read_png(overlay)
        red = int(((ov[..., 0] == 255) & (ov[..., 1] == 0) & (ov[..., 2] == 0)).sum())
        fm = rec["fm"]
        a1 = emit("a1 main_image", {
            "rc": rc, "chamfers": rec["chamfers"], "add_mm": fm["add_mm"],
            "adds_mm": fm["adds_mm"], "mssd_mm": fm["mssd_mm"], "mspd_px": fm["mspd_px"],
            **rec["ar"], "add_nearer_mm": add_nearer_mm(T_est, T_gt),
            "add_gate_mm": OFFLINE_ADD_DIAG * diag * 1e3, "overlay_shape": list(ov.shape),
            "overlay_red_px": red, "main_ms": main_ms, "registration_ms": rec["reg_ms"],
            "launches": launches, "registration_launches": rec["reg_launches"]})
        if rc != 0 or not a1["add_nearer_mm"] < a1["add_gate_mm"]:
            fail(f"apps a1: rc {rc}, ADD {a1['add_nearer_mm']:.2f} mm against the nearer twin "
                 f"(gate {a1['add_gate_mm']:.1f} mm)")
        if ov.shape != read_png(os.path.join(scene, "depth", "000000.png")).shape + (3,) \
                or red == 0 or launches["k1"] == 0:
            fail(f"apps a1: overlay {ov.shape} with {red} red pixels, K1 {launches['k1']}")
        parts["a1"] = a1

        # (b4) the same run through the compat namespace's module path: the
        # same registration, metrics and overlay
        from poseestimator_tpu_torch.compat import main_image as compat_image

        first = dict(rec)
        rec.clear()
        overlay_c = os.path.join(off_dir, "b4_overlay.png")
        t = time.perf_counter()
        rc_c = compat_image.main([
            "--weights", weights, "--rgb", os.path.join(scene, "rgb", "000000.png"),
            "--depth", os.path.join(scene, "depth", "000000.png"),
            "--scene-camera", os.path.join(scene, "scene_camera.json"),
            "--scene-gt", os.path.join(scene, "scene_gt.json"), "--templates", views,
            "--ply", cad, "--models-info", os.path.join(scene, "models_info.json"),
            "--headless", "--save-overlay", overlay_c, "--device", dev_s])
        torch.cuda.synchronize()
        same = (rc_c == rc and np.array_equal(rec["H"], first["H"])
                and rec["chamfers"] == first["chamfers"]
                and all(np.array_equal(np.asarray(rec["fm"][k]), np.asarray(first["fm"][k]))
                        for k in first["fm"]) and rec["ar"] == first["ar"]
                and np.array_equal(read_png(overlay_c), ov))
        b4 = emit("b4 compat.main_image", {
            "rc": rc_c, "equal_to_a1": same, "main_ms": (time.perf_counter() - t) * 1e3,
            "add_mm": rec["fm"]["add_mm"], "bop_ar": rec["ar"]["bop_ar"]})
        if not same:
            fail(f"apps b4: compat.main_image differs from apps/main_image: {b4}")
        parts["b4"] = b4

        # (a2) main_realsense, the synthetic source at the app's defaults
        cams, steps, builds = [], [], []

        def make_cam(args, intr_fb):
            cams.append(orig["make"](args, intr_fb))
            return cams[-1]

        def step(self):
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), counts()
            res = orig["step"](self)
            torch.cuda.synchronize()
            if res is not None:
                gt = getattr(self.camera, "current_gt", None)
                steps.append({"state": res.state, "ms": (time.perf_counter() - t0) * 1e3,
                              "T": None if res.T_m2c is None else np.array(res.T_m2c),
                              "gt": None if gt is None else np.array(gt), **since(c0),
                              "registration_ms": res.timings.get("global_registration", 0.0)
                              * 1e3})
            return res

        def render(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig["render"](*a, **k)
            torch.cuda.synchronize()
            builds.append({"s": time.perf_counter() - t0, "views": len(out)})
            return out

        main_realsense.make_camera = make_cam
        tracking.Tracker.step = step
        tdb.render_templates = render
        SilhouetteDetector.silhouette = staticmethod(lambda img: cams[-1].depth > 0)
        views_full = os.path.join(off_dir, "views_full")
        shutil.rmtree(views_full, ignore_errors=True)  # rendered on first use, as users meet it
        base = ["--weights", weights, "--pcd-path", views_full, "--cad-path", cad,
                "--headless", "--device", dev_s]
        zero()
        t = time.perf_counter()
        rc = main_realsense.main(base + ["--source", "synthetic", "--max-frames",
                                         str(APPS_FRAMES)])
        torch.cuda.synchronize()
        main_ms = (time.perf_counter() - t) * 1e3
        live = list(steps)
        states = "".join(r["state"][0] for r in live)
        first = states.find("i")
        tracked = [r for r in live[first + 1:]] if first >= 0 else []
        adds = [adds_sym_cm(torch, pts, torch.from_numpy(r["T"].astype(np.float32)).to(dev),
                            torch.from_numpy(r["gt"]).to(dev), syms)[0] for r in tracked]
        init = live[first] if first >= 0 else {}
        a2 = emit("a2 main_realsense synthetic", {
            "rc": rc, "frames": len(live), "states": states, "main_ms": main_ms,
            "db_build": builds, "first_pose_ms": init.get("ms"),
            "init_registration_ms": init.get("registration_ms"),
            "k1_per_init": init.get("k1"), "k1_batched_per_init": init.get("k1_batched"),
            "k2_per_init": init.get("k2"),
            "adds_mean_cm": float(np.mean(adds)) if adds else None,
            "adds_p95_cm": float(np.percentile(adds, 95)) if adds else None,
            "adds_budget_cm": ADDS_BUDGET_CM,
            "step_ms_median": float(np.median([r["ms"] for r in tracked])) if tracked else None,
            "k1_per_tracked_frame": float(np.mean([r["k1"] for r in tracked])) if tracked else 0,
            "k2_per_tracked_frame": float(np.mean([r["k2"] for r in tracked])) if tracked else 0})
        if rc != 0 or first < 0 or not tracked or any(r["state"] != "track" for r in tracked):
            fail(f"apps a2: rc {rc}, states {states}: every frame after acquisition must track")
        if not a2["adds_mean_cm"] < ADDS_BUDGET_CM:
            fail(f"apps a2: ADD-S mean {a2['adds_mean_cm']:.4f} cm >= {ADDS_BUDGET_CM} cm")
        if not builds or builds[0]["views"] != 26 or a2["k1_per_tracked_frame"] == 0 \
                or a2["k2_per_tracked_frame"] == 0:
            fail(f"apps a2: DB builds {builds}, K1 {a2['k1_per_tracked_frame']} and K2 "
                 f"{a2['k2_per_tracked_frame']} per tracked frame")
        parts["a2"] = a2

        # (a3) the first frames of the same camera recorded, then replayed
        rec_dir = os.path.join(off_dir, "replay")
        ns = argparse.Namespace(source="synthetic", cad_path=cad, device=dev_s)
        n_rec = record(orig["make"](ns, intr), rec_dir, APPS_RECORD, verbose=False)
        steps.clear()
        zero()
        rc = main_realsense.main(base + ["--source", f"replay:{rec_dir}"])
        replay = list(steps)
        diffs = [float(np.abs(a["T"] - b["T"]).max()) for a, b in zip(live, replay)]
        a3 = emit("a3 record and replay", {
            "rc": rc, "recorded": n_rec, "frames": len(replay),
            "states": "".join(r["state"][0] for r in replay),
            "max_abs_pose_diff": max(diffs) if diffs else None, "pose_diffs": diffs})
        if rc != 0 or n_rec != APPS_RECORD or len(replay) < 2 or not max(diffs) <= 1e-5:
            steps.clear()  # is the live session itself repeatable?
            main_realsense.main(base + ["--source", "synthetic", "--max-frames",
                                        str(len(replay))])
            again = [float(np.abs(a["T"] - b["T"]).max()) for a, b in zip(live, steps)]
            fail(f"apps a3: rc {rc}, {n_rec} frames recorded, {len(replay)} replayed, pose "
                 f"differences {diffs}; a second live session differs from the first by "
                 f"{again}")
        parts["a3"] = a3

        # (a4) --multi on the synthetic source
        msteps = []

        def mstep(self):
            c0 = counts()
            res = orig["mstep"](self)
            if res is not None:
                msteps.append({"tracks": len(res.tracks), "detections": res.n_detections,
                               **since(c0)})
            return res

        multi_tracking.MultiTracker.step = mstep
        zero()
        t = time.perf_counter()
        rc = main_realsense.main(base + ["--source", "synthetic", "--multi", "--max-frames",
                                         str(APPS_MULTI)])
        torch.cuda.synchronize()
        a4 = emit("a4 main_realsense --multi", {
            "rc": rc, "frames": len(msteps), "tracks": [r["tracks"] for r in msteps],
            "main_ms": (time.perf_counter() - t) * 1e3, "launches": counts()})
        if rc != 0 or not msteps or msteps[-1]["tracks"] != 1:
            fail(f"apps a4: rc {rc}, tracks per frame {a4['tracks']}")
        parts["a4"] = a4

        # (a5) main_seibersdorf on a LiDAR frame
        parts["a5"] = seibersdorf_part(torch, dev, kc, rs, main_seibersdorf, off_dir, cad,
                                       views, weights, intr, pts, syms, diag, orig, counts,
                                       zero, emit, SilhouetteDetector, colour_sil, write_png)

        # (a6) eval_bop --mask detector over the scene
        SilhouetteDetector.silhouette = staticmethod(colour_sil)
        SilhouetteDetector.made = 0
        zero()
        t = time.perf_counter()
        det = eval_bop.run(eval_bop.build_parser().parse_args([
            "--scene-dir", scene, "--ply", cad, "--templates", views, "--mask", "detector",
            "--weights", weights, "--target-points", str(OFFLINE_POINTS), "--device", dev_s,
            "--models-info", os.path.join(scene, "models_info.json")]), quiet=True)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        launches = counts()
        d1 = SilhouetteDetector(weights, device=dev)
        px = []
        for k in range(3):
            img = read_png(os.path.join(scene, "rgb", f"{k:06d}.png"))[..., ::-1]
            m = d1.detect_mask(np.ascontiguousarray(img))[0]["mask"]
            px.append(int((m != read_png(os.path.join(scene, "mask_visib",
                                                      f"{k:06d}_000000.png"))).sum()))
        a6 = emit("a6 eval_bop --mask detector", {
            "summary": det, "bop_ar_visib": visib["bop_ar"], "mask_px_differing": px,
            "detectors_made": SilhouetteDetector.made - 1, "wall_ms_per_frame": wall / 3,
            "launches": launches})
        if det is None or det["frames"] != 3 or det["bop_ar"] != visib["bop_ar"] \
                or SilhouetteDetector.made != 2:
            fail(f"apps a6: --mask detector summary {det} against --mask visib bop_ar "
                 f"{visib['bop_ar']}, mask pixels differing {px}")
        parts["a6"] = a6
    finally:
        knn_mod.fused_nn, knn_mod.fused_nn_batched = orig["nn"], orig["nnb"]
        rs.raster, rs.raster_batched = orig["k2"], orig["k2b"]
        main_realsense.make_camera = orig["make"]
        tracking.Tracker.step, multi_tracking.MultiTracker.step = orig["step"], orig["mstep"]
        tdb.render_templates = orig["render"]
        det_mod.Detector = orig["det_mod"]
        main_seibersdorf.Detector, main_realsense.Detector = orig["seiber_det"], orig["rs_det"]
        eval_bop.Detector = orig["bop_det"]
        main_seibersdorf.PoseEstimator = orig["seiber_est"]
        main_seibersdorf.remove_statistical_outlier = orig["seiber_sor"]
        main_seibersdorf.from_points = orig["seiber_pts"]
        main_image.find_best_template_teaser = orig["image_reg"]
        main_image.frame_metrics = orig["image_fm"]
        main_image.bop_average_recall = orig["image_ar"]
    return {"parts": parts, "nn_inputs": nn_in, "nn_batched_inputs": nnb_in,
            "raster_inputs": k2_in, "raster_batched_inputs": k2b_in}


def seibersdorf_part(torch, dev, kc, rs, app, off_dir, cad, views, weights, intr, pts, syms,
                     diag, orig, counts, zero, emit, SilhouetteDetector, colour_sil,
                     write_png) -> dict:
    """(a5): a LiDAR frame of LIDAR_POINTS points (a ground plane under the
    L-shape, its sampled surface and uniform clutter, as a LiDAR beside the
    camera sees them: points the object hides from the camera are
    dropped), in a LiDAR frame given as xyz + rpy in a calib.yaml written as
    text with a 5-term D; the image the object's flat-coloured render."""
    from poseestimator_tpu_torch.geom3d.se3 import euler_xyz_to_R
    from poseestimator_tpu_torch.render.mesh import TriangleMesh
    from poseestimator_tpu_torch.utils.plyio import write_ply

    v, f = kc.lshape_mesh()
    T_m2c = kc.bop_scene_poses()[0].astype(np.float64)
    depth = rs.render_depth_mesh(torch.from_numpy(v).to(dev),
                                 torch.from_numpy(f.astype(np.int64)).to(dev),
                                 torch.from_numpy(T_m2c.astype(np.float32)).to(dev), intr,
                                 near=0.01, far=10.0).cpu().numpy()
    img = np.full((intr.height, intr.width, 3), 30, np.uint8)
    img[depth > 0] = (200, 160, 90)  # RGB
    write_png(os.path.join(off_dir, "a5_image.png"), img)
    rng = np.random.default_rng(5)
    n = int(LIDAR_POINTS * 1.3)
    surf, _ = TriangleMesh(vertices=v, faces=f).sample_points_uniformly(n // 5, rng)
    y0 = float(v[:, 1].min())
    ground = np.stack([rng.uniform(-3, 3, n // 2), np.full(n // 2, y0),
                       rng.uniform(-3, 3, n // 2)], -1)
    clutter = rng.uniform(-3, 3, (n - n // 5 - n // 2, 3))
    model = np.concatenate([surf, ground, clutter])
    cam = model @ T_m2c[:3, :3].T + T_m2c[:3, 3]
    uv = cam[:, :2] / np.maximum(cam[:, 2:3], 1e-6) * [intr.fx, intr.fy] + [intr.cx, intr.cy]
    u, w = np.round(uv[:, 0]).astype(int), np.round(uv[:, 1]).astype(int)
    inside = (cam[:, 2] > 0.01) & (u >= 0) & (u < intr.width) & (w >= 0) & (w < intr.height)
    dz = np.full(len(cam), np.inf)
    dz[inside] = depth[w[inside], u[inside]]
    hidden = inside & (dz > 0) & (cam[:, 2] > dz + 0.005)
    keep = np.flatnonzero(~hidden)
    keep = keep[rng.permutation(len(keep))[:LIDAR_POINTS]]
    if len(keep) != LIDAR_POINTS:
        fail(f"apps a5: only {len(keep)} LiDAR points after the visibility cut")
    rpy, xyz = [0.02, -0.03, 0.01], [0.12, -0.35, 0.05]  # the LiDAR's mount (camera -> LiDAR)
    T = np.eye(4)
    T[:3, :3] = euler_xyz_to_R(rpy).numpy().astype(np.float64)
    T[:3, 3] = xyz
    lidar = cam[keep] @ T[:3, :3].T + T[:3, 3]
    write_ply(os.path.join(off_dir, "a5_lidar.ply"), lidar.astype(np.float32))
    K = intr.K.astype(np.float64)
    fmt = lambda a: "[" + ", ".join(repr(float(x)) for x in np.ravel(a)) + "]"  # noqa: E731
    with open(os.path.join(off_dir, "a5_calib.yaml"), "w") as fh:
        fh.write(f"# camera -> LiDAR extrinsics of the a5 frame\nK: {fmt(K)}\n"
                 f"D: {fmt([1e-3, -5e-4, 0.0, 0.0, 0.0])}\nxyz: {fmt(xyz)}\nrpy: {fmt(rpy)}\n")
    stages, masked, est_out = {}, [], []

    def timed(name, fn):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            stages[name] = stages.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return wrapped

    class TimedEstimator(orig["seiber_est"]):
        def __init__(self, *a, **k):
            timed("estimator build", super().__init__)(*a, **k)

        def find_best_template_teaser(self, *a, **k):
            out = timed("template search", super().find_best_template_teaser)(*a, **k)
            est_out.append(out[0])
            return out

    SilhouetteDetector.silhouette = staticmethod(colour_sil)
    SilhouetteDetector.detect_mask = timed("detect_mask", SilhouetteDetector.detect_mask)
    app.PoseEstimator = TimedEstimator
    app.remove_statistical_outlier = timed("outlier removal", orig["seiber_sor"])
    app.from_points = lambda p, **k: (masked.append(len(p)), orig["seiber_pts"](p, **k))[1]
    overlay = os.path.join(off_dir, "a5_overlay.png")
    zero()
    torch.cuda.synchronize()
    t = time.perf_counter()
    rc = app.main(["--weights", weights, "--ply-path", views, "--cad-path", cad,
                   "--image", os.path.join(off_dir, "a5_image.png"),
                   "--cloud", os.path.join(off_dir, "a5_lidar.ply"),
                   "--calib", os.path.join(off_dir, "a5_calib.yaml"), "--headless",
                   "--save-overlay", overlay, "--device", str(dev)])
    torch.cuda.synchronize()
    main_ms = (time.perf_counter() - t) * 1e3
    SilhouetteDetector.detect_mask = orig["det_mod"].detect_mask
    T_est = torch.from_numpy(np.asarray(est_out[0], np.float32)).to(dev)
    adds, twin = adds_sym_cm(torch, pts, T_est, torch.from_numpy(T_m2c.astype(np.float32))
                             .to(dev), syms)
    a5 = emit("a5 main_seibersdorf", {
        "rc": rc, "lidar_points": LIDAR_POINTS, "masked_cloud": masked[0] if masked else None,
        "adds_cm": adds, "nearer": "twin" if twin else "identity",
        "adds_gate_cm": LIDAR_ADDS_DIAG * diag * 100.0, "main_ms": main_ms, "stage_ms": stages,
        "launches": counts()})
    if rc != 0 or not adds < a5["adds_gate_cm"]:
        fail(f"apps a5: rc {rc}, ADD-S {adds:.3f} cm against the nearer twin >= "
             f"{a5['adds_gate_cm']:.2f} cm")
    return a5


TRAIN_FRAMES = (32, 8)  # (t1) train + val frames at 640x480
TRAIN_EPOCHS = 2  # (t2) epochs, then one more on resume
OVERFIT_STEPS = 250  # (t3), the JAX package's single-image overfit test
OVERFIT_LR = 6e-3


def leaf_rel_err(a, b, where=None) -> float:
    """max |a - b| over a leaf (or the elements ``where`` selects), relative
    to the leaf's largest magnitude in ``b``."""
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    d = (a - b).abs()
    if where is not None:
        d = d[where]
    return float(d.max()) / max(float(b.abs().max()), 1e-6) if d.numel() else 0.0


def train_phase(torch, dev, rs, tmp: str, card: str, size=(640, 480), imgsz: int = 640,
                batch: int = 16, points: int = 60_000) -> dict:
    """Detector training and synthetic data on the card, parts (t1)-(t4)
    (see the module docstring) at ``size`` frames, ``imgsz`` and ``batch``
    (``points`` splat samples per distractor). Each part prints one
    ``{"train": ...}`` line; returns them, and the batched K2 inputs of the
    generator by shape (first call of each) for the shape checks."""
    import contextlib
    import io

    from poseestimator_tpu_torch import kernel_cases as kc
    from poseestimator_tpu_torch.apps import train as train_app
    from poseestimator_tpu_torch.apps import val as val_app
    from poseestimator_tpu_torch.models.yolo.contours import contour_area
    from poseestimator_tpu_torch.models.yolo.decode import decode_boxes
    from poseestimator_tpu_torch.models.yolo.nms import box_iou
    from poseestimator_tpu_torch.pipeline.detector import Detector
    from poseestimator_tpu_torch.render.mesh import make_icosphere
    from poseestimator_tpu_torch.training import trainer as trainer_mod
    from poseestimator_tpu_torch.training.data import (DataLoader, list_samples,
                                                       load_dataset_yaml, parse_label_file)
    from poseestimator_tpu_torch.training.evaluate import evaluate_detector
    from poseestimator_tpu_torch.training.synth import SynthConfig, generate
    from poseestimator_tpu_torch.utils.image import IMREAD_UNCHANGED, read_image
    from poseestimator_tpu_torch.utils.plyio import write_ply

    parts, k2_inputs = {}, {}
    real_rb = rs.raster_batched

    def recording_rb(coef, bbox, H, W):
        key = (coef.shape[0], H, W, coef.shape[1])
        if key not in k2_inputs:
            k2_inputs[key] = (coef.clone(), bbox.clone(), None, None)
        return real_rb(coef, bbox, H, W)

    def emit(name, rec):
        rec = {"part": name, "card": card, **rec}
        parts[name] = rec
        log(json.dumps({"train": rec}))

    # (t1) generate: three CADs written as PLY, the exact-raster instrument
    cads = []
    for name, (v, f) in (("lshape", kc.lshape_mesh()),
                         ("benchbox", (kc.box_vertices(), kc.BOX_FACES)),
                         ("icosphere", make_icosphere(radius=0.1, subdivisions=4))):
        path = os.path.join(tmp, f"{name}.ply")
        write_ply(path, v, faces=f)
        cads.append(f"{name}={path}")
    out = os.path.join(tmp, "synth")
    n_train, n_val = TRAIN_FRAMES
    rs.raster_batched = recording_rb
    try:
        # the L-shape and the box alone first: their 256-face capacity
        generate(SynthConfig(cad=cads[:2], out=os.path.join(tmp, "synth256"), n_train=2,
                             n_val=0, width=size[0], height=size[1], points_per_object=points,
                             depth_instrument="mesh", bop=True, device=str(dev)),
                 log=lambda *a: None)
        rs.raster_batched_stats.launches = 0
        t0 = time.perf_counter()
        summ = generate(SynthConfig(cad=cads, out=out, n_train=n_train, n_val=n_val,
                                    width=size[0], height=size[1], points_per_object=points,
                                    depth_instrument="mesh", bop=True, device=str(dev)),
                        log=lambda *a: None)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        k2b = rs.raster_batched_stats.launches
    finally:
        rs.raster_batched = real_rb
    frames = summ["frames"]["train"] + summ["frames"]["val"]
    if k2b != n_train + n_val:
        fail(f"(t1): {k2b} batched K2 launches for {n_train + n_val} frames")
    with open(summ["scene_gt"]) as fh:
        scene_gt = json.load(fh)
    n_labels, min_ratio = 0, np.inf
    for split in ("train", "val"):
        for img, lbl in list_samples(load_dataset_yaml(summ["dataset_yaml"]), split):
            stem = os.path.splitext(os.path.basename(img))[0]
            with open(lbl) as fh:
                lines = [ln for ln in fh.read().splitlines() if ln.strip()]
            entries = parse_label_file(lbl)
            if len(entries) != len(lines) or any(len(p) < 3 for _, p in entries):
                fail(f"(t1): {lbl} does not parse as YOLO-seg polygons")
            if len(entries) != len(scene_gt[str(int(stem))]):
                fail(f"(t1): frame {stem} has {len(entries)} labels and "
                     f"{len(scene_gt[str(int(stem))])} scene_gt entries")
            for j, (_, poly) in enumerate(entries):
                m = read_image(os.path.join(out, "mask_visib", f"{stem}_{j:06d}.png"),
                               IMREAD_UNCHANGED)
                area = contour_area(poly * np.array(size, np.float64))
                min_ratio = min(min_ratio, area / max(int((m > 0).sum()), 1))
            n_labels += len(entries)
    if min_ratio < 0.5:
        fail(f"(t1): a polygon covers {min_ratio:.3f} of its visible mask (< 0.5)")
    per = {k: v / (n_train + n_val) for k, v in summ["timing_ms"].items()}
    emit("t1 generate", {
        "frames_written": frames, "frames_drawn": n_train + n_val,
        "instances_labelled": n_labels, "instances_skipped": summ["skipped_instances"],
        "ms_per_frame": gen_s * 1e3 / (n_train + n_val),
        "ms_per_frame_render": per["render"], "ms_per_frame_background": per["background"],
        "ms_per_frame_jpeg": per["jpeg"], "ms_per_frame_png": per["png"],
        "k2_batched_launches": k2b, "min_polygon_to_mask_area": float(min_ratio),
        "k2_shapes": sorted(f"B={b} x {h}x{w}, {f} faces" for b, h, w, f in k2_inputs)})

    # (t2) the training app at the operating point, then resume, then val
    yml = summ["dataset_yaml"]
    project = os.path.join(tmp, "runs")
    step_ms, data_ms = [], []
    real_epoch = trainer_mod.Trainer.train_epoch

    def timed_epoch(self, state):
        metrics, it = [], iter(self.loader)
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                break
            data_ms.append((time.perf_counter() - t0) * 1e3)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            state, p = self._train_step(state, *self._tensors(batch))
            e.record()
            e.synchronize()
            step_ms.append(s.elapsed_time(e))
            metrics.append(p)
        return state, trainer_mod._mean_parts(metrics)

    argv = ["--data", yml, "--epochs", str(TRAIN_EPOCHS), "--imgsz", str(imgsz),
            "--batch", str(batch),
            "--optimizer", "Adam", "--lr0", "0.001", "--close-mosaic", "0",
            "--project", project, "--name", "t2", "--device", str(dev)]
    trainer_mod.Trainer.train_epoch = timed_epoch
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as o1:
            rc1 = train_app.main(argv)
        fit_s = time.perf_counter() - t0
        n_steps = len(step_ms)
        with contextlib.redirect_stdout(io.StringIO()) as o2:
            rc2 = train_app.main([*argv[:3], str(TRAIN_EPOCHS + 1), *argv[4:], "--resume"])
    finally:
        trainer_mod.Trainer.train_epoch = real_epoch
    peak = torch.cuda.max_memory_allocated()
    run = os.path.join(project, "t2")
    with open(os.path.join(run, "results.json")) as fh:
        hist = json.load(fh)
    missing = [f for f in ("last.pt", "best.pt", "results.json")
               if not os.path.exists(os.path.join(run, f))]
    if rc1 != 0 or rc2 != 0 or missing:
        fail(f"(t2): train rc {rc1}, {rc2}; missing {missing}")
    if hist[0]["epoch"] != TRAIN_EPOCHS or "resumed from epoch" not in o2.getvalue():
        fail(f"(t2): resume started at epoch {hist[0]['epoch']}, not {TRAIN_EPOCHS}")
    losses = [line for line in o1.getvalue().splitlines() + o2.getvalue().splitlines()
              if line.startswith("epoch") and "train" in line]
    totals = [float(w) for line in losses for k, w in zip(line.split(), line.split()[1:])
              if k in ("train", "val")]
    if len(losses) != TRAIN_EPOCHS + 1 or not np.all(np.isfinite(totals)):
        fail(f"(t2): epoch losses {losses}")
    Detector(os.path.join(run, "best.pt"), nc=3, device=dev)  # the port's Detector loads it
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as o3:
        rc3 = val_app.main(["--weights", os.path.join(run, "best.pt"), "--data", yml,
                            "--device", str(dev)])
    val_s = time.perf_counter() - t0
    m = json.loads(o3.getvalue())
    if rc3 != 0:
        fail(f"(t2): val rc {rc3}")
    emit("t2 train", {
        "steps": len(step_ms), "step_ms_median": float(np.median(step_ms)),
        "step_ms": step_ms, "data_ms_per_batch_median": float(np.median(data_ms)),
        "data_ms_per_batch": data_ms,
        "images_per_s_step": batch * 1e3 / float(np.median(step_ms)),
        "images_per_s_fit": batch * n_steps / fit_s, "fit_s": fit_s,
        "max_memory_allocated_gib": peak / 2 ** 30,
        "losses_per_epoch": [{k: r[k] for k in ("epoch", "train/total", "val/total")}
                             for r in hist],
        "first_fit_epochs_log": losses, "map50": m["map50"], "map50_95": m["map50_95"],
        "val_s": val_s})

    # (t3) overfit one batch at imgsz, augment off, Adam 6e-3 constant. The
    # recipe runs at Adam's edge of stability (the loss spikes and recovers
    # every ~100 steps), so where the last step lands decides the gate: with
    # cuDNN's nondeterministic algorithms it failed 2 of 8 runs on the card,
    # its deterministic algorithms gave one trajectory 8 of 8 times
    # (scripts/overfit_stability.py)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    tr = trainer_mod.Trainer(trainer_mod.TrainConfig(
        data=yml, imgsz=imgsz, batch=batch, augment=False, ema=False, device=str(dev),
        project=project, name="t3"))
    state = tr.init_state()
    tr.tx = trainer_mod.Optimizer("adam", lambda count: OVERFIT_LR)
    state.opt_state = tr.tx.init(list(state.params.values()))
    samples = tr.train_samples[:batch]
    ten = tr._tensors(next(iter(DataLoader(samples, batch, imgsz, 32, shuffle=False))))
    t0 = time.perf_counter()
    first = last = None
    for i in range(OVERFIT_STEPS):
        state, p = tr._train_step(state, *ten)
        if i == 0:
            first = float(p["total"])
    last = float(p["total"])
    torch.cuda.synchronize()
    over_s = time.perf_counter() - t0
    torch.backends.cudnn.deterministic = deterministic
    tr.model.eval()
    with torch.no_grad():
        raw = tr.model(ten[0][:1])
    bx, cl, _ = decode_boxes(raw)
    score = cl[0].amax(-1)
    top = int(score.argmax())
    gt = ten[1][0][ten[4][0]]
    iou = float(box_iou(bx[0, top][None], gt).max())
    det = Detector(tr.export_variables(state), nc=tr.nc, imgsz=imgsz, device=dev)
    m3 = evaluate_detector(det, samples, imgsz=imgsz)
    emit("t3 overfit", {
        "steps": OVERFIT_STEPS, "loss_first": first, "loss_last": last,
        "ms_per_step": over_s * 1e3 / OVERFIT_STEPS, "top_score": float(score[top]),
        "iou": iou, "images": len(samples), "map50": m3["map50"],
        "map50_95": m3["map50_95"]})
    if not (float(score[top]) > 0.3 and iou > 0.5):
        fail(f"(t3): top score {float(score[top]):.3f} (> 0.3), IoU {iou:.3f} (> 0.5)")

    # (t4) two steps from identical weights on one batch of 4, card and CPU,
    # each judged against a float64 CPU reference of the first step. TAL is
    # discrete (a top-k of metric^6 over near-ties): all three take the
    # card's assignment (how many anchors the CPU's own would move is
    # reported). Train-mode BatchNorm over flat image regions (the letterbox
    # bars, smooth backgrounds) divides by tiny batch variances, which
    # amplifies float32 rounding on any device: the gate is that the card's
    # error against float64 is no worse than 4x the float32 CPU's
    from poseestimator_tpu_torch.models.yolo.model import YOLO11Seg
    from poseestimator_tpu_torch.training import loss as loss_mod

    cfg = dict(data=yml, imgsz=imgsz, batch=4, augment=False, warmup_epochs=0.0,
               project=project, name="t4")
    trs = {role: trainer_mod.Trainer(trainer_mod.TrainConfig(**cfg, device=d))
           for role, d in (("card", str(dev)), ("cpu", "cpu"))}
    sd = {k: v.detach().cpu().clone() for k, v in trs["card"].init_state().params.items()}
    sd.update({k: v.cpu().clone() for k, v in trs["card"].model.named_buffers()})
    states = {role: t.init_state(sd) for role, t in trs.items()}
    b4 = next(iter(DataLoader(trs["cpu"].train_samples, 4, imgsz, 32, shuffle=False)))
    real_assign = loss_mod.assign
    pinned = {}

    def card_assign(*a, **k):
        out = real_assign(*a, **k)
        pinned["card"] = [t.cpu() for t in out]
        return out

    def cpu_assign(*a, **k):
        own = real_assign(*a, **k)
        pinned["fg_differs"] = int((own[0] != pinned["card"][0]).sum())
        return pinned["card"]

    def f64_assign(*a, **k):
        return [t.double() if t.is_floating_point() else t for t in pinned["card"]]

    got = {}
    try:
        for step in range(2):
            for role, t in trs.items():
                loss_mod.assign = card_assign if role == "card" else cpu_assign
                states[role], p = t._train_step(states[role], *t._tensors(b4))
                if step == 0:
                    st = states[role]
                    got[role] = {
                        "loss": {k: p[k].cpu().double() for k in ("box", "cls", "dfl", "seg")},
                        "grad": {k: g.cpu().double() / (1.0 - t.tx.B1)
                                 for k, g in zip(st.params, st.opt_state["mu"])},
                        "stats": {k: b.cpu().double() for k, b in st.batch_stats.items()
                                  if b.is_floating_point()}}
        ref = YOLO11Seg(nc=trs["cpu"].nc).double()
        ref.load_state_dict(sd)
        ref.train()
        ten = [x.double() if x.is_floating_point() else x for x in trs["cpu"]._tensors(b4)]
        loss_mod.assign = f64_assign
        total, p64 = loss_mod.segmentation_loss(ref(ten[0]), *ten[1:])
        names = [k for k, _ in ref.named_parameters()]
        g64 = torch.autograd.grad(total, list(ref.parameters()))
    finally:
        loss_mod.assign = real_assign
    want = {"loss": {k: p64[k].detach() for k in ("box", "cls", "dfl", "seg")},
            "grad": dict(zip(names, g64)),
            "stats": {k: b for k, b in ref.named_buffers() if b.is_floating_point()}}
    err = {role: {c: max(leaf_rel_err(got[role][c][k], want[c][k]) for k in want[c])
                  for c in want} for role in got}
    # step 2 moved the weights (lr 1e-3): card against CPU where the gradient
    # is determined (both know it to 0.1%: Adam's step is ~lr sign(g))
    sa, sb = states["card"], states["cpu"]
    worst, known, total_n = {"params": 0.0, "ema": 0.0}, 0, 0
    for k in sb.params:
        ga, gb = got["card"]["grad"][k], got["cpu"]["grad"][k]
        sure = (gb.abs() > 1e-5) & ((ga - gb).abs() <= 1e-3 * gb.abs())
        known, total_n = known + int(sure.sum()), total_n + sure.numel()
        worst["params"] = max(worst["params"], leaf_rel_err(sa.params[k], sb.params[k], sure))
        worst["ema"] = max(worst["ema"], leaf_rel_err(sa.ema_params[k], sb.ema_params[k], sure))
    emit("t4 card vs cpu", {
        "err_vs_float64": err, "card_over_cpu": {c: err["card"][c] / max(err["cpu"][c], 1e-300)
                                                  for c in want},
        "step2_card_vs_cpu_determined": worst, "determined_share": known / total_n,
        "lr_steps": [0.0, trs["cpu"].last_lr],
        "tal_fg_anchors_cpu_would_move": pinned["fg_differs"]})
    bad = [c for c in want if err["card"][c] > 4.0 * err["cpu"][c] + 1e-9]
    if bad or worst["params"] > 1e-5 or worst["ema"] > 1e-5:
        fail(f"(t4): the card's float32 error against float64 exceeds 4x the CPU's in {bad}, "
             f"or step 2 differs on determined elements: {err} {worst}")
    return {"parts": parts, "raster_inputs": k2_inputs, "dataset_yaml": yml}


def check_b_independence(torch, trk, args, kw, draws, res) -> dict:
    """Each track of a recorded batched step run again alone through the
    batched step (B = 1) and through the unbatched ``track_step`` on its
    own draws: pose, fitness, rmse, covariance and ICP iterations must be
    bit for bit the batch's."""
    mesh_v, mesh_f, masks, depth, Ts, intr, dists = args
    per_track = mesh_v.dim() == 3
    B = Ts.shape[0]
    for i in range(B):
        mv, mf = (mesh_v[i], mesh_f[i]) if per_track else (mesh_v, mesh_f)
        one = trk.track_step_batched(mesh_v[i:i + 1] if per_track else mesh_v,
                                     mesh_f[i:i + 1] if per_track else mesh_f, masks[i:i + 1],
                                     depth, Ts[i:i + 1], intr, dists[i:i + 1], **kw,
                                     draws=[draws[i]])
        alone = trk.track_step(mv, mf, masks[i], depth, Ts[i], intr, float(dists[i]),
                               win_hw=kw["win_hw"], icp_pose_tol=kw["icp_pose_tol"],
                               target_pts=kw["target_pts"], draws=draws[i])
        for who, r, k in (("B=1", one, 0), ("unbatched", alone, None)):
            got = [r.T, r.fitness, r.rmse, r.cov] if k is None else \
                [r.T[k], r.fitness[k], r.rmse[k], r.cov[k]]
            same = all(torch.equal(a, b) for a, b in zip(
                got, (res.T[i], res.fitness[i], res.rmse[i], res.cov[i])))
            n = r.n_iters if k is None else r.n_iters[k]
            if not same or n != res.n_iters[i]:
                fail(f"track {i} of a batch of {B} differs from itself run {who}")
    return {"B": B, "tracks_bit_equal": B, "n_iters": list(res.n_iters)}


def batch_sizes_part(torch, dev, fnn, rs, trk, mt, cam, est, profile_path=None) -> dict:
    """(m4) The batched step alone on m3's last frame (640x480) at B = 1, 3
    and 8 (B = 8 repeats the scene's three tracks): the median wall time
    of a synchronised call over 5 after a warm-up, per frame and per
    object, the batched K1 and K2 launches of one call, and the B
    independence of tracks at B = 3 and 8."""
    from poseestimator_tpu_torch.pipeline.window import merge_windows

    tracks = sorted(mt.tracks, key=lambda t: t.track_id)
    masks = torch.from_numpy(cam.object_masks).to(dev)
    # each track's own instance: the one its pose projects nearest to
    gts = cam.current_gt
    inst = [int(np.argmin([np.linalg.norm(g[:3, 3] - t.T_m2c[:3, 3]) for g in gts]))
            for t in tracks]
    win = merge_windows([t.win for t in tracks])
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {"window": win}
    for B in (1, 3, 8):
        sel = [i % len(tracks) for i in range(B)]
        Ts = torch.from_numpy(np.stack([tracks[i].T_m2c for i in sel]).astype(np.float32)).to(dev)
        m = masks[[inst[i] for i in sel]]
        dists = torch.full((B,), 0.01, device=dev)
        draws = [trk.step_draws(est.intr, trk.window_dims(est.intr.scaled(2), win), 0, gen, dev)
                 for _ in range(B)]
        kw = dict(win_hw=win, target_pts=0, icp_pose_tol=1e-4)

        def call():
            return trk.track_step_batched(est._mesh_v, est._mesh_f, m, cam.depth, Ts, est.intr,
                                          dists, **kw, draws=draws)

        call()
        times = []
        for _ in range(5):
            fnn.fused_nn_batched_stats.launches = 0
            rs.raster_batched_stats.launches = 0
            t = time.perf_counter()
            res = call()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            k1, k2 = fnn.fused_nn_batched_stats.launches, rs.raster_batched_stats.launches
        if k2 != 1 or k1 != max(res.n_iters) + 1:
            fail(f"multi m4 B={B}: {k1} K1 / {k2} K2 launches for n_iters {res.n_iters}")
        row = {"ms_median": float(np.median(times)), "ms": times,
               "ms_per_object": float(np.median(times)) / B, "k1_launches": k1,
               "k2_launches": k2, "n_iters": list(res.n_iters)}
        if B == 3 and profile_path:
            row["profile"] = profile_calls(torch, call, 3, profile_path, "step")
        if B > 1:
            row["b_independence"] = check_b_independence(
                torch, trk, (est._mesh_v, est._mesh_f, m, cam.depth, Ts, est.intr, dists), kw,
                draws, res)
        out[f"B={B}"] = row
    log(json.dumps({"multi": {"part": "m4: the batched step alone, 640x480", **out}}))
    return out


def check_batched_shapes(torch, fnn, rs, nn_inputs: dict, raster_inputs: dict) -> dict:
    """The batched K1 and K2 against their batched plain versions on the
    inputs the multi-object phase gave them (the first call of each shape),
    with device times and bounds."""
    out = {"K1": {}, "K2": {}}
    for (B, n, m), (q, qv, d, dv) in sorted(nn_inputs.items()):
        got = fnn.fused_nn_batched(q, qv, d, dv)
        torch.cuda.synchronize()
        want = fnn.fused_nn_batched_plain(q, qv, d, dv)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"batched K1 at {B} x {n}x{m}: differs from the batched plain version")
        ops, nbytes = 9.0 * B * n * m, 13.0 * B * (2 * n + m)
        b = bound_ms(ops, nbytes)
        out["K1"][f"B={B} x {n}x{m}"] = {
            "device_ms": device_ms(torch, lambda: fnn.fused_nn_batched(q, qv, d, dv)),
            "call_ms": call_ms(torch, lambda: fnn.fused_nn_batched(q, qv, d, dv)),
            "plain_ms": call_ms(torch, lambda: fnn.fused_nn_batched_plain(q, qv, d, dv), reps=5),
            "library_ms": device_ms(torch, lambda: torch.cdist(q, d).min(2)),
            "bound_ms": b[0], "bound_by": b[1], "issue_ms": nn_issue_ms(B * n, m)}
    for (B, H, W, F), (coef, bbox, _, _) in sorted(raster_inputs.items()):
        izk = rs.raster_batched(coef, bbox, H, W)
        torch.cuda.synchronize()
        if not torch.equal(izk, rs.raster_batched_plain(coef, H, W, chunk=64)):
            fail(f"batched K2 at {B} x {H}x{W}: differs from the batched plain version")
        b = bound_ms(sum(20.0 * raster_pairs(bbox[i], H, W) for i in range(B)),
                     B * (64.0 * F + 4.0 * H * W))
        out["K2"][f"B={B} x {H}x{W}, {F} faces"] = {
            "device_ms": device_ms(torch, lambda: rs.raster_batched(coef, bbox, H, W)),
            "call_ms": call_ms(torch, lambda: rs.raster_batched(coef, bbox, H, W)),
            "plain_ms": call_ms(torch, lambda: rs.raster_batched_plain(coef, H, W, chunk=64),
                                reps=5),
            "bound_ms": b[0], "bound_by": b[1]}
    for k in ("K1", "K2"):
        for shape, t in out[k].items():
            log(f"batched {k} at {shape}: identical to the batched plain version; device "
                f"{t['device_ms']:.5f} ms, call {t['call_ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.3g} ms ({t['bound_by']})"
                + (f", library {t['library_ms']:.5f} ms" if "library_ms" in t else ""))
    return out


def adds_cm(torch, pts, T_est, T_true) -> float:
    """ADD-S: mean distance from each estimated model point to the nearest
    true one (exact, no matmul distance form)."""
    a = pts @ T_est[:3, :3].T + T_est[:3, 3]
    b = pts @ T_true[:3, :3].T + T_true[:3, 3]
    d = torch.cdist(a, b, compute_mode="donot_use_mm_for_euclid_dist").min(1).values
    return float(d.mean()) * 100.0


def adds_sym_cm(torch, pts, T_est, T_true, symmetries) -> tuple[float, int]:
    """ADD-S against the nearest symmetric twin of the true pose,
    ``min over S of ADD-S(T_est, T_true @ S)`` (the BOP treatment of
    discrete symmetries), and the index of that S. On a finite point sample
    plain ADD-S does not vanish on a twin: each estimated point meets only
    other samples of the same surface."""
    errs = [adds_cm(torch, pts, T_est, T_true @ S) for S in symmetries]
    k = int(np.argmin(errs))
    return errs[k], k


def profile_calls(torch, fn, n: int, path: str, unit: str) -> dict:
    """Trace ``n`` calls of ``fn`` with torch.profiler: device busy share and
    device time by kernel, per ``unit`` (one call); the kernel table goes to
    ``path``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    ka = prof.key_averages()
    # device-side events only (kernels, copies): an aten op's own "self
    # device time" repeats the time of the kernels it launched
    kern = [e for e in ka if str(getattr(e, "device_type", "")).endswith("CUDA")]
    dev_ms = lambda e: e.self_device_time_total / 1e3  # noqa: E731
    busy_ms = sum(dev_ms(e) for e in kern)
    top = sorted(kern, key=dev_ms, reverse=True)[:12]
    with open(path, "w") as f:
        f.write(ka.table(sort_by="self_device_time_total", row_limit=60))
    out = {f"wall_ms_per_{unit}": wall_ms / n, f"device_busy_ms_per_{unit}": busy_ms / n,
           "device_busy_share": busy_ms / wall_ms,
           f"top_device_ms_per_{unit}": {e.key[:60]: dev_ms(e) / n for e in top},
           f"kernels_per_{unit}": sum(e.count for e in kern) / n}
    log(f"profile ({n} x {unit}): {wall_ms / n:.2f} ms/{unit} wall, device busy "
        f"{busy_ms / n:.2f} ms/{unit} ({100 * busy_ms / wall_ms:.1f}%), "
        f"{out[f'kernels_per_{unit}']:.0f} kernels/{unit}")
    return out


def par_launches(par: dict, key: str) -> dict:
    """The parallel phase's launches of one kernel by part and world, one
    count per rank (batched: per rank and frame of (p3))."""
    if key.endswith("batched"):
        return {name: [r[key] for r in rec["batched_launches_per_rank_per_frame"]]
                for name, rec in par["parts"].items() if name.startswith("p3")}
    return {f"{p} world {w}": [r[p][key] for r in ranks]
            for w, ranks in par["launches"].items() for p in ranks[0]}


def apps_launches(parts: dict, k: str) -> dict:
    """A kernel's launches in each apps part (``k``: "k1" or "k2"; the
    batched entry beside it)."""
    out = {p: {k: parts[p]["launches"][k], f"{k}_batched": parts[p]["launches"][f"{k}_batched"]}
           for p in ("a1", "a4", "a5", "a6")}
    out["a2"] = {f"{k}_per_tracked_frame": parts["a2"][f"{k}_per_tracked_frame"],
                 f"{k}_per_init": parts["a2"][f"{k}_per_init"]}
    return out


def tools_launches(parts: dict, k: str) -> dict:
    """A kernel's launches in the tools phase by prefix (``k``: "k1", "k2",
    "k1_batched", "k2_batched"): profile_stages' over its timed frames (the
    single kernels), profile_search's a search."""
    out = {}
    for p, rec in parts.items():
        if p.startswith("profile_stages") and f"prefix_{k}_launches" in rec:
            out[p] = rec[f"prefix_{k}_launches"]
        elif p.startswith("profile_search"):
            out[p] = {label: v[k] for label, v in rec["prefix_launches"].items()}
    return out


PAR_POINTS = 16384  # (p1) points a cloud
PAR_SYNTH_TEMPLATES = 16  # (p2) templates of the synthetic search, as the dry run builds
PAR_SEARCH_REPS = 3  # (p2) timed warm searches a world
PAR_TRACKS = 4  # (p3) tracks
PAR_STEPS = 3  # (p3) sharded steps on the one frame, as the dry run takes
PAR_DET_BATCH = 8  # (p4) images
PAR_TRAIN_BATCH = 16  # (p5) the global batch
PAR_IMGSZ = 640  # (p4), (p5) letterbox
PAR_TRAIN_STEPS = 2  # (p5) update 0 has lr 0: the second moves the weights
PAR_WORLDS = ((1, "nccl", "cuda"), (2, "gloo", "cuda:0"))


def parallel_rank(io: str, world: int) -> None:
    """One rank of the parallel phase (module level: the launcher imports it
    again in each child process). Runs (p1)-(p5) on the mesh of ``world``
    ranks, with the launch counts set to 0 just before each part and read
    just after; the world of one also runs the single-device references.
    Saves what it got, and rank 0 the kernels' inputs by shape, into
    ``io``; the parent process compares and gates."""
    import torch

    from poseestimator_tpu_torch.geom3d import fused_nn as fnn
    from poseestimator_tpu_torch.geom3d import knn as knn_mod
    from poseestimator_tpu_torch.geom3d.camera import Intrinsics, backproject_depth
    from poseestimator_tpu_torch.geom3d.cloud import PointCloud, from_points
    from poseestimator_tpu_torch.geom3d.metrics import add_metric, chamfer_distance
    from poseestimator_tpu_torch.geom3d.sampling import random_sample
    from poseestimator_tpu_torch.models.yolo.model import YOLO11Seg, init_random_
    from poseestimator_tpu_torch.parallel import (ShardedDetector, make_mesh,
                                                  make_synthetic_search_inputs, sharded_chamfer,
                                                  sharded_multi_track, sharded_template_search)
    from poseestimator_tpu_torch.pipeline.detector import Detector
    from poseestimator_tpu_torch.pipeline.pose_estimator import PoseEstimator, search_templates
    from poseestimator_tpu_torch.pipeline.tracking import track_step_batched
    from poseestimator_tpu_torch.render import raster as rs
    from poseestimator_tpu_torch.training import trainer as trainer_mod

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    with open(os.path.join(io, "spec.json")) as fh:
        spec = json.load(fh)
    mesh, tmesh = make_mesh("dp"), make_mesh("tp")
    dev, single = mesh.device, world == 1
    res = {"rank": mesh.rank, "size": mesh.size, "device": str(dev), "backend": mesh.backend}
    counters = {"k1": fnn.fused_nn_stats, "k1_batched": fnn.fused_nn_batched_stats,
                "k2": rs.raster_stats, "k2_batched": rs.raster_batched_stats}
    inputs = {"nn": {}, "nn_batched": {}, "raster": {}, "raster_batched": {}}
    knn_mod.fused_nn = _first_call_recorder(torch, inputs["nn"], knn_mod.fused_nn,
                                            lambda q, qv, d, dv: (q.shape[0], d.shape[0]))
    knn_mod.fused_nn_batched = _first_call_recorder(
        torch, inputs["nn_batched"], knn_mod.fused_nn_batched,
        lambda q, qv, d, dv: (q.shape[0], q.shape[1], d.shape[1]))
    rs.raster = _first_call_recorder(torch, inputs["raster"], rs.raster,
                                     lambda c, b, H, W: (H, W, c.shape[0]))
    rs.raster_batched = _first_call_recorder(torch, inputs["raster_batched"], rs.raster_batched,
                                             lambda c, b, H, W: (c.shape[0], H, W, c.shape[1]))

    def run(fn):
        """``fn()`` with the launch counts set to 0 before and read after:
        ``(out, ms, counts)``."""
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3, {k: c.launches for k, c in counters.items()}

    cpu = lambda x: x.detach().cpu() if torch.is_tensor(x) else x  # noqa: E731

    # (p1) the query-sharded Chamfer
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(PAR_POINTS, 3, device=dev, generator=g)
    b = a + 0.01 * torch.randn(PAR_POINTS, 3, device=dev, generator=g)
    ones = torch.ones(PAR_POINTS, dtype=torch.bool, device=dev)
    sharded_chamfer(mesh, a, ones, b, ones)  # warm-up
    ch, ms, n = run(lambda: float(sharded_chamfer(mesh, a, ones, b, ones)))
    res["p1"] = {"chamfer": ch, "ms": ms, **n}
    if single:
        res["p1"]["single"] = float(chamfer_distance(PointCloud(a, ones), PointCloud(b, ones)))

    # (p2) the sharded product search: PoseEstimator(mesh_devices=) on the
    # 26 views, then the synthetic fixture as the dry run searches it
    intr = Intrinsics.from_fov(60.0, 640, 480)
    T_true = torch.tensor(spec["scene_pose"], device=dev)
    est, build_ms, _ = run(lambda: PoseEstimator(spec["cad"], spec["views"], intr,
                                                 view_set="full", mesh_devices=tmesh))
    depth = rs.render_depth_mesh(est._mesh_v, est._mesh_f, T_true, intr, near=0.01, far=5.0)
    cloud = random_sample(backproject_depth(depth, intr, depth_min=0.01, depth_max=5.0), 16384,
                          torch.Generator(device=dev).manual_seed(1))
    mask = depth > 0

    def estimator_record(e):
        (H, _, cand), ms, n = run(lambda: e.find_best_template_candidates(cloud, mask=mask))
        return {"H": H, "scores": [c[0] for c in cand], "order": [c[2] for c in cand],
                "Ts": np.stack([c[1] for c in cand]), "ms": ms, **n}

    rec = estimator_record(est)
    rec["templates"] = int(est._tpl_points.shape[0])
    rec["build_ms"] = build_ms
    rec["warm_ms"] = [run(lambda: est.find_best_template_candidates(cloud, mask=mask))[1]
                      for _ in range(PAR_SEARCH_REPS)]
    res["p2 estimator"] = rec
    if single:
        est_s = PoseEstimator(spec["cad"], spec["views"], intr, view_set="full",
                              search_final_topk=0, device=dev)
        srec = estimator_record(est_s)
        srec["warm_ms"] = [run(lambda: est_s.find_best_template_candidates(cloud, mask=mask))[1]
                           for _ in range(PAR_SEARCH_REPS)]
        rec["single"] = srec
    fx = make_synthetic_search_inputs(n_tpl=PAR_SYNTH_TEMPLATES, C=128, n_cad=1200, device=dev)
    good, T_gt = fx.pop("good_idx"), torch.from_numpy(fx.pop("T_gt")).to(dev)
    model = from_points(fx["cad_points"], device=dev)

    def synthetic():
        return sharded_template_search(tmesh, generator=torch.Generator(device=dev).manual_seed(0),
                                       **fx)

    synthetic()  # warm-up
    (_, Hr, sc), ms, n = run(synthetic)
    w = int(torch.argmin(sc))
    res["p2 synthetic"] = {"Hr": cpu(Hr), "scores": cpu(sc), "good": good, "ms": ms, **n,
                           "add": float(add_metric(Hr[w], T_gt, model))}
    if single:
        r = search_templates(fx["dst_points"], fx["dst_valid"], fx["tpl_points"],
                             fx["tpl_valid"], fx["tpl_fpfh"], fx["cad_points"], fx["cad_valid"],
                             fx["intr"], fx["mask_sil"], True, 0.05,
                             torch.Generator(device=dev).manual_seed(0), n_final=None,
                             render_kind="points")
        res["p2 synthetic"]["single"] = {"Hr": cpu(r[4]), "scores": cpu(r[3])}

    # (p3) the object-sharded frame step: B tracks of the scene's L-shape,
    # each from its own perturbation of the truth, three steps on one frame
    c, s = np.cos(0.03), np.sin(0.03)
    perts = []
    for i in range(PAR_TRACKS):
        D = np.eye(4, dtype=np.float32)
        D[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        D[:3, 3] = [0.004 * ((i % 3) - 1), 0.003, 0.002]
        perts.append(D @ np.asarray(spec["scene_pose"], np.float32))
    Ts0 = torch.from_numpy(np.stack(perts)).to(dev)
    masks = mask[None].expand(PAR_TRACKS, -1, -1).contiguous()
    dists = torch.full((PAR_TRACKS,), 0.05, device=dev)

    def steps(step_fn):
        gen, T, out = torch.Generator(device=dev).manual_seed(3), Ts0, []
        for _ in range(PAR_STEPS):
            r, ms, n = run(lambda: step_fn(T, gen))
            T = r[0]
            out.append({"ms": ms, **n})
        return [cpu(x) for x in r], out

    args = (est._mesh_v, est._mesh_f, masks, depth)
    steps(lambda T, gen: sharded_multi_track(mesh, *args, T, intr, 0, dists, generator=gen))
    r, per_step = steps(lambda T, gen: sharded_multi_track(mesh, *args, T, intr, 0, dists,
                                                           generator=gen))
    res["p3"] = {"T": r[0], "fitness": r[1], "rmse": r[2], "cov": r[3], "Ts0": cpu(Ts0),
                 "steps": per_step}
    if single:
        r, _ = steps(lambda T, gen: (lambda o: (o.T, o.fitness, o.rmse, o.cov))(
            track_step_batched(*args, T, intr, dists, target_pts=0, icp_pose_tol=5e-5,
                               generator=gen)))
        res["p3"]["single"] = {"T": r[0], "fitness": r[1], "rmse": r[2], "cov": r[3]}

    # (p4) batch-sharded detection serving, seeded YOLO11n-seg weights
    yolo = init_random_(YOLO11Seg(nc=5, scale="n"), torch.Generator().manual_seed(0))
    det = Detector(yolo.state_dict(), nc=5, imgsz=PAR_IMGSZ, device=dev)
    imgs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (PAR_DET_BATCH, 480, 640, 3), dtype=np.uint8)).to(dev)
    sd = ShardedDetector.from_detector(det, mesh)
    sd(imgs)  # warm-up
    (d, bx), ms, _ = run(lambda: sd(imgs))
    res["p4"] = {"valid": cpu(d.valid), "scores": cpu(d.scores), "classes": cpu(d.classes),
                 "boxes": cpu(bx), "ms": ms}
    if single:
        det.predict_batch(imgs)
        (d, bx), ms, _ = run(lambda: det.predict_batch(imgs))
        res["p4"]["single"] = {"valid": cpu(d.valid), "scores": cpu(d.scores),
                               "classes": cpu(d.classes), "boxes": cpu(bx), "ms": ms}

    # (p5) data-parallel train steps at the operating point: rank 0 loads
    # the global batch and scatters it
    cfg = trainer_mod.TrainConfig(
        data=spec["dataset"], epochs=1, imgsz=PAR_IMGSZ, batch=PAR_TRAIN_BATCH, augment=False,
        workers=0, warmup_epochs=0.0, project=os.path.join(io, f"runs{world}"), name="p5",
        device=str(dev))
    tr = trainer_mod.Trainer(cfg, mesh=mesh)
    state = tr.init_state()

    def global_batches():  # epoch after epoch: the dataset may hold one batch
        while True:
            yield from tr._batches(tr.loader)

    batches, rows = global_batches(), []
    for _ in range(PAR_TRAIN_STEPS):
        ten, load_ms, _ = run(lambda: tr._tensors(next(batches)))
        (state, parts), ms, _ = run(lambda: tr._train_step(state, *ten))
        rows.append({"parts": {k: float(v) for k, v in parts.items()}, "ms": ms,
                     "load_scatter_ms": load_ms, "lr": tr.last_lr})
    res["p5"] = {"steps": rows, "params": {k: cpu(v) for k, v in state.params.items()},
                 "mu": [cpu(m) for m in state.opt_state["mu"]],
                 "stats": {k: cpu(v) for k, v in state.batch_stats.items()},
                 "local_batch": int(ten[0].shape[0])}

    torch.save(res, os.path.join(io, f"world{world}_rank{mesh.rank}.pt"))
    if mesh.rank == 0:
        torch.save(inputs, os.path.join(io, f"inputs{world}.pt"))


def _max_abs(a, b) -> float:
    d = (a.double() - b.double()).abs()
    return float(d.max()) if d.numel() else 0.0


def parallel_phase(torch, dev, kc, off_dir: str, dataset_yaml: str, tmp: str, card: str) -> dict:
    """The multi-device paths (the port's counterpart of the JAX package's
    ``dryrun_multichip``), parts (p1)-(p5), each at world 1 over NCCL and at
    world 2 as two processes sharing this card over gloo, on the offline
    phase's L-shape CAD and scene pose, the apps phase's 26-view database
    and the training phase's dataset. One ``{"parallel": ...}`` line per
    part and world size; every time is that of processes sharing one card,
    not a speed-up. Returns the parts, the gloo probe and the kernels'
    inputs by shape (first call of each, rank 0 of each world)."""
    from poseestimator_tpu_torch.parallel import launch
    from poseestimator_tpu_torch.render.mesh import TriangleMesh

    io = os.path.join(tmp, "parallel")
    os.makedirs(io, exist_ok=True)
    T_true = kc.bop_scene_poses()[0]
    with open(os.path.join(io, "spec.json"), "w") as fh:
        json.dump({"cad": os.path.join(off_dir, "obj_000001.ply"),
                   "views": os.path.join(off_dir, "views_full"), "dataset": dataset_yaml,
                   "scene_pose": T_true.tolist()}, fh)
    runs, wall_s = {}, {}
    for world, backend, device in PAR_WORLDS:
        t = time.perf_counter()
        launch(parallel_rank, world, backend, device, init_file=os.path.join(io, f"rdv{world}"),
               args=(io, world))
        wall_s[world] = time.perf_counter() - t
        runs[world] = [torch.load(os.path.join(io, f"world{world}_rank{r}.pt"),
                                  map_location="cpu", weights_only=False) for r in range(world)]
    one, two = runs[1][0], runs[2]
    ranks = [one] + two
    v, f = kc.lshape_mesh()
    pts = torch.from_numpy(TriangleMesh(vertices=v, faces=f).sample_points_uniformly(
        2000, np.random.default_rng(1))[0])
    T_t = torch.from_numpy(T_true)
    parts = {}

    def emit(part: str, world: int, rec: dict) -> dict:
        backend = dict((w, b) for w, b, _ in PAR_WORLDS)[world]
        rec = {"part": part, "world": world, "backend": backend, "card": card,
               "ms_are": f"{world} process(es) sharing one card, not a speed-up", **rec}
        log(json.dumps({"parallel": rec}))
        parts[f"{part} world {world}"] = rec
        return rec

    counts = lambda r, keys=("k1", "k2", "k1_batched", "k2_batched"): {  # noqa: E731
        k: r[k] for k in keys}

    # (p1)
    ref = one["p1"]["single"]
    for world, rs_ in ((1, [one]), (2, two)):
        rel = [abs(r["p1"]["chamfer"] - ref) / ref for r in rs_]
        rec = emit("p1 sharded_chamfer 16384x16384", world, {
            "chamfer": rs_[0]["p1"]["chamfer"], "single_device": ref, "rel_diff": max(rel),
            "ms": [r["p1"]["ms"] for r in rs_], "launches_per_rank": [counts(r["p1"])
                                                                      for r in rs_]})
        if not max(rel) <= 1e-6:
            fail(f"parallel p1 world {world}: Chamfer {rel} from the single device (> 1e-6)")
        if any(r["p1"]["k1"] != 2 for r in rs_):
            fail(f"parallel p1 world {world}: K1 launches {rec['launches_per_rank']} (2 a rank)")

    # (p2) the estimator
    s = one["p2 estimator"]["single"]
    for world, rs_ in ((1, [one]), (2, two)):
        e = [r["p2 estimator"] for r in rs_]
        sc = torch.tensor(e[0]["scores"])
        # scores in template order for the comparison
        by_tpl = lambda rec: torch.tensor(rec["scores"])[torch.argsort(  # noqa: E731
            torch.tensor(rec["order"]))]
        diff = _max_abs(by_tpl(e[0]), by_tpl(s))
        adds = adds_cm(torch, pts, torch.from_numpy(np.asarray(e[0]["H"], np.float32)), T_t)
        bit = (np.array_equal(e[0]["H"], s["H"]) and e[0]["order"] == s["order"]
               and e[0]["scores"] == s["scores"] and np.array_equal(e[0]["Ts"], s["Ts"]))
        rec = emit("p2 PoseEstimator(mesh_devices=), 26 views, 640x480", world, {
            "templates": e[0]["templates"], "winner": e[0]["order"][0],
            "single_device_winner": s["order"][0], "bit_equal_single_device": bit,
            "max_score_diff": diff, "adds_cm": adds, "adds_budget_cm": ADDS_BUDGET_CM,
            "first_ms": [x["ms"] for x in e], "warm_ms": [x["warm_ms"] for x in e],
            "single_device_warm_ms": s["warm_ms"], "build_ms": [x["build_ms"] for x in e],
            "launches_per_rank": [counts(x) for x in e]})
        if world == 1 and not bit:
            fail("parallel p2: the world-1 search differs from the single-device search")
        if world == 2 and not (rec["winner"] == rec["single_device_winner"] and diff <= 1e-5):
            fail(f"parallel p2 world 2: winner {rec['winner']} (single "
                 f"{rec['single_device_winner']}), scores {diff} from world 1 (> 1e-5)")
        if any(not np.array_equal(x["H"], e[0]["H"]) or x["scores"] != e[0]["scores"]
               for x in e):
            fail(f"parallel p2 world {world}: the ranks' results differ")
        if not adds < ADDS_BUDGET_CM:
            fail(f"parallel p2 world {world}: winner ADD-S {adds:.4f} cm >= {ADDS_BUDGET_CM}")
        if any(x["k1"] == 0 or x["k2_batched"] == 0 for x in e):
            fail(f"parallel p2 world {world}: K1/K2 launches {rec['launches_per_rank']}")
    # (p2) the synthetic fixture: both worlds bit-equal to the single
    # device (the batched registration's sums over points run in an order
    # fixed by the point count, so 8 chains a rank give the bits of 16)
    ss = one["p2 synthetic"]["single"]
    for world, rs_ in ((1, [one]), (2, two)):
        e = [r["p2 synthetic"] for r in rs_]
        d = (e[0]["scores"].double() - ss["scores"].double()).abs()
        bit = torch.equal(e[0]["scores"], ss["scores"]) and torch.equal(e[0]["Hr"], ss["Hr"])
        w = int(torch.argmin(e[0]["scores"]))
        rec = emit(f"p2 sharded_template_search, synthetic {PAR_SYNTH_TEMPLATES} templates",
                   world, {"winner": w, "good_idx": e[0]["good"], "add_m": e[0]["add"],
                           "bit_equal_single_device": bit, "max_score_diff": float(d.max()),
                           "templates_differing": [int(i) for i in torch.nonzero(d > 0)],
                           "winner_score_diff": float(d[w]),
                           "ms": [x["ms"] for x in e], "launches_per_rank": [counts(x) for x in e]})
        if not bit or not torch.isfinite(e[0]["scores"]).all():
            fail(f"parallel p2 synthetic world {world}: {rec}")
        if any(not torch.equal(x["scores"], e[0]["scores"]) for x in e):
            fail(f"parallel p2 synthetic world {world}: the ranks' results differ")

    # (p3)
    st = one["p3"]["single"]
    model_v = torch.from_numpy(v)

    def add_mm(T):
        return float(((model_v @ T[:3, :3].T + T[:3, 3])
                      - (model_v @ T_t[:3, :3].T + T_t[:3, 3])).norm(dim=1).mean()) * 1e3

    for world, rs_ in ((1, [one]), (2, two)):
        e = [r["p3"] for r in rs_]
        bit = all(torch.equal(x[k], st[k]) for x in e for k in ("T", "fitness", "rmse", "cov"))
        before = [add_mm(T) for T in e[0]["Ts0"]]
        after = [add_mm(T) for T in e[0]["T"]]
        per_frame = [{k: float(np.mean([s_[k] for s_ in x["steps"]])) for k in (
            "k1_batched", "k2_batched")} for x in e]
        rec = emit(f"p3 sharded_multi_track, {PAR_TRACKS} L-shape tracks, 640x480", world, {
            "bit_equal_world1_and_unsharded": bit, "add_mm_start": before, "add_mm_after": after,
            "add_mm_mean": [float(np.mean(before)), float(np.mean(after))],
            "step_ms": [[s_["ms"] for s_ in x["steps"]] for x in e],
            "batched_launches_per_rank_per_frame": per_frame})
        if not bit:
            fail(f"parallel p3 world {world}: differs from the unsharded batched step")
        if not (all(a < 0.85 * b for a, b in zip(after, before))
                and np.mean(after) < 0.7 * np.mean(before)):
            fail(f"parallel p3 world {world}: ADD {before} -> {after} mm")
        if any(p["k2_batched"] != 1 or p["k1_batched"] < 2 for p in per_frame):
            fail(f"parallel p3 world {world}: batched launches a frame {per_frame}")

    # (p4)
    sd_ = one["p4"]["single"]
    for world, rs_ in ((1, [one]), (2, two)):
        e = [r["p4"] for r in rs_]
        same_valid = all(torch.equal(x["valid"], sd_["valid"]) for x in e)
        ds = max(_max_abs(x["scores"], sd_["scores"]) for x in e)
        db = max(_max_abs(x["boxes"], sd_["boxes"]) for x in e)
        rec = emit(f"p4 ShardedDetector, batch {PAR_DET_BATCH} at 640x480", world, {
            "detections": int(sd_["valid"].sum()), "valid_equal": same_valid,
            "max_score_diff": ds, "max_box_diff_px": db, "ms": [x["ms"] for x in e],
            "single_device_ms": sd_["ms"]})
        if not (same_valid and ds <= 1e-5 and db <= 1e-4):
            fail(f"parallel p4 world {world}: {rec}")

    # (p5)
    t1 = one["p5"]
    for world, rs_ in ((1, [one]), (2, two)):
        e = [r["p5"] for r in rs_]
        x = e[0]
        part_rel = max(abs(a["parts"][k] - b["parts"][k]) / max(abs(b["parts"][k]), 1e-12)
                       for a, b in zip(x["steps"], t1["steps"]) for k in b["parts"])
        known = total = 0
        worst = 0.0
        for k, m1, m2 in zip(t1["params"], t1["mu"], x["mu"]):
            sure = (m1.abs() > 1e-6) & ((m2 - m1).abs() <= 1e-3 * m1.abs())
            known, total = known + int(sure.sum()), total + sure.numel()
            d = (x["params"][k] - t1["params"][k]).abs()[sure]
            worst = max(worst, float(d.max()) if d.numel() else 0.0)
        bn = max(leaf_rel_err(x["stats"][k], t1["stats"][k]) for k in t1["stats"]
                 if t1["stats"][k].is_floating_point())
        replicated = all(torch.equal(y["params"][k], x["params"][k]) for y in e
                         for k in x["params"])
        rec = emit(f"p5 data-parallel train step, batch {PAR_TRAIN_BATCH} "
                   f"({' + '.join(str(y['local_batch']) for y in e)}) at {PAR_IMGSZ}", world, {
                       "loss_parts": x["steps"][-1]["parts"], "max_part_rel_diff": part_rel,
                       "max_param_diff_where_known": worst, "known_share": known / total,
                       "max_bn_stat_rel_diff": bn, "replicated": replicated,
                       "step_ms": [[r_["ms"] for r_ in y["steps"]] for y in e],
                       "load_scatter_ms": [[r_["load_scatter_ms"] for r_ in y["steps"]]
                                           for y in e],
                       "lr": [r_["lr"] for r_ in x["steps"]]})
        if not (part_rel <= 1e-4 and worst <= 2e-5 and known / total > 0.5 and bn <= 1e-4
                and replicated):
            fail(f"parallel p5 world {world}: {rec}")

    log(json.dumps({"parallel": {"part": "launch to exit, s", "card": card, **wall_s}}))
    inputs = [torch.load(os.path.join(io, f"inputs{w}.pt"), map_location=dev,
                         weights_only=False) for w, _, _ in PAR_WORLDS]
    merged = {k: {**inputs[0][k], **inputs[1][k]} for k in inputs[0]}
    return {"parts": parts, "wall_s": wall_s,
            "nn_inputs": merged["nn"], "nn_batched_inputs": merged["nn_batched"],
            "raster_inputs": merged["raster"], "raster_batched_inputs": merged["raster_batched"],
            "launches": {w: [{p: {k: v for k, v in r[p].items() if k in (
                "k1", "k2", "k1_batched", "k2_batched")} for p in ("p1", "p2 estimator",
                                                                   "p2 synthetic")}
                for r in runs[w]] for w in runs}}


EVAL_FRAMES = 100  # (e1)-(e4) turning frames, the JAX evaluation's default
EVAL_MULTI = ("320x240", 40)  # (e5) camera and frames, the JAX multi-object record's run
EVAL_TRAINED = ("160x128", 8, 100, 16)  # (e6) camera, frames, epochs, images: the JAX test's
EVAL_JAX_MULTI_CM = {"e5 objects 3": 1.44, "e5 objects 3 mixed-cad": 1.60}  # BASELINE.md:34
EVAL_JAX_INIT = {"reduced:1:2": [61.8, 0.328], "full:1:2": [23.3, 0.456]}  # BASELINE.md:53-55


def eval_phase(torch, dev, fnn, rs, images_dir: str, tmp: str, card: str,
               res: str = "640x480") -> dict:
    """The reference's evaluation harnesses and detection scripts, as their
    users run them, through the port's ``apps/`` (see the module
    docstring): one ``{"eval": ...}`` line per part, with its gates, its
    wall seconds and the K1 and K2 launches (single and batched) of its run,
    the counts set to 0 just before it."""
    import contextlib
    import io

    from poseestimator_tpu_torch.apps import (clique_sweep, eval_init, eval_tracking, predict,
                                              scaling_eval)
    from poseestimator_tpu_torch.models.yolo.model import YOLO11Seg, init_random_

    counters = {"k1": fnn.fused_nn_stats, "k1_batched": fnn.fused_nn_batched_stats,
                "k2": rs.raster_stats, "k2_batched": rs.raster_batched_stats}
    device = str(dev)
    parts = {}

    def part(name, fn):
        for c in counters.values():
            c.launches = 0
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        rec = {"part": name, "card": card, "wall_s": time.perf_counter() - t,
               "launches": {k: c.launches for k, c in counters.items()}, **out}
        parts[name] = rec
        log(json.dumps({"eval": rec}))
        return rec

    def tracking(argv):
        args = eval_tracking.build_parser().parse_args(argv + ["--device", device])
        return {"argv": argv, "rows": eval_tracking.run(args, quiet=True)}

    def need(cond, msg):
        if not cond:
            fail(f"eval {msg}")

    frames = str(EVAL_FRAMES)
    base = ["--res", res, "--frames", frames]
    e1 = part("e1 sparse 300 and dense, mesh", lambda: tracking(
        base + ["--modes", "300,0", "--observation", "mesh"]))
    rows = {r["mode"]: r for r in e1["rows"]}
    need(set(rows) == {"300pt", "dense"}, f"e1: rows {sorted(rows)}")
    need(rows["dense"]["adds_mean_cm"] <= ADDS_BUDGET_CM,
         f"e1 dense: ADD-S {rows['dense']['adds_mean_cm']} cm > {ADDS_BUDGET_CM}")
    need(rows["300pt"]["adds_mean_cm"] <= SPARSE_BUDGET_CM,
         f"e1 300pt: ADD-S {rows['300pt']['adds_mean_cm']} cm > {SPARSE_BUDGET_CM}")
    for name, extra, budget in (
            ("e2 degraded 2 px, mesh", ["--detector", "degraded:2", "--observation", "mesh"],
             DEGRADED_BUDGET_CM),
            ("e3 splat stress", ["--observation", "splat"], SPLAT_BUDGET_CM),
            ("e4 noise 3 mm + RealSense filters, mesh",
             ["--noise-sigma", "0.003", "--observation", "mesh"], 3.0)):
        rec = part(name, lambda: tracking(base + ["--modes", "0"] + extra))
        need(len(rec["rows"]) == 1, f"{name}: {len(rec['rows'])} rows")
        r = rec["rows"][0]
        need(r["adds_mean_cm"] <= budget, f"{name}: ADD-S {r['adds_mean_cm']} cm > {budget}")
        if name.startswith("e4"):
            need(r["frames_tracked"] >= int(0.9 * EVAL_FRAMES),
                 f"{name}: {r['frames_tracked']} frames tracked < {int(0.9 * EVAL_FRAMES)}")
    mres, mframes = EVAL_MULTI
    for name, extra in (("e5 objects 3", []), ("e5 objects 3 mixed-cad", ["--mixed-cad"])):
        rec = part(name, lambda: {**tracking(["--res", mres, "--frames", str(mframes),
                                              "--modes", "0", "--objects", "3"] + extra),
                                  "jax_record_adds_mean_cm": EVAL_JAX_MULTI_CM[name],
                                  "jax_record_note": "the JAX package's splat multi-object "
                                  "accuracy (BASELINE.md:34), an accuracy, not a time"})
        need(len(rec["rows"]) == 1, f"{name}: never acquired all instances")
        r = rec["rows"][0]
        need(r["id_switches"] == 0, f"{name}: {r['id_switches']} identity switches")
        need(r["frames_distinct"] == 1.0, f"{name}: frames_distinct {r['frames_distinct']}")
        need(r["acquired_at_frame"] <= 3, f"{name}: acquired at frame {r['acquired_at_frame']}")
        need(r["adds_mean_cm"] <= 3.0, f"{name}: ADD-S {r['adds_mean_cm']} cm > 3.0")
    tres, tframes, epochs, n_img = EVAL_TRAINED
    # 200 steps from scratch: cuDNN's deterministic algorithms, as (t3), so
    # that the run's atomics do not decide the mAP gate
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    rec = part("e6 trained-ckpt", lambda: {**tracking(
        ["--res", tres, "--frames", str(tframes), "--modes", "0", "--detector", "trained-ckpt",
         "--train-epochs", str(epochs), "--train-images", str(n_img), "--conf", "auto",
         "--observation", "mesh"]),
        "note": "the JAX test's size, through the mesh camera (the splat camera's colour "
                "shows a few pixels of the object in both packages); the full-size trained "
                "row waits on the training loader"})
    torch.backends.cudnn.deterministic = deterministic
    need(len(rec["rows"]) == 1, "e6: tracking never started")
    r = rec["rows"][0]
    need(r["detector_map50"] > 0.5, f"e6: detector mAP50 {r['detector_map50']} <= 0.5")
    need(r["frames_tracked"] >= 5, f"e6: {r['frames_tracked']} frames tracked < 5")
    need(0.0 < r["adds_mean_cm"] < 15.0, f"e6: ADD-S {r['adds_mean_cm']} cm")
    need(r["adds_last10pct_cm"] <= r["adds_first10pct_cm"] + 5.0,
         f"e6: drift {r['adds_first10pct_cm']} -> {r['adds_last10pct_cm']} cm")

    def init_sweep():
        out = os.path.join(tmp, "eval_init.json")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = eval_init.main(["--work-dir", os.path.join(tmp, "eval_init"), "--imgsz", res,
                                 "--configs", "reduced:1:2", "full:1:2", "--device", device,
                                 "--json-out", out])
        with open(out) as f:
            return {"rc": rc, "rows": json.load(f)}

    rec = part("eval_init", lambda: {**init_sweep(), "jax_record": EVAL_JAX_INIT,
                                     "jax_record_note": "ADD-S mm, bop_ar of the JAX package's "
                                     "product search on its 12-frame mesh scene (BASELINE.md:50-56)"})
    need(rec["rc"] == 0 and len(rec["rows"]) == 2, f"eval_init: rc {rec['rc']}, {rec['rows']}")
    for r in rec["rows"]:
        # random orientations of a near-symmetric L: the JAX records are 0.33 / 0.46
        need(r.get("bop_ar", 0.0) >= 0.2, f"eval_init {r['config']}: bop_ar {r.get('bop_ar')}")
    rec = part("clique_sweep", lambda: {"rows": clique_sweep.run(
        clique_sweep.build_parser().parse_args(
            ["--ks", "128,256", "--ratios", "0.5,0.9", "--budget", "24", "--device", device]),
        quiet=True)})
    need(all(r["size_ratio_min"] > 0.0 for r in rec["rows"]), "clique_sweep: an empty clique")
    rec = part("scaling_eval", lambda: {"rows": scaling_eval.run(
        scaling_eval.build_parser().parse_args(
            ["--worlds", "1,2", "--repeat", "2", "--device",
             "cuda:0" if dev.type == "cuda" else device]), quiet=True)})
    need([r["world"] for r in rec["rows"]] == [1, 2]
         and all(r["scores_bit_equal"] for r in rec["rows"]), f"scaling_eval: {rec['rows']}")

    weights = os.path.join(tmp, "eval_yolo.pt")
    torch.save(init_random_(YOLO11Seg(nc=5, scale="n"),
                            torch.Generator().manual_seed(0)).state_dict(), weights)

    def folder():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = predict.main(["--weights", weights, "--folder", images_dir, "--batch", "8",
                               "--conf", "0.25", "--device", device])
        lines = buf.getvalue().splitlines()
        return {"rc": rc, "images": len(lines) - 1, "summary": lines[-1]}

    rec = part("predict --folder", folder)
    need(rec["rc"] == 0 and rec["images"] > 0, f"predict: {rec}")
    for name in ("e1 sparse 300 and dense, mesh", "e6 trained-ckpt"):
        n = parts[name]["launches"]
        need(n["k1"] > 0 and n["k2"] + n["k2_batched"] > 0, f"{name}: launches {n}")
    return parts


TOOLS_FRAMES = 30  # profile_stages --frames, float32 and bfloat16
# profile_search: reps of the random worst case and of the realistic searches
TOOLS_SEARCH = (("random", ["10"]), ("realistic", ["5", "--realistic"]),
                ("realistic full", ["5", "--realistic", "--view-set", "full"]))
# ab_mosaic cut from its defaults (60 epochs, 48 + 16 images at 320) to fit a minute
TOOLS_MOSAIC = {"epochs": (60, 3), "train": (48, 16), "val": (16, 8), "imgsz": (320, 160)}


def tools_phase(torch, dev, fnn, rs, tmp: str, card: str) -> dict:
    """The per-stage profilers and the mosaic A/B through the port's apps/,
    as their users run them: one ``{"tools": ...}`` line per part with the
    card's name and power limit (see the module docstring). Returns the
    parts, the phase's wall seconds and the kernels' inputs of the profiled
    searches by shape."""
    import contextlib
    import io

    from poseestimator_tpu_torch.apps import ab_mosaic, profile_search, profile_stages
    from poseestimator_tpu_torch.geom3d import knn as knn_mod

    device = str(dev)
    parts = {}
    t_phase = time.perf_counter()

    def need(cond, msg):
        if not cond:
            fail(f"tools {msg}")

    def emit(name, t, out):
        rec = {"part": name, "card": card, "wall_s": time.perf_counter() - t, **out}
        parts[name] = rec
        log(json.dumps({"tools": rec}))
        return rec

    def quiet(fn):
        with contextlib.redirect_stdout(io.StringIO()):
            return fn()

    stages = profile_stages.STAGES
    for dtype in ("float32", "bfloat16"):
        t = time.perf_counter()
        args = profile_stages.build_parser().parse_args(
            ["--frames", str(TOOLS_FRAMES), "--dtype", dtype, "--device", device])
        rec = emit(f"profile_stages {dtype}", t, quiet(lambda: profile_stages.run(args)))
        name = rec["part"]
        chk = rec["prefix10_vs_fused_frame"]
        need(chk["ok"] and chk["pose_max_abs"] == 0.0 and chk["fitness_abs"] == 0.0
             and chk["n_iters"][0] == chk["n_iters"][1],
             f"{name}: prefix 10 is not the fused frame on the same frame and draws: {chk}")
        k1, k2 = rec["prefix_k1_launches"], rec["prefix_k2_launches"]
        need(all(k2[s] == 0 for s in stages[:5])
             and all(k2[s] == TOOLS_FRAMES for s in stages[5:]),
             f"{name}: K2 launches by prefix {k2}, want 0 before render_depth(win) and one "
             "a frame from it on")
        need(all(k1[s] == 0 for s in stages[:-1])
             and k1[stages[-1]] == sum(n + 1 for n in rec["icp_n_iters"]),
             f"{name}: K1 launches by prefix {k1}, want 0 before icp_dense and "
             f"sum(n_iters + 1) = {sum(n + 1 for n in rec['icp_n_iters'])} in it")
        need(all(np.isfinite(v) for v in rec["stages_ms"].values()),
             f"{name}: a marginal time is not finite: {rec['stages_ms']}")
        need(all(v is not None for v in rec["kernels"].values()),
             f"{name}: no device trace: {rec['kernels']}")

    nn_inputs, nnb_inputs, raster_inputs = {}, {}, {}
    for kind, argv in TOOLS_SEARCH:
        t = time.perf_counter()
        args = profile_search.build_parser().parse_args(argv + ["--device", device])
        W, H = (int(v) for v in args.res.split("x"))
        prof = profile_search.SearchProfile(device, args.realistic, args.view_set, True, (W, H))
        rec = emit(f"profile_search {kind}", t, quiet(lambda: profile_search.run(args, prof)))
        chk = rec["full_vs_search_templates"]
        need(chk["winner"][0] == chk["winner"][1] and chk["pose_max_abs"] == 0.0
             and chk["scores_max_abs"] == 0.0,
             f"profile_search {kind}: the full prefix is not search_templates: {chk}")
        need(all(np.isfinite(v) for v in rec["marginal_ms"].values()),
             f"profile_search {kind}: a marginal time is not finite: {rec['marginal_ms']}")
        need(all(v is not None for v in rec["kernels"].values()),
             f"profile_search {kind}: no device trace: {rec['kernels']}")
        # the kernels' inputs of one full search, by shape
        orig = knn_mod.fused_nn, knn_mod.fused_nn_batched, rs.raster_batched
        knn_mod.fused_nn = _first_call_recorder(
            torch, nn_inputs, orig[0], lambda q, qv, d, dv: (q.shape[0], d.shape[0]))
        knn_mod.fused_nn_batched = _first_call_recorder(
            torch, nnb_inputs, orig[1], lambda q, qv, d, dv: (q.shape[0], q.shape[1], d.shape[1]))
        rs.raster_batched = _first_call_recorder(
            torch, raster_inputs, orig[2], lambda c, b, H, W: (c.shape[0], H, W, c.shape[1]))
        try:
            prof.prefix(7, 4, 0)
        finally:
            knn_mod.fused_nn, knn_mod.fused_nn_batched, rs.raster_batched = orig

    t = time.perf_counter()
    args = ab_mosaic.build_parser().parse_args(
        [x for k, (_, v) in TOOLS_MOSAIC.items() for x in (f"--{k}", str(v))]
        + ["--device", device])
    out = quiet(lambda: ab_mosaic.run(args, work_dir=os.path.join(tmp, "ab_mosaic")))
    rec = emit("ab_mosaic", t, {**out, "reduced_from_defaults": TOOLS_MOSAIC})
    need(set(rec["rows"]) == {"off", "on"}
         and all(np.isfinite(r["map50"]) for r in rec["rows"].values()),
         f"ab_mosaic: rows {rec['rows']}")
    wall = time.perf_counter() - t_phase
    log(f"tools phase: {wall:.1f} s")
    return {"parts": parts, "wall_s": wall, "nn_inputs": nn_inputs,
            "nn_batched_inputs": nnb_inputs, "raster_batched_inputs": raster_inputs}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", help="also write the JSON summary to this file")
    p.add_argument("--profile", metavar="FILE.txt",
                   help="also trace 5 frames with torch.profiler and write the kernel table "
                   "to this file, 2 searches to FILE_search.txt and 3 batched multi-object "
                   "steps (B = 3) to FILE_multi.txt and 2 offline registrations to "
                   "FILE_offline.txt")
    p.add_argument("--offline-dir", metavar="DIR",
                   help="write the offline phase's CAD, template database and BOP scene "
                   "here and keep them (default: a temporary directory)")
    args = p.parse_args(argv)
    wall0 = time.perf_counter()

    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA GPU")
    try:
        from poseestimator_tpu_torch import kernel_cases as kc
        from poseestimator_tpu_torch import kernels
        from poseestimator_tpu_torch.apps._scene import make_light_scene
        from poseestimator_tpu_torch.device import resolve_device
        from poseestimator_tpu_torch.geom3d import fused_nn as fnn
        from poseestimator_tpu_torch.geom3d.camera import Intrinsics
        from poseestimator_tpu_torch.models.yolo.model import YOLO11Seg, init_random_
        from poseestimator_tpu_torch.pipeline.tracking import FusedFrame, track_step
        from poseestimator_tpu_torch.pipeline.window import window_for_object, window_origin
        from poseestimator_tpu_torch.render import raster as rs
        from poseestimator_tpu_torch.render.mesh import pad_faces
    except ImportError as e:
        fail(f"the port package is missing ({e}); run from the repository root")

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else f"nvidia-smi unavailable (rc {smi.returncode})"
    dev = resolve_device("cuda")
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {card}")

    # 2. build
    t0 = time.perf_counter()
    built = kernels.build_all()
    build_s = time.perf_counter() - t0
    each = ", ".join(f"{k} {v:.2f} s" for k, v in built.items()) or "cached"
    log(f"build: {build_s:.2f} s ({each})")

    # scene: the bench box (apps/_scene.py) one motion delta per frame from z = 0.5 m
    intr = Intrinsics.from_fov(60.0, 640, 480)
    intr_r = intr.scaled(2)
    verts = kc.box_vertices()
    diag = float(np.linalg.norm(verts.max(0) - verts.min(0)))
    win = window_for_object(intr_r, diag, 0.5)
    _, _, mesh_v, mesh_f, T0, _, _, _ = make_light_scene(intr, np.random.default_rng(0), dev)

    # 3. K1
    k1 = check_fused_nn(torch, fnn, dev)
    log(f"K1 4096x4096: device {k1['device_ms']:.5f} ms (graph replay), call {k1['call_ms']:.4f} ms, "
        f"plain {k1['plain_ms']:.4f} ms, bound {k1['bound'][0]:.5f} ms ({k1['bound'][1]}), "
        f"FMA-free issue ceiling {k1['issue_ms']:.5f} ms, library_ms (torch.cdist(q, d).min(1), "
        f"TF32 off; the port never calls it) {k1['library_ms']:.5f} ms")
    log(f"K1 16384x16384: device {k1['16384x16384']['device_ms']:.5f} ms, call "
        f"{k1['16384x16384']['call_ms']:.4f} ms, plain {k1['16384x16384']['plain_ms']:.4f} ms, "
        f"FMA-free issue ceiling {k1['16384x16384']['issue_ms']:.5f} ms, library_ms "
        f"{k1['16384x16384']['library_ms']:.5f} ms")
    cm = k1["cost_model"]
    log(f"K1 cost at N=4096 over M=512..16384: fixed {cm['fixed_ms']:.5f} ms + pairs at "
        f"{cm['pairs_per_s']:.4g}/s ({100 * cm['share_of_issue_ceiling']:.1f}% of the FMA-free "
        f"issue ceiling); a 1-element fill takes {cm['launch_floor_ms']:.5f} ms")

    # 4. K2
    k2 = check_raster(torch, rs, window_origin, mesh_v, mesh_f, T0, intr_r, win, dev)

    # 5. main path
    model = init_random_(YOLO11Seg(nc=5, scale="n"), torch.Generator().manual_seed(0))
    frame = FusedFrame(model, verts, pad_faces(kc.BOX_FACES, 256), intr, win_hw=win,
                       imgsz=640, max_det=32, device=dev)
    rng = np.random.default_rng(0)
    color = torch.from_numpy(rng.integers(0, 255, (480, 640, 3), dtype=np.uint8)).to(dev)
    delta = torch.from_numpy(motion_delta()).to(dev)
    T_true, depths = [], []
    T = T0
    for _ in range(FRAMES):
        T = delta @ T
        T_true.append(T)
        depths.append(rs.render_depth_mesh(mesh_v, mesh_f, T, intr, near=0.01, far=5.0))
    gen = torch.Generator(device=dev).manual_seed(0)
    frame(color, depths[0], T0, mask_union=depths[0] > 0, generator=gen)  # warm-up
    torch.cuda.synchronize()

    fnn.fused_nn_stats.launches = 0
    rs.raster_stats.launches = 0
    T_est, frame_ms, n_iters, oks = T0, [], [], []
    poses = []
    for k in range(FRAMES):
        t = time.perf_counter()
        res = frame(color, depths[k], T_est, conf=0.25, icp_dist=0.01,
                    mask_union=depths[k] > 0, generator=gen)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1e3)
        T_est = res.T
        poses.append(T_est)
        n_iters.append(res.n_iters)
        oks.append(bool(res.ok))
    k1_launches = fnn.fused_nn_stats.launches
    k2_launches = rs.raster_stats.launches

    pts = torch.from_numpy(box_surface(np.random.default_rng(1), 2000, kc.BOX_HALF)).to(dev)
    adds = [adds_cm(torch, pts, Te, Tt) for Te, Tt in zip(poses, T_true)]
    adds_mean = float(np.mean(adds))
    log(f"main path: {FRAMES} frames, median frame {np.median(frame_ms):.3f} ms "
        f"(min {min(frame_ms):.3f}), "
        f"mean ICP n_iters {np.mean(n_iters):.2f}, ok {sum(oks)}/{FRAMES}, "
        f"K1 launches {k1_launches}, K2 launches {k2_launches}, "
        f"ADD-S mean {adds_mean:.4f} cm (max {max(adds):.4f})")
    if k2_launches != FRAMES:
        fail(f"K2 launched {k2_launches} times in {FRAMES} frames")
    if k1_launches != sum(n + 1 for n in n_iters):
        fail(f"K1 launched {k1_launches} times, expected sum(n_iters + 1) = "
             f"{sum(n + 1 for n in n_iters)}")
    if not all(oks):
        fail(f"{FRAMES - sum(oks)} frames had no detection")
    if not all(np.isfinite(np.asarray([P.cpu().numpy() for P in poses])).ravel()):
        fail("non-finite pose")
    if not adds_mean <= ADDS_BUDGET_CM:
        fail(f"mean ADD-S {adds_mean:.4f} cm > {ADDS_BUDGET_CM} cm")

    # 5b. the main path over the bfloat16 detector (b1), and its detections
    # against the float32 detector's (b2)
    bf16 = bf16_phase(torch, dev, fnn, rs, model, verts, pad_faces(kc.BOX_FACES, 256), intr,
                      win, color, depths, T0, T_true, pts, {
                          "frame_ms_median": float(np.median(frame_ms)),
                          "frame_ms_min": float(min(frame_ms)), "adds_mean_cm": adds_mean,
                          "k1_launches": k1_launches, "k2_launches": k2_launches}, card)

    # where the frame goes: the track step alone on the same inputs, and
    # the cost of one host read (the ICP loop makes one per iteration)
    track_ms = call_ms(torch, lambda: track_step(mesh_v, mesh_f, depths[0] > 0, depths[0], T0,
                                          intr, 0.01, win_hw=win, generator=gen),
                       reps=20, warmup=3)
    flag = torch.zeros((), device=dev)
    read_us = call_ms(torch, lambda: bool(flag + 1 > 0), reps=200) * 1e3

    # 6. init path: the template search, then the kernels at its shapes
    with tempfile.TemporaryDirectory() as tmp:
        search = search_phase(torch, dev, kc, fnn, rs, intr, tmp, profile_path=(
            "{0}_search{1}".format(*os.path.splitext(args.profile)) if args.profile else None))
        search_bi = search_b_independence(torch, dev)
        # 7. the tracker, then the kernels at its new shapes
        tracker = tracker_phase(torch, dev, kc, fnn, rs, tmp)
        icp_options = icp_options_phase(torch, dev, kc, fnn, rs, track_step)
        # 8. multi-object tracking, then the batched kernels at its shapes
        multi = multi_phase(torch, dev, kc, fnn, rs, tmp, profile_path=(
            "{0}_multi{1}".format(*os.path.splitext(args.profile)) if args.profile else None))
        # 9. the offline path and the BOP scene sweep
        off_dir = args.offline_dir or os.path.join(tmp, "offline")
        offline = offline_phase(torch, dev, kc, fnn, rs, off_dir, profile_path=(
            "{0}_offline{1}".format(*os.path.splitext(args.profile)) if args.profile else None))
        # 10. the user-facing apps on the offline phase's CAD, database and scene
        apps = apps_phase(torch, dev, kc, fnn, rs, off_dir, offline["offline"]["summary"], card)
        # 11. detector training and synthetic data
        train = train_phase(torch, dev, rs, tmp, card)
        bf16["b3"] = bf16_train_part(torch, dev, train["dataset_yaml"], tmp, card)
        # 12. the multi-device paths at world 1 (NCCL) and 2 (gloo, one card)
        yml = train.pop("dataset_yaml")
        par = parallel_phase(torch, dev, kc, off_dir, yml, tmp, card)
        # 13. the reference's evaluation harnesses and detection scripts
        images = os.path.join(os.path.dirname(yml), "val", "images")
        evals = eval_phase(torch, dev, fnn, rs, images, tmp, card)
        # 14. the per-stage profilers and the mosaic A/B
        tools = tools_phase(torch, dev, fnn, rs, tmp, card)
    # the apps' kernel shapes that no earlier phase gave (checked below)
    new = lambda got, *seen: {k: v for k, v in got.items()  # noqa: E731
                              if not any(k in d for d in seen)}
    apps_nn = new(apps.pop("nn_inputs"), search["nn_inputs"], tracker["nn_inputs"],
                  offline["nn_inputs"])
    apps_k2 = new(apps.pop("raster_inputs"), search["raster_inputs"], tracker["raster_inputs"])
    apps_nnb = new(apps.pop("nn_batched_inputs"), multi["nn_inputs"],
                   offline["nn_batched_inputs"])
    apps_k2b = new(apps.pop("raster_batched_inputs"), multi["raster_inputs"])
    par_nn = new(par.pop("nn_inputs"), search["nn_inputs"], tracker["nn_inputs"],
                 offline["nn_inputs"], apps_nn)
    par_k2 = new(par.pop("raster_inputs"), search["raster_inputs"], tracker["raster_inputs"],
                 apps_k2)
    par_nnb = new(par.pop("nn_batched_inputs"), multi["nn_inputs"],
                  offline["nn_batched_inputs"], apps_nnb)
    par_k2b = new(par.pop("raster_batched_inputs"), multi["raster_inputs"], apps_k2b,
                  train["raster_inputs"])
    tools_nn = new(tools.pop("nn_inputs"), search["nn_inputs"], tracker["nn_inputs"],
                   offline["nn_inputs"], apps_nn, par_nn)
    tools_nnb = new(tools.pop("nn_batched_inputs"), multi["nn_inputs"],
                    offline["nn_batched_inputs"], apps_nnb, par_nnb)
    tools_k2b = new(tools.pop("raster_batched_inputs"), multi["raster_inputs"], apps_k2b,
                    train["raster_inputs"], par_k2b, search["raster_batched_inputs"])
    search_k = check_search_shapes(torch, fnn, rs, search.pop("nn_inputs"),
                                   search.pop("raster_inputs"))
    tracker_k = check_search_shapes(torch, fnn, rs, tracker.pop("nn_inputs"),
                                    tracker.pop("raster_inputs"), where="the tracker's")
    multi_k = check_batched_shapes(torch, fnn, rs, multi.pop("nn_inputs"),
                                   multi.pop("raster_inputs"))
    search_kb = check_batched_shapes(torch, fnn, rs, {}, search.pop("raster_batched_inputs"))
    offline_k = check_search_shapes(torch, fnn, rs, offline.pop("nn_inputs"), {},
                                    where="the offline path's")
    offline_kb = check_batched_shapes(torch, fnn, rs, offline.pop("nn_batched_inputs"), {})
    apps_k = check_search_shapes(torch, fnn, rs, apps_nn, apps_k2, where="the apps'")
    apps_kb = check_batched_shapes(torch, fnn, rs, apps_nnb, apps_k2b)
    synth_kb = check_batched_shapes(torch, fnn, rs, {}, train.pop("raster_inputs"))
    par_k = check_search_shapes(torch, fnn, rs, par_nn, par_k2, where="the parallel phase's")
    par_kb = check_batched_shapes(torch, fnn, rs, par_nnb, par_k2b)
    tools_kb = check_batched_shapes(torch, fnn, rs, tools_nnb, tools_k2b)
    tools_k = check_search_shapes(torch, fnn, rs, tools_nn, {}, where="the tools'")

    if args.profile:
        # the first 5 frames of the sequence again from the start pose
        state = {"T": T0, "k": 0}

        def next_frame():
            k = state["k"]
            state["T"] = frame(color, depths[k], state["T"], mask_union=depths[k] > 0,
                               generator=gen).T
            state["k"] = k + 1

        summary_prof = profile_calls(torch, next_frame, 5, args.profile, "frame")
    summary = {
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s, "frames": FRAMES, "window": list(win),
        "frame_ms_median": float(np.median(frame_ms)), "frame_ms_min": float(min(frame_ms)),
        "frame_ms": frame_ms,
        "track_step_ms_median": track_ms, "host_read_us": read_us,
        "icp_n_iters_mean": float(np.mean(n_iters)), "icp_n_iters": n_iters,
        "adds_mean_cm": adds_mean, "adds_max_cm": float(max(adds)),
        "k1_launches": k1_launches, "k2_launches": k2_launches,
        "search": search, "tracker": tracker["parts"], "icp_options": icp_options,
        "multi": multi["parts"], "offline": offline, "apps": apps["parts"],
        "train": train["parts"], "parallel": par["parts"], "parallel_wall_s": par["wall_s"],
        "bf16": bf16, "search_b_independence": search_bi, "eval": evals,
        "tools": tools["parts"], "tools_wall_s": tools["wall_s"],
        "wall_s": time.perf_counter() - wall0,
    }
    log(f"track step alone: {track_ms:.3f} ms; one host read: {read_us:.1f} us")
    k2_main = k2["shapes"][k2["main"]]
    kernels_line = {"kernels": [
        {"name": "K1 fused_nn", "route": "cuda",
         "source": "poseestimator_tpu_torch/csrc/fused_nn.cu",
         "replaces": "poseestimator_tpu/geom3d/pallas_nn.py:30",
         "launches": k1_launches, "max_abs_err": k1["max_abs_err"], "ms": k1["call_ms"],
         "device_ms": k1["device_ms"], "call_ms": k1["call_ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound"][0], "bound_by": k1["bound"][1],
         "issue_bound_ms": k1["issue_ms"], "library_ms": k1["library_ms"],
         "shape": "4096x4096",
         "other_shapes": {"16384x16384": k1["16384x16384"],
                          **{f"search {k}": v for k, v in search_k["K1"].items()},
                          **{f"tracker {k}": v for k, v in tracker_k["K1"].items()},
                          **{f"offline {k}": v for k, v in offline_k["K1"].items()},
                          **{f"apps {k}": v for k, v in apps_k["K1"].items()},
                          **{f"parallel {k}": v for k, v in par_k["K1"].items()},
                          **{f"tools {k}": v for k, v in tools_k["K1"].items()}},
         "search_launches": {n: r["k1_launches"] for n, r in search["scenes"].items()},
         "offline_launches": {n: {"k1_launches": offline[n]["k1_launches"],
                                  "k1_per_frame": offline[n]["k1_per_frame"]}
                              for n in ("offline", "product")},
         "tracker_launches": {p["part"]: {k: p[k] for k in (
             "k1_launches", "k1_per_tracked_frame", "k1_per_init")}
             for p in tracker["parts"].values()},
         "apps_launches": apps_launches(apps["parts"], "k1"),
         "parallel_launches_per_rank": par_launches(par, "k1"),
         "tools_launches": tools_launches(tools["parts"], "k1"),
         "cost_model": k1["cost_model"]},
        {"name": "K2 raster", "route": "cuda",
         "source": "poseestimator_tpu_torch/csrc/raster.cu",
         "replaces": "poseestimator_tpu/render/raster.py:134",
         "launches": k2_launches, "max_abs_err": k2["max_abs_err"], "ms": k2_main["call_ms"],
         "device_ms": k2_main["device_ms"], "call_ms": k2_main["call_ms"],
         "plain_ms": k2_main["plain_ms"], "bound_ms": k2_main["bound"][0],
         "bound_by": k2_main["bound"][1], "library_ms": None, "shape": k2["main"],
         "other_shapes": {**{k: {"device_ms": v["device_ms"], "call_ms": v["call_ms"],
                                 "plain_ms": v["plain_ms"], "bound_ms": v["bound"][0],
                                 "bound_by": v["bound"][1]}
                             for k, v in k2["shapes"].items() if k != k2["main"]},
                          **{f"search {k}": v for k, v in search_k["K2"].items()},
                          **{f"tracker {k}": v for k, v in tracker_k["K2"].items()},
                          **{f"apps {k}": v for k, v in apps_k["K2"].items()},
                          **{f"parallel {k}": v for k, v in par_k["K2"].items()}},
         "search_launches": {n: r["k2_launches"] for n, r in search["scenes"].items()},
         "tracker_launches": {p["part"]: {k: p[k] for k in (
             "k2_launches", "k2_per_tracked_frame", "k2_per_init")}
             for p in tracker["parts"].values()},
         "apps_launches": apps_launches(apps["parts"], "k2"),
         "parallel_launches_per_rank": par_launches(par, "k2"),
         "tools_launches": tools_launches(tools["parts"], "k2")},
    ]}
    mparts = [multi["parts"][k] for k in ("m1", "m2", "m3")]
    k1b_offline = {"offline_launches": {n: {k: offline[n][k] for k in (
        "k1_batched_launches", "k1_batched_per_frame")} for n in ("offline", "product")}}
    for name, key, source, replaces, shapes, extra in (
            ("K1 fused_nn batched", "k1_launches", "poseestimator_tpu_torch/csrc/fused_nn.cu",
             "poseestimator_tpu/geom3d/pallas_nn.py:30",
             {**multi_k["K1"], **{f"offline {k}": v for k, v in offline_kb["K1"].items()},
              **{f"apps {k}": v for k, v in apps_kb["K1"].items()},
              **{f"parallel {k}": v for k, v in par_kb["K1"].items()},
              **{f"tools {k}": v for k, v in tools_kb["K1"].items()}},
             {**k1b_offline, "parallel_launches_per_rank_per_frame": par_launches(
                 par, "k1_batched"), "tools_launches_per_search": tools_launches(
                 tools["parts"], "k1_batched")}),
            ("K2 raster batched", "k2_launches", "poseestimator_tpu_torch/csrc/raster.cu",
             "poseestimator_tpu/render/raster.py:134",
             {**multi_k["K2"], **{f"search {k}": v for k, v in search_kb["K2"].items()},
              **{f"apps {k}": v for k, v in apps_kb["K2"].items()},
              **{f"synth {k}": v for k, v in synth_kb["K2"].items()},
              **{f"parallel {k}": v for k, v in par_kb["K2"].items()},
              **{f"tools {k}": v for k, v in tools_kb["K2"].items()}},
             {"synth_launches": {"t1 generate": train["parts"]["t1 generate"][
                 "k2_batched_launches"]},
              "search_launches": {n: r["k2_batched_launches"]
                                  for n, r in search["scenes"].items()},
              "parallel_launches_per_rank_per_frame": par_launches(par, "k2_batched"),
              "tools_launches_per_search": tools_launches(tools["parts"], "k2_batched")})):
        # the main shape: the largest batch of the 640x480 part
        main = max((k for k in shapes if k.startswith("B=")),
                   key=lambda k: int(k.split(" ")[0][2:]))
        t = shapes[main]
        kernels_line["kernels"].append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(p[key] for p in mparts), "max_abs_err": 0.0, "ms": t["call_ms"],
            "device_ms": t["device_ms"], "call_ms": t["call_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms"), "shape": main,
            "other_shapes": {k: v for k, v in shapes.items() if k != main},
            "multi_launches": {p["part"]: {k: p[k] for k in (
                key, "k1_per_tracked_frame" if key == "k1_launches" else "k2_per_tracked_frame")}
                for p in mparts}, **extra})
    summary["kernels"] = kernels_line["kernels"]
    if args.profile:
        summary["profile"] = summary_prof
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    log(f"card: {card}")
    log(json.dumps({k: v for k, v in summary.items() if k not in (
        "frame_ms", "icp_n_iters", "kernels", "search", "tracker", "multi", "icp_options",
        "offline", "apps", "train", "parallel", "bf16", "search_b_independence", "eval",
        "tools")}))
    log(json.dumps({"search": search}))
    log(json.dumps(kernels_line))
    log(f"chip_smoke: {time.perf_counter() - wall0:.1f} s in all")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
