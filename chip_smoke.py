#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's hand-written kernels from ``poseestimator_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, then drives the
port's main path — the fused detect + track frame (YOLO11n-seg at a 640
letterbox, mesh render, dense point-to-point ICP) — for 30 frames of the
bench box scene and checks its accuracy against ground truth. Any failed
phase exits nonzero.

Output: progress lines, then the card's name and power limit, a JSON
summary, a JSON line of the kernels, and as the last line
``{"ok": true, "device": {...}}``.

Run from the repository root:
    python3 chip_smoke.py  [--out FILE.json] [--profile FILE.txt]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

FRAMES = 30
ADDS_BUDGET_CM = 1.5  # dense tracking budget of the JAX package's bench
H100 = {"f32_ops": 67e12, "bytes": 3.35e12}  # non-tensor float32 peak, HBM rate
BOX_HALF = (0.06, 0.04, 0.025)  # the bench box CAD
BOX_FACES = np.array(
    [[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
     [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def box_vertices(half=BOX_HALF) -> np.ndarray:
    bx, by, bz = half
    return np.array([[sx * bx, sy * by, sz * bz] for sx in (-1, 1) for sy in (-1, 1)
                     for sz in (-1, 1)], np.float32)


def box_surface(rng: np.random.Generator, n: int, half=BOX_HALF) -> np.ndarray:
    """Uniform samples on the box shell (the ADD-S model points)."""
    half = np.asarray(half, np.float32)
    face = rng.integers(0, 6, size=n)
    pts = rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32) * half[None, :]
    ax = face // 2
    pts[np.arange(n), ax] = np.where(face % 2 == 0, 1.0, -1.0).astype(np.float32) * half[ax]
    return pts


def motion_delta() -> np.ndarray:
    """One camera period of motion: 0.01 rad about z plus (2, 0, 1) mm."""
    c, s = np.cos(0.01), np.sin(0.01)
    d = np.eye(4, dtype=np.float32)
    d[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    d[:3, 3] = [0.002, 0.0, 0.001]
    return d


def median_ms(fn, reps: int = 100, warmup: int = 10) -> float:
    """Median time of one call from CUDA events around each call."""
    import torch

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


def bound_ms(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / H100["f32_ops"], nbytes / H100["bytes"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def nn_bound(n: int, m: int) -> tuple[float, str]:
    # 8 float32 operations and one compare per pair; each input read once
    # (points 12 B + mask 1 B), outputs 4 + 8 + 1 B per query
    return bound_ms(9.0 * n * m, 13 * (n + m) + 13 * n)


def raster_bound(bbox, H: int, W: int) -> tuple[float, str]:
    # ~20 float32 operations per (pixel, face) pair that the bbox cull keeps
    # (four planes at 2 mul + 2 add, three compares, a max); 64 B per face
    # read once, 4 B per pixel written once
    b = bbox.double().cpu().numpy()
    live = b[:, 0] <= b[:, 1]
    x0 = np.clip(np.ceil(b[live, 0]), 0, W)
    x1 = np.clip(np.floor(b[live, 1]) + 1, 0, W)
    y0 = np.clip(np.ceil(b[live, 2]), 0, H)
    y1 = np.clip(np.floor(b[live, 3]) + 1, 0, H)
    pairs = float((np.clip(x1 - x0, 0, None) * np.clip(y1 - y0, 0, None)).sum())
    return bound_ms(20.0 * pairs, 64 * b.shape[0] + 4 * H * W)


def check_fused_nn(torch, fnn, dev):
    """K1 against its plain version; returns (max_abs_err, kernel ms,
    plain ms, library ms) with the times at the main path's 4096 x 4096."""
    g = torch.Generator(device=dev).manual_seed(1)

    def cloud(n, scale=0.03, center=0.5):
        return torch.randn(n, 3, device=dev, generator=g) * scale + torch.tensor(
            [0.0, 0.0, center], device=dev)

    def mask(n, p):
        return torch.rand(n, device=dev, generator=g) < p

    ones = lambda n: torch.ones(n, dtype=torch.bool, device=dev)  # noqa: E731
    q4, d4 = cloud(4096), cloud(4096)
    cases = {
        "4096x4096": (q4, ones(4096), d4, ones(4096)),
        "ragged 1000x3000": (cloud(1000, 1.0, 0.0), ones(1000), cloud(3000, 1.0, 0.0), ones(3000)),
        "random invalid masks": (cloud(4096), mask(4096, 0.8), cloud(4096), mask(4096, 0.6)),
        "all data invalid": (cloud(500), ones(500), cloud(2000), torch.zeros(
            2000, dtype=torch.bool, device=dev)),
        "16k x 16k streamed": (cloud(16384, 0.2), mask(16384, 0.95), cloud(16384, 0.2),
                               mask(16384, 0.95)),
    }
    worst = 0.0
    for name, (q, qv, d, dv) in cases.items():
        kd, ki, kf = fnn.fused_nn(q, qv, d, dv)
        torch.cuda.synchronize()
        pd, pi, pf = fnn.fused_nn_plain(q, qv, d, dv)
        if not torch.equal(ki, pi):
            fail(f"K1 {name}: {(ki != pi).sum().item()} indices differ from the plain version")
        if not torch.equal(kf, pf):
            fail(f"K1 {name}: found flags differ from the plain version")
        err = float((kd - pd).abs().max())
        if err > 1e-6:
            fail(f"K1 {name}: distance error {err} > 1e-6")
        worst = max(worst, err)
        log(f"K1 {name}: indices identical, max |d| err {err:.3g}, found {int(kf.sum())}")
    q, qv, d, dv = cases["4096x4096"]
    ms = median_ms(lambda: fnn.fused_nn(q, qv, d, dv))
    plain = median_ms(lambda: fnn.fused_nn_plain(q, qv, d, dv), reps=20)
    lib = median_ms(lambda: torch.cdist(q, d).min(1), reps=50)
    return worst, ms, plain, lib


def check_raster(torch, rs, window_origin, mesh_v, mesh_f, T0, intr_r, win, dev):
    """K2 against its plain version at the main path's window and at a
    4096-face sphere over the full half-resolution frame."""
    from poseestimator_tpu_torch.render.mesh import make_icosphere

    o = window_origin(mesh_v, T0, intr_r, *win).to(torch.float32)
    cw = rs.face_coeffs(mesh_v, mesh_f, T0, intr_r, near=0.01, origin=o)
    sv, sf = make_icosphere(0.1, 4)
    Ts = torch.eye(4, device=dev)
    Ts[2, 3] = 0.45
    cs = rs.face_coeffs(torch.from_numpy(sv).to(dev), torch.from_numpy(sf[:4096]).to(dev),
                        Ts, intr_r, near=0.01)
    cases = {f"bench box, {win[0]}x{win[1]} window at origin {o.tolist()}": (cw, win),
             f"icosphere 4096 faces, {intr_r.height}x{intr_r.width} frame":
                 (cs, (intr_r.height, intr_r.width))}
    worst, timings = 0.0, {}
    for name, ((coef, bbox), (H, W)) in cases.items():
        izk = rs.raster(coef, bbox, H, W)
        torch.cuda.synchronize()
        izp = rs.raster_plain(coef, H, W, chunk=64)
        if not torch.equal(izk > 0, izp > 0):
            fail(f"K2 {name}: coverage differs on {((izk > 0) != (izp > 0)).sum().item()} px")
        dk, dp = rs.izmax_to_depth(izk, 0.01, 5.0), rs.izmax_to_depth(izp, 0.01, 5.0)
        err = float((dk - dp).abs().max())
        if err > 1e-6:
            fail(f"K2 {name}: depth error {err} m > 1e-6")
        worst = max(worst, err)
        ms = median_ms(lambda: rs.raster(coef, bbox, H, W))
        plain = median_ms(lambda: rs.raster_plain(coef, H, W, chunk=64), reps=20)
        timings[name] = (ms, plain, raster_bound(bbox, H, W), int((izk > 0).sum()))
        log(f"K2 {name}: coverage identical ({int((izk > 0).sum())} px), "
            f"max depth err {err:.3g} m, kernel {ms:.4f} ms, plain {plain:.4f} ms")
    return worst, timings


def adds_cm(torch, pts, T_est, T_true) -> float:
    """ADD-S: mean distance from each estimated model point to the nearest
    true one (exact, no matmul distance form)."""
    a = pts @ T_est[:3, :3].T + T_est[:3, 3]
    b = pts @ T_true[:3, :3].T + T_true[:3, 3]
    d = torch.cdist(a, b, compute_mode="donot_use_mm_for_euclid_dist").min(1).values
    return float(d.mean()) * 100.0


def profile_frames(torch, frame, color, depths, T, gen, path: str) -> dict:
    """Trace the first 5 frames of the sequence again from ``T`` (the start
    pose): device busy share and device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for k in range(5):
            T = frame(color, depths[k], T, mask_union=depths[k] > 0, generator=gen).T
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
    out = {"wall_ms_per_frame": wall_ms / 5, "device_busy_ms_per_frame": busy_ms / 5,
           "device_busy_share": busy_ms / wall_ms,
           "top_device_ms_per_frame": {e.key[:60]: dev_ms(e) / 5 for e in top},
           "kernels_per_frame": sum(e.count for e in kern) / 5}
    log(f"profile (5 frames): {out['wall_ms_per_frame']:.2f} ms/frame wall, device busy "
        f"{out['device_busy_ms_per_frame']:.2f} ms/frame ({100 * out['device_busy_share']:.1f}%), "
        f"{out['kernels_per_frame']:.0f} kernels/frame")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", help="also write the JSON summary to this file")
    p.add_argument("--profile", help="also trace 5 frames with torch.profiler and write "
                   "the kernel table to this file")
    args = p.parse_args(argv)

    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA GPU")
    try:
        from poseestimator_tpu_torch import kernels
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

    # scene: the bench box one motion delta per frame from z = 0.5 m
    intr = Intrinsics.from_fov(60.0, 640, 480)
    intr_r = intr.scaled(2)
    verts = box_vertices()
    diag = float(np.linalg.norm(verts.max(0) - verts.min(0)))
    win = window_for_object(intr_r, diag, 0.5)
    mesh_v = torch.from_numpy(verts).to(dev)
    mesh_f = torch.from_numpy(pad_faces(BOX_FACES, 256)).to(dev)
    T0 = torch.eye(4, device=dev)
    T0[2, 3] = 0.5

    # 3. K1
    k1_err, k1_ms, k1_plain, k1_lib = check_fused_nn(torch, fnn, dev)
    log(f"K1 4096x4096: kernel {k1_ms:.4f} ms, plain {k1_plain:.4f} ms, "
        f"library_ms (torch.cdist(q, d).min(1), TF32 off; the port never calls it) {k1_lib:.4f} ms")

    # 4. K2
    k2_err, k2_t = check_raster(torch, rs, window_origin, mesh_v, mesh_f, T0, intr_r, win, dev)

    # 5. main path
    model = init_random_(YOLO11Seg(nc=5, scale="n"), torch.Generator().manual_seed(0))
    frame = FusedFrame(model, verts, pad_faces(BOX_FACES, 256), intr, win_hw=win,
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

    pts = torch.from_numpy(box_surface(np.random.default_rng(1), 2000)).to(dev)
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

    # where the frame goes: the track step alone on the same inputs, and
    # the cost of one host read (the ICP loop makes one per iteration)
    track_ms = median_ms(lambda: track_step(mesh_v, mesh_f, depths[0] > 0, depths[0], T0,
                                            intr, 0.01, win_hw=win, generator=gen),
                         reps=20, warmup=3)
    flag = torch.zeros((), device=dev)
    read_us = median_ms(lambda: bool(flag + 1 > 0), reps=200) * 1e3

    if args.profile:
        summary_prof = profile_frames(torch, frame, color, depths, T0, gen, args.profile)
    summary = {
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s, "frames": FRAMES, "window": list(win),
        "frame_ms_median": float(np.median(frame_ms)), "frame_ms_min": float(min(frame_ms)),
        "frame_ms": frame_ms,
        "track_step_ms_median": track_ms, "host_read_us": read_us,
        "icp_n_iters_mean": float(np.mean(n_iters)), "icp_n_iters": n_iters,
        "adds_mean_cm": adds_mean, "adds_max_cm": float(max(adds)),
        "k1_launches": k1_launches, "k2_launches": k2_launches,
        "k2_cases": {k: {"ms": v[0], "plain_ms": v[1], "bound_ms": v[2][0],
                         "bound_by": v[2][1], "covered_px": v[3]} for k, v in k2_t.items()},
    }
    log(f"track step alone: {track_ms:.3f} ms; one host read: {read_us:.1f} us")
    (k2_main, k2_main_t), = [(k, v) for k, v in k2_t.items() if k.startswith("bench box")]
    k1_bound = nn_bound(4096, 4096)
    kernels_line = {"kernels": [
        {"name": "K1 fused_nn", "route": "cuda",
         "source": "poseestimator_tpu_torch/csrc/fused_nn.cu",
         "replaces": "poseestimator_tpu/geom3d/pallas_nn.py:30",
         "launches": k1_launches, "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain,
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1], "library_ms": k1_lib},
        {"name": "K2 raster", "route": "cuda",
         "source": "poseestimator_tpu_torch/csrc/raster.cu",
         "replaces": "poseestimator_tpu/render/raster.py:134",
         "launches": k2_launches, "max_abs_err": k2_err, "ms": k2_main_t[0],
         "plain_ms": k2_main_t[1], "bound_ms": k2_main_t[2][0], "bound_by": k2_main_t[2][1],
         "library_ms": None},
    ]}
    summary["kernels"] = kernels_line["kernels"]
    if args.profile:
        summary["profile"] = summary_prof
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    log(f"card: {card}")
    log(json.dumps({k: v for k, v in summary.items() if k not in ("frame_ms", "icp_n_iters",
                                                                  "kernels")}))
    log(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
