"""Per-stage profile of the fused frame (counterpart of
``tools/profile_stages.py``): cumulative prefixes of ``FusedFrame``, each
timed over ``--frames`` frames; the difference of consecutive prefixes is a
stage's marginal cost.

Stages (``FusedFrame.detect_stages`` then ``track_program``,
``pipeline/tracking.py``):

   0 dispatch_floor (the frame's draws)   1 letterbox
   2 yolo_forward       3 decode+nms      4 assemble_mask
   5 render_depth(win)  6 tpl_backproj+sample4k
   7 obs_backproject(win)                 8 obs_sample4k
   9 outlier_removal   10 icp_dense (p2p, 0.01 m, 30 iterations)

Prefix k calls the fused frame's own code and stops after stage k: the
detection generator is cut after its k-th item, and ``track_program`` runs
with ``stages=k - 4``. Each frame draws its samplers' numbers with
``step_draws`` from a generator seeded with the frame's index; that is
stage 0, so every prefix carries it. Prefix 10 is the fused frame bit for
bit on the same frame and draws (``check_prefix``).

Eager PyTorch has no fused program: a marginal time here is the stage's
host time and its device time together, and the host's share is large
(one launch per op, one host read per ICP and NMS iteration). So after the
timing, one frame of each prefix is traced with ``torch.profiler`` on
the card (the counts do not change from frame to frame), and each stage's
marginal count of device
kernels and device-busy ms is printed beside its K1 and K2 launches. A
trace with no device time on a card (CUPTI failed) is an error, not zeros.
On the CPU there is no device trace: those columns are null.

The inputs are the JAX tool's: YOLO11n-seg (nc 5, seeded weights), a
random 640 x 480 frame, ``apps/_scene.py``'s light scene; half-resolution
render in the auto 128 x 128 window, 4096-point samples, outliers 20 /
1.0, dense point-to-point ICP.

    python -m poseestimator_tpu_torch.apps.profile_stages --frames 100
    python -m poseestimator_tpu_torch.apps.profile_stages --device cpu --frames 2

Prints a per-stage table, then one JSON line (``total_ms``, ``stages_ms``,
``device``, ``frames``, with ``kernels``, ``device_ms``, ``k1_launches``
and ``k2_launches`` by stage).
"""
from __future__ import annotations

import argparse
import itertools
import json
import sys

import numpy as np
import torch

from ..device import resolve_device

STAGES = ("dispatch_floor", "letterbox", "yolo_forward", "decode+nms", "assemble_mask",
          "render_depth(win)", "tpl_backproj+sample4k", "obs_backproject(win)", "obs_sample4k",
          "outlier_removal", "icp_dense")
DETECT_STAGES = 4  # stages 1-4 come from FusedFrame.detect_stages


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="YOLO forward dtype (the --detector-dtype axis)")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    p.add_argument("--res", default="640x480", help="camera WxH")
    p.add_argument("--imgsz", type=int, default=640,
                   help="the detector's letterbox size (smaller for a quick CPU run)")
    return p


class Profile:
    """The profiled frame: ``FusedFrame`` over the seeded YOLO11n-seg, the
    random frame and the light scene, on ``device``."""

    def __init__(self, device="cuda", dtype: str = "float32", res=(640, 480),
                 imgsz: int = 640):
        from ..geom3d.camera import Intrinsics
        from ..models.yolo.model import YOLO11Seg, init_random_
        from ..pipeline.tracking import RENDER_DOWNSCALE, FusedFrame
        from ..pipeline.window import window_dims
        from ._scene import make_light_scene

        self.device = resolve_device(device)
        W, H = res
        self.intr = Intrinsics.from_fov(60.0, W, H)
        model = init_random_(YOLO11Seg(nc=5, scale="n"), torch.Generator().manual_seed(0))
        model.set_dtype(getattr(torch, dtype))
        rng = np.random.default_rng(0)
        self.color = torch.from_numpy(rng.integers(0, 255, (H, W, 3), dtype=np.uint8)).to(
            self.device)
        (_, _, mesh_v, mesh_f, self.T0, _, self.depth,
         self.sil) = make_light_scene(self.intr, rng, self.device)
        self.frame = FusedFrame(model, mesh_v, mesh_f, self.intr, win_hw="auto", imgsz=imgsz,
                                max_det=32, device=self.device)
        self.win = window_dims(self.intr.scaled(RENDER_DOWNSCALE), "auto")

    def draws(self, i: int) -> dict:
        """Frame ``i``'s samplers' numbers, from a generator seeded ``i``."""
        from ..pipeline.tracking import step_draws

        gen = torch.Generator(device=self.device).manual_seed(i)
        return step_draws(self.intr, self.win, 0, gen, self.device)

    @torch.no_grad()
    def prefix(self, k: int, i: int = 0):
        """Stages 0..k of frame ``i``; returns stage k's output (prefix 10:
        the ``TrackResult``)."""
        from .. import chains
        from ..pipeline.tracking import track_program

        draws = self.draws(i)
        if k == 0:
            return draws
        out = list(itertools.islice(self.frame.detect_stages(self.color, conf=0.25),
                                    min(k, DETECT_STAGES)))[-1]
        if k <= DETECT_STAGES:
            return out
        _, mask = out
        f = self.frame
        # FusedFrame's call: the true silhouette OR-ed into the detected mask
        return chains.run(track_program(
            f.mesh_v, f.mesh_f, mask | self.sil, self.depth, self.T0, self.intr, 0.01, self.win,
            5e-5, f.target_pts, f.icp_variant, f.icp_kernel, draws,
            stages=k - DETECT_STAGES))

    def check_prefix(self, i: int = 0) -> dict:
        """Prefix 10 of frame ``i`` against ``FusedFrame`` on the same frame
        and draws: max abs differences of pose and fitness, both n_iters."""
        got = self.prefix(len(STAGES) - 1, i)
        ref = self.frame(self.color, self.depth, self.T0, conf=0.25, icp_dist=0.01,
                         mask_union=self.sil, draws=self.draws(i))
        return {"pose_max_abs": float((got.T - ref.T).abs().max()),
                "fitness_abs": float((got.fitness - ref.fitness).abs()),
                "n_iters": [got.n_iters, ref.n_iters], "ok": bool(ref.ok)}


def run(args, prof: Profile | None = None) -> dict:
    """Time every prefix, then trace it on the card; returns the JSON
    line's dict, with the timed frames' K1 / K2 launches by prefix (the
    ``prefix_*`` totals), prefix 10's ``n_iters`` frame by frame, and
    prefix 10 held against ``FusedFrame`` on frame 0 (``check_prefix``).
    ``prof``: the frame to profile (default: built from ``args``)."""
    from ..geom3d import fused_nn as fnn
    from ..render import raster as rs
    from ..utils.profiling import device_activity, time_calls

    if prof is None:
        W, H = (int(v) for v in args.res.lower().split("x"))
        prof = Profile(args.device, args.dtype, (W, H), args.imgsz)
    dev = prof.device
    on_card = dev.type == "cuda"
    print(f"device: {torch.cuda.get_device_name(dev) if on_card else 'cpu'}", flush=True)
    cum, k1, k2, kernels, busy, n_iters = [], [], [], [], [], []

    def reset():
        fnn.fused_nn_stats.launches = rs.raster_stats.launches = 0
        n_iters.clear()

    for k, name in enumerate(STAGES):
        if k == len(STAGES) - 1:
            fn = lambda i: n_iters.append(prof.prefix(k, i).n_iters)  # noqa: E731
        else:
            fn = lambda i: prof.prefix(k, i)  # noqa: E731
        cum.append(time_calls(fn, args.frames, dev, after_warm=reset))
        k1.append(fnn.fused_nn_stats.launches)
        k2.append(rs.raster_stats.launches)
        nk, ms = device_activity(lambda i: prof.prefix(k, i), 1) if on_card else (None, None)
        kernels.append(nk)
        busy.append(ms)
        print(f"prefix {k:2d} ({name:>21}): {cum[-1]:9.3f} ms/frame, K1 {k1[-1]}, K2 {k2[-1]} "
              f"launches in {args.frames} frames", flush=True)
    if on_card and not busy[-1] > 0.0:
        raise SystemExit("profile_stages: torch.profiler recorded no device time on the card "
                         "(CUPTI tracing failed); no device figures to report")

    def marginal(xs):
        return [None if x is None else (x - (xs[i - 1] if i else 0.0)) for i, x in enumerate(xs)]

    per = lambda xs: [x / args.frames for x in xs]  # noqa: E731
    m_ms, m_k, m_busy, m_k1, m_k2 = (marginal(x) for x in (cum, kernels, busy, per(k1), per(k2)))
    print("\nmarginal per-stage cost (ms a frame: host and device; kernels and device ms "
          "from the trace; K1 / K2 launches a frame):")
    for i, name in enumerate(STAGES):
        kk = "-" if m_k[i] is None else f"{m_k[i]:8.1f}"
        bb = "-" if m_busy[i] is None else f"{m_busy[i]:8.4f}"
        print(f"  {name:>21}: {m_ms[i]:9.3f} ms  kernels {kk}  device {bb} ms  "
              f"K1 {m_k1[i]:6.2f}  K2 {m_k2[i]:4.2f}")

    def by(xs):
        return {n: (None if x is None else round(x, 4)) for n, x in zip(STAGES, xs)}

    return {"total_ms": round(cum[-1], 3), "stages_ms": by(m_ms),
            "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "frames": args.frames, "dtype": args.dtype, "kernels": by(m_k),
            "device_ms": by(m_busy), "k1_launches": by(m_k1), "k2_launches": by(m_k2),
            "prefix_ms": by(cum), "prefix_k1_launches": dict(zip(STAGES, k1)),
            "prefix_k2_launches": dict(zip(STAGES, k2)), "icp_n_iters": list(n_iters),
            "prefix10_vs_fused_frame": prof.check_prefix(0)}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    out = run(args)
    print(json.dumps({k: v for k, v in out.items() if k != "icp_n_iters"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
