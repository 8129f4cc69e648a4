"""Record a camera stream in the replay layout (counterpart of
``poseestimator_tpu/camera/record.py``), the directory that
``apps/main_realsense --source replay:<dir>`` reads, in either package:
``color_{i:05d}.png`` (the BGR frame written as ``cv2.imwrite`` writes it),
``depth_{i:05d}.npy`` (float32 metres) and ``intrinsics.npy`` (the pickled
object array ``[K, width, height]``). K is written in float64 (the JAX
recorder writes ``Intrinsics.K``, float32), so that a replay's intrinsics
are the recorded camera's exactly: a float32-rounded focal length moves the
search's rounding, and a symmetric object's twin choice with it.

Run: ``python -m poseestimator_tpu_torch.camera.record --out DIR
[--frames N] [--device cuda]`` (a RealSense camera).
"""
from __future__ import annotations

import os

import numpy as np

from ..utils.image import write_image


def record(camera, out_dir: str, n_frames: int = 300, verbose: bool = True) -> int:
    """Pull up to ``n_frames`` from a camera source into ``out_dir``;
    returns the number of frames written (fewer when the source ends)."""
    os.makedirs(out_dir, exist_ok=True)
    intr = camera.intrinsics
    K = np.array([[intr.fx, 0.0, intr.cx], [0.0, intr.fy, intr.cy], [0.0, 0.0, 1.0]])
    np.save(os.path.join(out_dir, "intrinsics.npy"),
            np.array([K, intr.width, intr.height], dtype=object), allow_pickle=True)
    for i in range(n_frames):
        color = camera.get_rgbd()
        if color is None:
            return i
        write_image(os.path.join(out_dir, f"color_{i:05d}.png"), color)
        depth = camera.depth
        depth = depth.cpu().numpy() if hasattr(depth, "cpu") else np.asarray(depth)
        np.save(os.path.join(out_dir, f"depth_{i:05d}.npy"), depth.astype(np.float32))
        if verbose and i % 30 == 0:
            print(f"recorded {i} frames")
    return n_frames


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--frames", type=int, default=300)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from .source import RealSenseCamera

    cam = RealSenseCamera(device=args.device)
    try:
        n = record(cam, args.out, args.frames)
        print(f"wrote {n} frames to {args.out}")
    finally:
        cam.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
