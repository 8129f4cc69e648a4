"""Camera-rate motion of the tracked scene.

``motion_delta`` is copied from ``poseestimator_tpu_torch/apps/_scene.py``
(itself the JAX package's ``tools/_scene.py``): one camera period, 0.01 rad
about the camera's z axis plus (2, 0, 1) mm. Applied on the left, it moves
every pose of the scene along an arc of radius ~0.2 m about a fixed point,
so a stream plays ``forward`` frames of it and then the same frames back:
the motion turns round and never jumps.
"""
from __future__ import annotations

import numpy as np


def motion_delta() -> np.ndarray:
    """One camera period of motion: 0.01 rad about z plus (2, 0, 1) mm."""
    c, s = np.cos(0.01), np.sin(0.01)
    d = np.eye(4, dtype=np.float32)
    d[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    d[:3, 3] = [0.002, 0.0, 0.001]
    return d


def stream_deltas(forward: int) -> list[np.ndarray]:
    """Scene motion of frames 0 .. forward - 1 (float64): the delta applied
    k times, the first frame's placed so that the middle frame of the arc
    sits where the scene was placed (the arc is centred on the view)."""
    d = motion_delta().astype(np.float64)
    ks = [np.linalg.matrix_power(d, k) for k in range(forward)]
    mid_inv = np.linalg.inv(ks[forward // 2])
    return [k @ mid_inv for k in ks]


def playback(n_frames: int, forward: int, phase: int) -> np.ndarray:
    """Indices into the ``forward`` rendered frames of a stream of
    ``n_frames``: forward then back, over and over, from ``phase``."""
    period = 2 * forward - 2
    k = (np.arange(n_frames) + phase) % period
    return np.where(k < forward, k, period - k)
