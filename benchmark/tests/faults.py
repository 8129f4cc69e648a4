"""Faults planted under a cell's timed path, one function each: given a
pytest ``monkeypatch``, it breaks the port where the fault would arise.
``FAULTS`` maps a fault's name to the cell it breaks and that function.
The CPU tests plant them in the small copies of the cells, the card's test
in the cells at their own size."""
from __future__ import annotations

import numpy as np
import torch


def state_unchanged(mp) -> None:
    """The fused frame returns the pose it was given."""
    from poseestimator_tpu_torch.pipeline import tracking

    real = tracking.FusedFrame.__call__

    def frozen(self, color, depth, T, *a, **k):
        res = real(self, color, depth, T, *a, **k)
        res.T = T
        return res

    mp.setattr(tracking.FusedFrame, "__call__", frozen)


def half_batch_frozen(mp) -> None:
    """The batched track step returns half of its tracks' poses as given."""
    from poseestimator_tpu_torch.pipeline import multi_tracking

    real = multi_tracking.track_step_batched

    def half(mesh_v, mesh_f, masks, depth, Ts, *a, **k):
        res = real(mesh_v, mesh_f, masks, depth, Ts, *a, **k)
        keep = (Ts.shape[0] + 1) // 2
        res.T = torch.cat([res.T[:keep], Ts[keep:]])
        return res

    mp.setattr(multi_tracking, "track_step_batched", half)


def tracks_not_stepped(mp) -> None:
    """Half of the matched tracks are left out of the batched step (neither
    moved nor aged)."""
    from poseestimator_tpu_torch.pipeline import multi_tracking

    real = multi_tracking.MultiTracker._update

    def half(self, matched, masks):
        real(self, matched[: (len(matched) + 1) // 2], masks)

    mp.setattr(multi_tracking.MultiTracker, "_update", half)


def answer_shifted(mp) -> None:
    """The search's winning pose moved 2 cm where it is produced."""
    from poseestimator_tpu_torch.pipeline import pose_estimator

    real = pose_estimator.PoseEstimator.find_best_template_candidates

    def shifted(self, *a, **k):
        H, src, cands = real(self, *a, **k)
        H = np.array(H, copy=True)
        H[:3, 3] += 0.02
        return H, src, cands

    mp.setattr(pose_estimator.PoseEstimator, "find_best_template_candidates", shifted)


def detector_altered(mp) -> None:
    """Every class logit of the detector's forward raised by 0.01."""
    from poseestimator_tpu_torch.models.yolo import model

    real = model.YOLO11Seg.forward

    def bent(self, x):
        out = real(self, x)
        out["cls"] = tuple(c + 0.01 for c in out["cls"])
        return out

    mp.setattr(model.YOLO11Seg, "forward", bent)


FAULTS = {
    "state_unchanged": ("d435_single.track", state_unchanged),
    "half_batch_frozen": ("lmo8_multi.track", half_batch_frozen),
    "tracks_not_stepped": ("lmo8_multi.track", tracks_not_stepped),
    "answer_shifted": ("d435_single.init", answer_shifted),
    "detector_altered.track": ("d435_single.track", detector_altered),
    "detector_altered.multi": ("lmo8_multi.track", detector_altered),
}
