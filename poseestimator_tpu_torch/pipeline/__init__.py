"""Per-frame pipeline: object windows, the detector, the template search,
the track step, the tracking FSM and multi-object tracking."""
from .detector import Detector
from .pose_estimator import PoseEstimator
from .tracking import FrameResult, Tracker
from .multi_tracking import MultiFrameResult, MultiTracker, TrackedObject
