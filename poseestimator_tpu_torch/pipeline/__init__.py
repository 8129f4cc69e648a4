"""Per-frame pipeline: object windows, the detector, the template search,
the track step and the tracking FSM."""
from .detector import Detector
from .pose_estimator import PoseEstimator
from .tracking import FrameResult, Tracker
