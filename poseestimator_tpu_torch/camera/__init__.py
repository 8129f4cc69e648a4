"""Camera sources (RealSense, replay, synthetic) and the depth filters
(counterpart of ``poseestimator_tpu/camera``)."""
from .filters import hole_filling_filter, spatial_filter, temporal_filter
from .source import (
    PCD_CAPACITY,
    CameraSource,
    RealSenseCamera,
    ReplayCamera,
    SyntheticCamera,
)
