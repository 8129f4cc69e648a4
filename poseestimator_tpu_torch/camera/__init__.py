"""Camera sources (RealSense, replay, synthetic), the depth filters
(counterpart of ``poseestimator_tpu/camera``) and the evaluation's
segmentation-error model of a mask."""
from .filters import hole_filling_filter, spatial_filter, temporal_filter
from .masks import degrade_mask
from .source import (
    PCD_CAPACITY,
    CameraSource,
    RealSenseCamera,
    ReplayCamera,
    SyntheticCamera,
)
