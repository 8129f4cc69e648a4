"""``from ...EstimHelpers.detection_utils import detect_mask``: the port's
stateless one-image mask."""
from ...pipeline.detector import detect_mask

__all__ = ["detect_mask"]
