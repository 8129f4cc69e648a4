"""``from ...EstimHelpers.RealSenseClass import RealSenseCamera``: the port's
RealSense source."""
from ...camera.source import RealSenseCamera

__all__ = ["RealSenseCamera"]
