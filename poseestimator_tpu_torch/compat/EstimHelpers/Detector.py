"""``from ...EstimHelpers.Detector import Detector``: the port's detector."""
from ...pipeline.detector import Detector

__all__ = ["Detector"]
