"""``from ...EstimHelpers.PoseEstimator import PoseEstimator``: the port's
template-search estimator."""
from ...pipeline.pose_estimator import PoseEstimator

__all__ = ["PoseEstimator"]
