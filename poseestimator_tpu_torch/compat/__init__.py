"""The reference package layout on the port: the twin of the JAX package's
``pose_estimator`` namespace. The reference is imported and run as
``pose_estimator.*`` (``python -m pose_estimator.main_realsense``); here the
same module paths and call signatures live under
``poseestimator_tpu_torch.compat`` and forward to the port:

    python -m poseestimator_tpu_torch.compat.main_realsense --headless ...
    from poseestimator_tpu_torch.compat.EstimHelpers.Detector import Detector

The free functions take and return numpy, as the reference's do, and run
on the card unless the caller passes ``device="cpu"``; the classes are the
port's own (each takes ``device=``).
"""

__version__ = "0.1.0"
