"""``python -m poseestimator_tpu_torch.compat.main_realsense`` runs the port's
the realtime tracker (``apps/main_realsense.py``)."""
from ..apps.main_realsense import build_parser, main

__all__ = ["build_parser", "main"]

if __name__ == "__main__":
    import sys

    sys.exit(main())
