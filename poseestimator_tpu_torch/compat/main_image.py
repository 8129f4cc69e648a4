"""``python -m poseestimator_tpu_torch.compat.main_image`` runs the port's
the offline single-frame pose estimate (``apps/main_image.py``)."""
from ..apps.main_image import build_parser, main

__all__ = ["build_parser", "main"]

if __name__ == "__main__":
    import sys

    sys.exit(main())
