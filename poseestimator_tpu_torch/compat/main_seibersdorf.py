"""``python -m poseestimator_tpu_torch.compat.main_seibersdorf`` runs the port's
the LiDAR + RGB pose estimate (``apps/main_seibersdorf.py``)."""
from ..apps.main_seibersdorf import build_parser, main

__all__ = ["build_parser", "main"]

if __name__ == "__main__":
    import sys

    sys.exit(main())
