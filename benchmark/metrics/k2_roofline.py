"""K2's share of its roofline: the least time of the rasters that the
traced slice ran (``ops/k2_raster.py``) over the device time of their
kernels; ``k2_roofline.frame`` and ``k2_roofline.init`` read it in the
cells they list."""
from benchmark.harness.readings import roofline_pct


def read(r):
    return roofline_pct(r, "k2_raster")
