"""K1's share of its roofline: the least time of the nearest-neighbour
queries that the traced slice ran (``ops/k1_nn.py``) over the device time
of their kernels; ``k1_roofline.frame`` and ``k1_roofline.init`` read it in
the cells they list."""
from benchmark.harness.readings import roofline_pct


def read(r):
    return roofline_pct(r, "k1_nn")
