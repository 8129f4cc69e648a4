"""The whole step's share of the H100's float32 peak: every counted op's
operations a request in the traced slice (the detector's forward, K1's
pairs, K2's pairs) times the requests before the slice, over that host
time at 67 TFLOP/s; ``mfu.frame`` and ``mfu.init`` read it in the cells they
list."""
from benchmark.harness.readings import mfu_pct as read  # noqa: F401
