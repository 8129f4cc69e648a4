"""Device kernels a frame in the traced slice, copies and fills not counted
(as ``utils/profiling.py::device_activity`` counts them)."""
from benchmark.harness.readings import launches as read  # noqa: F401
