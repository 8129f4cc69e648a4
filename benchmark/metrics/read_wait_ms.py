"""Host time a request spends in the program's device-to-host reads in the
traced slice: the summed duration of its ``read`` spans, in ms;
``read_wait_ms.frame`` and ``read_wait_ms.init`` read it in the cells they
list."""
from benchmark.metrics.host_reads import program_session


def read(r):
    s = program_session(r)
    if s is None:
        return None
    return float(s.duration_ns()[s.named("read")].sum()) / 1e6 / r.slice_steps
