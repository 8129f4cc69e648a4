"""Host time a request spends issuing ICP's own arithmetic in the traced
slice: the self time of the program's ``icp`` spans (their K1 serves and
host reads are spans of their own, and excluded), in ms;
``icp_self_ms.frame`` and ``icp_self_ms.init`` read it in the cells they
list."""
from benchmark.metrics.host_reads import program_session


def read(r):
    s = program_session(r)
    if s is None:
        return None
    return float(s.self_ns()[s.named("icp")].sum()) / 1e6 / r.slice_steps
