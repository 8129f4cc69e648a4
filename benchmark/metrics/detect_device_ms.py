"""Device time a frame of the detector in the traced slice: the device
events that start inside one of the program's ``detect`` spans, placed on
the trace's clock by the session's tie, in ms."""
import numpy as np

from benchmark.metrics.host_reads import program_session


def read(r):
    s = program_session(r)
    if s is None:
        return None
    idx = s.named("detect")
    if not len(idx):
        return None
    ev = sorted((start, dur) for _, start, dur in r.events)
    starts = np.array([e[0] for e in ev], np.int64)
    durs = np.array([e[1] for e in ev], np.int64)
    lo = np.searchsorted(starts, s.start_ns[idx] + s.tie_ns, side="left")
    hi = np.searchsorted(starts, s.end_ns[idx] + s.tie_ns, side="left")
    ends = np.concatenate([[0], np.cumsum(durs)])
    return float((ends[hi] - ends[lo]).sum()) / 1e6 / r.slice_steps
