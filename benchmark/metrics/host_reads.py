"""Device-to-host reads a request in the traced slice, as the program counts
them (``host_reads``, one at each read: ICP loop tests, the NMS fixpoint,
the search's reads, the results brought to the host);
``host_reads.frame`` and ``host_reads.init`` read it in the cells they
list. ``program_session`` is the program's own record of the slice, which
the other readers of the program's spans share."""


def program_session(r):
    """``profiling.last_session()`` of the traced slice, or None: off the
    card, with a program that records no spans, or when its store dropped
    records."""
    if not r.events or not r.slice_steps:
        return None
    try:
        from poseestimator_tpu_torch.utils import profiling
    except ImportError:
        return None
    last = getattr(profiling, "last_session", None)
    s = last() if last is not None else None
    if s is None or s.dropped or s.requests < r.slice_steps:
        return None
    return s


def read(r):
    s = program_session(r)
    return None if s is None else s.counter("host_reads") / r.slice_steps
