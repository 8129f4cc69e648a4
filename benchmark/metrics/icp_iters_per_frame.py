"""ICP iterations a frame, from the program's own returns: the mean of
``FusedResult.n_iters``, or of the largest ``BatchedTrackResult.n_iters`` of
each batched step."""


def read(r):
    it = r.counters.get("icp_iters")
    return sum(it) / len(it) if it else None
