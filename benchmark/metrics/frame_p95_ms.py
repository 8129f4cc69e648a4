"""95th percentile of the host time of a frame (each ends in a
synchronise), over the frames before the traced slice."""
import statistics


def read(r):
    if len(r.step_s) < 20:
        return None
    return statistics.quantiles(r.step_s, n=20)[18] * 1e3
