"""Device time of the profiled train steps' operations, per step (ms):
the sum of their lengths in the trace."""


def read(rec):
    p = rec.profile
    if p is None or "profiled_units" not in rec.counts:
        return None
    return sum(d for _, _, d in p.ops) * 1e-6 / rec.counts["profiled_units"]
