"""The device's idle share of an epoch: 100 × (1 − the union of the
profiled epoch's device operations over the window's mean host time an
epoch, measured without the profiler)."""


def read(rec):
    p = rec.profile
    if p is None or not rec.units or "arrow" not in rec.counts:
        return None
    return 100.0 * (1.0 - p.busy_s() / (rec.window_s / rec.units))
