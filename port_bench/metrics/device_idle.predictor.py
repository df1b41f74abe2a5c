"""The device's idle share of a train step: 100 × (1 − the union of the
profiled steps' device operations, per step, over the window's mean host
time a step, measured without the profiler)."""


def read(rec):
    p = rec.profile
    n = rec.counts.get("profiled_units")
    if p is None or not rec.units or not n:
        return None
    return 100.0 * (1.0 - p.busy_s() / n / (rec.window_s / rec.units))
