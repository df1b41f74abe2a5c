"""The crowd observation's share of its roofline: its least bytes (the
output written once, the inputs read once; `counts.crowd`, over the rows
and calls the program's host counters `CROWD_COUNTS` saw in the profiled
epoch) at the HBM rate over the device time of the operations inside the
benchmark's `crowd.group_obs` and `crowd.velocity_map` spans of that
epoch. The driver drains the device before each such call and the span
synchronizes at its end, so those operations are the kernels the call
launched, whatever implements it. None in a program without the
counters."""
from port_bench.counts.peaks import HBM_BYTES_S

SPANS = ("crowd.group_obs", "crowd.velocity_map")


def read(rec):
    p, c = rec.profile, rec.counts.get("crowd_obs")
    if p is None or not c:
        return None
    spans = [(s, e) for n, s, e in p.spans if n in SPANS]
    ns = sum(d for _, t, d in p.ops if any(s <= t < e for s, e in spans))
    if not ns:
        return None
    return 100.0 * c["bytes"] / HBM_BYTES_S / (ns * 1e-9)
