"""Kernel launches per profiled train step: the trace's device operations
that are kernels (copies and fills left out)."""


def read(rec):
    p = rec.profile
    if p is None or "profiled_units" not in rec.counts:
        return None
    n = sum(1 for name, _, _ in p.ops
            if not name.startswith(("Memcpy", "Memset")))
    return n / rec.counts["profiled_units"]
