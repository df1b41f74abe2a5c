"""The block-arrow resolve's share of its roofline, as the factor's: its
bytes and flops (`counts.arrow`) over its kernel's device time in the
profiled epoch."""
import re

from port_bench.counts import arrow

KERNEL = re.compile(r"(^|[^A-Za-z0-9_])resolve_kernel")


def read(rec):
    if rec.profile is None or "arrow" not in rec.counts:
        return None
    return arrow.roofline_share(rec.profile, rec.counts["arrow"], "resolve",
                                KERNEL)
