"""The block-arrow factor's share of its roofline: the least time the
problem allows (the larger of its bytes at the HBM rate and its flops at
the float32 rate, each launch over the step's N envs; `counts.arrow`)
over the device time of the factor's kernel in the profiled epoch."""
import re

from port_bench.counts import arrow

KERNEL = re.compile(r"(^|[^A-Za-z0-9_])factor_kernel")


def read(rec):
    if rec.profile is None or "arrow" not in rec.counts:
        return None
    return arrow.roofline_share(rec.profile, rec.counts["arrow"], "factor",
                                KERNEL)
