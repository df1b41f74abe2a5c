"""Work of the block-arrow Cholesky factor and resolve, from the pattern.

The engine's LHS is M × M per env (M = 75 DoF) and zero outside a
block-arrow pattern: dense diagonal blocks (the limbs), and a trailing
shared block coupled to every limb. The factor has no fill-in outside that
pattern. Counts per env (the same arithmetic as the kernel table's bounds):
  factor   Σ over columns k of 1 + r + r(r + 1), r the in-pattern entries
           below the diagonal (a square root, r divides, r(r + 1)/2
           multiply-subtracts); bytes: A's in-pattern lower triangle read,
           the dense L written, float32
  resolve  two triangular sweeps, 2(2·offdiag + M); bytes: L's in-pattern
           lower triangle and b read, x written
"""
from __future__ import annotations

import numpy as np


def pattern(limbs, s_lo: int, M: int) -> np.ndarray:
    keep = np.zeros((M, M), bool)
    for lo, hi in limbs:
        keep[lo:hi, lo:hi] = True
        keep[s_lo:M, lo:hi] = True
    keep[s_lo:M, s_lo:M] = True
    return np.tril(keep)


def work(limbs, s_lo: int, M: int) -> dict:
    """Per env: flops and bytes of the factor and of one resolve."""
    p = pattern(limbs, s_lo, M)
    n = int(p.sum())
    factor = 0
    for k in range(M):
        r = int(p[k + 1:, k].sum())
        factor += 1 + r + r * (r + 1)
    return {"factor_flops": factor, "factor_bytes": (n + M * M) * 4,
            "resolve_flops": 2 * (2 * (n - M) + M),
            "resolve_bytes": (n + 2 * M) * 4}


def roofline_share(profile, work: dict, kind: str, kernel) -> float | None:
    """100 × the least time of the profiled unit's launches of `kind`
    ("factor" or "resolve": the larger of its bytes at the HBM rate and its
    flops at the float32 rate, over the step's envs) over the device time of
    the kernel whose name `kernel` (a regex) matches; None where the unit
    launched no such kernel."""
    from .peaks import F32_FLOP_S, HBM_BYTES_S
    secs, launches = profile.op_seconds(kernel)
    if not launches:
        return None
    least = work["envs"] * max(work[kind + "_bytes"] / HBM_BYTES_S,
                               work[kind + "_flops"] / F32_FLOP_S)
    return 100.0 * launches * least / secs


def gram_flops(rows: int, M: int) -> int:
    """Per env: the lower triangle of the weighted Gram RᵀWR, rows × M."""
    return rows * M * (M + 1)
