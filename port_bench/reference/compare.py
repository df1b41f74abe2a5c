"""The numbers the check compares with their limits. Each is a gap between
what the program produced and what the reference gives, as a share of the
reference's own scale, so that it reads the same at any size.
"""
from __future__ import annotations

import statistics

import torch

# a leaf whose reference gradient is under this share of the median leaf's
# is nought to rounding (a bias under a softmax, a dead unit): Adam moves it
# by round-off alone, so its change is left out
GRAD_FLOOR = 1e-3


def rel_max(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """max |prog − ref| over max |ref|."""
    prog, ref = prog.double(), ref.double()
    scale = float(ref.abs().max())
    return float((prog - ref).abs().max()) / max(scale, 1e-30)


def rel_scalar(prog: float, ref: float) -> float:
    return abs(float(prog) - float(ref)) / max(abs(float(ref)), 1e-30)


def norms(tree: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def moving_leaves(ref_grad: dict) -> list:
    """The leaves whose reference gradient is not nought to rounding."""
    n = norms(ref_grad)
    med = statistics.median(n.values())
    return [k for k, v in n.items() if v >= GRAD_FLOOR * med]


def leaf_gaps(prog: dict, ref: dict, keys) -> list:
    """Each leaf's gap, the norm of the program's leaf minus the
    reference's, over the larger of that leaf's reference norm and the
    median leaf's (some leaves are all but zero). A difference, not a
    difference of norms, so that a sign flipped or entries permuted within
    a leaf read as the gap they are."""
    rn = norms({k: ref[k] for k in keys})
    med = statistics.median(rn.values())
    return [float((prog[k].double() - ref[k].double()).norm())
            / max(rn[k], med, 1e-30) for k in keys]


def training(prog_losses, ref_losses, prog_m1: dict, ref_m1: dict,
             prog_change: dict, ref_change: dict, ref_grad1: dict) -> dict:
    """The training bullet's numbers: each step's loss (the worst of the
    first two, and of all), the first gradient as the optimizer got it
    (from its first moment after one step) by the worst leaf, and the
    parameters' change over the steps by the worst leaf and by the median
    leaf."""
    change = leaf_gaps(prog_change, ref_change, moving_leaves(ref_grad1))
    gaps = [rel_scalar(p, r) for p, r in zip(prog_losses, ref_losses)]
    return {
        "loss1_gap": gaps[0],
        "loss2_gap": max(gaps[:2]),
        "loss_gap": max(gaps),
        "grad1_gap": max(leaf_gaps(prog_m1, ref_m1, sorted(ref_m1))),
        "change_gap": max(change),
        "change_med_gap": statistics.median(change),
    }
