"""Adam and its schedules as optax defines them, on dicts of tensors.

Adam: b1 0.9, b2 0.999, eps 1e-8; m ← b1·m + (1−b1)·g, v ← b2·v +
(1−b2)·g², u = (m / (1−b1ᵗ)) / (√(v / (1−b2ᵗ)) + eps). The step is
p ← p − lr_t·u (plus lr_t·wd·p under AdamW), lr_t at the count before the
step. Clipping by global norm scales by max/‖g‖ when ‖g‖ ≥ max. A step
whose gradient holds a non-finite number is dropped whole.
"""
from __future__ import annotations

import math

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def zeros_state(params: dict) -> dict:
    return {"count": 0, "m": {k: torch.zeros_like(v) for k, v in
                              params.items()},
            "v": {k: torch.zeros_like(v) for k, v in params.items()}}


def clip_global(grads: dict, max_norm: float) -> dict:
    norm = math.sqrt(sum(float((g.double() ** 2).sum())
                         for g in grads.values()))
    if norm < max_norm:
        return grads
    return {k: g * (max_norm / norm) for k, g in grads.items()}


def step(params: dict, grads: dict, state: dict, lr: float,
         weight_decay: float = 0.0):
    """(params, state) after one Adam(W) step at rate `lr`."""
    if not all(bool(torch.isfinite(g).all()) for g in grads.values()):
        return params, state
    t = state["count"] + 1
    m = {k: B1 * state["m"][k] + (1 - B1) * g for k, g in grads.items()}
    v = {k: B2 * state["v"][k] + (1 - B2) * g * g for k, g in grads.items()}
    out = {}
    for k, p in params.items():
        u = (m[k] / (1 - B1 ** t)) / (torch.sqrt(v[k] / (1 - B2 ** t)) + EPS)
        out[k] = p - lr * (u + weight_decay * p)
    return out, {"count": t, "m": m, "v": v}


def staircase_decay(count: int, lr: float, transition: int,
                    decay: float) -> float:
    """optax.exponential_decay(..., staircase=True)."""
    return lr * decay ** (count // transition)


def warmup_cosine(count: int, init: float, peak: float, warmup: int,
                  total: int, end: float) -> float:
    """optax.warmup_cosine_decay_schedule: linear to `peak` over `warmup`
    steps, then a cosine to `end` over the remaining total − warmup."""
    if count < warmup:
        return init + (peak - init) * count / warmup
    c = min(count - warmup, total - warmup)
    cos = 0.5 * (1 + math.cos(math.pi * c / (total - warmup)))
    alpha = end / peak
    return peak * ((1 - alpha) * cos + alpha)
