"""Weights made by the benchmark from the seed, on the device, in two large
draws: one normal for every normal-initialized leaf and one uniform for
every uniform one. Both sides of the check get the same tensors.

A spec is a list of (name, shape, kind, scale):
  "normal"   N(0, 1) clipped to ±2, times √(scale / fan_in) / 0.8796 (the
             standard deviation of a normal truncated at ±2): flax's
             lecun-normal family
  "uniform"  U(−b, b) with b = scale / √fan_in, or b = √(6 / (fan_in +
             fan_out)) when scale is None (xavier-uniform)
  "embed"    N(0, scale²)
  "const"    every entry `scale`
fan_in is the last axis of a 2-d leaf (torch's (out, in) layout).
"""
from __future__ import annotations

import math

import torch

_TRUNC_STD = 0.87962566103423978


def make(spec, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n_norm = sum(math.prod(s) for _, s, k, _ in spec if k in ("normal",
                                                            "embed"))
    n_unif = sum(math.prod(s) for _, s, k, _ in spec if k == "uniform")
    normal = torch.randn(n_norm, generator=gen, device=device)
    unif = torch.rand(n_unif, generator=gen, device=device) * 2 - 1
    out, i, j = {}, 0, 0
    for name, shape, kind, scale in spec:
        n = math.prod(shape)
        if kind == "normal":
            std = math.sqrt(scale / shape[-1]) / _TRUNC_STD
            out[name] = normal[i:i + n].clamp(-2, 2).mul(std).view(shape)
            i += n
        elif kind == "embed":
            out[name] = normal[i:i + n].mul(scale).view(shape)
            i += n
        elif kind == "uniform":
            b = (math.sqrt(6.0 / (shape[0] + shape[-1])) if scale is None
                 else scale / math.sqrt(shape[-1]))
            out[name] = unif[j:j + n].mul(b).view(shape)
            j += n
        elif kind == "const":
            out[name] = torch.full(shape, float(scale), device=device)
        else:
            raise ValueError(f"unknown kind {kind!r} of {name}")
    return {k: v.clone() for k, v in out.items()}


def load_into(params: dict, made: dict) -> dict:
    """`made` in place of the program's `params`, after checking that the
    names and shapes agree."""
    if set(params) != set(made):
        raise ValueError("parameter names differ: "
                         f"{sorted(set(params) ^ set(made))[:8]}")
    for k, v in params.items():
        if tuple(v.shape) != tuple(made[k].shape):
            raise ValueError(f"{k}: {tuple(v.shape)} vs "
                             f"{tuple(made[k].shape)}")
    return {k: made[k].to(params[k].dtype) for k in params}
