"""Tensor dataclasses: the port's stand-in for flax's struct.PyTreeNode."""
from __future__ import annotations

import dataclasses

import torch


class TensorStruct:
    """Mixin for dataclasses whose fields are tensors (or nested structs)."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def map_tensors(self, fn):
        """New instance with `fn` applied to every tensor field and to the
        tensors of dict fields (recursing into nested TensorStructs; other
        fields are kept as they are)."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                v = fn(v)
            elif isinstance(v, TensorStruct):
                v = v.map_tensors(fn)
            elif isinstance(v, dict):
                v = {k: fn(t) for k, t in v.items()}
            out[f.name] = v
        return dataclasses.replace(self, **out)

    def to(self, device):
        return self.map_tensors(lambda t: t.to(device))
