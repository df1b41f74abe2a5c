"""Checkpoint save and load for trees of arrays (port of
emloco_tpu/utils/checkpoint.py).

The on-disk format is the JAX package's: a pickle of {"tree": the tree with
every leaf a numpy array, "metadata": a dict}. A tree is nested dicts, lists
and tuples; tensors are copied to the host as numpy arrays. A valuenet is
stored in the flax layout (`{"params": {"fc1": {"kernel" (in, out),
"bias"}, …}}`, `convert.valuenet_params`), so that each package loads the
other's file.
"""
from __future__ import annotations

import os
import pickle
import re
from typing import Any, Optional

import numpy as np
import torch

from .. import convert


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return None if tree is None else np.asarray(tree)


def save_pytree(path: str, tree: Any, metadata: Optional[dict] = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"tree": _to_host(tree), "metadata": metadata or {}}, f)


def load_pytree(path: str):
    """(tree of numpy arrays, metadata). Unpickling runs code the file
    names: load only files this package or the JAX package wrote."""
    with open(path, "rb") as f:
        blob = pickle.load(f)
    return blob["tree"], blob.get("metadata", {})


def save_valuenet(path: str, vnet_params: dict,
                  config: Optional[dict] = None):
    """Valuenet-only export from ValuePoseNet's state_dict, in the flax
    layout (reference *_valuenet_*.pth, common_agent.py:252,264)."""
    save_pytree(path, convert.valuenet_params(vnet_params),
                {"kind": "valuenet", "config": config})


def latest_checkpoint(directory: str, pattern: str = r".*_(\d+)\.ckpt"):
    """The newest checkpoint in `directory` by epoch number, or None
    (reference --epoch -1 resolution, utils/config.py:109-116)."""
    if not os.path.isdir(directory):
        return None
    best, best_ep = None, -1
    for f in os.listdir(directory):
        m = re.match(pattern, f)
        if m and int(m.group(1)) > best_ep:
            best_ep = int(m.group(1))
            best = os.path.join(directory, f)
    return best
