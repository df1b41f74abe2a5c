"""Checkpoint save and load for trees of arrays (port of
emloco_tpu/utils/checkpoint.py).

The on-disk format is the JAX package's: a pickle of {"tree": the tree with
every leaf a numpy array, "metadata": a dict}. A tree is nested dicts, lists
and tuples; tensors are copied to the host as numpy arrays. A valuenet is
stored in the flax layout (`{"params": {"fc1": {"kernel" (in, out),
"bias"}, …}}`, `convert.valuenet_params`), so that each package loads the
other's valuenet file; a predictor's params are stored in the flax layout
too. A policy file holds the flax-layout params (`convert.agent_params`)
with its norms and Adam state as plain dicts: the port reads policy files
of both packages, but the JAX package, which expects its RunningNorm and
optax states there, reads only the port's valuenet and predictor files
(their params), not its policy files.

Reading never imports the JAX package, jax, flax or optax. A file the JAX
package wrote names four of their classes (a policy's RunningNorm and
optax states, a predictor's schedule state); `load_pytree` unpickles with
`Unpickler`, which maps those four names to the plain stand-ins below,
lets through numpy's array reconstruction and the builtins a tree of
dicts, tuples and arrays needs, and raises `pickle.UnpicklingError` naming
any other class.
"""
from __future__ import annotations

import os
import pickle
import re
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from .. import convert


class RunningNormFields:
    """The JAX package's RunningNorm as its fields: `mean`, `var`, `count`.
    Pickle restores the frozen flax dataclass by NEWOBJ with no arguments
    and then BUILD with its field dict, which lands in `__dict__` here."""

    def __init__(self, mean=None, var=None, count=None):
        self.mean, self.var, self.count = mean, var, count


class _EmptyState(tuple):
    """optax's EmptyState, which carries nothing: read as ()."""

    def __new__(cls, *args):
        return ()


class ScaleByAdamState(NamedTuple):
    """optax's scale_by_adam state: the step count and the moment trees."""
    count: Any
    mu: Any
    nu: Any


class ScaleByScheduleState(NamedTuple):
    """optax's scale_by_schedule state: the step count."""
    count: Any


STAND_INS = {
    ("emloco_tpu.learning.running_norm", "RunningNorm"): RunningNormFields,
    ("optax._src.base", "EmptyState"): _EmptyState,
    ("optax._src.transform", "ScaleByAdamState"): ScaleByAdamState,
    ("optax._src.transform", "ScaleByScheduleState"): ScaleByScheduleState,
}
# numpy's array and scalar reconstruction (numpy 1 and 2 module paths;
# `_frombuffer` and bytearray for pickle protocol 5, `_codecs.encode` for
# array bytes in protocols 0-2), and copyreg's reconstructor of protocols 0
# and 1 with its base
_ALLOWED = {(m + mod, n) for m in ("numpy.core", "numpy._core")
            for mod, n in ((".multiarray", "_reconstruct"),
                           (".multiarray", "scalar"),
                           (".numeric", "_frombuffer"))} | {
    ("numpy", "ndarray"), ("numpy", "dtype"), ("builtins", "bytearray"),
    ("_codecs", "encode"), ("copyreg", "_reconstructor"),
    ("builtins", "object")}


class Unpickler(pickle.Unpickler):
    """Reads the trees either package writes, importing neither jax nor
    the JAX package; every class outside STAND_INS and the allowed numpy,
    copyreg and builtins names is refused."""

    def find_class(self, module, name):
        if (module, name) in STAND_INS:
            return STAND_INS[module, name]
        if (module, name) in _ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint names {module}.{name}, which this loader does not "
            "read (only trees of dicts, lists, tuples and numpy arrays, and "
            "the JAX package's RunningNorm and optax states)")


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


def load_pickle(path: str):
    """The object pickled at `path`, read with `Unpickler`."""
    with open(path, "rb") as f:
        return Unpickler(f).load()


# leading bytes of the compressed files joblib writes (zlib, gzip, bz2, xz,
# lzma, lz4)
_COMPRESSED = (b"\x78", b"\x1f\x8b", b"BZh", b"\xfd7zXZ", b"\x5d\x00\x00",
               b"\x04\x22\x4d\x18")


def load_data_pickle(path: str):
    """A data file written with `pickle` (a motion pickle, a trajectory
    bank), read with `Unpickler`. A joblib file, compressed or not, raises
    ValueError: the port reads no joblib (re-save it with pickle.dump)."""
    with open(path, "rb") as f:
        head = f.read(6)
    if head.startswith(_COMPRESSED):
        raise ValueError(f"{path} is compressed (a joblib dump?); the port "
                         "reads plain pickle files only: re-save it with "
                         "pickle.dump")
    try:
        return load_pickle(path)
    except pickle.UnpicklingError as e:
        if "joblib" in str(e):
            raise ValueError(f"{path} is a joblib file; the port reads plain "
                             "pickle files only: re-save it with "
                             "pickle.dump") from e
        raise


def load_pytree(path: str):
    """(tree of numpy arrays, metadata) from a file either package wrote."""
    blob = load_pickle(path)
    return blob["tree"], blob.get("metadata", {})


def load_valuenet(path: str, device) -> dict:
    """A valuenet file of either package as ValuePoseNet's state_dict on
    `device`."""
    tree, _ = load_pytree(path)
    return {k: v.to(device)
            for k, v in convert.valuenet_state_dict(tree).items()}


def save_valuenet(path: str, vnet_params: dict,
                  config: Optional[dict] = None):
    """Valuenet-only export from ValuePoseNet's state_dict, in the flax
    layout (reference *_valuenet_*.pth, common_agent.py:252,264)."""
    save_pytree(path, convert.valuenet_params(vnet_params),
                {"kind": "valuenet", "config": config})


def save_policy(path: str, ts, epoch: int):
    """A policy file as `cmd_train_policy` writes one (cli/run.py:166-171):
    the agent's params in the flax layout, its three norms and its Adam
    state as dicts of numpy arrays, the metadata `epoch`."""
    save_pytree(path, dict(
        params=convert.agent_params(ts.params),
        obs_norm=convert.running_norm_fields(ts.obs_norm),
        amp_norm=convert.running_norm_fields(ts.amp_norm),
        value_norm=convert.running_norm_fields(ts.value_norm),
        opt_state=convert.adam_fields(ts.opt_state)),
        metadata=dict(epoch=epoch))


def restore_policy(ts, tree, full: bool = True):
    """The TrainState `ts` with a policy file's params and obs / AMP norms
    (either package's file); with `full`, also its value norm and Adam
    state where the file holds them (older JAX files carry neither)."""
    dev = ts.obs_norm.mean.device
    ts = ts.replace(
        params={k: v.to(dev) for k, v in
                convert.agent_state_dict(tree["params"]).items()},
        obs_norm=convert.running_norm(tree["obs_norm"], dev),
        amp_norm=convert.running_norm(tree["amp_norm"], dev))
    if full and "value_norm" in tree:
        ts = ts.replace(value_norm=convert.running_norm(tree["value_norm"],
                                                        dev))
    if full and "opt_state" in tree:
        ts = ts.replace(opt_state=convert.adam_state(tree["opt_state"], dev))
    return ts


def checkpoint_epoch(path: str, metadata: Optional[dict] = None) -> int:
    """The absolute epoch a checkpoint was written after: its metadata's
    `epoch`, else the number in its file name (`_<epoch>.ckpt`), else −1
    (cli/run.py:136-145, :203-210)."""
    ep = int((metadata or {}).get("epoch", -1))
    if ep < 0:
        m = re.search(r"_(\d+)\.ckpt$", path)
        ep = int(m.group(1)) if m else -1
    return ep


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
