"""Carry weights and state from the JAX package into this one.

Every function takes the JAX package's object as a *numpy* pytree — the
caller converts its leaves first, e.g. `jax.tree.map(np.asarray, obj)` — and
reads it by field name, so this module imports neither jax nor emloco_tpu.
Static fields (a heightfield's cell and origin) come across as they are.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import device as _device
from .envs.pedestrian_terrain import EnvState
from .kinematics.body_model import BodyParams
from .kinematics.motion_lib import MotionLib
from .learning.amp_agent import AdamState
from .learning.running_norm import RunningNorm
from .physics.reduced import Model, PhysicsState
from .physics.terrain import Heightfield


def tensor(a, device=None) -> torch.Tensor | None:
    """numpy array → tensor of the same dtype on `device`."""
    if a is None:
        return None
    return torch.as_tensor(np.array(a), device=_device.resolve(device))


def _fields(cls, src, device, **override):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in override:
            kw[f.name] = override[f.name]
        else:
            kw[f.name] = tensor(getattr(src, f.name, None), device)
    return cls(**kw)


def heightfield(hf, device=None) -> Heightfield:
    return Heightfield(
        heights=tensor(hf.heights, device), cell=float(hf.cell),
        origin=tuple(float(o) for o in hf.origin),
        spawnable_xy=tensor(hf.spawnable_xy, device),
        corner_tex=tensor(hf.corner_tex, device))


def body_params(p, device=None) -> BodyParams:
    return _fields(BodyParams, p, device)


def model(m, device=None) -> Model:
    return Model(params=body_params(m.params, device),
                 com_off=tensor(m.com_off, device),
                 anchor_c=tensor(m.anchor_c, device))


def motion_lib(lib, device=None) -> MotionLib:
    return _fields(MotionLib, lib, device)


def physics_state(st, device=None) -> PhysicsState:
    return _fields(PhysicsState, st, device)


def env_state(st, generator: torch.Generator, device=None) -> EnvState:
    """Every EnvState field but the JAX rng key, which has no torch
    counterpart: the converted state draws from `generator` instead. The
    hard-negative fields come across where the state has them (None
    otherwise)."""
    return _fields(EnvState, st, device,
                   physics=physics_state(st.physics, device), rng=generator)


def running_norm(rn, device=None) -> RunningNorm:
    return _fields(RunningNorm, rn, device)


_ACTOR = (("task_mlp_", "actor_mlp_", "point_net_", "cnn_"),
          ("mu", "cnn_proj"))
_ALL_HEADS = (("task_mlp_", "actor_mlp_", "critic_mlp_", "disc_mlp_",
               "task_value_mlp_", "point_net_", "cnn_"),
              ("mu", "value", "disc_logits", "value_logits", "cnn_proj"))


def _state_dict(params, mlps, dense) -> dict:
    """flax params → a state_dict of the layers named by the prefixes `mlps`
    (`actor_mlp_1` → `actor_mlp.1`, `cnn_0` → `cnn.0`) and the single layers
    `dense`, with log_sigma where the tree has one. Flax Dense kernels are
    (in, out), nn.Linear weights (out, in); flax Conv kernels are HWIO,
    nn.Conv2d weights OIHW."""
    p = params.get("params", params)
    sd = ({"log_sigma": torch.as_tensor(np.array(p["log_sigma"]))}
          if "log_sigma" in p else {})
    for name, layer in p.items():
        if name in dense:
            key = name
        elif name.startswith(mlps):
            head, idx = name.rsplit("_", 1)
            key = f"{head}.{idx}"
        else:
            continue
        kernel = np.array(layer["kernel"])
        kernel = kernel.T if kernel.ndim == 2 else kernel.transpose(3, 2, 0, 1)
        sd[f"{key}.weight"] = torch.as_tensor(np.ascontiguousarray(kernel))
        sd[f"{key}.bias"] = torch.as_tensor(np.array(layer["bias"]))
    return sd


def actor_state_dict(params) -> dict:
    """flax AMPSeptValueNet or AMPSeptCNNNet params → the actor's
    state_dict (its task embedding's layers included)."""
    return _state_dict(params, *_ACTOR)


def agent_state_dict(params) -> dict:
    """flax AMPSeptValueNet or AMPSeptCNNNet params → the state_dict of all
    four heads, the pointnet and the conv encoder included."""
    return _state_dict(params, *_ALL_HEADS)


_VALUENET = ((), ("fc1", "fc2", "fc3"))


def valuenet_state_dict(params) -> dict:
    """flax ValuePoseNet params ({"params": {"fc1": {"kernel", "bias"},
    …}}) → ValuePoseNet's state_dict."""
    return _state_dict(params, *_VALUENET)


def valuenet_params(state_dict) -> dict:
    """ValuePoseNet's state_dict → the flax params tree as numpy arrays
    (kernels (in, out)), the layout the JAX package applies and pickles."""
    return {"params": {
        name: {"kernel": state_dict[f"{name}.weight"].detach().cpu()
               .numpy().T.copy(),
               "bias": state_dict[f"{name}.bias"].detach().cpu().numpy()
               .copy()}
        for name in _VALUENET[1]}}


def adam_state(opt_state, device=None, state_dict=agent_state_dict):
    """optax state holding one scale_by_adam state (the agent's
    chain(clip_by_global_norm, adam), the valuenet's adamw) → the port's
    AdamState: the step count and the first and second moments per
    parameter, under the names `state_dict` gives the moment trees
    (agent_state_dict, or valuenet_state_dict for the valuenet's)."""
    def find(node):
        if hasattr(node, "mu") and hasattr(node, "nu"):
            return node
        if isinstance(node, (tuple, list)):
            for child in node:
                hit = find(child)
                if hit is not None:
                    return hit
        return None

    st = find(opt_state)
    if st is None:
        raise ValueError("no adam moments in this optimizer state")
    dev = _device.resolve(device)
    return AdamState(
        count=tensor(st.count, dev),
        mu={k: v.to(dev) for k, v in state_dict(st.mu).items()},
        nu={k: v.to(dev) for k, v in state_dict(st.nu).items()})
