"""Carry weights and state from the JAX package into this one.

Every function takes the JAX package's object as a *numpy* pytree — the
caller converts its leaves first, e.g. `jax.tree.map(np.asarray, obj)` — and
reads it by field name, so this module imports neither jax nor emloco_tpu.
Static fields (a heightfield's cell and origin) come across as they are.
The inverses (`agent_params`, `valuenet_params`, `transmotion_params`,
`lstm_params`, `eqmotion_params`, `eqmotion_full_params`,
`running_norm_fields`, `adam_fields`) write this package's state in the
flax layout as numpy, for the files it saves.
"""
from __future__ import annotations

import dataclasses
import re
import types

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
    """A RunningNorm from the JAX package's (or its unpickled stand-in) or
    from a dict of its fields, as this package's policy files hold it."""
    if isinstance(rn, dict):
        rn = types.SimpleNamespace(**rn)
    return _fields(RunningNorm, rn, device)


def running_norm_fields(rn: RunningNorm) -> dict:
    """A RunningNorm as a dict of numpy arrays (mean, var, count)."""
    return {f.name: getattr(rn, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(RunningNorm)}


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


def _to_numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _flax_layer(weight, bias) -> dict:
    """nn.Linear's (out, in) or nn.Conv2d's OIHW weight and bias → a flax
    Dense kernel (in, out) or Conv kernel HWIO with the bias."""
    w = _to_numpy(weight)
    w = w.T if w.ndim == 2 else w.transpose(2, 3, 1, 0)
    return {"kernel": np.ascontiguousarray(w), "bias": _to_numpy(bias)}


def agent_params(state_dict) -> dict:
    """The inverse of agent_state_dict: the agent's state_dict → the flax
    params tree as numpy (`actor_mlp.1` → `actor_mlp_1`, `cnn.0` →
    `cnn_0`), the layout the JAX package applies and pickles."""
    out = {}
    if "log_sigma" in state_dict:
        out["log_sigma"] = _to_numpy(state_dict["log_sigma"])
    for key in state_dict:
        if not key.endswith(".weight"):
            continue
        layer = key[:-len(".weight")]
        head, _, idx = layer.rpartition(".")
        name = f"{head}_{idx}" if idx.isdigit() else layer
        out[name] = _flax_layer(state_dict[key], state_dict[f"{layer}.bias"])
    return {"params": out}


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
    chain(clip_by_global_norm, adam), the valuenet's adamw), or this
    package's dict of `count`, `mu` and `nu` (`adam_fields`) → the port's
    AdamState: the step count and the first and second moments per
    parameter, under the names `state_dict` gives the moment trees
    (agent_state_dict, or valuenet_state_dict for the valuenet's)."""
    def find(node):
        if isinstance(node, dict) and "mu" in node and "nu" in node:
            return types.SimpleNamespace(**node)
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


def adam_fields(state: AdamState, params=agent_params) -> dict:
    """The port's AdamState as a dict of numpy arrays: `count` and the
    moment trees in the flax layout `params` gives them (agent_params, or
    another inverse of a state_dict conversion)."""
    return {"count": _to_numpy(state.count), "mu": params(state.mu),
            "nu": params(state.nu)}


# ---------------------------------------------------------------------------
# trajectory predictors
# ---------------------------------------------------------------------------

_ATTN = ("query", "key", "value")


def transmotion_state_dict(params) -> dict:
    """flax TransMotion params → TransMotion's state_dict. The encoder
    stacks' layers, stacked on axis 0 by nn.scan under
    `local|global/layers/EncoderLayer_0`, become `local.<l>` and
    `global.<l>`; DenseGeneral q/k/v kernels (D, H, Dh) and the output
    kernel (H, Dh, D) become (H·Dh, D) and (D, H·Dh) nn.Linear weights;
    LayerNorm's scale its weight; embeddings come across as they are."""
    p = params.get("params", params)
    sd = {}

    def put(key, a):
        sd[key] = torch.as_tensor(np.array(a))

    for name, v in p.items():
        if name in ("local", "global"):
            lay = v["layers"]["EncoderLayer_0"]
            att = lay["MultiHeadDotProductAttention_0"]
            for i in range(np.shape(lay["Dense_0"]["kernel"])[0]):
                pre = f"{name}.{i}"
                for q in _ATTN:
                    k = np.asarray(att[q]["kernel"][i])
                    put(f"{pre}.attn.{q}.weight", k.reshape(k.shape[0], -1).T)
                    put(f"{pre}.attn.{q}.bias",
                        np.asarray(att[q]["bias"][i]).reshape(-1))
                k = np.asarray(att["out"]["kernel"][i])
                put(f"{pre}.attn.out.weight", k.reshape(-1, k.shape[-1]).T)
                put(f"{pre}.attn.out.bias", np.asarray(att["out"]["bias"][i]))
                for src, dst in (("Dense_0", "ff1"), ("Dense_1", "ff2")):
                    put(f"{pre}.{dst}.weight",
                        np.asarray(lay[src]["kernel"][i]).T)
                    put(f"{pre}.{dst}.bias", np.asarray(lay[src]["bias"][i]))
                for src, dst in (("LayerNorm_0", "norm1"),
                                 ("LayerNorm_1", "norm2")):
                    put(f"{pre}.{dst}.weight",
                        np.asarray(lay[src]["scale"][i]))
                    put(f"{pre}.{dst}.bias", np.asarray(lay[src]["bias"][i]))
        elif isinstance(v, dict):
            put(f"{name}.weight", np.asarray(v["kernel"]).T)
            put(f"{name}.bias", np.asarray(v["bias"]))
        else:
            put(name, np.asarray(v))
    return sd


def _flax_encoder_layer(sd: dict, pre: str, nhead: int) -> dict:
    """One EncoderLayer of a numpy state_dict in the flax layout."""
    att = {}
    for q in _ATTN:
        w = sd[f"{pre}.attn.{q}.weight"]                # (H·Dh, D)
        att[q] = {"kernel": w.T.reshape(w.shape[1], nhead, -1),
                  "bias": sd[f"{pre}.attn.{q}.bias"].reshape(nhead, -1)}
    w = sd[f"{pre}.attn.out.weight"]                    # (D, H·Dh)
    att["out"] = {"kernel": w.T.reshape(nhead, -1, w.shape[0]),
                  "bias": sd[f"{pre}.attn.out.bias"]}
    lay = {"MultiHeadDotProductAttention_0": att}
    for dst, src in (("Dense_0", "ff1"), ("Dense_1", "ff2")):
        lay[dst] = {"kernel": sd[f"{pre}.{src}.weight"].T,
                    "bias": sd[f"{pre}.{src}.bias"]}
    for dst, src in (("LayerNorm_0", "norm1"), ("LayerNorm_1", "norm2")):
        lay[dst] = {"scale": sd[f"{pre}.{src}.weight"],
                    "bias": sd[f"{pre}.{src}.bias"]}
    return lay


def _stack(trees: list):
    """Trees of one structure → one tree, each leaf stacked on axis 0."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def transmotion_params(state_dict, nhead: int) -> dict:
    """The inverse of transmotion_state_dict: TransMotion's state_dict →
    the flax params tree as numpy, each encoder's layers stacked on axis 0
    as nn.scan keeps them; `nhead` splits the attention kernels."""
    sd = {k: _to_numpy(v) for k, v in state_dict.items()}
    out = {}
    for stack in ("local", "global"):
        n = 1 + max(int(k.split(".")[1]) for k in sd
                    if k.startswith(stack + "."))
        out[stack] = {"layers": {"EncoderLayer_0": _stack(
            [_flax_encoder_layer(sd, f"{stack}.{i}", nhead)
             for i in range(n)])}}
    for k, v in sd.items():
        layer, _, leaf = k.rpartition(".")
        if k.split(".")[0] in ("local", "global") or leaf == "bias":
            continue
        if leaf == "weight":
            out[layer] = {"kernel": np.ascontiguousarray(v.T),
                          "bias": sd[f"{layer}.bias"]}
        else:
            out[k] = v
    return {"params": out}


_LSTM_CELLS = (("OptimizedLSTMCell_0", "enc"), ("OptimizedLSTMCell_1", "dec"))


def lstm_state_dict(params) -> dict:
    """flax LSTMPredictor params → LSTMPredictor's state_dict: the two
    OptimizedLSTMCells become `enc` and `dec` (input kernels `ii`, `if`,
    `ig`, `io` without bias, hidden kernels `hi`, `hf`, `hg`, `ho` with
    one), `in_proj`, `out_proj` and `mode_emb` keep their names."""
    p = params.get("params", params)
    cells = dict(_LSTM_CELLS)
    sd = {}
    for name, v in p.items():
        if name in cells:
            for gate, layer in v.items():
                sd[f"{cells[name]}.{gate}.weight"] = torch.as_tensor(
                    np.ascontiguousarray(np.asarray(layer["kernel"]).T))
                if "bias" in layer:
                    sd[f"{cells[name]}.{gate}.bias"] = torch.as_tensor(
                        np.array(layer["bias"]))
        elif isinstance(v, dict):
            sd[f"{name}.weight"] = torch.as_tensor(
                np.ascontiguousarray(np.asarray(v["kernel"]).T))
            sd[f"{name}.bias"] = torch.as_tensor(np.array(v["bias"]))
        else:
            sd[name] = torch.as_tensor(np.array(v))
    return sd


def lstm_params(state_dict) -> dict:
    """The inverse of lstm_state_dict: LSTMPredictor's state_dict → the
    flax params tree as numpy."""
    cells = {dst: src for src, dst in _LSTM_CELLS}
    out = {}
    for k, v in state_dict.items():
        parts = k.split(".")
        if parts[0] in cells:
            layer = out.setdefault(cells[parts[0]], {}).setdefault(
                parts[1], {})
            a = _to_numpy(v)
            if parts[2] == "weight":
                layer["kernel"] = np.ascontiguousarray(a.T)
            else:
                layer["bias"] = a
        elif parts[-1] == "weight":
            out[parts[0]] = {"kernel": np.ascontiguousarray(_to_numpy(v).T),
                             "bias": _to_numpy(state_dict[
                                 parts[0] + ".bias"])}
        elif parts[-1] != "bias":
            out[k] = _to_numpy(v)
    return {"params": out}


# ---------------------------------------------------------------------------
# EqMotion
# ---------------------------------------------------------------------------

def _linear_to_torch(sd: dict, name: str, layer) -> None:
    """A flax Dense (kernel (in, out)[, bias]) as nn.Linear entries."""
    sd[f"{name}.weight"] = torch.as_tensor(
        np.ascontiguousarray(np.asarray(layer["kernel"]).T))
    if "bias" in layer:
        sd[f"{name}.bias"] = torch.as_tensor(np.array(layer["bias"]))


def _linear_to_flax(sd: dict, name: str) -> dict:
    out = {"kernel": np.ascontiguousarray(_to_numpy(sd[f"{name}.weight"]).T)}
    if f"{name}.bias" in sd:
        out["bias"] = _to_numpy(sd[f"{name}.bias"])
    return out


def _layers(sd: dict) -> list:
    """The layer names of a state_dict, in order, without .weight/.bias."""
    return list(dict.fromkeys(k.rpartition(".")[0] for k in sd
                              if k.endswith((".weight", ".bias"))))


# the compact EqMotion: flax names its layers by call order
_EQ_TOP = {"Dense_0": "speed_embed", "Dense_1": "angle_embed"}
_EQ_LAYER = ("edge1", "edge2", "category", "gate", "channel_mix", "node")


def eqmotion_state_dict(params) -> dict:
    """flax EqMotion params → EqMotion's state_dict: `Dense_0` and
    `Dense_1` are the speed and angle embeddings, each layer's `Dense_0`…
    `Dense_5` are edge1, edge2, category, gate, channel_mix and node
    (`gcl_<i>` → `gcl.<i>`), `head_<m>` → `head.<m>`."""
    p = params.get("params", params)
    sd = {}
    for name, layer in p.items():
        if name.startswith("gcl_"):
            i = name[len("gcl_"):]
            for j, dst in enumerate(_EQ_LAYER):
                _linear_to_torch(sd, f"gcl.{i}.{dst}", layer[f"Dense_{j}"])
        elif name.startswith("head_"):
            _linear_to_torch(sd, f"head.{name[len('head_'):]}", layer)
        else:
            _linear_to_torch(sd, _EQ_TOP.get(name, name), layer)
    return sd


def eqmotion_params(state_dict) -> dict:
    """The inverse of eqmotion_state_dict: EqMotion's state_dict → the flax
    params tree as numpy."""
    top = {v: k for k, v in _EQ_TOP.items()}
    out = {}
    for layer in _layers(state_dict):
        parts = layer.split(".")
        dense = _linear_to_flax(state_dict, layer)
        if parts[0] == "gcl":
            j = _EQ_LAYER.index(parts[2])
            out.setdefault(f"gcl_{parts[1]}", {})[f"Dense_{j}"] = dense
        elif parts[0] == "head":
            out[f"head_{parts[1]}"] = dense
        else:
            out[top.get(layer, layer)] = dense
    return {"params": out}


# the architecture-exact EqMotion: the reference's names, but calc_category's
# four MLPs, which flax prefixes with cat_
_FULL_CAT = {"edge_mlp": "cat_edge_mlp", "coord_mlp": "cat_coord_mlp",
             "node_mlp": "cat_node_mlp", "category_mlp": "cat_head_mlp"}
_INDEXED = re.compile(r"^(.*?)((?:_\d+)+)$")


def _full_sd(p: dict, prefix: str) -> dict:
    sd = {}
    cat = {v: k for k, v in _FULL_CAT.items()}
    for name, v in p.items():
        if name == "core":
            sd.update(_full_sd(v, prefix + "core."))
        elif name == "agent_embed":
            sd[prefix + name] = torch.as_tensor(np.array(v))
        elif re.fullmatch(r"gcl_\d+", name):
            for sub, layer in v.items():
                m = _INDEXED.match(sub)
                key = (m.group(1) + m.group(2).replace("_", ".") if m
                       else sub)
                _linear_to_torch(sd, f"{prefix}{name}.{key}", layer)
        else:
            m = _INDEXED.match(name)
            key = (cat.get(m.group(1), m.group(1))
                   + m.group(2).replace("_", ".") if m else name)
            _linear_to_torch(sd, prefix + key, v)
    return sd


def eqmotion_full_state_dict(params) -> dict:
    """flax EqMotionFull (or EqMotionFullEth, whose `core` becomes
    `core.`) params, the layout of the JAX package's
    transplant_from_torch → the port's state_dict under the reference's
    names: `cat_edge_mlp_0` → `edge_mlp.0`, `gcl_1/category_mlp_0_2` →
    `gcl_1.category_mlp.0.2`, `gcl_1/mlp_q_0` → `gcl_1.mlp_q.0`."""
    return _full_sd(params.get("params", params), "")


def eqmotion_full_params(state_dict) -> dict:
    """The inverse of eqmotion_full_state_dict: the port's state_dict → the
    flax params tree as numpy; keys under `core.` go under `core`."""
    core = {k[len("core."):]: v for k, v in state_dict.items()
            if k.startswith("core.")}
    if core:
        return {"params": {"core": eqmotion_full_params(core)["params"]}}
    out = {}
    if "agent_embed" in state_dict:
        out["agent_embed"] = _to_numpy(state_dict["agent_embed"])
    for layer in _layers(state_dict):
        head, _, rest = layer.partition(".")
        dense = _linear_to_flax(state_dict, layer)
        if re.fullmatch(r"gcl_\d+", head):
            out.setdefault(head, {})[rest.replace(".", "_")] = dense
        else:
            name = _FULL_CAT.get(head, head)
            out[f"{name}_{rest.replace('.', '_')}" if rest else name] = dense
    return {"params": out}
