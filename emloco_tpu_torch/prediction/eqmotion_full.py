"""The architecture-exact EqMotion (h36m / nbody / md17 family; port of
emloco_tpu/prediction/eqmotion_full.py, reference EqMotion
h36m/model_t.py:8-167 and h36m/gcl_t.py:26-171).

DCT temporal basis, velocity turning-angle invariants, learned interaction
categories (calc_category), and per-layer equivariant updates: inner-agent
attention, category-weighted neighbor aggregation, the velocity channel
mix and the reflection gate.

The modules carry the reference torch model's names and layout
(`embedding`, `edge_mlp.0/.2`, `category_mlp`, `gcl_<i>.category_mlp.<j>.
0/.2`, `gcl_<i>.mlp_q.0`, …), so a reference state_dict loads with
`load_state_dict` once its dead per-layer `gcl_<i>.coord_mlp.*` keys are
dropped (`drop_dead_keys`). `convert.eqmotion_full_params` writes the flax
layout of the JAX package's `transplant_from_torch`, and
`convert.eqmotion_full_state_dict` reads it back.

Kept from the reference:
  * the per-layer `coord_mlp` is built and never called: not ported;
  * the aggregation sums category_mlp[j] over j < category_num − 2, so the
    last two categories contribute no force;
  * the aggregation reads coord_diff from before the inner-agent attention.
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from .. import device as _device
from .eqmotion import Adam, _safe_arccos, grads_or_zeros
from .model import init_flax_families

_DEAD_KEY = re.compile(r"gcl_\d+\.coord_mlp\.")


def _safe_norm(d, dim=-1):
    """sqrt(Σd² + 1e-12): a norm with a finite gradient at the self-pair
    zeros (i == j), where a norm's gradient is NaN."""
    return torch.sqrt(torch.sum(d * d, dim=dim) + 1e-12)


@dataclasses.dataclass(frozen=True)
class EqMotionFullConfig:
    past: int = 10                 # in_node_nf == in_channel
    future: int = 10               # out_channel
    nf: int = 64                   # hidden_nf
    channels: int = 72             # hid_channel
    n_layers: int = 4
    category_num: int = 4
    n_agent: int = 22
    add_agent_token: bool = True
    # the ETH-UCY variant (main_eth_diverse.py:292): > 1 puts a mode axis
    # on the predict head
    nmode: int = 1


def _masked_mean(x, valid, dims):
    """Mean over `dims` counting only valid agents (valid broadcastable to
    x; None → the plain mean). Keeps dims."""
    if valid is None:
        return torch.mean(x, dim=dims, keepdim=True)
    num = torch.sum(x * valid, dim=dims, keepdim=True)
    den = torch.sum(valid.expand(x.shape), dim=dims, keepdim=True)
    return num / torch.clamp(den, min=1.0)


def _dct_matrix(N: int) -> np.ndarray:
    """model_t.get_dct_matrix (model_t.py:74-85), float64."""
    m = np.eye(N)
    for k in range(N):
        for i in range(N):
            w = np.sqrt((1 if k == 0 else 2) / N)
            m[k, i] = w * np.cos(np.pi * (i + 0.5) * k / N)
    return m


def _mlp(sizes, act_last=True) -> nn.Sequential:
    """nn.Sequential(Linear, SiLU, Linear[, SiLU]): the reference's layout,
    its Linears at indices 0 and 2."""
    layers = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        layers.append(nn.Linear(a, b))
        if i < len(sizes) - 2 or act_last:
            layers.append(nn.SiLU())
    return nn.Sequential(*layers)


def _channels(layer: nn.Linear, x):
    """A linear map over the channel axis of (B, N, C, d)."""
    return layer(x.transpose(2, 3)).transpose(2, 3)


class FeatureLayer(nn.Module):
    """gcl_t.Feature_learning_layer (gcl_t.py:26-171), SiLU activations."""

    def __init__(self, nf: int, channels: int, category_num: int):
        super().__init__()
        c, f = channels, nf
        self.coord_vel = nn.Linear(c, c, bias=False)
        self.edge_mlp = _mlp([2 * f + c, f, f])
        self.category_mlp = nn.ModuleList(
            _mlp([2 * f + c, f, c]) for _ in range(category_num - 2))
        self.factor_mlp = _mlp([c, c, c])
        self.node_mlp = _mlp([2 * f, f, f], act_last=False)
        self.layer_q = nn.Linear(c, c, bias=False)
        self.layer_k = nn.Linear(c, c, bias=False)
        self.mlp_q = nn.Sequential(nn.Linear(f, c), nn.SiLU())

    def forward(self, h, coord, vel, category, valid=None):
        """valid: optional (B, N) 0/1 agent mask; invalid agents are left
        out of every cross-agent mean and neighbor aggregation."""
        B, N, C, _ = coord.shape
        H = h.shape[-1]
        v_node = None if valid is None else valid[..., None, None]
        v_nbr = None if valid is None else valid[:, None, :, None]
        h1 = h[:, :, None].expand(B, N, N, H)
        h2 = h[:, None, :].expand(B, N, N, H)
        coord_diff = coord[:, :, None] - coord[:, None, :]    # (B,N,N,C,d)
        edge_h = torch.cat([h1, h2, _safe_norm(coord_diff)], -1)
        edge_feat = self.edge_mlp(edge_h)

        # inner-agent attention (gcl_t.py:137-145)
        att = self.mlp_q(h)[..., None]                        # (B,N,C,1)
        coord = att * (coord - _masked_mean(coord, v_node, (1, 2))) + coord

        # category-weighted neighbor aggregation (gcl_t.py:112-126), on
        # coord_diff from before the attention
        factors = torch.zeros((B, N, N, C), dtype=h.dtype, device=h.device)
        for i, mlp in enumerate(self.category_mlp):
            factors = factors + category[..., i:i + 1] * mlp(edge_h)
        factors = self.factor_mlp(factors)
        if v_nbr is not None:
            factors = factors * v_nbr
        coord = coord + torch.sum(factors[..., None] * coord_diff, dim=2)

        # velocity channel mix
        coord = coord + _channels(self.coord_vel, vel)

        # reflection-gate non-linearity (gcl_t.py:147-159)
        mean = _masked_mean(coord, v_node, (1, 2))
        cc = coord - mean
        q = _channels(self.layer_q, cc)
        k = _channels(self.layer_k, cc)
        product = torch.sum(q * k, dim=-1, keepdim=True)      # (B,N,C,1)
        mask = (product >= 0).to(coord.dtype)
        k_norm_sq = torch.sum(k * k, dim=-1, keepdim=True)
        coord = mask * q + (1 - mask) * (q - (product / (k_norm_sq + 1e-4))
                                         * k)
        coord = coord + mean

        # node update with the self-excluded edge sum (gcl_t.py:128-135)
        eye = torch.eye(N, dtype=h.dtype, device=h.device)[None, :, :, None]
        w_edge = (1.0 - eye) if v_nbr is None else (1.0 - eye) * v_nbr
        agg = torch.sum(w_edge * edge_feat, dim=2)
        h = h + self.node_mlp(torch.cat([h, agg], -1))
        return h, coord


class EqMotionFull(nn.Module):
    """model_t.EqMotion forward (model_t.py:115-167)."""

    def __init__(self, cfg: EqMotionFullConfig = EqMotionFullConfig(),
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        c = self.cfg = cfg
        half = c.nf // 2
        self.embedding = nn.Linear(c.past, half)
        self.embedding2 = nn.Linear(c.past, half)
        self.coord_trans = nn.Linear(c.past, c.channels, bias=False)
        self.vel_trans = nn.Linear(c.past, c.channels, bias=False)
        self.predict_head = nn.Linear(c.channels, c.nmode * c.future,
                                      bias=False)
        if c.add_agent_token:
            self.agent_embed = nn.Parameter(torch.empty(1, c.n_agent, c.nf))
            self.embed_MLP = _mlp([2 * c.nf, c.nf, c.nf])
        # calc_category's heads (model_t.py:40-63)
        self.edge_mlp = _mlp([2 * c.nf + 2 * c.channels, c.nf, c.nf])
        self.coord_mlp = _mlp([2 * c.channels, c.nf, 2 * c.channels])
        self.node_mlp = _mlp([2 * c.nf, c.nf, c.nf])
        self.category_mlp = _mlp([2 * c.nf + 2 * c.channels, c.nf,
                                  c.category_num])
        for i in range(c.n_layers):
            self.add_module(f"gcl_{i}", FeatureLayer(c.nf, c.channels,
                                                     c.category_num))
        # the DCT of the past and the inverse DCT of the future, float64 on
        # the host; cast on first use per dtype and device
        self._dct_np = (_dct_matrix(c.past),
                        np.linalg.inv(_dct_matrix(c.future)))
        self._dct = {}
        self.to(_device.resolve(device))
        self.init_parameters(generator)

    @property
    def layers(self):
        return [getattr(self, f"gcl_{i}") for i in range(self.cfg.n_layers)]

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator | None = None):
        """flax's defaults: lecun-normal kernels, zero biases, and
        agent_embed N(0, 1)."""
        init_flax_families(self, generator, embeddings=())
        if self.cfg.add_agent_token:
            nn.init.normal_(self.agent_embed, 0.0, 1.0, generator=generator)

    def dct(self, dtype, device):
        key = (dtype, device)
        if key not in self._dct:
            self._dct[key] = tuple(torch.as_tensor(m, dtype=dtype,
                                                   device=device)
                                   for m in self._dct_np)
        return self._dct[key]

    def _calc_category(self, h, x_cat, valid=None):
        B, N = h.shape[:2]
        dist = self.coord_mlp(_safe_norm(x_cat[:, :, None]
                                         - x_cat[:, None, :]))  # (B,N,N,·)
        H = h.shape[-1]
        h1 = h[:, :, None].expand(B, N, N, H)
        h2 = h[:, None, :].expand(B, N, N, H)
        edge_feat = self.edge_mlp(torch.cat([h1, h2, dist], -1))
        w = 1.0 - torch.eye(N, dtype=h.dtype,
                            device=h.device)[None, :, :, None]
        if valid is not None:
            w = w * valid[:, None, :, None]
        agg = torch.sum(w * edge_feat, dim=2)
        node = self.node_mlp(torch.cat([h, agg], -1))
        K = node.shape[-1]
        n1 = node[:, :, None].expand(B, N, N, K)
        n2 = node[:, None, :].expand(B, N, N, K)
        logits = self.category_mlp(torch.cat([n1, n2, dist], -1))
        return torch.softmax(logits, dim=-1)                  # tao = 1

    def forward(self, h, x, vel, valid=None):
        """h (B, N, T) node invariants, x (B, N, T, d) positions, vel
        (B, N, T, d), valid an optional (B, N) agent mask → (pred,
        [category] · n_layers), pred (B, N, future, d) for nmode 1, else
        (B, N, nmode, future, d)."""
        c = self.cfg
        B, N, T, dims = x.shape
        v_node = None if valid is None else valid[..., None, None]
        # the velocity turning-angle invariant (model_t.py:116-123)
        vel_pre = torch.cat([vel[:, :, :1], vel[:, :, :-1]], dim=2)
        cos = torch.sum(vel_pre * vel, -1) / (
            (torch.linalg.vector_norm(vel_pre, dim=-1) + 1e-6)
            * (torch.linalg.vector_norm(vel, dim=-1) + 1e-6))
        vel_angle = _safe_arccos(cos)

        x_center = _masked_mean(x, v_node, (1, 2))
        x = x - x_center
        dct, idct = self.dct(x.dtype, x.device)
        x = torch.einsum("kt,bntd->bnkd", dct, x)
        vel = torch.einsum("kt,bntd->bnkd", dct, vel)

        h = torch.cat([self.embedding(h), self.embedding2(vel_angle)], -1)
        if c.add_agent_token:
            tok = self.agent_embed.expand(B, N, c.nf)
            h = self.embed_MLP(torch.cat([h, tok], -1))

        x_mean = _masked_mean(x, v_node, (1, 2))
        x = _channels(self.coord_trans, x - x_mean) + x_mean
        vel = _channels(self.vel_trans, vel)
        category = self._calc_category(h, torch.cat([x, vel], dim=-2),
                                       valid=valid)
        cats = []
        for layer in self.layers:
            h, x = layer(h, x, vel, category, valid=valid)
            cats.append(category)

        x_mean = _masked_mean(x, v_node, (1, 2))
        y = self.predict_head((x - x_mean).transpose(2, 3))
        if c.nmode == 1:
            x = y.transpose(2, 3) + x_mean
            x = torch.einsum("kt,bntd->bnkd", idct, x)
            return x + x_center, cats
        # the mode axis: (B, N, d, nmode·Tf) → (B, N, nmode, Tf, d), each
        # mode's coefficients through the inverse DCT
        y = y.reshape(B, N, dims, c.nmode, c.future).permute(0, 1, 3, 4, 2)
        y = y + x_mean[:, :, None]
        y = torch.einsum("kt,bnmtd->bnmkd", idct, y)
        return y + x_center[:, :, None], cats


class EqMotionFullEth(nn.Module):
    """The architecture-exact model on the ETH-UCY pedestrian domain with
    the compact trainer's interface: past (B, A, Tp, 2) → (B, A, nmode,
    Tf, 2).

    The featurization is the reference train loop's (main_eth_diverse.py:
    283-291): vel by backward difference with vel[:, :, 0] = vel[:, :, 1],
    node invariants the per-step speeds, positions absolute. An agent whose
    anchor lies further than `pad_radius` from the ego's is a pad: it is
    masked out and parked on the ego's anchor before the core (its +1e3·k m
    dummy coordinates would overflow float32 through the MLP chains, and
    0·inf in a masked sum is NaN)."""

    def __init__(self, cfg: EqMotionFullConfig, pad_radius: float = 500.0,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.cfg = cfg
        self.pad_radius = pad_radius
        self.core = EqMotionFull(cfg, generator, device)

    def init_parameters(self, generator: torch.Generator | None = None):
        self.core.init_parameters(generator)

    def forward(self, past):
        anchor = past[:, :, -1]                               # (B,A,2)
        dist = torch.linalg.vector_norm(anchor - anchor[:, :1], dim=-1)
        valid = (dist < self.pad_radius).to(past.dtype)
        ego = past[:, :1, -1:]                                # (B,1,1,2)
        past = torch.where(valid[..., None, None] > 0, past, ego)
        vel = torch.diff(past, dim=2, prepend=past[:, :, :1])
        vel = torch.cat([vel[:, :, 1:2], vel[:, :, 1:]], 2)   # vel[0]=vel[1]
        h = torch.linalg.vector_norm(vel, dim=-1)             # (B,A,T)
        pred, _ = self.core(h, past, vel, valid=valid)
        if self.cfg.nmode == 1:
            pred = pred[:, :, None]                           # (B,A,1,Tf,2)
        return pred


def eth_full_config(past=8, future=12, nmode=20,
                    channels=64) -> EqMotionFullConfig:
    """main_eth_diverse.py's defaults: nf 64, channels 64 (zara1 128,
    :119-122), 4 layers, 20 modes, no agent tokens."""
    return EqMotionFullConfig(past=past, future=future, nf=64,
                              channels=channels, n_layers=4,
                              add_agent_token=False, nmode=nmode)


def drop_dead_keys(state_dict: dict) -> dict:
    """A reference EqMotion state_dict without the per-layer coord_mlp
    keys, which the reference builds and never calls."""
    return {k: v for k, v in state_dict.items() if not _DEAD_KEY.match(k)}


class EqMotionFullTrainer:
    """Single-mode regression (reference main_h36m.py:224-266 and
    main_nbody.py: the mean L2 distance of the predicted trajectory), on
    the h36m (joints as nodes) and nbody domains."""

    def __init__(self, cfg: EqMotionFullConfig, lr: float = 5e-4,
                 device=None):
        self.device = _device.resolve(device)
        self.cfg = cfg
        self.model = EqMotionFull(cfg, device=self.device)
        self.tx = Adam(lr)

    @staticmethod
    def featurize(past):
        """(B, N, T, 3) positions → (h, x, vel) as main_h36m.py:231-236
        feeds the model: vel by backward difference, h the speeds."""
        vel = torch.diff(past, dim=2, prepend=past[:, :, :1])
        return torch.linalg.vector_norm(vel, dim=-1), past, vel

    def init(self, seed: int, example_past=None):
        """(params, optimizer state), the weights from a generator seeded
        with `seed`."""
        self.model.init_parameters(
            torch.Generator(device=self.device).manual_seed(seed))
        params = {k: v.detach().clone()
                  for k, v in self.model.named_parameters()}
        return params, self.tx.init(params)

    def loss_and_grads(self, params, past, future):
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            pred, _ = functional_call(self.model, p, self.featurize(past))
            # _safe_norm: a joint predicted exactly has a NaN norm gradient
            loss = torch.mean(_safe_norm(pred - future))
            grads = grads_or_zeros(loss, p)
        return loss.detach(), grads

    def train_step(self, params, opt_state, past, future):
        past, future = (torch.as_tensor(a, device=self.device)
                        for a in (past, future))
        loss, grads = self.loss_and_grads(params, past, future)
        params, opt_state = self.tx.update(grads, opt_state, params)
        return params, opt_state, loss

    @torch.no_grad()
    def predict(self, params, past):
        past = torch.as_tensor(past, device=self.device)
        return functional_call(self.model, params, self.featurize(past))
