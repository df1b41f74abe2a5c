"""EqMotion-style equivariant trajectory predictor, the second trajectory
prediction baseline (port of emloco_tpu/prediction/eqmotion.py; reference
EqMotion h36m/model_t.py:8-170 and gcl_t.py, wired to the LocoVal loss in
main_eth_diverse.py:172-177, 295-316).

  * geometric channels: the centered past trajectory (C = past_length
    coordinate channels per agent) mixed by learned channel matrices
    without bias, so rotations and translations commute with the model;
  * invariant node features from speeds and turning angles;
  * interaction reasoning: per-edge soft categories from invariant
    features weight relative-coordinate messages;
  * nmode equivariant decoder heads → (B, agents, M, T_future, d);
  * the winner-takes-all loss over modes for the ego agent, and the EmLoco
    loss of every mode through ValuePoseNet(use_pose=False, use_vel=True).

Parameters are a dict of tensors under the model's state_dict names, run
through `torch.func.functional_call`. `convert.eqmotion_state_dict` and
`eqmotion_params` map them to flax's automatic names (`Dense_0`…`Dense_5`
of each layer in call order, `Dense_0`/`Dense_1` for the speed and angle
embeddings) and back.

The synthetic domains draw on a `torch.Generator` in a function of their own
(`eth_draws`, `nbody_draws`, `h36m_draws`, `md17_draws`) and make the
batch from the draws in a pure function, so that given draws give the JAX
package's batch.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from .. import convert
from .. import device as _device
from ..learning.amp_agent import AdamState, adam_directions
from ..learning.networks import ValuePoseNet
from ..struct import TensorStruct
from ..utils.checkpoint import save_pytree
from . import metrics as M
from .model import init_flax_families
from .train import exponential_decay

ETH_FPS = 2.5
# the aspirin bond graph of the reference's MD17 preprocess, kept beside
# the JAX package's module and read in place
MD17_FIXTURES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "emloco_tpu", "prediction", "fixtures")


def _safe_arccos(cos):
    """arccos with the reference's [-1, 1] clamp (model_t.py:119) and a
    bounded gradient: d/dx arccos = −1/√(1 − x²) is −inf at the clamp, and
    real ETH-UCY tracks (grid-interpolated straight lines) have a turning
    cosine of exactly 1. The value is exact; the gradient is taken 1e-6
    inside the clamp."""
    c = torch.clamp(cos, -1.0, 1.0)
    safe = torch.clamp(c, -1.0 + 1e-6, 1.0 - 1e-6)
    return torch.arccos(safe) + (torch.arccos(c)
                                 - torch.arccos(safe)).detach()


@dataclasses.dataclass(frozen=True)
class EqMotionConfig:
    past_length: int = 8
    future_length: int = 12
    hidden_nf: int = 64
    hid_channel: int = 32
    n_layers: int = 4
    nmode: int = 20
    category_num: int = 4


def _channel_linear(layer: nn.Linear, z):
    """A bias-free linear map over the channel axis of (…, C, d)."""
    return layer(z.transpose(-1, -2)).transpose(-1, -2)


class EqLayer(nn.Module):
    """One feature-learning layer: an invariant update and an equivariant
    coordinate-channel update with category-weighted neighbor messages.
    Its six layers in flax's call order: edge1, edge2, category, gate,
    channel_mix, node (`Dense_0`…`Dense_5`)."""

    def __init__(self, hidden_nf: int, hid_channel: int, category_num: int):
        super().__init__()
        H, C, K = hidden_nf, hid_channel, category_num
        self.category_num = K
        self.edge1 = nn.Linear(2 * H + C, H)
        self.edge2 = nn.Linear(H, H)
        self.category = nn.Linear(H, K)
        self.gate = nn.Linear(H, K * C)
        self.channel_mix = nn.Linear(C, C, bias=False)
        self.node = nn.Linear(2 * H, H)

    def forward(self, h, z):
        """h (B, A, H) invariant; z (B, A, C, d) equivariant channels."""
        B, A, C, _ = z.shape
        H = h.shape[-1]
        zd = z[:, :, None] - z[:, None]                       # (B,A,A,C,d)
        dist = torch.sqrt(torch.sum(zd ** 2, -1) + 1e-8)      # (B,A,A,C)
        h1 = h[:, :, None].expand(B, A, A, H)
        h2 = h[:, None].expand(B, A, A, H)
        e = F.silu(self.edge2(F.silu(self.edge1(
            torch.cat([h1, h2, dist], -1)))))                 # (B,A,A,H)
        cat = torch.softmax(self.category(e), -1)             # (B,A,A,K)
        mask = 1.0 - torch.eye(A, dtype=z.dtype,
                               device=z.device)[None, :, :, None]
        gate = self.gate(e).reshape(B, A, A, self.category_num, C)
        w = torch.einsum("bijk,bijkc->bijc", cat, gate) * mask
        dz = torch.einsum("bijc,bijcd->bicd", w, zd) / (A - 1 + 1e-6)
        z_new = z + dz + _channel_linear(self.channel_mix, z)
        agg = torch.sum(e * mask[..., :1], 2)
        h_new = h + F.silu(self.node(torch.cat([h, agg], -1)))
        return h_new, z_new


class EqMotion(nn.Module):
    """past (B, A, T_past, d) absolute trajectories → (B, A, nmode, T_future,
    d) absolute predictions."""

    def __init__(self, cfg: EqMotionConfig = EqMotionConfig(),
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        c = self.cfg = cfg
        self.speed_embed = nn.Linear(c.past_length, c.hidden_nf // 2)
        self.angle_embed = nn.Linear(c.past_length, c.hidden_nf // 2)
        self.coord_trans = nn.Linear(c.past_length, c.hid_channel,
                                     bias=False)
        self.gcl = nn.ModuleList(
            EqLayer(c.hidden_nf, c.hid_channel, c.category_num)
            for _ in range(c.n_layers))
        self.head = nn.ModuleList(
            nn.Linear(c.hid_channel, c.future_length, bias=False)
            for _ in range(c.nmode))
        self.to(_device.resolve(device))
        self.init_parameters(generator)

    def init_parameters(self, generator: torch.Generator | None = None):
        """flax's Dense defaults: lecun-normal kernels, zero biases."""
        init_flax_families(self, generator, embeddings=())

    def forward(self, past):
        center = past[:, :, -1:]                              # last observed
        z = past - center
        vel = torch.diff(past, dim=2, prepend=past[:, :, :1])
        speed = torch.linalg.vector_norm(vel, dim=-1)         # (B,A,T)
        vp = torch.cat([vel[:, :, :1], vel[:, :, :-1]], 2)
        cos = torch.sum(vp * vel, -1) / (
            torch.linalg.vector_norm(vp, dim=-1) * speed + 1e-6)
        angle = _safe_arccos(cos)
        h = torch.cat([self.speed_embed(speed), self.angle_embed(angle)], -1)
        zc = _channel_linear(self.coord_trans, z)             # (B,A,C,d)
        for layer in self.gcl:
            h, zc = layer(h, zc)
        out = torch.stack([_channel_linear(head, zc) for head in self.head],
                          2)                                  # (B,A,M,Tf,d)
        return out + center[:, :, None]


def grads_or_zeros(loss, params: dict) -> dict:
    """d loss / d params by name, zeros for a parameter the loss does not
    reach (the last layer's invariant update feeds nothing), as JAX's
    gradient has them."""
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return {k: torch.zeros_like(v) if g is None else g
            for (k, v), g in zip(params.items(), grads)}


@dataclasses.dataclass(frozen=True)
class Adam:
    """optax.adam(lr), or adam(exponential_decay(lr, transition_steps,
    decay, staircase=True)) when transition_steps > 0, on dicts of
    tensors: no clip, eps outside the square root."""

    lr: float
    transition_steps: int = 0
    decay: float = 1.0

    def init(self, params: dict) -> AdamState:
        return AdamState.zeros_like(params)

    def learning_rate(self, count: torch.Tensor):
        if not self.transition_steps:
            return self.lr
        return exponential_decay(count, self.lr, self.transition_steps,
                                 self.decay)

    def update(self, grads: dict, state: AdamState, params: dict):
        """(new params, new state) after one step on `grads`."""
        step = -self.learning_rate(state.count)
        state, u = adam_directions(grads, state)
        return {k: params[k] + u[k] * step for k in u}, state


@dataclasses.dataclass(frozen=True)
class EqMotionTrainState(TensorStruct):
    params: dict                   # the model's, by state_dict name
    opt_state: AdamState
    step: int


class EqMotionTrainer:
    """ETH-UCY-style training with the WTA loss and the optional EmLoco
    loss (reference main_eth_diverse.py:295-316: per-mode
    calc_embodied_motion_loss with the initial velocity only, averaged,
    × valueloss_w)."""

    def __init__(self, cfg: EqMotionConfig = EqMotionConfig(), lr=5e-4,
                 vnet: Optional[ValuePoseNet] = None,
                 valueloss_w: float = 0.0, value_loss_mode: str = "all",
                 model: Optional[nn.Module] = None, device=None):
        """`lr` is a float or an `Adam`; `model` any module mapping past
        (B, A, Tp, 2) → (B, A, nmode, Tf, 2), e.g. eqmotion_full's
        EqMotionFullEth (on the trainer's device)."""
        self.device = _device.resolve(device)
        self.cfg = cfg
        self.model = (EqMotion(cfg, device=self.device) if model is None
                      else model)
        self.tx = lr if isinstance(lr, Adam) else Adam(float(lr))
        self.vnet = vnet
        self.valueloss_w = valueloss_w
        # "all": the reference's value loss averaged over every mode; "wta":
        # only the WTA-winning head feels it, so the other heads keep their
        # diversity
        if value_loss_mode not in ("all", "wta"):
            raise ValueError(f"value_loss_mode {value_loss_mode!r}")
        self.value_loss_mode = value_loss_mode

    def init(self, seed: int, example_past=None,
             vnet_params: Optional[dict] = None):
        """(fresh state, the LocoVal parameters on the device): the model's
        weights from a generator seeded with `seed`. `example_past` is
        accepted as the JAX trainer takes it."""
        self.model.init_parameters(
            torch.Generator(device=self.device).manual_seed(seed))
        params = {k: v.detach().clone()
                  for k, v in self.model.named_parameters()}
        if vnet_params is not None:
            vnet_params = {k: v.detach().to(self.device)
                           for k, v in vnet_params.items()}
        return EqMotionTrainState(params=params,
                                  opt_state=self.tx.init(params),
                                  step=0), vnet_params

    def _apply(self, params, past):
        return functional_call(self.model, params, (past,))

    @staticmethod
    def _locoval_inputs(past, pred):
        """Each mode rebased to the ego's last observed position with the
        origin first, (B, M, Tf + 1, 2), and the ego's initial velocity."""
        cur = past[:, 0, -1:]
        init_vel = (past[:, 0, -1] - past[:, 0, -2]) * 2.5
        rel = pred - cur[:, None]                            # (B,M,Tf,2)
        trajs = torch.cat([torch.zeros_like(rel[:, :, :1]), rel], 2)
        return trajs, init_vel

    def loss_and_grads(self, params, vnet_params, past, future):
        """(total, {wta, value_loss}, gradient by parameter) of one batch;
        the ego agent is index 0."""
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            pred = self._apply(p, past)                      # (B,A,M,Tf,2)
            # sqrt(Σd² + 1e-12), not a norm: a standing pedestrian is
            # predicted exactly at init, where a norm's gradient is NaN
            d = pred[:, 0] - future[:, 0:1]
            err = torch.sqrt(torch.sum(d * d, -1) + 1e-12)   # (B,M,Tf)
            wta = torch.amin(err.mean(-1), -1).mean()
            total = wta
            vloss = torch.zeros((), device=past.device, dtype=past.dtype)
            if self.vnet is not None and self.valueloss_w > 0:
                trajs, init_vel = self._locoval_inputs(past, pred[:, 0])
                B, Mm = trajs.shape[:2]
                v = functional_call(self.vnet, vnet_params, (
                    trajs.reshape(B * Mm, -1, 2), None,
                    init_vel.repeat_interleave(Mm, 0)))
                per_mode = ((v - 1.0) ** 2).reshape(B, Mm)
                if self.value_loss_mode == "wta":
                    win = err.mean(-1).argmin(-1).detach()
                    vloss = torch.mean(per_mode.gather(1, win[:, None]))
                else:
                    vloss = per_mode.mean()
                total = total + self.valueloss_w * vloss
            grads = grads_or_zeros(total, p)
        aux = dict(wta=wta.detach(), value_loss=vloss.detach())
        return total.detach(), aux, grads

    def train_step(self, ts: EqMotionTrainState, vnet_params, past, future):
        """One Adam step → (ts, {wta, value_loss} as 0-d device tensors).
        past (B, A, Tp, 2); future (B, A, Tf, 2)."""
        past, future = (torch.as_tensor(a, device=self.device)
                        for a in (past, future))
        _, aux, grads = self.loss_and_grads(ts.params, vnet_params, past,
                                            future)
        params, opt = self.tx.update(grads, ts.opt_state, ts.params)
        return ts.replace(params=params, opt_state=opt,
                          step=ts.step + 1), aux

    @torch.no_grad()
    def predict(self, params, past):
        return self._apply(params, torch.as_tensor(past, device=self.device))

    @torch.no_grad()
    def mode_values(self, vnet_params, past, pred):
        """The LocoVal value of each mode, mode by mode (reference
        main_eth_diverse.py:189): pred (B, M, Tf, 2) → (B, M)."""
        past = torch.as_tensor(past, device=self.device)
        trajs, init_vel = self._locoval_inputs(past, pred)
        return torch.stack([
            functional_call(self.vnet, vnet_params,
                            (trajs[:, m], None, init_vel))
            for m in range(trajs.shape[1])], -1)

    def vis_dict(self, params, past, future, vnet_params=None) -> dict:
        """A batch in the shared vis_dict schema (prediction/visualize.py):
        the ego's observed track, its ground-truth future, the modes'
        predictions (S, Tf, M, 2) and, with a valuenet, their values."""
        past = torch.as_tensor(past, device=self.device)
        future = torch.as_tensor(future, device=self.device)
        pred = self.predict(params, past)[:, 0]              # (B,M,Tf,2)
        out = {"obs": past[:, 0, :, :2].cpu().numpy(),
               "gt": future[:, 0, :, :2].cpu().numpy(),
               "pred": pred.movedim(1, 2)[..., :2].cpu().numpy()}
        if self.vnet is not None and vnet_params is not None:
            out["values"] = self.mode_values(vnet_params, past,
                                             pred).cpu().numpy()
        return out

    @torch.no_grad()
    def evaluate(self, params, past, future, vnet_params=None,
                 threshold: float = 0.7) -> dict:
        """ADE/FDE over modes; with vnet_params also the LocoVal filter's
        metrics (reference main_eth_diverse.py:189: every mode scored, the
        modes at or above the threshold kept, else the best-valued one)."""
        past = torch.as_tensor(past, device=self.device)
        future = torch.as_tensor(future, device=self.device)
        pred = self.predict(params, past)[:, 0]              # (B,M,Tf,2)
        pred_t = pred.movedim(1, 2)                          # (B,Tf,M,2)
        out = {k: float(v) for k, v in M.ade_fde(pred_t, future[:, 0]).items()
               if not k.endswith("per_mode")}
        if self.vnet is not None and vnet_params is not None:
            values = self.mode_values(vnet_params, past, pred)
            keep = M.locoval_filter(pred_t, values, threshold)
            err = torch.linalg.vector_norm(pred - future[:, 0:1],
                                           dim=-1).mean(-1)
            big = torch.where(keep, err, torch.full_like(err, np.inf))
            out["ade_filtered_min"] = float(big.amin(-1).mean())
            out["mean_value"] = float(values.mean())
        return out

    # ------------------------------------------------------------------

    def flax_params(self, params: dict) -> dict:
        """The model's state_dict → the flax params tree as numpy."""
        if isinstance(self.model, EqMotion):
            return convert.eqmotion_params(params)
        return convert.eqmotion_full_params(params)

    def params_from(self, tree) -> dict:
        """A flax params tree of this trainer's model (either package's
        eqmotion.ckpt) → its parameters on the trainer's device."""
        sd = (convert.eqmotion_state_dict(tree)
              if isinstance(self.model, EqMotion)
              else convert.eqmotion_full_state_dict(tree))
        return {k: v.to(self.device) for k, v in sd.items()}

    def save_checkpoint(self, path: str, params: dict,
                        metadata: Optional[dict] = None):
        """`eqmotion.ckpt` as the JAX package's train-eqmotion writes it:
        {"params": the flax tree}, and `metadata` (the JAX command stores
        str(cfg) under "cfg")."""
        save_pytree(path, {"params": self.flax_params(params)}, metadata)


# ---------------------------------------------------------------------------
# synthetic domains: draws on a generator, batches from the draws
# ---------------------------------------------------------------------------

def _uniform(gen, shape, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                       device=gen.device)


def eth_draws(gen: torch.Generator, batch: int = 8, agents: int = 4) -> dict:
    """The draws of one synthetic ETH-like batch: speed U(0.3, 1.8), initial
    heading U(−π, π), curvature N(0, 0.1²), each (B, A, 1), and the
    offset U(−5, 5) (B, A, 1, 2)."""
    shape = (batch, agents, 1)
    return dict(speed=_uniform(gen, shape, 0.3, 1.8),
                heading0=_uniform(gen, shape, -np.pi, np.pi),
                curv=torch.randn(shape, generator=gen, device=gen.device)
                * 0.1,
                offset=_uniform(gen, (batch, agents, 1, 2), -5.0, 5.0))


def eth_batch(draws: dict, past: int = 8, future: int = 12):
    """ETH-UCY-like pedestrian scenes (2.5 Hz world coordinates) from
    `eth_draws`: (past (B, A, Tp, 2), future (B, A, Tf, 2))."""
    speed, curv = draws["speed"], draws["curv"]
    t = torch.arange(past + future, device=speed.device)[None, None]
    heading = draws["heading0"] + curv * t
    v = torch.stack([speed * torch.cos(heading), speed * torch.sin(heading)],
                    -1)
    xy = torch.cumsum(v, 2) / ETH_FPS + draws["offset"]
    return xy[:, :, :past], xy[:, :, past:]


def synthetic_eth_batch(gen: torch.Generator, batch: int = 8,
                        agents: int = 4, past: int = 8, future: int = 12):
    """Random ETH-UCY-like scenes on `gen`'s device."""
    return eth_batch(eth_draws(gen, batch, agents), past, future)


def nbody_draws(gen: torch.Generator, batch: int = 8, bodies: int = 5,
                dim: int = 3):
    """(x0 N(0, 1), v0 N(0, 0.5²)), each (B, bodies, dim)."""
    x0 = torch.randn((batch, bodies, dim), generator=gen, device=gen.device)
    v0 = torch.randn((batch, bodies, dim), generator=gen,
                     device=gen.device) * 0.5
    return x0, v0


def nbody_batch(x0, v0, past: int = 10, future: int = 10, dt: float = 0.05,
                k_spring: float = 0.5):
    """N-body spring-system rollouts (the reference's n_body_system domain):
    symplectic Euler under pairwise linear springs from (x0, v0). Returns
    (past, future), each (B, bodies, T, dim)."""
    x, v = x0, v0
    xs = []
    for _ in range(past + future):
        d = x[:, :, None] - x[:, None]                        # (B,N,N,dim)
        v = v + dt * (-k_spring * torch.sum(d, 2))
        x = x + dt * v
        xs.append(x)
    xs = torch.stack(xs, 2)                                   # (B,N,T,dim)
    return xs[:, :, :past], xs[:, :, past:]


def synthetic_nbody_batch(gen: torch.Generator, batch=8, bodies=5, past=10,
                          future=10, dim=3, dt=0.05, k_spring=0.5):
    return nbody_batch(*nbody_draws(gen, batch, bodies, dim), past, future,
                       dt, k_spring)


def nbody_config(past=10, future=10, nmode=1) -> EqMotionConfig:
    """The n-body domain: single-mode regression, as the reference's
    n_body_system main."""
    return EqMotionConfig(past_length=past, future_length=future,
                          hidden_nf=64, hid_channel=32, n_layers=4,
                          nmode=nmode)


def h36m_library(device=None):
    """The gait library the h36m domain samples when given none."""
    from ..kinematics import motion_lib as ml
    return ml.synthetic_walk_motions(speeds=(0.8, 1.2, 1.6), duration=4.0,
                                     device=device)


def h36m_draws(gen: torch.Generator, lib, batch: int = 8, past: int = 10,
               future: int = 10, fps: float = 25.0):
    """(motion ids (B,), start times (B,)) of one h36m batch."""
    from ..kinematics import motion_lib as ml
    ids = ml.sample_motions(lib, gen, batch)
    t0 = ml.sample_time(lib, gen, ids, truncate_time=(past + future) / fps)
    return ids, t0


def h36m_batch(lib, ids, t0, past: int = 10, future: int = 10,
               fps: float = 25.0):
    """The human-motion domain (the reference's EqMotion/h36m): the 24
    skeleton joints of one person are the nodes, their 3-D trajectories
    from forward kinematics of the library's gaits at (ids, t0).
    Returns (past, future), each (B, 24, T, 3)."""
    from ..kinematics import body_model as bm
    from ..kinematics import motion_lib as ml
    from ..kinematics.skeleton import forward_kinematics
    T = past + future
    B = ids.shape[0]
    times = t0[:, None] + torch.arange(T, device=t0.device)[None] / fps
    st = ml.get_motion_state(lib, ids.repeat_interleave(T),
                             times.reshape(-1))
    _, jpos = forward_kinematics(bm.canonical_skeleton(), st["local_rot"],
                                 st["root_pos"])
    jpos = jpos.reshape(B, T, -1, 3)                          # (B,T,J,3)
    return (jpos[:, :past].transpose(1, 2), jpos[:, past:].transpose(1, 2))


def synthetic_h36m_batch(gen: torch.Generator, batch=8, past=10, future=10,
                         fps=25.0, lib=None):
    if lib is None:
        lib = h36m_library(gen.device)
    ids, t0 = h36m_draws(gen, lib, batch, past, future, fps)
    return h36m_batch(lib, ids, t0, past, future, fps)


def h36m_config(past=10, future=10, nmode=1) -> EqMotionConfig:
    return EqMotionConfig(past_length=past, future_length=future,
                          hidden_nf=64, hid_channel=32, n_layers=4,
                          nmode=nmode)


def load_md17_structure(molecule: str = "aspirin"):
    """A molecule's heavy-atom bond graph for the MD17 domain (the
    reference's md17/preprocess.py:59 → <molecule>_structure.npy; aspirin's
    13 atoms ship with the repo), from EMLOCO_MD17_DIR first. Returns the
    (N, N) 0/1 float32 matrix, or None when there is none."""
    for root in (os.environ.get("EMLOCO_MD17_DIR"), MD17_FIXTURES):
        if not root:
            continue
        p = os.path.join(root, f"{molecule}_structure.npy")
        if os.path.exists(p):
            adj = np.load(p)
            if adj.ndim == 2 and adj.shape[0] == adj.shape[1]:
                return (np.asarray(adj) > 0.5).astype(np.float32)
    return None


def _embed_structure(adj: np.ndarray, bond_len: float = 1.4,
                     iters: int = 800, seed: int = 0) -> np.ndarray:
    """A deterministic 3-D equilibrium geometry for a bond graph: gradient
    descent on harmonic bond springs (rest bond_len) and a short-range
    repulsion between non-bonded atoms, in numpy."""
    n = adj.shape[0]
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 3) * 0.5
    bonded = adj > 0.5
    np.fill_diagonal(bonded, True)                        # mask self-pairs
    for _ in range(iters):
        d = x[:, None] - x[None]                          # (N,N,3)
        dist = np.sqrt((d ** 2).sum(-1)) + 1e-9
        f_bond = np.where(adj > 0.5, dist - bond_len, 0.0)
        rep = np.where(~bonded & (dist < 2.0 * bond_len),
                       dist - 2.0 * bond_len, 0.0)        # soft repulsion
        coef = (f_bond + 0.3 * rep) / dist
        x = x - 0.05 * (coef[..., None] * d).sum(1)
        x -= x.mean(0)
    return x.astype(np.float32)


def md17_draws(gen: torch.Generator, batch: int = 8, atoms: int = 13):
    """(rotation quaternions before normalization (B, 4), position jitter
    N(0, 1) (B, N, 3), velocities N(0, 1) (B, N, 3)); md17_batch scales
    the jitter by 0.05 and the velocities by 0.4."""
    def normal(*shape):
        return torch.randn(shape, generator=gen, device=gen.device)
    return normal(batch, 4), normal(batch, atoms, 3), normal(batch, atoms, 3)


def _md17_geometry(atoms: int, structure, device):
    """(equilibrium geometry (N, 3), bond endpoints i and j)."""
    if structure is not None:
        adj = np.asarray(structure)
        eq = torch.as_tensor(_embed_structure(adj), device=device)
        ii, jj = np.nonzero(np.triu(adj, 1))
        bonds = list(zip(ii.tolist(), jj.tolist()))
        # angle stiffness: second neighbours (atoms sharing a bonded atom)
        two_hop = (adj @ adj > 0.5) & (adj < 0.5)
        np.fill_diagonal(two_hop, False)
        ii2, jj2 = np.nonzero(np.triu(two_hop, 1))
        bonds += list(zip(ii2.tolist(), jj2.tolist()))
    else:
        # a jittered 3-D zig-zag chain, one molecule a call
        t = torch.arange(atoms, dtype=torch.float32, device=device)
        eq = torch.stack([t * 1.2, 0.6 * torch.cos(t * 2.1),
                          0.6 * torch.sin(t * 1.3)], -1)
        bonds = [(i, i + 1) for i in range(atoms - 1)]
        bonds += [(i, i + 2) for i in range(atoms - 2)]
    bi = torch.as_tensor([b[0] for b in bonds], device=device)
    bj = torch.as_tensor([b[1] for b in bonds], device=device)
    return eq, bi, bj


def md17_batch(draws, past: int = 25, future: int = 25, dt: float = 0.02,
               k_bond: float = 8.0, damping: float = 0.02, structure=None):
    """The molecular-dynamics domain (the reference's EqMotion/md17: one
    molecule's atom trajectories, 25 past → 25 future frames): harmonic
    bonds around the equilibrium geometry, damped symplectic Euler, each
    batch element under a random global rotation, from `md17_draws`.
    `structure` takes a real (N, N) bond graph (load_md17_structure());
    the default is a chain with skip bonds. Returns (past, future), each
    (B, atoms, T, 3). The force sum is an index_add_, whose float atomics
    on CUDA do not add in a fixed order."""
    from ..ops import quat as Q
    q_raw, jitter, vel = draws
    B, atoms = jitter.shape[:2]
    if structure is not None and atoms != np.asarray(structure).shape[0]:
        raise ValueError(f"draws for {atoms} atoms, structure of "
                         f"{np.asarray(structure).shape[0]}")
    eq, bi, bj = _md17_geometry(atoms, structure, jitter.device)
    r0 = torch.linalg.vector_norm(eq[bi] - eq[bj], dim=-1)    # rest lengths
    q = Q.normalize(q_raw)
    x = Q.rotate(q[:, None].expand(B, atoms, 4), eq[None] + 0.05 * jitter)
    v = 0.4 * vel
    v = v - v.mean(1, keepdim=True)                           # zero momentum
    xs = []
    for _ in range(past + future):
        d = x[:, bi] - x[:, bj]                               # (B, E, 3)
        dist = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        f_e = -k_bond * (dist - r0[None, :, None]) * d / (dist + 1e-8)
        f = torch.zeros_like(x).index_add_(1, bi, f_e).index_add_(1, bj,
                                                                  -f_e)
        v = (1.0 - damping) * v + dt * f
        x = x + dt * v
        xs.append(x)
    xs = torch.stack(xs, 2)                                   # (B,N,T,3)
    return xs[:, :, :past], xs[:, :, past:]


def synthetic_md17_batch(gen: torch.Generator, batch=8, atoms=13, past=25,
                         future=25, dt=0.02, k_bond=8.0, damping=0.02,
                         structure=None):
    """`md17_batch` on fresh draws; with `structure` the atom count is the
    structure's (a conflicting explicit `atoms` is an error)."""
    if structure is not None:
        n = np.asarray(structure).shape[0]
        if atoms not in (13, n):
            raise ValueError(f"atoms={atoms} conflicts with structure of {n} "
                             "atoms; omit `atoms` when passing `structure`")
        atoms = n
    return md17_batch(md17_draws(gen, batch, atoms), past, future, dt,
                      k_bond, damping, structure)


def md17_config(past=25, future=25, nmode=1) -> EqMotionConfig:
    """The MD17 domain (reference main_md17.py: 25 past / 25 future frames,
    single-mode)."""
    return EqMotionConfig(past_length=past, future_length=future,
                          hidden_nf=64, hid_channel=32, n_layers=4,
                          nmode=nmode)


# ---------------------------------------------------------------------------
# ETH-UCY raw annotations
# ---------------------------------------------------------------------------

def read_ethucy_txt(path: str):
    """An ETH-UCY annotation file: one row per observation, whitespace-
    separated `frame_id ped_id x y` in world metres, every 10 video frames
    (2.5 Hz). Returns (sorted frame ids (F,), {frame: {ped: (x, y)}})."""
    data = np.loadtxt(path, dtype=np.float64)
    if data.ndim == 1:
        data = data[None]
    frames = np.unique(data[:, 0])
    table = {f: {} for f in frames}
    for f, p, x, y in data:
        table[f][int(p)] = (float(x), float(y))
    return frames, table


def ethucy_windows(path: str, past: int = 8, future: int = 12,
                   num_agents: int = 4, stride: int = 1,
                   pad_offset: float = 1e3):
    """Slide a (past + future)-frame window over the annotated frames and
    emit one sample per pedestrian present in every frame of it: the ego at
    agent 0, then the nearest co-present pedestrians at the last observed
    frame; missing slots are static dummies at anchor + pad_offset·k m,
    outside any interaction radius. `path` may be a comma-separated list:
    windows are built per file and concatenated (frame ids collide across
    scenes). Returns (past (S, A, Tp, 2), future (S, A, Tf, 2)) float32."""
    if "," in path:
        parts = [ethucy_windows(p, past, future, num_agents, stride,
                                pad_offset)
                 for p in path.split(",") if p]
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))
    frames, table = read_ethucy_txt(path)
    T = past + future
    past_out, future_out = [], []
    for i in range(0, len(frames) - T + 1, stride):
        window = frames[i:i + T]
        present = set(table[window[0]].keys())
        for f in window[1:]:
            present &= set(table[f].keys())
        if not present:
            continue
        tracks = {p: np.asarray([table[f][p] for f in window])
                  for p in present}                        # (T, 2) each
        for ego in sorted(present):
            anchor = tracks[ego][past - 1]
            others = sorted(
                (p for p in present if p != ego),
                key=lambda p: np.hypot(*(tracks[p][past - 1] - anchor)))
            arr = np.empty((num_agents, T, 2), np.float32)
            arr[0] = tracks[ego]
            for k in range(1, num_agents):
                if k - 1 < len(others):
                    arr[k] = tracks[others[k - 1]]
                else:
                    arr[k] = anchor + pad_offset * k       # static dummy
            past_out.append(arr[:, :past])
            future_out.append(arr[:, past:])
    if not past_out:
        raise ValueError(f"no complete {T}-frame windows in {path}")
    return np.stack(past_out), np.stack(future_out)


def ethucy_batches(past_arr, future_arr, batch_size: int,
                   gen: Optional[torch.Generator] = None, perm=None,
                   device=None):
    """Shuffled full batches of the windows (drop_last, as the reference's
    train DataLoader, main_eth_diverse.py:163) as tensors on `device`: the
    order is `perm`, else a permutation drawn on `gen`."""
    S = past_arr.shape[0]
    if perm is None:
        perm = torch.randperm(S, generator=gen, device=gen.device)
    perm = np.asarray(perm.cpu() if torch.is_tensor(perm) else perm)
    dev = _device.resolve(device)
    for i in range(0, S - batch_size + 1, batch_size):
        idx = perm[i:i + batch_size]
        yield (torch.as_tensor(past_arr[idx], device=dev),
               torch.as_tensor(future_arr[idx], device=dev))
