"""PPO + AMP agent (port of emloco_tpu/learning/amp_agent.py).

One training epoch, `AMPAgent.train_epoch`, runs in three parts that a
caller timing them may also call in turn:
  * rollout — `horizon` control steps of the env under the current policy
    (action noise μ + σ·ε, the critic's value on the normalized obs, the
    feature-space mirror of each obs for the symmetry loss), into buffers
    allocated once per epoch, then the env's hard-negative refresh of its
    motion-sampling weights;
  * prepare — the discriminator reward and GAE, the obs / AMP / value norms
    (updated after the rollout: the pools are normalized with the updated
    norms while logp was taken under the old one), the normalized
    advantages (population std), the replay ring's insert and draw, and the
    demo windows fetched from the motion library under the env's live
    motion-sampling weights;
  * update — `mini_epochs` × `num_minibatches` PPO + AMP updates, each with
    its three AMP dropout masks, the R1 gradient penalty on the demo batch,
    the motion-symmetry loss and a nonfinite guard that drops the whole
    update (parameters, moments and count) on the device.
The combined reward is task_w·task + disc_w·(−log(max(1 − σ(D), 1e-4))·2).

The network is `AMPConfig.network`'s ("sept", or "sept_cnn" with the conv
encoder over the sensor image), with the people pointnet under the env's
group_obs and bfloat16 hidden layers under `hidden_bf16` (`build_net`).
`query_value_gradient` gives the critic's value under hypothetical
trajectories and its gradient with respect to them.

Parameters are a dict of tensors under the network's state_dict names; the
heads run through `torch.func.functional_call`, so an update is a pure
function of its inputs on whatever device they lie. The optimizer is optax's
`chain(clip_by_global_norm(grad_norm), adam(lr))` written out on tensors
(`ClipAdam`), one kernel over every leaf on the card (`fused_adam`).

On the card a minibatch's loss and gradients (the heads' forwards, R1's
double backward and the gradient of every leaf) run as one CUDA graph
(`utils/cuda_graph.py`), captured on the first call of each key and
replayed after: the key is the network, the config, the settings that
choose the kernels, and each input's dtype, shape and stride (so masks or
none, and each row count, get their own graph; `_loss_graph_key`). The
CPU, a mesh's split (row counts that change by minibatch) and a net with
Python hooks run eagerly. `LOSS_GRAPH` counts captures, replays and eager
calls.

Random streams: `jax.random` cannot be reproduced in torch. The agent draws
every number from the one torch.Generator in `TrainState.rng`, in this
order: in the rollout, per step, one standard normal (N, A) for the action
noise; in prepare, a permutation of T·N for the replay insert (only when T·N
exceeds the ring), the replay rows (uniform integers below the fill), then
the demo windows' motion ids and times; in the update, per mini-epoch one
permutation of T·N, then per minibatch three uniform dropout draws (the
rollout, replay and demo rows) when `amp_dropout` is on. The env draws from
its own generator in EnvState.rng.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils._pytree import tree_flatten

from ..envs import observations as obs_mod
from ..envs.pedestrian_terrain import (GROUP_OBS_DIM, EnvConfig, EnvState,
                                       PedestrianTerrainEnv)
from ..parallel import mesh as pmesh
from ..struct import TensorStruct
from ..utils import cuda_graph
from ..utils.profiling import annotate
from . import fused_adam, networks
from .networks import AMPSeptCNNNet, AMPSeptValueNet
from .running_norm import RunningNorm, moments

NETWORKS = ("sept", "sept_cnn")

# minibatch loss-and-gradient calls since the last reset: graphs captured,
# calls replayed (the first call of a key too), calls run eagerly
LOSS_GRAPH = {"captures": 0, "replays": 0, "eager": 0}


def reset_loss_graph_counts():
    for k in LOSS_GRAPH:
        LOSS_GRAPH[k] = 0


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


def _hooked(net: torch.nn.Module) -> bool:
    """Whether a Python hook would run in the net's forward or backward (a
    replayed graph runs none)."""
    g = torch.nn.modules.module
    return (bool(g._global_forward_hooks or g._global_forward_pre_hooks
                 or g._global_backward_hooks
                 or g._global_backward_pre_hooks)
            or any(m._forward_hooks or m._forward_pre_hooks
                   or m._backward_hooks or m._backward_pre_hooks
                   for m in net.modules()))


@dataclasses.dataclass(frozen=True)
class AMPConfig:
    horizon: int = 32
    num_minibatches: int = 20
    mini_epochs: int = 6
    gamma: float = 0.99
    tau: float = 0.95
    lr: float = 2e-5
    e_clip: float = 0.2
    grad_norm: float = 50.0
    actor_coef: float = 1.0
    critic_coef: float = 5.0
    bounds_coef: float = 10.0
    disc_coef: float = 5.0
    tv_coef: float = 5.0
    sym_coef: float = 1.0
    motion_sym_loss: bool = True
    disc_logit_reg: float = 0.01
    disc_grad_penalty: float = 5.0
    disc_weight_decay: float = 1e-4
    disc_reward_scale: float = 2.0
    task_reward_w: float = 0.5
    disc_reward_w: float = 0.5
    amp_replay_size: int = 200_000
    amp_batch_size: int = 1280
    amp_dropout: bool = True
    amp_dropout_rate: float = 0.3
    hidden_bf16: bool = False
    network: str = "sept"
    normalize_input: bool = True
    normalize_value: bool = True
    normalize_advantage: bool = True
    max_cum_reward: float = 100.0
    min_cum_reward: float = -10.0

    def __post_init__(self):
        if self.network not in NETWORKS:
            raise ValueError(f"unknown network {self.network!r}")


def build_net(ecfg: EnvConfig, task_obs_dim: int, amp_dim: int,
              network: str = "sept", hidden_bf16: bool = False,
              generator: torch.Generator | None = None, device=None,
              **widths) -> AMPSeptValueNet:
    """The network `network` names for the env configuration `ecfg`: the
    people pointnet over the crowd observation under group_obs; for
    "sept_cnn" the conv encoder over the square sensor image (3 channels
    under velocity_map), which other sensors refuse with ValueError."""
    kw = dict(people_obs_dim=GROUP_OBS_DIM if ecfg.group_obs else 0,
              hidden_bf16=hidden_bf16, generator=generator, device=device,
              **widths)
    args = (ecfg.num_actions, ecfg.self_obs_dim, ecfg.num_traj_samples * 2,
            task_obs_dim, amp_dim)
    if network == "sept_cnn":
        if ecfg.sensor_shape != "square" or not ecfg.terrain_obs:
            raise ValueError(
                "sept_cnn needs the square res² sensor image "
                f"(sensor_shape={ecfg.sensor_shape!r}, "
                f"terrain_obs={ecfg.terrain_obs})")
        return AMPSeptCNNNet(*args, sensor_res=ecfg.sensor_res,
                             sensor_channels=3 if ecfg.velocity_map else 1,
                             **kw)
    if network == "sept":
        return AMPSeptValueNet(*args, **kw)
    raise ValueError(f"unknown network {network!r}")


@dataclasses.dataclass(frozen=True)
class AdamState(TensorStruct):
    count: torch.Tensor            # () int32, updates applied
    mu: dict                       # first moments, by parameter name
    nu: dict                       # second moments

    @classmethod
    def zeros_like(cls, params: dict) -> "AdamState":
        """The state before the first step: count 0, zero moments."""
        dev = next(iter(params.values())).device
        return cls(count=torch.zeros((), dtype=torch.int32, device=dev),
                   mu={k: torch.zeros_like(v) for k, v in params.items()},
                   nu={k: torch.zeros_like(v) for k, v in params.items()})


# optax adam's defaults, which the JAX agent's `adam(lr)` takes
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def adam_directions(grads: dict, state: AdamState):
    """optax scale_by_adam (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) on
    dicts of tensors: (the new state, the bias-corrected directions, which
    the caller scales by −lr). The bias corrections divide the moments, as
    optax applies them."""
    count = state.count + 1
    bc1 = 1 - _B1 ** count.float()
    bc2 = 1 - _B2 ** count.float()
    mu, nu, u = {}, {}, {}
    for k, g in grads.items():
        mu[k] = (1 - _B1) * g + _B1 * state.mu[k]
        nu[k] = (1 - _B2) * (g * g) + _B2 * state.nu[k]
        u[k] = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + _EPS)
    return AdamState(count=count, mu=mu, nu=nu), u


@dataclasses.dataclass(frozen=True)
class ClipAdam:
    """optax.chain(clip_by_global_norm(max_norm), adam(lr)) on dicts of
    tensors, one `fused_adam.clip_adam` step (the kernel on the card, per-leaf
    ops on the CPU). The clip scales by max_norm / norm only when
    norm ≥ max_norm (no 1e-6, unlike clip_grad_norm_)."""

    max_norm: float
    lr: float

    def init(self, params: dict) -> AdamState:
        return AdamState.zeros_like(params)

    def clip(self, grads: dict) -> dict:
        return fused_adam.clip(grads, self.max_norm)

    def schedule(self):
        """(transition_steps, decay) of the rate's staircase decay, or None
        for the constant rate lr."""
        return None

    def step(self, grads: dict, state: AdamState, params: dict,
             guard: bool = False):
        """(new params, new state, finite) after one step on `grads`; with
        `guard` a nonfinite gradient drops the whole step."""
        p, count, mu, nu, finite = fused_adam.clip_adam(
            grads, params, state.count, state.mu, state.nu, self.max_norm,
            self.lr, self.schedule(), guard)
        return p, AdamState(count=count, mu=mu, nu=nu), finite

    def update(self, grads: dict, state: AdamState, params: dict):
        """(new params, new state) after one step on `grads`."""
        return self.step(grads, state, params)[:2]


@dataclasses.dataclass(frozen=True)
class MinibatchSplit:
    """A rank's part of a minibatch under a mesh (without one, all of
    it): its first `rollout` rows
    are rollout rows of the discriminator's agent batch, and each loss term
    is the sum over its rows divided by the whole minibatch's count of that
    term's rows (`mb` rows, `agent` discriminator agent rows, `demo` demo
    rows); the terms of the parameters alone (the logit and weight-decay
    penalties) count on the rank with `param_terms` only."""

    rollout: int
    mb: int
    agent: int
    demo: int
    param_terms: bool


@dataclasses.dataclass(frozen=True)
class TrainState(TensorStruct):
    params: dict                   # network parameters by state_dict name
    opt_state: AdamState
    obs_norm: RunningNorm
    amp_norm: RunningNorm
    value_norm: RunningNorm
    env_state: EnvState
    replay_amp: torch.Tensor       # (R, amp_dim) ring, updated in place
    replay_ptr: int                # sizes only: host ints, no sync
    replay_filled: int
    rng: torch.Generator           # every draw of the agent
    epoch: int
    task_reward_w: torch.Tensor    # () f32
    disc_reward_w: torch.Tensor    # () f32


class AMPAgent:
    """Holds the env, the network's structure and the optimizer; the
    parameters, optimizer state, norms and env state travel in TrainState.

    Under the env's mesh (`env.mesh`, R ranks) each rank steps its block of
    the envs, and the epoch is the one-rank epoch's computation: the action
    noise, the replay insert's permutation, the replay and demo draws, the
    minibatch permutations and the dropout masks are drawn whole from the
    replicated generator; the norms and the advantage normalization take
    every rank's rows; the replay ring is written with every rank's rows;
    each minibatch's rows, and the replay and demo blocks split by index,
    are spread over the ranks, each loss term summed over a rank's rows and
    divided by the whole minibatch's count; the gradients are summed over
    the ranks before the clip, and the metrics reduced."""

    def __init__(self, env: PedestrianTerrainEnv,
                 cfg: AMPConfig = AMPConfig()):
        self.env = env
        self.mesh = env.mesh
        self.cfg = cfg
        ecfg = env.cfg
        self.amp_dim = ecfg.num_amp_obs_steps * ecfg.amp_obs_per_step
        # the structure; `init` draws the weights (a fixed generator here
        # leaves torch's global one alone)
        self.net = build_net(
            ecfg, env.task_obs_dim, self.amp_dim, cfg.network,
            cfg.hidden_bf16,
            generator=torch.Generator(device=env.device).manual_seed(0),
            device=env.device)
        self.tx = ClipAdam(cfg.grad_norm, cfg.lr)
        self._loss_graphs = {}          # key → cuda_graph.Captured

    # ------------------------------------------------------------------

    def init(self, seed: int) -> TrainState:
        """Fresh weights, optimizer state, norms, replay ring and env state;
        the weights, the env and the agent draw from three generators seeded
        from `seed`."""
        dev = self.env.device
        s_net, s_env, s_agent = (
            int(s) for s in np.random.SeedSequence(seed).generate_state(
                3, np.uint64))
        self.net.init_parameters(
            torch.Generator(device=dev).manual_seed(s_net))
        params = {k: v.detach().clone()
                  for k, v in self.net.named_parameters()}
        cfg = self.cfg
        return TrainState(
            params=params,
            opt_state=self.tx.init(params),
            obs_norm=RunningNorm.create(self.env.obs_dim, device=dev),
            amp_norm=RunningNorm.create(self.amp_dim, device=dev),
            value_norm=RunningNorm.create(1, device=dev),
            env_state=self.env.reset(
                torch.Generator(device=dev).manual_seed(s_env)),
            replay_amp=torch.zeros((cfg.amp_replay_size, self.amp_dim),
                                   device=dev),
            replay_ptr=0,
            replay_filled=0,
            rng=torch.Generator(device=dev).manual_seed(s_agent),
            epoch=0,
            task_reward_w=torch.tensor(cfg.task_reward_w, device=dev),
            disc_reward_w=torch.tensor(cfg.disc_reward_w, device=dev),
        )

    def _apply(self, params, method, *inputs):
        """The head `method` under `params` (flax's net.apply)."""
        return functional_call(self.net, params, inputs, {"method": method})

    # ------------------------------------------------------------------
    # rollout
    # ------------------------------------------------------------------

    def _policy(self, params, obs_norm, obs, gen):
        with annotate("policy.actor"):
            o = obs_norm.normalize(obs) if self.cfg.normalize_input else obs
            mu, sigma = self._apply(params, "actor", o)
            a = mu + sigma * pmesh.draw_rows(torch.randn, mu.shape,
                                             self.mesh, generator=gen,
                                             device=mu.device)
            return a, mu, sigma, self._logp(mu, sigma, a), o

    @staticmethod
    def _logp(mu, sigma, a):
        return (-0.5 * (((a - mu) / sigma) ** 2)
                - torch.log(sigma)
                - 0.5 * math.log(2 * math.pi)).sum(-1)

    def _disc_reward(self, params, amp_norm, amp_obs):
        with annotate("policy.disc_reward"):
            logit = self._apply(params, "disc", amp_norm.normalize(amp_obs))
            prob = torch.sigmoid(logit)
            return (-torch.log(torch.clamp(1 - prob, min=1e-4))
                    * self.cfg.disc_reward_scale)

    @torch.no_grad()
    def rollout(self, ts: TrainState):
        """`horizon` control steps → (ts with the new env state, the (T, N,
        …) batch, the last obs)."""
        with annotate("trainer.rollout"):
            cfg, env = self.cfg, self.env
            T, N, dev = cfg.horizon, env.num_envs, env.device
            A = env.cfg.num_actions

            def buf(*shape, dtype=torch.float32):
                return torch.empty((T, N) + shape, dtype=dtype, device=dev)

            batch = dict(obs=buf(env.obs_dim), action=buf(A), logp=buf(),
                         value=buf(), reward=buf(),
                         done=buf(dtype=torch.bool),
                         terminated=buf(dtype=torch.bool),
                         amp_obs=buf(self.amp_dim), reward_raw=buf(2))
            if cfg.motion_sym_loss:
                batch["flip_obs"] = buf(env.obs_dim)
            # the first obs is the one learning-facing tensor that does not
            # pass through StepOutput's sanitizer
            obs = torch.nan_to_num(env.observe(ts.env_state), nan=0.0,
                                   posinf=0.0, neginf=0.0)
            env_state = ts.env_state
            for t in range(T):
                if cfg.motion_sym_loss:
                    batch["flip_obs"][t] = env.observe_flipped_from(obs)
                a, _, _, logp, o_n = self._policy(ts.params, ts.obs_norm,
                                                  obs, ts.rng)
                with annotate("policy.critic"):
                    batch["value"][t] = self._apply(ts.params, "critic", o_n)
                env_state, out = env.step(env_state, a)
                batch["obs"][t] = obs
                batch["action"][t] = a
                batch["logp"][t] = logp
                for k in ("reward", "done", "terminated", "amp_obs",
                          "reward_raw"):
                    batch[k][t] = getattr(out, k)
                obs = out.obs
            env_state = env.apply_hard_negative_update(env_state)
            return ts.replace(env_state=env_state), batch, obs

    def query_value_gradient(self, ts: TrainState, env_state: EnvState,
                             new_traj):
        """The critic's value of each env's state under the hypothetical
        future trajectory samples `new_traj` (N, S, 3), and its gradient
        with respect to them: (values (N,), gradient (N, S, 3))."""
        traj = new_traj.detach().requires_grad_()
        with torch.enable_grad():
            o = self.env.observe_with_traj(env_state, traj)
            if self.cfg.normalize_input:
                o = ts.obs_norm.normalize(o)
            v = self._apply(ts.params, "critic", o)
            grad, = torch.autograd.grad(v.sum(), traj)
        return v.detach(), grad

    def compute_gae(self, ts: TrainState, batch, last_obs):
        """GAE over the (T, N) batch, in reverse. Every done step bootstraps
        0: the env auto-resets inside step, so the next state belongs to a
        fresh episode. Returns (advantages, returns, combined reward, disc
        reward)."""
        cfg = self.cfg
        disc_r = self._disc_reward(ts.params, ts.amp_norm, batch["amp_obs"])
        reward = (ts.task_reward_w * batch["reward"]
                  + ts.disc_reward_w * disc_r)
        o_n = (ts.obs_norm.normalize(last_obs) if cfg.normalize_input
               else last_obs)
        last_value = self._apply(ts.params, "critic", o_n)
        if cfg.normalize_value:
            values = ts.value_norm.denormalize(batch["value"][..., None])[
                ..., 0]
            last_value = ts.value_norm.denormalize(last_value[..., None])[
                ..., 0]
        else:
            values = batch["value"]
        advs = torch.empty_like(reward)
        adv_next, v_next = torch.zeros_like(last_value), last_value
        for t in reversed(range(reward.shape[0])):
            nondone = 1.0 - batch["done"][t].float()
            delta = reward[t] + cfg.gamma * v_next * nondone - values[t]
            adv_next = delta + cfg.gamma * cfg.tau * nondone * adv_next
            advs[t] = adv_next
            v_next = values[t]
        return advs, advs + values, reward, disc_r

    # ------------------------------------------------------------------
    # losses
    # ------------------------------------------------------------------

    def _loss_and_grads(self, params, mb, demo_amp, replay_amp, masks,
                        split: MinibatchSplit | None = None):
        """(total loss, loss terms, gradient by parameter) of one minibatch.
        `masks` are the (rollout, replay, demo) dropout masks, or None;
        `split` a rank's part of the minibatch under a mesh, where the terms
        are its partial sums (None: all of it, each term the mean of its
        rows). On the card without a split, a replay of the key's CUDA graph
        (captured on its first call); the tensors returned are the caller's
        own."""
        with annotate("trainer.loss_and_grads"):
            if (split is not None or not _on_card(demo_amp)
                    or _hooked(self.net)):
                LOSS_GRAPH["eager"] += 1
                return self._compute_loss_and_grads(
                    params, mb, demo_amp, replay_amp, masks, split)
            # no masks as () (a leaf of no tensor)
            leaves, spec = tree_flatten((params, mb, demo_amp, replay_amp,
                                         masks or ()))
            key = self._loss_graph_key(params, mb, leaves)
            graph = self._loss_graphs.get(key)
            if graph is None:
                with annotate("trainer.loss_graph_capture"):
                    graph = cuda_graph.Captured(
                        self._compute_loss_and_grads, leaves, spec,
                        counters=(networks.CONV_ENCODER,))
                self._loss_graphs[key] = graph
                LOSS_GRAPH["captures"] += 1
            with annotate("trainer.loss_graph_replay"):
                out = graph(leaves)
            LOSS_GRAPH["replays"] += 1
            return out

    def _loss_graph_key(self, params, mb, leaves):
        """What a captured loss graph is specific to: the network and the
        config (the coefficients are constants of the graph), the settings
        that choose its kernels (float32 matmul and conv precision, cuDNN's
        deterministic and benchmark modes, deterministic algorithms), the
        inputs' names, and each input's dtype, shape, stride and device (the
        masks' among them, or none)."""
        b = torch.backends
        return (self.net, self.cfg, b.cuda.matmul.fp32_precision,
                b.cudnn.conv.fp32_precision, b.cudnn.deterministic,
                b.cudnn.benchmark,
                torch.are_deterministic_algorithms_enabled(),
                tuple(params), tuple(mb),
                tuple((x.dtype, x.shape, x.stride(), x.device)
                      for x in leaves))

    def _compute_loss_and_grads(self, params, mb, demo_amp, replay_amp,
                                masks, split: MinibatchSplit | None = None):
        """`_loss_and_grads`, run eagerly (and the function its graphs
        capture)."""
        cfg = self.cfg
        if split is None:
            rows, half = mb["adv"].shape[0], replay_amp.shape[0]
            split = MinibatchSplit(rollout=half, mb=rows,
                                   agent=min(half, rows) + half,
                                   demo=demo_amp.shape[0],
                                   param_terms=True)
        n_roll, pt, den = split.rollout, float(split.param_terms), split

        def red(x, n):
            return x.sum() / n
        amp_rollout = mb["amp_n"][:n_roll]
        if masks:
            # constants w.r.t. the gradient, on the normalized features
            amp_rollout = amp_rollout * masks[0]
            replay_amp = replay_amp * masks[1]
            demo_amp = demo_amp * masks[2]
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            mu, sigma = self._apply(p, "actor", mb["obs_n"])
            logp = self._logp(mu, sigma, mb["action"])
            # exp(±16) keeps a far-moved policy's ratio inside float32
            ratio = torch.exp(torch.clamp(logp - mb["logp"], -16.0, 16.0))
            surr1 = ratio * mb["adv"]
            surr2 = torch.clamp(ratio, 1 - cfg.e_clip,
                                1 + cfg.e_clip) * mb["adv"]
            a_loss = -red(torch.minimum(surr1, surr2), den.mb)

            v = self._apply(p, "critic", mb["obs_n"])
            c_loss = 0.5 * red((v - mb["ret_n"]) ** 2, den.mb)

            b_loss = red(torch.sum(
                torch.clamp(mu - 1.1, min=0) ** 2
                + torch.clamp(mu + 1.1, max=0) ** 2, -1), den.mb)

            # discriminator: agent (rollout ∪ replay, half each) vs demo
            agent_logit = self._apply(p, "disc", torch.cat([amp_rollout,
                                                            replay_amp]))
            demo_in = demo_amp.detach().requires_grad_()
            demo_logit = self._apply(p, "disc", demo_in)
            d_loss = 0.5 * (red(F.softplus(agent_logit), den.agent)
                            + red(F.softplus(-demo_logit), den.demo))
            logit_reg = torch.sum(p["disc_logits.weight"] ** 2)
            # R1 penalty: its gradient is itself differentiated
            grad, = torch.autograd.grad(demo_logit.sum(), demo_in,
                                        create_graph=True)
            grad_pen = red(torch.sum(grad ** 2, -1), den.demo)
            w_decay = sum(torch.sum(w ** 2) for k, w in p.items()
                          if k.startswith("disc_mlp.")
                          and k.endswith(".weight")) + logit_reg
            disc_total = (d_loss + cfg.disc_logit_reg * logit_reg * pt
                          + cfg.disc_grad_penalty * grad_pen
                          + cfg.disc_weight_decay * w_decay * pt)

            tv = self._apply(p, "task_value", mb["obs_n"])
            tv_loss = red((tv - mb["ret_01"]) ** 2, den.mb)

            total = (cfg.actor_coef * a_loss
                     + cfg.critic_coef * c_loss
                     + cfg.bounds_coef * b_loss
                     + cfg.disc_coef * disc_total
                     + cfg.tv_coef * tv_loss)
            if cfg.motion_sym_loss:
                mu_f, _ = self._apply(p, "actor", mb["flip_obs_n"])
                sym = red(torch.sum(
                    (mu - obs_mod.flip_actions(mu_f)) ** 2, -1), den.mb)
                total = total + cfg.sym_coef * sym
            grads = torch.autograd.grad(total, list(p.values()))
        terms = dict(a_loss=a_loss, c_loss=c_loss, b_loss=b_loss,
                     d_loss=d_loss, grad_pen=grad_pen, tv_loss=tv_loss)
        return (total.detach(), {k: v.detach() for k, v in terms.items()},
                dict(zip(p, grads)))

    def _apply_grads(self, params, opt_state: AdamState, grads):
        """One optimizer step on the gradients summed over the mesh's ranks
        (so the clip sees the whole minibatch's norm), dropped whole
        (parameters, moments and count) where any gradient is nonfinite,
        on the device with no host sync (`ClipAdam.step` with its guard).
        Returns (params, opt_state, finite)."""
        with annotate("trainer.optimizer"):
            grads = pmesh.all_reduce_dict(grads, self.mesh)
            return self.tx.step(grads, opt_state, params, guard=True)

    def _update_minibatch(self, params, opt_state, mb, demo_amp, replay_amp,
                          masks, split: MinibatchSplit | None = None):
        total, metrics, grads = self._loss_and_grads(
            params, mb, demo_amp, replay_amp, masks, split)
        params, opt_state, finite = self._apply_grads(params, opt_state,
                                                      grads)
        metrics["total"] = total
        # a skipped minibatch must not NaN the epoch's averaged metrics
        metrics = {k: torch.where(finite, v, 0.0) for k, v in metrics.items()}
        metrics["nonfinite_grad"] = 1.0 - finite.float()
        return params, opt_state, metrics

    # ------------------------------------------------------------------
    # epoch
    # ------------------------------------------------------------------

    def _all_envs(self, x):
        """(T, N, …) of every rank's (T, n, …) rows, env blocks in rank
        order; `x` itself without a mesh."""
        if self.mesh is None or self.mesh.size == 1:
            return x
        g = pmesh.gather(x, self.mesh)                   # (R, T, n, …)
        return g.transpose(0, 1).reshape((x.shape[0], -1) + x.shape[2:])

    @torch.no_grad()
    def prepare(self, ts: TrainState, batch, last_obs):
        """GAE, the norms, the replay ring and the demo windows → (ts, the
        update's pools)."""
        with annotate("trainer.prepare"):
            cfg, mesh = self.cfg, self.mesh
            T, N, dev = cfg.horizon, self.env.num_envs, self.env.device
            gen = ts.rng
            advs, returns, comb_reward, disc_r = self.compute_gae(ts, batch,
                                                                  last_obs)

            def flat(x):
                return x.reshape((-1,) + x.shape[2:])

            obs_f, amp_f, ret_f = (flat(batch["obs"]), flat(batch["amp_obs"]),
                                   flat(returns))
            if cfg.normalize_input:
                ts = ts.replace(obs_norm=ts.obs_norm.update(obs_f, mesh))
            ts = ts.replace(amp_norm=ts.amp_norm.update(amp_f, mesh))
            if cfg.normalize_value:
                ts = ts.replace(value_norm=ts.value_norm.update(ret_f[:, None],
                                                                mesh))
                ret_n = ts.value_norm.normalize(ret_f[:, None], clip=1e6)[:, 0]
            else:
                ret_n = ret_f
            adv_f = flat(advs)
            if cfg.normalize_advantage:
                # over every rank's rows, population std
                _, a_mean, a_var = moments(adv_f[:, None], mesh)
                adv_f = (adv_f - a_mean[0]) / (torch.sqrt(a_var[0]) + 1e-8)
            # returns mapped to [0, 1] for the task-value head
            ret01 = torch.clamp((ret_f - cfg.min_cum_reward)
                                / (cfg.max_cum_reward - cfg.min_cum_reward),
                                0, 1)

            # replay ring (replicated): every rank's rows; when the rollout
            # exceeds the ring, a random subset
            R = cfg.amp_replay_size
            amp_all = flat(self._all_envs(batch["amp_obs"]))
            n_all = amp_all.shape[0]
            n_new = min(n_all, R)
            rows = (amp_all[torch.randperm(n_all, generator=gen,
                                           device=dev)[:n_new]]
                    if n_all > R else amp_all)
            idx = (ts.replay_ptr + torch.arange(n_new, device=dev)) % R
            ts.replay_amp.index_copy_(0, idx, rows)
            ts = ts.replace(replay_ptr=(ts.replay_ptr + n_new) % R,
                            replay_filled=min(ts.replay_filled + n_new, R))
            del amp_all, rows
            # the replay half of the discriminator's agent batch (the ring
            # holds this rollout already, so it is never empty here) and the
            # demo windows under the live hard-negative weights, as the resets:
            # drawn whole, each minibatch's block split over the ranks by index
            half = max(1, cfg.amp_batch_size // 2)
            nmb = cfg.num_minibatches
            ridx = torch.randint(0, ts.replay_filled, (nmb * half,),
                                 generator=gen, device=dev)
            replay_rows = ts.replay_amp[self._part(ridx.reshape(nmb, half))]
            mids, t0 = self.env.sample_amp_demo(
                gen, nmb * cfg.amp_batch_size,
                motion_weights=ts.env_state.motion_weights)
            mids, t0 = (self._part(x.reshape(nmb, cfg.amp_batch_size))
                        .reshape(-1) for x in (mids, t0))
            demo_raw = self.env.amp_obs_demo(mids, t0)

            def norm_obs(x):
                return ts.obs_norm.normalize(x) if cfg.normalize_input else x

            data = dict(obs_n=norm_obs(obs_f), action=flat(batch["action"]),
                        logp=flat(batch["logp"]), adv=adv_f, ret_n=ret_n,
                        ret_01=ret01, amp_n=ts.amp_norm.normalize(amp_f))
            if cfg.motion_sym_loss:
                data["flip_obs_n"] = norm_obs(flat(batch["flip_obs"]))
            pools = dict(
                data=data,
                demo=ts.amp_norm.normalize(demo_raw).reshape(
                    nmb, -1, demo_raw.shape[-1]),
                replay=ts.amp_norm.normalize(replay_rows),
                half=half,
                stats=pmesh.pmean_metrics(dict(
                    task_reward=batch["reward"].mean(),
                    disc_reward=disc_r.mean(),
                    combined_reward=comb_reward.mean(),
                    episode_done_frac=batch["done"].float().mean(),
                    loc_reward=batch["reward_raw"][..., 0].mean(),
                    power_reward=batch["reward_raw"][..., 1].mean()), mesh))
            return ts, pools

    def _part(self, x):
        """This rank's columns of (blocks, rows) split by index; all of
        them without a mesh."""
        if self.mesh is None or self.mesh.size == 1:
            return x
        return x[:, self.mesh.part(x.shape[1])]

    def _rank_rows(self, sel, mb_rows: int, half: int):
        """Under a mesh, this rank's rows of the minibatch whose rows are
        the flat (t·N + env) indices `sel` (numpy) of the whole T·N batch:
        (the rank's local row indices, their positions in the minibatch,
        the MinibatchSplit)."""
        env, mesh = self.env, self.mesh
        t, e = np.divmod(sel, env.cfg.num_envs)
        pos = np.nonzero(e // env.num_envs == mesh.rank)[0]
        loc = t[pos] * env.num_envs + e[pos] - mesh.rank * env.num_envs
        n_roll_all = min(half, mb_rows)
        split = MinibatchSplit(
            rollout=int((pos < n_roll_all).sum()), mb=mb_rows,
            agent=n_roll_all + half, demo=self.cfg.amp_batch_size,
            param_terms=mesh.rank == 0)
        return loc, pos, split

    def minibatches(self, pools, gen: torch.Generator):
        """(minibatch, demo block, replay block, dropout masks or None,
        MinibatchSplit or None) in the order the update takes them: per
        mini-epoch a fresh permutation of T·N cut into `num_minibatches`
        slices; minibatch i takes demo and replay block i. Under a mesh the
        permutation and the masks are drawn whole and each rank takes its
        rows of them (`_rank_rows`), with its parts of the blocks."""
        cfg, ecfg, mesh = self.cfg, self.env.cfg, self.mesh
        data = pools["data"]
        dev = data["adv"].device
        split_on = mesh is not None and mesh.size > 1
        n = data["adv"].shape[0] * (mesh.size if split_on else 1)
        half = pools["half"]
        mb_size = n // cfg.num_minibatches
        mask_rows = (min(half, mb_size), half, cfg.amp_batch_size)
        for _ in range(cfg.mini_epochs):
            with annotate("trainer.minibatch_draw"):
                perm = torch.randperm(n, generator=gen, device=dev)
                if split_on:
                    # the mini-epoch's rows of this rank and its rollout
                    # rows' positions, every minibatch's in one host read
                    # and one upload
                    perm_h = perm.cpu().numpy()
                    parts = [self._rank_rows(
                        perm_h[i * mb_size:(i + 1) * mb_size], mb_size, half)
                        for i in range(cfg.num_minibatches)]
                    idx = torch.as_tensor(np.concatenate(
                        [a for loc, pos, sp in parts
                         for a in (loc, pos[:sp.rollout])]), device=dev)
                    idx = idx.split([len(a) for loc, pos, sp in parts
                                     for a in (loc, pos[:sp.rollout])])
            for i in range(cfg.num_minibatches):
                with annotate("trainer.minibatch_draw"):
                    sel = perm[i * mb_size:(i + 1) * mb_size]
                    split = None
                    if split_on:
                        sel, roll = idx[2 * i], idx[2 * i + 1]
                        split = parts[i][2]
                    mb = {k: v[sel] for k, v in data.items()}
                    demo, replay = pools["demo"][i], pools["replay"][i]
                    masks = None
                    if cfg.amp_dropout:
                        us = [obs_mod.amp_dropout_draw(gen, r, dev)
                              for r in mask_rows]
                        if split_on:
                            us = [us[0][roll], us[1][mesh.part(half)],
                                  us[2][mesh.part(cfg.amp_batch_size)]]
                        masks = tuple(
                            obs_mod.amp_dropout_mask(
                                u, ecfg.num_amp_obs_steps,
                                ecfg.amp_obs_per_step, cfg.amp_dropout_rate)
                            for u in us)
                yield mb, demo, replay, masks, split

    def update(self, ts: TrainState, pools):
        """The epoch's PPO + AMP updates → (ts, metrics): each loss term's
        mean over every (mini-epoch, minibatch) pair (under a mesh, the sum
        of the ranks' partial terms), with the rollout's reward and done
        means."""
        with annotate("trainer.update"):
            params, opt_state = ts.params, ts.opt_state
            sums, count = {}, 0
            for mb, demo, replay, masks, split in self.minibatches(pools,
                                                                   ts.rng):
                params, opt_state, m = self._update_minibatch(
                    params, opt_state, mb, demo, replay, masks, split)
                sums = {k: sums.get(k, 0.0) + v for k, v in m.items()}
                count += 1
            metrics = {k: v / count for k, v in sums.items()}
            terms = {k: v for k, v in metrics.items() if k != "nonfinite_grad"}
            metrics.update(pmesh.all_reduce_dict(terms, self.mesh))
            metrics.update(pools["stats"])
            return ts.replace(params=params, opt_state=opt_state,
                              epoch=ts.epoch + 1), metrics

    def update_getup_reward_schedule(self, ts: TrainState, epoch: int,
                                     update_epoch: int) -> TrainState:
        """The getup reward curriculum: the discriminator's reward alone up
        to `update_epoch`, the configured task/disc mix after."""
        early = epoch <= update_epoch
        dev = ts.task_reward_w.device
        return ts.replace(
            task_reward_w=torch.tensor(
                0.0 if early else self.cfg.task_reward_w, device=dev),
            disc_reward_w=torch.tensor(
                1.0 if early else self.cfg.disc_reward_w, device=dev))

    def train_epoch(self, ts: TrainState):
        """rollout → prepare → update; returns (ts, metrics as 0-d device
        tensors)."""
        ts, batch, last_obs = self.rollout(ts)
        ts, pools = self.prepare(ts, batch, last_obs)
        ts, metrics = self.update(ts, pools)
        pmesh.check_lockstep(self.mesh, agent_rng=ts.rng,
                             env_rng=ts.env_state.rng, params=ts.params)
        return ts, metrics
