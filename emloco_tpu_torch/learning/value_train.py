"""LocoVal function training: regress plausibility values from rollouts of
a frozen policy (port of emloco_tpu/learning/value_train.py).

Semantics of the reference's AMPValueAgent (amp_continuous_value.py:23-454)
and the finetune plumbing in CommonAgent (common_agent.py:69-108, 154-155):
  * roll out a FROZEN pretrained policy (actions μ + σ·ε);
  * accumulate each env's discounted combined reward
    γᵗ·(w_task·task + w_disc·disc), the weights from the agent's AMPConfig;
  * heading-inverted (negative-sample) envs get reward × (−0.3);
  * latch the return at episode end OR at step_to_pred = 144, once an
    episode;
  * regress ValuePoseNet(waypoints[:13], init_pose, init_vel) to the
    normalized return (G − min)/(max − min), min −10, max 100, clipped to
    [0, 1]: masked MSE over the latched samples, one AdamW step an epoch
    with a warm-up cosine schedule (optax's adamw written out, `AdamW`).

An epoch is `_collect` (`horizon` control steps, each through the pure
`latch_step`) then `update`. The metrics stay on the device: nothing in an
epoch waits for the host.

Random streams: `init(policy_ts, seed)` takes three seeds from
numpy's SeedSequence(seed): the valuenet's weights, the env's reset (its
generator then travels in EnvState.rng for every env draw), and the
trainer's generator (ValueTrainState.rng), which draws one standard normal
(N, A) a control step for the policy's action noise.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.func import functional_call

from ..struct import TensorStruct
from ..utils.profiling import annotate
from .amp_agent import AdamState, AMPAgent, TrainState, adam_directions
from .networks import ValuePoseNet


@dataclasses.dataclass(frozen=True)
class ValueTrainConfig:
    horizon: int = 32
    gamma: float = 0.99
    step_to_pred: int = 144
    inversion_penalty: float = 0.3
    # fraction of real-bank trajectories flipped 180° as hard negatives
    # while the valuenet trains (the reference trains it with
    # --heading_inversion, which inverts half, traj_generator.py:195-200)
    heading_inversion_prob: float = 0.5
    max_cum: float = 100.0
    min_cum: float = -10.0
    lr: float = 1e-3
    warmup_steps: int = 100
    total_steps: int = 25000
    weight_decay: float = 1e-4


@dataclasses.dataclass(frozen=True)
class ValueTrainState(TensorStruct):
    policy: TrainState             # frozen (never updated here)
    vnet_params: dict              # ValuePoseNet's state_dict
    vnet_opt: AdamState
    cum_reward: torch.Tensor       # (N,) discounted accumulator
    disc_factor: torch.Tensor      # (N,) current γ^t
    already_latched: torch.Tensor  # (N,) bool
    rng: torch.Generator           # the policy's action noise
    epoch: int


def warmup_cosine_decay(count: torch.Tensor, init_value: float,
                        peak_value: float, warmup_steps: int,
                        decay_steps: int, end_value: float) -> torch.Tensor:
    """optax.warmup_cosine_decay_schedule at the int32 `count`, in float32
    as optax computes it: linear from init_value to peak_value over
    warmup_steps, then a cosine from peak_value to end_value over the
    remaining decay_steps − warmup_steps (decay_steps counts the warm-up)."""
    frac = 1 - torch.clamp(count, 0, warmup_steps).float() / warmup_steps
    linear = (init_value - peak_value) * frac + peak_value
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = float(decay_steps - warmup_steps)
    c = torch.clamp((count - warmup_steps).float(), max=span)
    cosine = 0.5 * (1 + torch.cos(math.pi * c / span))
    return torch.where(count < warmup_steps, linear,
                       peak_value * ((1 - alpha) * cosine + alpha))


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax.adamw(warmup_cosine_decay_schedule(0.1·lr, lr, warmup_steps,
    total_steps, 0.01·lr), weight_decay) on dicts of tensors: Adam's
    directions (`adam_directions`), plus weight_decay·p on every leaf,
    biases included (optax's mask=None), times −lr_t, with lr_t the
    schedule at the count before the step."""

    lr: float
    warmup_steps: int
    total_steps: int
    weight_decay: float

    def init(self, params: dict) -> AdamState:
        return AdamState.zeros_like(params)

    def learning_rate(self, count: torch.Tensor) -> torch.Tensor:
        return warmup_cosine_decay(count, 0.1 * self.lr, self.lr,
                                   self.warmup_steps, self.total_steps,
                                   0.01 * self.lr)

    def update(self, grads: dict, state: AdamState, params: dict):
        """(new params, new state) after one step on `grads`."""
        step = -self.learning_rate(state.count)
        state, u = adam_directions(grads, state)
        wd = self.weight_decay
        return {k: params[k] + step * (u[k] + wd * params[k])
                for k in u}, state


def latch_step(cfg: ValueTrainConfig, cum, factor, already, reward, done,
               progress, inverted):
    """One control step of the return latching, on (N,) tensors: the
    step's combined reward, done flags, and the pre-step progress and
    inverted flags. Returns (cum, factor, already, target, latch): the
    carried accumulator, discount and latch flags after the step, and the
    step's target and which envs latched it."""
    r = torch.where(inverted, -cfg.inversion_penalty * reward, reward)
    cum = cum + factor * r
    hit_pred = (progress + 1) >= cfg.step_to_pred
    latch = (done | hit_pred) & ~already
    target = torch.clamp((cum - cfg.min_cum) / (cfg.max_cum - cfg.min_cum),
                         0.0, 1.0)
    already = (already | latch) & ~done
    cum = torch.where(done, 0.0, cum)
    factor = torch.where(done, 1.0, factor * cfg.gamma)
    return cum, factor, already, target, latch


class LocoValTrainer:
    def __init__(self, agent: AMPAgent, vnet: ValuePoseNet,
                 cfg: ValueTrainConfig = ValueTrainConfig()):
        self.agent = agent
        self.env = agent.env
        self.vnet = vnet
        self.cfg = cfg
        self.tx = AdamW(cfg.lr, cfg.warmup_steps, cfg.total_steps,
                        cfg.weight_decay)

    def init(self, policy_ts: TrainState, seed: int) -> ValueTrainState:
        """Fresh valuenet weights and optimizer state, and fresh episodes
        in every env: a mid-episode env inherited from policy training
        would latch a truncated return (cum missing its earlier rewards) as
        the very first regression target of every env."""
        dev = self.env.device
        n = self.env.cfg.num_envs
        s_vnet, s_env, s_rng = (
            int(s) for s in np.random.SeedSequence(seed).generate_state(
                3, np.uint64))
        self.vnet.init_parameters(
            torch.Generator(device=dev).manual_seed(s_vnet))
        params = {k: v.detach().clone()
                  for k, v in self.vnet.named_parameters()}
        policy_ts = policy_ts.replace(env_state=self.env.reset(
            torch.Generator(device=dev).manual_seed(s_env)))
        return ValueTrainState(
            policy=policy_ts,
            vnet_params=params,
            vnet_opt=self.tx.init(params),
            cum_reward=torch.zeros((n,), device=dev),
            disc_factor=torch.ones((n,), device=dev),
            already_latched=torch.zeros((n,), dtype=torch.bool, device=dev),
            rng=torch.Generator(device=dev).manual_seed(s_rng),
            epoch=0)

    def _apply(self, params, wp, pose, vel):
        """The valuenet under `params` (flax's vnet.apply)."""
        return functional_call(self.vnet, params, (wp, pose, vel))

    @torch.no_grad()
    def _collect(self, ts: ValueTrainState):
        """Frozen-policy rollout with return latching, shared by training
        and (read-only) evaluation → (ts, samples): each episode's
        pre-step LocoVal inputs `wp`, `pose`, `vel`, the step's `target`,
        `valid` (latched) and `inv` (inverted), flattened to (T·N, …)."""
        with annotate("locoval.collect"):
            cfg, agent, env = self.cfg, self.agent, self.env
            acfg = agent.cfg
            pol = ts.policy
            T, N = cfg.horizon, env.cfg.num_envs
            W = self.vnet.num_waypoints
            env_state = pol.env_state

            def buf(*shape):
                return torch.empty((T, N) + tuple(shape), device=env.device)

            s = dict(wp=buf(W, 2), pose=buf(*env_state.init_pose.shape[1:]),
                     vel=buf(2), target=buf(), valid=buf(), inv=buf())
            cum, factor = ts.cum_reward, ts.disc_factor
            already = ts.already_latched
            for t in range(T):
                obs = env.observe(env_state)
                a = agent._policy(pol.params, pol.obs_norm, obs, ts.rng)[0]
                # the episode's LocoVal inputs, before the step may reset it
                s["wp"][t] = env_state.waypoint_traj[:, :W]
                s["pose"][t] = env_state.init_pose
                s["vel"][t] = env_state.init_vel
                s["inv"][t] = env_state.inverted
                progress, inverted = env_state.progress, env_state.inverted
                env_state, out = env.step(env_state, a)
                disc_r = agent._disc_reward(pol.params, pol.amp_norm,
                                            out.amp_obs)
                with annotate("locoval.latch"):
                    r = (acfg.task_reward_w * out.reward
                         + acfg.disc_reward_w * disc_r)
                    (cum, factor, already, s["target"][t],
                     s["valid"][t]) = latch_step(cfg, cum, factor, already, r,
                                                 out.done, progress, inverted)
            samples = {k: v.reshape((T * N,) + v.shape[2:])
                       for k, v in s.items()}
            ts = ts.replace(policy=pol.replace(env_state=env_state),
                            cum_reward=cum, disc_factor=factor,
                            already_latched=already)
            return ts, samples

    def _loss_and_grads(self, params: dict, s: dict):
        """Masked MSE of the valuenet's predictions against the latched
        targets, sum / max(latched, 1), and its gradient by parameter."""
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            pred = self._apply(p, s["wp"], s["pose"], s["vel"])
            se = (pred - s["target"]) ** 2 * s["valid"]
            loss = se.sum() / torch.clamp(s["valid"].sum(), min=1.0)
            grads = torch.autograd.grad(loss, list(p.values()))
        return loss.detach(), dict(zip(p, grads))

    def update(self, ts: ValueTrainState, s: dict):
        """One AdamW step on the epoch's samples → (ts, metrics as 0-d
        device tensors)."""
        with annotate("locoval.update"):
            loss, grads = self._loss_and_grads(ts.vnet_params, s)
            params, opt = self.tx.update(grads, ts.vnet_opt, ts.vnet_params)
            target, valid, inv = s["target"], s["valid"], s["inv"]
            n = valid.sum()
            per = torch.clamp(n, min=1.0)
            metrics = dict(
                vnet_loss=loss, num_latched=n,
                mean_target=(target * valid).sum() / per,
                # hard-negative visibility: the share of latched episodes
                # that were heading-inverted, and their mean target
                inverted_frac=(inv * valid).sum() / per,
                inverted_target=(target * valid * inv).sum()
                / torch.clamp((valid * inv).sum(), min=1.0))
            return ts.replace(vnet_params=params, vnet_opt=opt,
                              epoch=ts.epoch + 1), metrics

    def train_epoch(self, ts: ValueTrainState):
        """_collect → update; returns (ts, metrics)."""
        return self.update(*self._collect(ts))

    @torch.no_grad()
    def eval_epoch(self, ts: ValueTrainState):
        """Read-only rollout epoch: (pred, realized target, valid) at the
        latch events. No valuenet update (evaluation must not train)."""
        ts, s = self._collect(ts)
        pred = self._apply(ts.vnet_params, s["wp"], s["pose"], s["vel"])
        return ts, (pred, s["target"], s["valid"])

    def collect_predictions(self, ts: ValueTrainState, num_epochs: int = 4):
        """Valid (prediction, realized target) pairs over `num_epochs`
        read-only rollout epochs, concatenated → (ts, preds, targets) as
        host numpy."""
        preds, targets = [], []
        for _ in range(num_epochs):
            ts, (p, t, v) = self.eval_epoch(ts)
            m = v.cpu().numpy() > 0
            preds.append(p.cpu().numpy()[m])
            targets.append(t.cpu().numpy()[m])
        return ts, np.concatenate(preds), np.concatenate(targets)

    @staticmethod
    def prediction_stats(preds, targets):
        """(mse, correlation) of valuenet predictions against realized
        returns."""
        if len(preds) == 0:
            return float("nan"), 0.0
        mse = float(((preds - targets) ** 2).mean())
        corr = (float(np.corrcoef(preds, targets)[0, 1])
                if preds.std() > 1e-6 and targets.std() > 1e-6 else 0.0)
        return mse, corr

    def evaluate(self, ts: ValueTrainState, num_epochs: int = 4):
        """Value-prediction quality over LATCHED episodes only: the
        prediction from the episode's (waypoints, init pose, init vel)
        against the realized normalized return at done / step_to_pred
        (reference AMPPlayerContinuousValue.run, amp_value_players.py:
        37-275). Returns (ts, mse, correlation)."""
        ts, p, t = self.collect_predictions(ts, num_epochs)
        mse, corr = self.prediction_stats(p, t)
        return ts, mse, corr
