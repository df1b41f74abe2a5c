"""Predictor training with the EmLoco loss (port of
emloco_tpu/prediction/train.py; reference train_jta.py:192-418).

  * the winner-takes-all multi-head loss (MSE_LOSS_MULTI) or the
    single-head MSE_LOSS,
  * + valueloss_weight · the EmLoco loss: mean (v − 1)² of the frozen
    LocoVal net's value of every head's trajectory (origin first), all
    heads folded into one call (train_jta.py:197-206, 288-308),
  * or the value loss alone (`valueloss_only`, :282-283, 351-357),
  * optax's chain(clip_by_global_norm(grad_clip), adam(exponential_decay(
    lr, lr_decay_epochs, lr_decay, staircase=True))) written out on
    tensors (`ClipAdamDecay`): step t (counted from 0) takes
    lr·decay^⌊t / lr_decay_epochs⌋. The JAX trainer hands lr_decay_epochs
    to optax as `transition_steps`, so the rate decays every
    lr_decay_epochs optimizer steps, not epochs; the port follows it.
  * best parameters by the evaluation's ade_min, one evaluation an epoch.

Parameters are a dict of tensors under the model's state_dict names, run
through `torch.func.functional_call`; the LocoVal net's parameters are a
state_dict that takes no gradient and never changes here.

Random streams: a train step draws from `PredictTrainState.rng`, in this
order: the `traj_noise_std` normal (obs trajectory tokens, when the std is
positive), the model's eight masking uniforms, then its dropout draws
(`model.py`). `TrainDraws` replaces the first two with given values.

Batch-axis data parallelism (`fit(..., mesh=)`, the reference's torch
DataParallel, train_jta.py:392): each rank takes its block of every batch,
draws the noise, masking and dropout numbers for the whole batch and keeps
its rows (so they equal the one-rank step's), and the gradients of its
share of the batch's loss are summed over the ranks before the clip.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import time
from typing import Optional

import numpy as np
import torch
from torch.func import functional_call

from .. import convert
from .. import device as _device
from ..learning.amp_agent import AdamState, ClipAdam
from ..learning.fused_adam import exponential_decay
from ..learning.networks import ValuePoseNet
from ..parallel import mesh as pmesh
from ..struct import TensorStruct
from ..utils.checkpoint import load_pickle
from ..utils.profiling import annotate
from . import data as data_mod
from . import metrics as M
from .lstm import LSTMPredictor
from .model import TransMotion, TransMotionConfig


@dataclasses.dataclass(frozen=True)
class PredictTrainConfig:
    lr: float = 1e-4
    lr_decay: float = 0.1
    lr_decay_epochs: int = 20
    grad_clip: float = 1.0
    valueloss_weight: float = 0.3
    valueloss_only: bool = False
    use_value_loss: bool = False
    # noisy-trajectory augmentation (train_jta.py:115-117 --add_noise):
    # gaussian jitter on the observed trajectory tokens only
    traj_noise_std: float = 0.0
    # JTA poses are z-flipped at consumption (train_jta.py:266); JRDB
    # feeds them as they are (train_jrdb.py:187)
    pose_z_flip: bool = True


@dataclasses.dataclass(frozen=True)
class PredictTrainState(TensorStruct):
    params: dict                   # the predictor's, by state_dict name
    opt_state: AdamState
    vnet_params: Optional[dict]    # the frozen LocoVal net's, or None
    rng: torch.Generator           # noise, masking and dropout draws
    step: int


@dataclasses.dataclass(frozen=True)
class TrainDraws:
    """Given draws for a train step: the traj_noise_std standard normal
    (shaped as obs[..., 0:1, :2]) and the eight masking uniforms
    (`model.mask_draws`); None draws from the state's generator."""

    noise: Optional[torch.Tensor] = None
    masks: Optional[list] = None


@dataclasses.dataclass(frozen=True)
class ClipAdamDecay(ClipAdam):
    """optax.chain(clip_by_global_norm(max_norm), adam(exponential_decay(
    lr, transition_steps, decay, staircase=True))) on dicts of tensors:
    ClipAdam's step at the rate −lr_t of the count before the step."""

    transition_steps: int = 1
    decay: float = 1.0

    def learning_rate(self, count: torch.Tensor) -> torch.Tensor:
        return exponential_decay(count, self.lr, self.transition_steps,
                                 self.decay)

    def schedule(self):
        return self.transition_steps, self.decay


def traj_noise_draw(gen: torch.Generator, shape, device,
                    mesh=None) -> torch.Tensor:
    """The standard normal of the `traj_noise_std` jitter, drawn on `gen`'s
    device and moved to `device` (`mesh`: this rank's rows of the whole
    batch's draw)."""
    return pmesh.draw_rows(torch.randn, shape, mesh, generator=gen,
                           device=gen.device).to(device)


class PredictorTrainer:
    def __init__(self, model_cfg: TransMotionConfig = TransMotionConfig(),
                 cfg: PredictTrainConfig = PredictTrainConfig(),
                 vnet: Optional[ValuePoseNet] = None, device=None):
        self.device = _device.resolve(device)
        if model_cfg.arch == "lstm":
            self.model = LSTMPredictor(model_cfg, device=self.device)
        else:
            self.model = TransMotion(model_cfg, device=self.device)
        self.mcfg = model_cfg
        self.cfg = cfg
        self.vnet = vnet
        self.tx = ClipAdamDecay(cfg.grad_clip, cfg.lr, cfg.lr_decay_epochs,
                                cfg.lr_decay)

    def init(self, seed: int, example_batch=None,
             vnet_params: Optional[dict] = None) -> PredictTrainState:
        """Fresh weights (flax's families) and optimizer state; the weights
        and the train steps' draws take two generators seeded from `seed`.
        `vnet_params` (ValuePoseNet's state_dict) is moved to the device and
        frozen. `example_batch` is accepted as the JAX trainer takes it."""
        dev = self.device
        s_net, s_rng = (int(s) for s in np.random.SeedSequence(
            seed).generate_state(2, np.uint64))
        self.model.init_parameters(
            torch.Generator(device=dev).manual_seed(s_net))
        params = {k: v.detach().clone()
                  for k, v in self.model.named_parameters()}
        if vnet_params is not None:
            vnet_params = {k: v.detach().to(dev)
                           for k, v in vnet_params.items()}
        return PredictTrainState(
            params=params, opt_state=self.tx.init(params),
            vnet_params=vnet_params,
            rng=torch.Generator(device=dev).manual_seed(s_rng), step=0)

    # ------------------------------------------------------------------

    def tensors(self, batch) -> data_mod.SceneBatch:
        """A SceneBatch's arrays as tensors on the trainer's device."""
        return data_mod.SceneBatch(*(
            None if a is None else torch.as_tensor(a, device=self.device)
            for a in batch))

    def _apply(self, params, obs, mask, **kw):
        return functional_call(self.model, params, (obs, mask), kw)

    def _value_loss(self, vnet_params, pred_modes, init_pose, init_vel):
        """The EmLoco loss averaged over heads: every head's trajectory,
        origin first, through one LocoVal call (pose and velocity repeated
        per head, b-major)."""
        B, Fp, Mm, _ = pred_modes.shape
        flat = pred_modes.movedim(2, 1).reshape(B * Mm, Fp, 2)
        traj = data_mod.prepend_origin(flat)
        pose = (None if init_pose is None
                else init_pose.repeat_interleave(Mm, dim=0))
        vel = (None if init_vel is None
               else init_vel.repeat_interleave(Mm, dim=0))
        v = functional_call(self.vnet, vnet_params, (traj, pose, vel))
        return torch.mean((v - 1.0) ** 2)

    def _inputs(self, ts, obs, init_pose, draws, mesh=None):
        """The step's jittered obs and z-flipped pose."""
        cfg = self.cfg
        if cfg.traj_noise_std > 0.0:
            shape = obs[..., 0:1, :2].shape
            n = (traj_noise_draw(ts.rng, shape, obs.device, mesh)
                 if draws is None or draws.noise is None
                 else draws.noise.to(obs.device))
            obs = obs.clone()
            obs[..., 0:1, :2] += cfg.traj_noise_std * n
        if init_pose is not None and cfg.pose_z_flip:
            init_pose = init_pose * torch.tensor([1.0, 1.0, -1.0],
                                                 device=init_pose.device)
        return obs, init_pose

    def loss_and_grads(self, ts: PredictTrainState, obs, mask, gt_future,
                       init_pose=None, init_vel=None,
                       draws: Optional[TrainDraws] = None, mesh=None):
        """(total loss, {traj_loss, value_loss}, gradient by parameter) of
        one batch of tensors under ts.params, drawing from ts.rng. Under a
        `mesh` the batch is this rank's block, the losses its mean, and the
        gradient that of its share (1/R) of the whole batch's loss."""
        cfg = self.cfg
        p = {k: v.detach().requires_grad_() for k, v in ts.params.items()}
        with torch.enable_grad():
            with annotate("predictor.forward"):
                obs, init_pose = self._inputs(ts, obs, init_pose, draws,
                                              mesh)
                out = self._apply(
                    p, obs, mask, train=True, gen=ts.rng,
                    draws=None if draws is None else draws.masks, mesh=mesh)
                pred = out[:, data_mod.OBS_FRAMES:]          # (B,Fp,M,2)
                if self.mcfg.multi_modal:
                    traj_loss = M.mse_loss_multi(pred, gt_future)
                else:
                    traj_loss = M.mse_loss(pred[:, :, 0], gt_future)
            total = traj_loss
            vloss = torch.zeros((), device=obs.device)
            if self.vnet is not None and (cfg.use_value_loss
                                          or cfg.valueloss_only):
                with annotate("predictor.value_loss"):
                    vloss = self._value_loss(ts.vnet_params, pred, init_pose,
                                             init_vel)
                total = cfg.valueloss_weight * vloss + (
                    0.0 if cfg.valueloss_only else traj_loss)
            share = total if mesh is None else total / mesh.size
            with annotate("predictor.backward"):
                grads = torch.autograd.grad(share, list(p.values()))
        aux = dict(traj_loss=traj_loss.detach(), value_loss=vloss.detach())
        return total.detach(), aux, dict(zip(p, grads))

    def train_step(self, ts: PredictTrainState, obs, mask, gt_future,
                   init_pose=None, init_vel=None,
                   draws: Optional[TrainDraws] = None, mesh=None):
        """One optimizer step on a batch (numpy or tensors) → (ts, {traj_loss,
        value_loss, total} as 0-d device tensors). Under a `mesh` the batch
        is this rank's block; the gradients are summed over the ranks before
        the clip and the losses averaged."""
        with annotate("predictor.step"):
            with annotate("predictor.upload"):
                b = self.tensors((obs, mask, gt_future, init_pose, init_vel))
            total, aux, grads = self.loss_and_grads(ts, *b, draws=draws,
                                                    mesh=mesh)
            with annotate("predictor.optimizer"):
                grads = pmesh.all_reduce_dict(grads, mesh)
                params, opt = self.tx.update(grads, ts.opt_state, ts.params)
            aux["total"] = total
            return (ts.replace(params=params, opt_state=opt,
                               step=ts.step + 1),
                    pmesh.pmean_metrics(aux, mesh))

    @torch.no_grad()
    def predict(self, params, obs, mask, limit_obs: int = 0):
        """Eval-mode prediction of the future frames: (B, Fp, M, 2)."""
        obs, mask = (torch.as_tensor(a, device=self.device)
                     for a in (obs, mask))
        out = self._apply(params, obs, mask, train=False,
                          limit_obs=int(limit_obs))
        return out[:, data_mod.OBS_FRAMES:]

    # ------------------------------------------------------------------

    def fit(self, ts, dataset, epochs: int, batches_per_epoch: int,
            batch_size: int, eval_dataset=None, log=None, mesh=None):
        """The epoch loop (reference train_jta.py:224-384): each epoch draws
        its batches, steps through them, then evaluates on
        max(1, batches_per_epoch // 4) batches of `eval_dataset`. Returns
        (ts, history, best params by ade_min); `log` is called with each
        epoch's entry (its metrics, seconds and steps/s). Under a `mesh`
        (R ranks, batch_size a multiple of R) every rank draws the same
        batches and trains on its block of each; each evaluates the whole
        evaluation set, so the ranks keep the same best parameters."""
        history = []
        best_ade = float("inf")
        best_params = ts.params
        for ep in range(epochs):
            bs = list(dataset.batches(batch_size, batches_per_epoch))
            t = time.perf_counter()
            losses = []
            for b in bs:
                if mesh is not None:
                    b = [None if a is None else a[mesh.block(len(a))]
                         for a in b]
                ts, aux = self.train_step(ts, *b, mesh=mesh)
                losses.append(aux["traj_loss"])
            pmesh.check_lockstep(mesh, rng=ts.rng, params=ts.params)
            entry = dict(epoch=ep, traj_loss=torch.stack(losses).mean()
                         .item())
            train_s = time.perf_counter() - t
            if eval_dataset is not None:
                evals = self.evaluate(ts.params, eval_dataset, batch_size,
                                      max(1, batches_per_epoch // 4))
                entry.update(evals)
                if evals["ade_min"] < best_ade:
                    best_ade = evals["ade_min"]
                    best_params = ts.params
            entry.update(train_seconds=train_s,
                         seconds=time.perf_counter() - t,
                         steps_per_s=len(bs) / train_s)
            history.append(entry)
            if log is not None:
                log(entry)
        return ts, history, best_params

    def evaluate(self, params, dataset, batch_size, num_batches):
        """Mean ADE/FDE (mean, min, worst over modes) over `num_batches`."""
        keys, rows = None, []
        for obs, mask, gt, *_ in dataset.batches(batch_size, num_batches):
            pred = self.predict(params, obs, mask)
            r = M.ade_fde(pred, torch.as_tensor(gt, device=self.device))
            keys = [k for k in r if not k.endswith("per_mode")]
            rows.append(torch.stack([r[k] for k in keys]).tolist())
        return {k: float(np.mean([r[i] for r in rows]))
                for i, k in enumerate(keys)}

    # ------------------------------------------------------------------

    def flax_params(self, params: dict) -> dict:
        """The predictor's state_dict → the flax params tree as numpy."""
        if self.mcfg.arch == "lstm":
            return convert.lstm_params(params)
        return convert.transmotion_params(params, self.mcfg.nhead)

    def params_from(self, tree) -> dict:
        """A flax params tree (either package's file) → the predictor's
        parameters on the trainer's device."""
        sd = (convert.lstm_state_dict(tree) if self.mcfg.arch == "lstm"
              else convert.transmotion_state_dict(tree))
        return {k: v.to(self.device) for k, v in sd.items()}

    def save_checkpoint(self, path, ts: PredictTrainState, cfg_dict=None):
        """{params (flax layout), opt_state (count, mu, nu as flax trees),
        step, config} as plain numpy (reference train_jta.py:167-175); the
        JAX package's load_checkpoint reads its `params`."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump({
                "params": self.flax_params(ts.params),
                "opt_state": convert.adam_fields(ts.opt_state,
                                                 self.flax_params),
                "step": int(ts.step),
                "config": cfg_dict or {},
            }, f)

    @staticmethod
    def load_checkpoint(path):
        """A predictor file of either package, read without the JAX
        package (utils.checkpoint.Unpickler)."""
        return load_pickle(path)
