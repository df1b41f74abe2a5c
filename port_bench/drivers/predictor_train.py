"""Trajectory-predictor training with the EmLoco loss: steps of
`PredictorTrainer.train_step` on a bank of scene batches made on the card
in set-up (`scenes.bank`), closed loop, cycling through the bank.

The predictor's weights, the frozen LocoVal net's and the generator of
the step's masking and dropout draws are the benchmark's, from the seed.
Set-up runs the first `STEPS` steps on the bank's first batches, keeping
each step's loss, the optimizer's first moment after the first and the
parameters after the last; the check runs the plain reference through the
same steps from the same weights, batches and draw generator.
"""
from __future__ import annotations

import numpy as np
import torch

from port_bench import pacer, scenes, weights
from port_bench.counts import networks
from port_bench.reference import transmotion, valuenet

STEPS = 3


class Driver:
    def setup(self, ctx, fault=None):
        from emloco_tpu_torch.learning.networks import ValuePoseNet
        from emloco_tpu_torch.prediction.train import PredictorTrainer
        from emloco_tpu_torch.utils.config import load_config
        self.ctx, dev = ctx, ctx.device
        tr = ctx.workload["traffic"]
        s = np.random.SeedSequence(ctx.seed).generate_state(4, np.uint32)
        self.s = [int(x) for x in s]
        cfg = load_config(None, pacer.overrides(ctx.config["run"]))
        self.mc, self.pc = cfg.model, cfg.predict
        vnet = ValuePoseNet(use_pose=True, use_vel=True, device=dev)
        self.trainer = PredictorTrainer(cfg.model, cfg.predict, vnet=vnet,
                                        device=dev)
        self.c = ctx.config["run"]["model"]
        with ctx.spans.span("scene_bank"):
            self.bank = scenes.bank(tr["bank_batches"], tr["batch"],
                                    tr["people"], tr["min_people"],
                                    self.s[0], dev)
        ts = self.trainer.init(self.s[1])
        p = weights.make(transmotion.param_spec(self.c), self.s[1], dev)
        vp = weights.make(valuenet.param_spec(), self.s[2], dev)
        ts = ts.replace(
            params=weights.load_into(ts.params, p),
            vnet_params=weights.load_into(dict(vnet.named_parameters()),
                                          vp),
            rng=torch.Generator(device=dev).manual_seed(self.s[3]))
        if fault is not None:
            self._plant(fault)
        start = pacer.cpu(ts.params)
        losses, m1 = [], None
        for k in range(STEPS):
            ts, aux = self.trainer.train_step(ts, *self.bank[k])
            losses.append(float(aux["total"]))
            if k == 0:
                m1 = pacer.cpu(ts.opt_state.mu)
        self.kept = {"start": start, "vnet": pacer.cpu(ts.vnet_params),
                     "batches": [tuple(x.cpu() for x in self.bank[k])
                                 for k in range(STEPS)],
                     "prog": dict(start=start, losses=losses, m1=m1,
                                  params=pacer.cpu(ts.params))}
        self.ts, self.k = ts, STEPS

    def _plant(self, fault):
        trainer = self.trainer
        if fault == "unchanged":
            orig = trainer.train_step

            def same(ts, *batch, **kw):
                new, aux = orig(ts, *batch, **kw)
                return ts.replace(rng=new.rng), aux
            trainer.train_step = same
        elif fault == "half_batch":
            orig = trainer.loss_and_grads

            def half(ts, *b, **kw):
                return orig(ts, *(None if x is None else x[::2]
                                  for x in b), **kw)
            trainer.loss_and_grads = half
        else:
            raise ValueError(f"no fault {fault!r} in this driver")

    def unit(self, spans):
        b = self.bank[self.k % len(self.bank)]
        self.k += 1
        with spans.span("train_step"):
            self.ts, aux = self.trainer.train_step(self.ts, *b)
        return torch.isfinite(aux["total"])

    def profiled_unit(self, spans):
        for _ in range(self.ctx.workload["traffic"]["profiled_steps"]):
            self.unit(spans)

    def work_per_unit(self):
        return {"scenes": self.ctx.workload["traffic"]["batch"]}

    def flops_per_unit(self):
        tr = self.ctx.workload["traffic"]
        return networks.transmotion_step(self.c, tr["batch"], tr["people"])

    def counts(self):
        return {"profiled_units":
                self.ctx.workload["traffic"]["profiled_steps"]}

    def release(self):
        kept = self.kept
        del self.ts, self.trainer, self.bank, self.kept
        return kept

    def check(self, kept, mode="program"):
        dev = self.ctx.device
        start = {k: v.to(dev) for k, v in kept["start"].items()}
        vp = {k: v.to(dev) for k, v in kept["vnet"].items()}
        batches = [tuple(x.to(dev) for x in b) for b in kept["batches"]]
        pc = dict(self.ctx.config["run"]["predict"])
        seed = self.s[3]

        def ref(*_):
            gen = torch.Generator(device=dev).manual_seed(seed)
            return transmotion.train(start, vp, self.c, pc, batches, gen)
        return pacer.train_numbers(ref, (), kept["prog"], dev, mode)
