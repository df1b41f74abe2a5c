"""PACER training: epochs of `AMPAgent.train_epoch` (rollout of `horizon`
control steps → prepare → `mini_epochs` × `num_minibatches` PPO + AMP
updates), closed loop, on the world `cli.run` builds from the
configuration.

Set-up runs the first epoch through the window's own call,
`AMPAgent.train_epoch`, with probes on: the first factor and resolve of
the physics step, one whole env step (its state, actions, the state it
reached, its observation and reward), the first policy call and
discriminator reward, and the first three minibatch updates (their
inputs, losses, the optimizer's first moment after the first, and the
parameters after the third). The check holds them to the plain reference
after the window. The window's spans sit beneath the same call.
"""
from __future__ import annotations

import torch

from port_bench import pacer
from port_bench.counts import networks
from port_bench.reference import policy

STEPS = 3
PARTS = {"rollout": "rollout", "prepare": "prepare", "update": "update"}


class Driver:
    def setup(self, ctx, fault=None):
        self.ctx, dev = ctx, ctx.device
        cfg, agent, ts, d, s = pacer.build(ctx)
        self.cfg, self.agent, self.d = cfg, agent, d
        self.world = pacer.world_of(cfg, s)
        self.undo = []
        start = pacer.cpu(ts.params)
        kept = {"start": start}
        if fault is not None:
            self._plant(fault)
        probes = pacer.Probes(agent)
        probes.install()
        orig = agent._update_minibatch
        mbs, outs = [], []

        def record(params, opt_state, mb, demo, replay, masks, split=None):
            p, o, m = orig(params, opt_state, mb, demo, replay, masks, split)
            if len(mbs) < STEPS:
                mbs.append((pacer.cpu(mb), demo.cpu(), replay.cpu(),
                            None if masks is None else
                            tuple(x.cpu() for x in masks)))
                outs.append((float(m["total"]), pacer.cpu(o.mu),
                             pacer.cpu(p)))
            return p, o, m
        agent._update_minibatch = record
        try:
            ts, m = agent.train_epoch(ts)
        finally:
            del agent._update_minibatch
            probes.remove()
        kept.update(probes.kept)
        kept["minibatches"] = mbs
        kept["prog"] = dict(start=start, losses=[o[0] for o in outs],
                            m1=outs[0][1], params=outs[-1][2])
        self.kept, self.ts = kept, ts
        self.spans = ctx.spans
        pacer.spanned(agent, PARTS, self)

    def _plant(self, fault):
        agent = self.agent
        if fault == "unchanged":
            def same(params, opt_state, grads):
                return params, opt_state, torch.ones((), dtype=torch.bool,
                                                     device=params[
                                                         "mu.bias"].device)
            agent._apply_grads = same
        elif fault == "half_batch":
            orig = agent._loss_and_grads

            def half(params, mb, demo, replay, masks, split=None):
                return orig(params, {k: v[::2] for k, v in mb.items()},
                            demo, replay, masks, split)
            agent._loss_and_grads = half
        elif fault == "skip_substep":
            self.undo.append(pacer.skip_substep())
        else:
            raise ValueError(f"no fault {fault!r} in this driver")

    def unit(self, spans):
        self.spans = spans
        with spans.span("epoch"):
            self.ts, m = self.agent.train_epoch(self.ts)
        ok = torch.stack([torch.isfinite(v).all() for v in m.values()]).all()
        return ok & (m["nonfinite_grad"] == 0)

    def profiled_unit(self, spans):
        self.unit(spans)

    def work_per_unit(self):
        c = self.cfg
        return {"env_steps": c.amp.horizon * c.env.num_envs}

    def flops_per_unit(self):
        c, d = self.cfg, self.d
        N, T = c.env.num_envs, c.amp.horizon
        rows = N * T // c.amp.num_minibatches
        half = max(1, c.amp.amp_batch_size // 2)
        return (T * (networks.policy_rollout_step(d, N)
                     + pacer.physics_flops(self.kept, N,
                                           c.env.engine.n_substeps))
                + networks.policy_prepare(d, N, T)
                + c.amp.mini_epochs * c.amp.num_minibatches
                * networks.policy_minibatch(d, rows, half,
                                            c.amp.amp_batch_size,
                                            c.amp.motion_sym_loss))

    def counts(self):
        return {"arrow": pacer.arrow_counts(self.kept)}

    def release(self):
        kept = self.kept
        kept["amp"] = {k: getattr(self.cfg.amp, k) for k in (
            "e_clip", "grad_norm", "actor_coef", "critic_coef",
            "bounds_coef", "disc_coef", "tv_coef", "sym_coef",
            "motion_sym_loss", "disc_logit_reg", "disc_grad_penalty",
            "disc_weight_decay", "disc_reward_scale", "lr")}
        kept["dims"] = self.d
        kept["world"] = self.world
        for undo in self.undo:
            undo()
        del self.ts, self.agent, self.kept
        return kept

    def check(self, kept, mode="program"):
        dev = self.ctx.device
        ac, d = kept["amp"], kept["dims"]
        out = pacer.check_rollout(kept, d, kept["start"],
                                  ac["disc_reward_scale"], dev, mode)
        out.update(pacer.check_step(kept, dev, mode))

        def on(x):
            return None if x is None else x.to(dev)
        mbs = [({k: v.to(dev) for k, v in mb.items()}, on(demo), on(replay),
                None if masks is None else tuple(on(m) for m in masks))
               for mb, demo, replay, masks in kept["minibatches"]]
        start = {k: v.to(dev) for k, v in kept["start"].items()}
        out.update(pacer.train_numbers(
            policy.train, (start, d, ac, mbs), kept["prog"], dev, mode))
        return out
