"""LocoVal collection and training: epochs of `LocoValTrainer.train_epoch`
(`horizon` control steps of the frozen policy with the return latching,
then one AdamW step of the valuenet), closed loop, as `cli.run
train-valuenet` builds them (heading inversion at the value
configuration's probability).

Set-up runs the first `STEPS` epochs through the window's own call,
`LocoValTrainer.train_epoch`, with probes on in the first: the first
factor and resolve of the physics step, one whole env step (its state,
actions, the state it reached, its observation and reward), the first
policy call and discriminator reward, and each step's combined reward,
done and pre-step progress and inversion flags; and every epoch's
samples, loss, the optimizer's first moment after the first and the
parameters after the last. The check holds them to the plain reference
after the window. The window's spans sit beneath the same call.
"""
from __future__ import annotations

import sys

import torch

from port_bench import pacer, weights
from port_bench.counts import networks
from port_bench.reference import valuenet

STEPS = 3
WAYPOINTS = 13
PARTS = {"_collect": "collect", "update": "vnet_update"}


class Driver:
    def setup(self, ctx, fault=None):
        from emloco_tpu_torch.learning.networks import ValuePoseNet
        from emloco_tpu_torch.learning.value_train import LocoValTrainer
        self.ctx, dev = ctx, ctx.device
        cfg, agent, ts, d, s = pacer.build(ctx)
        vnet = ValuePoseNet(use_pose=True, use_vel=True,
                            num_waypoints=WAYPOINTS, device=dev)
        tr = LocoValTrainer(agent, vnet, cfg.value)
        vts = tr.init(ts, cfg.seed + 1)
        made = weights.make(valuenet.param_spec(WAYPOINTS), s["valuenet"],
                            dev)
        vts = vts.replace(vnet_params=weights.load_into(vts.vnet_params,
                                                        made))
        self.cfg, self.agent, self.tr, self.d = cfg, agent, tr, d
        self.world = pacer.world_of(cfg, s)
        self.undo = []
        if fault is not None:
            self._plant(fault)
        kept = {"policy_params": pacer.cpu(ts.params),
                "start": pacer.cpu(vts.vnet_params),
                "latch0": dict(cum=vts.cum_reward.cpu(),
                               factor=vts.disc_factor.cpu(),
                               already=vts.already_latched.cpu())}
        steps = []

        def step(state, out):
            steps.append(dict(progress=state.progress.cpu(),
                              inverted=state.inverted.cpu(),
                              task=out.reward.cpu(), done=out.done.cpu()))
        probes = pacer.Probes(agent, step_hook=step)

        def disc(params, amp_norm, amp_obs):
            r = disc_orig(params, amp_norm, amp_obs)
            steps[-1]["disc"] = r.cpu()
            return r
        samples, losses, m1 = [], [], []
        had = "update" in tr.__dict__
        upd = tr.update

        def update(vts, smp):
            vts, m = upd(vts, smp)
            if not samples:
                probes.remove()
                m1.append(pacer.cpu(vts.vnet_opt.mu))
            samples.append(pacer.cpu(smp))
            losses.append(float(m["vnet_loss"]))
            return vts, m
        probes.install()
        disc_orig = agent._disc_reward         # the probe's wrapper
        agent._disc_reward, tr.update = disc, update
        try:
            for _ in range(STEPS):
                vts, m = tr.train_epoch(vts)
        finally:
            probes.remove()
            if had:
                tr.update = upd
            else:
                del tr.update
        kept.update(probes.kept)
        kept["steps"], kept["samples"] = steps, samples
        kept["prog"] = dict(start=kept["start"], losses=losses, m1=m1[0],
                            params=pacer.cpu(vts.vnet_params))
        self.kept, self.vts = kept, vts
        self.spans = ctx.spans
        pacer.spanned(tr, PARTS, self)

    def _plant(self, fault):
        tr = self.tr
        if fault == "unchanged":
            tr.update = lambda ts, s: (ts, dict(vnet_loss=torch.zeros(
                (), device=self.ctx.device)))
        elif fault == "half_batch":
            orig = tr._loss_and_grads

            def half(params, s):
                return orig(params, {k: v[::2] for k, v in s.items()})
            tr._loss_and_grads = half
        elif fault == "skip_substep":
            self.undo.append(pacer.skip_substep())
        else:
            raise ValueError(f"no fault {fault!r} in this driver")

    def unit(self, spans):
        self.spans = spans
        with spans.span("epoch"):
            self.vts, m = self.tr.train_epoch(self.vts)
        return torch.stack([torch.isfinite(v).all() for v in
                            m.values()]).all()

    def profiled_unit(self, spans):
        self.unit(spans)

    def work_per_unit(self):
        return {"env_steps": self.cfg.value.horizon * self.cfg.env.num_envs}

    def flops_per_unit(self):
        N, T = self.cfg.env.num_envs, self.cfg.value.horizon
        return (T * (networks.policy_actor_step(self.d, N)
                     + networks.disc_forward(self.d, N)
                     + pacer.physics_flops(self.kept, N,
                                           self.cfg.env.engine.n_substeps))
                + networks.valuenet_step(T * N, WAYPOINTS))

    def counts(self):
        return {"arrow": pacer.arrow_counts(self.kept)}

    def release(self):
        kept = self.kept
        v, a = self.cfg.value, self.cfg.amp
        kept["value"] = {k: getattr(v, k) for k in (
            "gamma", "step_to_pred", "inversion_penalty", "max_cum",
            "min_cum", "lr", "warmup_steps", "total_steps", "weight_decay")}
        kept["weights"] = dict(task=a.task_reward_w, disc=a.disc_reward_w,
                               scale=a.disc_reward_scale)
        kept["dims"] = self.d
        kept["world"] = self.world
        for undo in self.undo:
            undo()
        del self.vts, self.tr, self.agent, self.kept
        return kept

    def _latch(self, kept, dev, mode):
        """The epoch-1 targets and latch flags recomputed from each step's
        rewards, dones and flags (the control: in bfloat16)."""
        vc, w = kept["value"], kept["weights"]
        l0 = kept["latch0"]
        dt = torch.bfloat16 if mode == "control" else torch.float32
        cum, factor = l0["cum"].to(dev, dt), l0["factor"].to(dev, dt)
        already = l0["already"].to(dev)
        targets, latched = [], []
        for st in kept["steps"]:
            r = (w["task"] * st["task"].to(dev)
                 + w["disc"] * st["disc"].to(dev)).to(dt)
            cum, factor, already, t, lat = valuenet.latch(
                vc, cum, factor, already, r, st["done"].to(dev),
                st["progress"].to(dev), st["inverted"].to(dev))
            targets.append(t.float())
            latched.append(lat)
        return torch.stack(targets), torch.stack(latched)

    def check(self, kept, mode="program"):
        dev = self.ctx.device
        out = pacer.check_rollout(kept, kept["dims"], kept["policy_params"],
                                  kept["weights"]["scale"], dev, mode)
        out.update(pacer.check_step(kept, dev, mode))
        T = len(kept["steps"])
        t_ref, l_ref = self._latch(kept, dev, "program")
        s0 = kept["samples"][0]
        t_prog = s0["target"].to(dev).reshape(T, -1)
        l_prog = s0["valid"].to(dev).reshape(T, -1) > 0
        if mode == "control":
            t_prog, l_prog = self._latch(kept, dev, mode)
        both = l_ref & l_prog
        out["target_gap"] = (float((t_prog - t_ref).abs()[both].max())
                             if bool(both.any()) else 0.0)
        out["latch_mismatch"] = float((l_prog != l_ref).sum())
        if mode == "program":
            # the traffic the frozen policy made: how often its episodes
            # end, and how many steps latch a target
            ends = float(torch.stack([st["done"].float().mean()
                                      for st in kept["steps"]]).mean())
            latched = [float(s["valid"].float().mean())
                       for s in kept["samples"]]
            print(f"locoval traffic: episode ends per env-step {ends!r}, "
                  f"latched share per epoch {latched!r}", file=sys.stderr)
        epochs = [{k: v.to(dev) for k, v in s.items()}
                  for s in kept["samples"]]
        start = {k: v.to(dev) for k, v in kept["start"].items()}
        out.update(pacer.train_numbers(
            valuenet.train, (start, kept["value"], epochs), kept["prog"],
            dev, mode))
        return out
