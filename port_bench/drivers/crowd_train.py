"""PACER's crowd training: `policy_train`'s window (epochs of
`AMPAgent.train_epoch`, closed loop) on the crowd configuration: groups
of consecutive envs spawned around one centre, the crowd observation of
the 5 nearest people, the velocity map with them stamped in, and the
`sept_cnn` net with its pointnet.

Set-up builds the world and the agent through the entry
(`cli.run._agent`, TF32 off as `cli.run`'s main sets it), loads the
benchmark's weights (`reference/crowd.py`'s leaves) and runs the first
epoch through the window's own call with `pacer.Probes` on, keeping also
the checked step's state after the env's auto-reset (the others as the
observation read them) and the program's mirror of that step's
observation. The check holds the kernels, μ, the discriminator, the
step's physics, observation, mirror and reward, and the first three
minibatch updates to the plain reference.

The profiled unit drains the device before each call of the crowd
observation and the velocity map and wraps it in a benchmark span
(`crowd.group_obs`, `crowd.velocity_map`, synchronized at its end), so the
device operations inside those spans are the kernels those calls
launched (`crowd_obs_roofline.crowd`).
"""
from __future__ import annotations

import dataclasses

import torch

from port_bench import core, pacer, weights
from port_bench.counts import crowd as crowd_counts
from port_bench.reference import compare, crowd, humanoid, policy, solve
from port_bench.reference import world

_base = core.load_module("drivers", "policy_train")
STEPS = _base.STEPS
# the observation functions the profiled unit drains and spans, by the
# benchmark span each gets
OBS_SPANS = {"group_obs": "crowd.group_obs",
             "group_velocity_map_obs": "crowd.velocity_map"}


def build(ctx):
    """(run config, agent, TrainState with the benchmark's weights, dims,
    seeds), as `pacer.build` with the crowd's leaves."""
    from emloco_tpu_torch import device as _device
    from emloco_tpu_torch.cli import run as cli
    from emloco_tpu_torch.utils.config import load_config

    s = pacer.seeds(ctx.seed)
    run = pacer.merge(ctx.config["run"], ctx.workload["traffic"].get("run",
                                                                     {}))
    run = pacer.merge(run, {"seed": s["world"], "terrain": {"seed":
                                                            s["terrain"]}})
    cfg = load_config(None, pacer.overrides(run))
    _device.full_float32(ctx.device)
    with ctx.spans.span("world_build"):
        agent, ts = cli._agent(cfg, ctx.device)
    d = pacer.dims(ctx.config, agent.env, agent)
    made = crowd.as_conv(weights.make(crowd.param_spec(d), s["policy"],
                                      ctx.device))
    ts = ts.replace(params=weights.load_into(ts.params, made))
    return cfg, agent, ts, d, s


def world_of(cfg, s: dict) -> dict:
    """`pacer.world_of` for the crowd: the configuration must hold the
    velocity map and the crowd observation together (the reference covers
    that pair), the rest as the terrain's reference covers it."""
    env = cfg.env
    if not (env.velocity_map and env.group_obs and env.terrain_obs):
        raise ValueError("the crowd reference needs env.velocity_map, "
                         "env.group_obs and env.terrain_obs together")
    plain = dataclasses.replace(env, velocity_map=False, group_obs=False)
    w = pacer.world_of(dataclasses.replace(cfg, env=plain), s)
    w["env"]["group_size"] = env.obs_group_size
    return w


def check_rollout(kept, d, params, amp_scale, device, mode) -> dict:
    """`pacer.check_rollout` through the crowd's heads."""
    f, r = kept["factor"], kept["resolve"]
    At, L, b, x = (t.to(device) for t in (f["At"], f["L"], r["b"], r["x"]))
    if mode == "control":
        L, x = solve.bf16_solve(At, b, f["chunks"])
    out = {"factor_gap": solve.factor_gap(At, L, f["chunks"]),
           "resolve_gap": solve.resolve_gap(At, b, x)}
    p = {k: v.to(device) for k, v in params.items()}
    pk, dk = kept["policy"], kept["disc"]
    pacer._precision("ieee")
    o = policy.normalize(pk["obs"].to(device), pk["mean"].to(device),
                         pk["var"].to(device))
    mu_ref = crowd.heads(p, d, o, critic=False)["mu"]
    amp = policy.normalize(dk["amp"].to(device), dk["mean"].to(device),
                           dk["var"].to(device))

    def reward(logit):
        return -torch.log(torch.clamp(1 - torch.sigmoid(logit), min=1e-4)
                          ) * amp_scale
    r_ref = reward(policy.disc(p, amp))
    mu, r_prog = pk["mu"].to(device), dk["r"].to(device)
    if mode == "control":
        pacer._precision("control")
        mu = crowd.heads(p, d, o, critic=False)["mu"]
        r_prog = reward(policy.disc(p, amp))
        pacer._precision("ieee")
    out["mu_gap"] = compare.rel_max(mu, mu_ref)
    out["disc_gap"] = compare.rel_max(r_prog, r_ref)
    return out


def _live_gap(prog, ref, live) -> float:
    g = ((prog - ref).abs().amax(-1)[live].double()
         / ref[live].abs().max().double())
    return pacer._q(g)


def check_step(kept: dict, device, mode: str) -> dict:
    """`pacer.check_step` with the crowd's observation, the others read
    in the program's state after its auto-reset, and the mirror of the
    step's observation (`flip_gap`: the program's feature-space mirror
    against the reference's mirror of its own observation, each env's
    worst entry over the largest, at the envs' quantile). The control:
    the step as `pacer.check_step`'s, and its observation mirrored."""
    w, k = kept["world"], kept["step"]
    b = world.bodies(world.betas(w["num_envs"], w["seed"]), device)
    h, cell, origin = world.heights(w["terrain_seed"], **w["terrain"])
    ground = humanoid.Ground(h, cell, origin, device)

    def on(t):
        return {n: v.to(device) for n, v in t.items()}
    given = [on(t) for t in kept["substeps"]]
    starts = [on(k["state"])] + given[:-1]
    people = on(kept["post"])
    args = (b, ground, starts[0], k["actions"].to(device),
            k["verts"].to(device), k["progress"].to(device), w["env"],
            w["engine"], given)
    last = given[-1]
    subs, obs, rew = crowd.control_step(*args, people=people)
    flip = crowd.mirror(b, last, obs, w["env"])
    if mode == "control":
        given, p_obs, p_rew = crowd.control_step(*args, control=True,
                                                 people=people)
        p_flip = crowd.mirror(b, humanoid.rounded(last), p_obs, w["env"])
    else:
        p_obs, p_rew = k["obs"].to(device), k["reward"].to(device)
        p_flip = kept["flip"].to(device)
    N = obs.shape[0]
    gaps = []
    for s0, p, r in zip(starts, given, subs):
        du = (p["u"] - r["u"]).double().norm(dim=-1)
        dx = (p["body_x"] - r["body_x"]).double().reshape(N, -1).norm(dim=-1)
        su = r["u"].double().norm(dim=-1).median()
        sx = (r["body_x"] - s0["body_x"]).double().reshape(N, -1).norm(
            dim=-1).median()
        gaps.append(torch.maximum(du / su, dx / sx))
    live = ~k["done"].to(device)
    rg = (p_rew - rew).abs().double() / rew.abs().max().double()
    return {"state_gap": pacer._q(torch.stack(gaps).amax(0)),
            "obs_gap": _live_gap(p_obs, obs, live),
            "flip_gap": _live_gap(p_flip, flip, live),
            "reward_gap": pacer._q(rg)}


def stamped_share(post: dict, w: dict, device) -> float:
    """The share of envs with a stamped sensor point in the state the
    checked step's observation read."""
    b = world.bodies(world.betas(w["num_envs"], w["seed"]), device)
    s = {n: v.to(device) for n, v in post.items()}
    pos, grot, _, _ = humanoid.pivot_frame(b, s)
    return crowd.stamped_share(pos, grot[:, 0], s["body_v"][:, 0],
                               w["env"]["group_size"], w["env"])


class Driver(_base.Driver):
    def setup(self, ctx, fault=None):
        self.ctx = ctx
        cfg, agent, ts, d, s = build(ctx)
        self.cfg, self.agent, self.d = cfg, agent, d
        self.world = world_of(cfg, s)
        self.undo = []
        self.profiled = {}
        start = pacer.cpu(ts.params)
        kept = {"start": start}
        if fault is not None:
            self._plant(fault)
        env = agent.env
        self._keep_post_and_flip(env, kept)
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
            env.__dict__.pop("observe_flipped_from", None)
        kept.update(probes.kept)
        kept["minibatches"] = mbs
        kept["prog"] = dict(start=start, losses=[o[0] for o in outs],
                            m1=outs[0][1], params=outs[-1][2])
        self.kept, self.ts = kept, ts
        self.stamped = stamped_share(kept["post"], self.world, ctx.device)
        self.spans = ctx.spans
        pacer.spanned(agent, _base.PARTS, self)

    @staticmethod
    def _keep_post_and_flip(env, kept):
        """Keep the state after step `pacer.STEP_INDEX` (auto-reset
        included) and the program's mirror of that step's observation (the
        rollout mirrors each step's observation as it starts the next).
        The probes wrap this `step` and take both wrappers off."""
        step, flipped = env.step, env.observe_flipped_from
        calls = {"step": 0, "flip": 0}

        def keep_step(state, actions):
            new, out = step(state, actions)
            if calls["step"] == pacer.STEP_INDEX:
                kept["post"] = pacer._state(new.physics)
            calls["step"] += 1
            return new, out

        def keep_flip(obs):
            out = flipped(obs)
            if calls["flip"] == pacer.STEP_INDEX + 1:
                kept["flip"] = out.detach().cpu()
            calls["flip"] += 1
            return out
        env.step = keep_step
        env.observe_flipped_from = keep_flip

    def _plant(self, fault):
        from emloco_tpu_torch.envs import observations as obs
        if fault == "no_people":
            stamped, plain = obs.group_velocity_map_obs, obs.velocity_map_obs

            def unstamped(terrain, sensor_pos, sensor_rot, center_xy,
                          grid_local, root_pos, root_vel, group_size,
                          meas_scale=5.0, **kw):
                return plain(terrain, sensor_pos, sensor_rot, center_xy,
                             grid_local, root_vel, meas_scale)
            obs.group_velocity_map_obs = unstamped
            self.undo.append(lambda: setattr(obs, "group_velocity_map_obs",
                                             stamped))
        elif fault == "wrong_group":
            nearest = obs._nearest_in_group

            def next_group(xy, group_size, k):
                nd, idx = nearest(xy, group_size, k)
                return nd, (idx + group_size) % xy.shape[0]
            obs._nearest_in_group = next_group
            self.undo.append(lambda: setattr(obs, "_nearest_in_group",
                                             nearest))
        else:
            super()._plant(fault)

    def profiled_unit(self, spans):
        from emloco_tpu_torch.envs import observations as obs
        dev = self.ctx.device
        orig = {n: getattr(obs, n) for n in OBS_SPANS}

        def drained(fn, span):
            def f(*a, **kw):
                core.synchronize(dev)
                with spans.span(span):
                    return fn(*a, **kw)
            return f
        for name, span in OBS_SPANS.items():
            setattr(obs, name, drained(orig[name], span))
        getattr(obs, "reset_crowd_counts", lambda: None)()
        try:
            self.unit(spans)
        finally:
            for name, fn in orig.items():
                setattr(obs, name, fn)
        # the program's host counters of the calls just spanned (none in a
        # program without them)
        self.profiled = dict(getattr(obs, "CROWD_COUNTS", {}))

    def flops_per_unit(self):
        c, d = self.cfg, self.d
        N, T = c.env.num_envs, c.amp.horizon
        rows = N * T // c.amp.num_minibatches
        half = max(1, c.amp.amp_batch_size // 2)
        return (T * (crowd_counts.policy_rollout_step(d, N)
                     + pacer.physics_flops(self.kept, N,
                                           c.env.engine.n_substeps))
                + crowd_counts.policy_prepare(d, N, T)
                + c.amp.mini_epochs * c.amp.num_minibatches
                * crowd_counts.policy_minibatch(d, rows, half,
                                                c.amp.amp_batch_size,
                                                c.amp.motion_sym_loss))

    def counts(self):
        c, d = self.cfg, self.d
        out = {"arrow": pacer.arrow_counts(self.kept),
               "stamped_share": self.stamped,
               "minibatches": c.amp.mini_epochs * c.amp.num_minibatches}
        n = self.profiled
        if n:
            H, W = self.agent.env.terrain.shape
            out["crowd_obs"] = dict(bytes=crowd_counts.velocity_map_bytes(
                n["velocity_map_rows"], n["velocity_map_calls"],
                c.env.num_sensor_points, H * W) + crowd_counts.group_obs_bytes(
                n["group_obs_rows"], d["people_obs"]))
        return out

    def check(self, kept, mode="program"):
        dev = self.ctx.device
        ac, d = kept["amp"], kept["dims"]
        out = check_rollout(kept, d, kept["start"], ac["disc_reward_scale"],
                            dev, mode)
        out.update(check_step(kept, dev, mode))

        def on(x):
            return None if x is None else x.to(dev)
        mbs = [({k: v.to(dev) for k, v in mb.items()}, on(demo), on(replay),
                None if masks is None else tuple(on(m) for m in masks))
               for mb, demo, replay, masks in kept["minibatches"]]
        start = {k: v.to(dev) for k, v in kept["start"].items()}
        out.update(pacer.train_numbers(
            crowd.train, (start, d, ac, mbs), kept["prog"], dev, mode))
        out["stamped_share"] = kept["stamped_share"]
        return out

    def release(self):
        stamped = self.stamped
        kept = super().release()
        kept["stamped_share"] = stamped
        return kept
