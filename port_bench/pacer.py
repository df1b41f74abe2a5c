"""What the PACER drivers share: the world and agent built through the
port's entry (`cli.run._agent` over the configuration's values), the
policy's weights made by the benchmark, the probes that keep what the
first epoch produced for the check, and the checks of the kernels, the
policy and the discriminator against the plain reference."""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from . import weights
from .counts import arrow
from .reference import compare, humanoid, policy, solve, world

DISC_ROWS = 4096
# the control step whose state, observation and reward the check keeps:
# the third of the first epoch, past the reset's first steps
STEP_INDEX = 2
# the share of envs past which a step's gaps are read: a contact or a joint
# limit that one rounding tips is a different branch, not a fault
QUANTILE = 0.99


def seeds(seed: int) -> dict:
    """Sub-seeds of the run's seed: the world (bodies, agent and env
    draws), the terrain, the policy's weights, the valuenet's weights."""
    s = np.random.SeedSequence(seed).generate_state(4, np.uint32)
    return dict(world=int(s[0]), terrain=int(s[1]), policy=int(s[2]),
                valuenet=int(s[3]))


def merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = v
    return out


def _yaml(v) -> str:
    """A value as the port's YAML reader takes it (a float keeps its dot:
    YAML 1.1 reads 2e-05 as a string)."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        s = repr(v)
        if "e" in s and "." not in s:
            m, e = s.split("e")
            s = f"{m}.0e{e}"
        return s
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_yaml(x) for x in v) + "]"
    return str(v)


def overrides(run: dict, prefix: str = "") -> list:
    out = []
    for k, v in run.items():
        if isinstance(v, dict):
            out += overrides(v, f"{prefix}{k}.")
        else:
            out.append(f"{prefix}{k}={_yaml(v)}")
    return out


def dims(config: dict, env, agent) -> dict:
    """The network's dimensions: the configuration's widths, with the
    observation widths the env gives checked against those it states."""
    d = dict(config["widths"])
    seen = dict(self_obs=env.cfg.self_obs_dim, task_obs=env.task_obs_dim,
                traj_obs=env.cfg.num_traj_samples * 2, amp_obs=agent.amp_dim,
                actions=env.cfg.num_actions)
    for k, v in seen.items():
        if d[k] != v:
            raise ValueError(f"{k}: the env gives {v}, the configuration "
                             f"states {d[k]}")
    return d


def build(ctx, run_overrides=None):
    """(run config, agent, TrainState with the benchmark's weights, dims,
    seeds) for the cell."""
    from emloco_tpu_torch.cli import run as cli
    from emloco_tpu_torch.utils.config import load_config

    s = seeds(ctx.seed)
    run = merge(ctx.config["run"], ctx.workload["traffic"].get("run", {}))
    run = merge(run, {"seed": s["world"], "terrain": {"seed": s["terrain"]}})
    cfg = load_config(None, overrides(run) + list(run_overrides or []))
    if ctx.workload["traffic"].get("valuenet_inversion"):
        # as `cli.run train-valuenet` sets it
        import dataclasses
        traj = dataclasses.replace(
            cfg.env.traj,
            heading_inversion_prob=cfg.value.heading_inversion_prob)
        cfg = dataclasses.replace(cfg, env=dataclasses.replace(cfg.env,
                                                               traj=traj))
    with ctx.spans.span("world_build"):
        agent, ts = cli._agent(cfg, ctx.device)
    d = dims(ctx.config, agent.env, agent)
    made = weights.make(policy.param_spec(d), s["policy"], ctx.device)
    ts = ts.replace(params=weights.load_into(ts.params, made))
    return cfg, agent, ts, d, s


class Probes:
    """Wrappers around the program's calls that keep, once, what they took
    and gave: the first block-arrow factor and resolve of the physics step,
    the first policy call, the first discriminator reward, and the env
    step `STEP_INDEX` (its state, actions, the physics state after each
    substep, its observation, reward and ends). `step_hook(state, out)` is called
    after every env step while they are installed. Installed for the
    set-up's first epoch and removed before the window."""

    def __init__(self, agent, step_hook=None):
        from emloco_tpu_torch.envs import pedestrian_terrain
        from emloco_tpu_torch.physics import reduced
        self.reduced, self.agent = reduced, agent
        self.env_module = pedestrian_terrain
        self.step_hook = step_hook
        self.kept: dict = {}
        self._orig = {}

    def _wrap(self, owner, name, make):
        orig = getattr(owner, name)
        self._orig[(owner, name)] = orig
        setattr(owner, name, make(orig))

    def install(self):
        kept = self.kept
        hook = self.step_hook
        calls = {"step": 0, "physics": 0, "inside": False}

        def factor(orig):
            def f(At, chunks, limbs, s_lo):
                L = orig(At, chunks, limbs, s_lo)
                if "factor" not in kept:
                    kept["factor"] = dict(
                        At=At.detach().cpu(), L=L.detach().cpu(),
                        chunks=tuple(chunks), limbs=tuple(limbs),
                        s_lo=int(s_lo))
                return L
            return f

        def resolve(orig):
            def f(L, bt, chunks, limbs, s_lo):
                x = orig(L, bt, chunks, limbs, s_lo)
                if "resolve" not in kept and "factor" in kept:
                    kept["resolve"] = dict(b=bt.detach().cpu(),
                                           x=x.detach().cpu())
                return x
            return f

        def rows(orig):
            def f(*a, **kw):
                out = orig(*a, **kw)
                kept.setdefault("gram_rows", int(out[0].shape[1]))
                return out
            return f

        def pol(orig):
            def f(params, obs_norm, obs, gen):
                out = orig(params, obs_norm, obs, gen)
                if "policy" not in kept:
                    a, mu, sigma, logp, o_n = out
                    kept["policy"] = dict(
                        obs=obs.cpu(), mean=obs_norm.mean.cpu(),
                        var=obs_norm.var.cpu(), mu=mu.cpu(),
                        sigma=sigma.cpu())
                return out
            return f

        def disc(orig):
            def f(params, amp_norm, amp_obs):
                r = orig(params, amp_norm, amp_obs)
                if "disc" not in kept:
                    # the first rows only: prepare's call takes the epoch's
                    # T·N windows
                    n = DISC_ROWS
                    kept["disc"] = dict(
                        amp=amp_obs.reshape(-1, amp_obs.shape[-1])[:n].cpu(),
                        mean=amp_norm.mean.cpu(), var=amp_norm.var.cpu(),
                        r=r.reshape(-1)[:n].cpu())
                return r
            return f

        def physics(orig):
            def f(*a, **kw):
                calls["inside"] = calls["physics"] == STEP_INDEX
                out = orig(*a, **kw)
                calls["inside"] = False
                calls["physics"] += 1
                return out
            return f

        def integrate(orig):
            def f(*a, **kw):
                out = orig(*a, **kw)
                if calls["inside"]:
                    kept.setdefault("substeps", []).append(_state(out))
                return out
            return f

        def step(orig):
            def f(state, actions):
                pre = None
                if calls["step"] == STEP_INDEX:
                    pre = dict(state=_state(state.physics),
                               progress=state.progress.cpu(),
                               verts=state.traj_verts.cpu(),
                               actions=actions.cpu())
                new, out = orig(state, actions)
                if pre is not None:
                    kept["step"] = dict(pre, obs=out.obs.cpu(),
                                        reward=out.reward.cpu(),
                                        done=out.done.cpu())
                calls["step"] += 1
                if hook is not None:
                    hook(state, out)
                return new, out
            return f

        r = self.reduced
        self._wrap(r, "cholesky_factor_blocked_t", factor)
        self._wrap(r, "cholesky_resolve_blocked_t", resolve)
        self._wrap(r, "_merged_rows", rows)
        self._wrap(self.env_module, "physics_step", physics)
        self._wrap(r, "_integrate_pose", integrate)
        self._wrap(self.agent, "_policy", pol)
        self._wrap(self.agent, "_disc_reward", disc)
        self._wrap(self.agent.env, "step", step)

    def remove(self):
        for (owner, name), orig in self._orig.items():
            if owner is self.agent or owner is self.agent.env:
                # back to the class's method
                owner.__dict__.pop(name, None)
            else:
                setattr(owner, name, orig)
        self._orig.clear()


_STATE = ("root_pos", "root_rot", "joint_rot", "u", "body_x", "body_q",
          "body_v", "body_w")


def _state(physics) -> dict:
    return {k: getattr(physics, k).detach().cpu() for k in _STATE}


def spanned(owner, names: dict, where) -> None:
    """Wrap each method of `owner` named in `names` in a span of that name's
    value, on the spans `where.spans` holds at the call: the window calls
    the program's own entry, and the spans sit beneath it. A disabled span
    costs nothing."""
    for name, span in names.items():
        orig = getattr(owner, name)

        def f(*a, _orig=orig, _span=span, **kw):
            with where.spans.span(_span):
                return _orig(*a, **kw)
        setattr(owner, name, f)


def skip_substep():
    """The planted fault of a dropped substep: the second substep of every
    control step leaves the pose and velocities as the first left them.
    Returns the undo."""
    from emloco_tpu_torch.physics import reduced
    orig = reduced._integrate_pose
    calls = [0]

    def every_other(model, state, u_new, dt, tree):
        calls[0] += 1
        if calls[0] % 2 == 0:
            return state
        return orig(model, state, u_new, dt, tree)
    reduced._integrate_pose = every_other

    def undo():
        reduced._integrate_pose = orig
    return undo


def world_of(cfg, s: dict) -> dict:
    """What the reference needs to rebuild the world and step it: the
    configuration's values and the seeds (nothing the program made)."""
    env, eng = cfg.env, cfg.env.engine
    t = dict(cfg.terrain)
    t.pop("seed", None)
    if t.pop("type", "mixed") != "mixed":
        raise ValueError("the reference builds the mixed terrain only")
    unsupported = dict(
        tgs=not (eng.tgs_step and eng.n_substeps > 1),
        solver=not eng.blocked_solver or eng.batch_major_solver
        or eng.gram_kernel,
        gram=not (eng.sqrt_gram and eng.substep_dt * eng.contact_stiffness
                  + eng.contact_damping > eng.max_friction_damping),
        rows=not eng.rows_bf16, contacts=eng.mesh_contacts
        or eng.self_contact or eng.terrain_patch,
        env=env.dr.enabled or env.obs_noise_std or env.action_noise_std
        or env.push_interval or env.projectile_interval
        or not env.terrain_obs or env.velocity_map or env.group_obs
        or env.sensor_shape != "square" or not env.has_shape_obs
        or env.has_limb_weight_obs or not env.power_reward)
    bad = [k for k, v in unsupported.items() if v]
    if bad or cfg.task != "terrain" or cfg.smpl_npz:
        raise ValueError(f"the reference's control step does not cover "
                         f"this configuration's {bad or [cfg.task]}")
    return dict(
        num_envs=env.num_envs, seed=s["world"], terrain_seed=s["terrain"],
        terrain=t, engine=dataclasses.asdict(eng),
        env=dict(dt=env.dt, num_traj_samples=env.num_traj_samples,
                 traj_sample_timestep=env.traj_sample_timestep,
                 episode_dur=env.traj.episode_dur,
                 sensor_extent=env.sensor_extent, sensor_res=env.sensor_res,
                 height_meas_scale=env.height_meas_scale,
                 location_coefficient=env.location_coefficient,
                 power_coefficient=env.power_coefficient))


def _q(x: torch.Tensor) -> float:
    return float(torch.quantile(x.double(), QUANTILE)) if x.numel() else \
        float("inf")


def check_step(kept: dict, device, mode: str) -> dict:
    """The env step `STEP_INDEX`, judged substep by substep from the
    program's own state before each (contact physics is stiff: a rounding
    in one substep grows in the next) with the actions it took: each
    substep's state (each env's gap of its generalized velocity over the
    median env's speed, and of its bodies' displacement over the median
    env's, the larger), and the observation of the envs the step did not
    end and the reward from the program's last state (each env's worst
    entry over the largest); every gap read at the envs' `QUANTILE`, the
    worst substep kept. The control: the reference with its Gram in TF32
    and its solve in bfloat16, and the observation and the reward from the
    state in bfloat16, against the reference."""
    w, k = kept["world"], kept["step"]
    b = world.bodies(world.betas(w["num_envs"], w["seed"]), device)
    h, cell, origin = world.heights(w["terrain_seed"], **w["terrain"])
    ground = humanoid.Ground(h, cell, origin, device)

    def on(t):
        return {n: v.to(device) for n, v in t.items()}
    given = [on(t) for t in kept["substeps"]]
    starts = [on(k["state"])] + given[:-1]
    args = (b, ground, starts[0], k["actions"].to(device),
            k["verts"].to(device), k["progress"].to(device), w["env"],
            w["engine"], given)
    subs, obs, rew = humanoid.control_step(*args)
    if mode == "control":
        given, p_obs, p_rew = humanoid.control_step(*args, control=True)
    else:
        p_obs, p_rew = k["obs"].to(device), k["reward"].to(device)
    N = obs.shape[0]
    gaps = []
    for s0, p, r in zip(starts, given, subs):
        du = (p["u"] - r["u"]).double().norm(dim=-1)
        dx = (p["body_x"] - r["body_x"]).double().reshape(N, -1).norm(dim=-1)
        su = r["u"].double().norm(dim=-1).median()
        sx = (r["body_x"] - s0["body_x"]).double().reshape(N, -1).norm(
            dim=-1).median()
        gaps.append(torch.maximum(du / su, dx / sx))
    gap = torch.stack(gaps).amax(0)
    live = ~k["done"].to(device)
    og = ((p_obs - obs).abs().amax(-1)[live].double()
          / obs[live].abs().max().double())
    rg = (p_rew - rew).abs().double() / rew.abs().max().double()
    return {"state_gap": _q(gap), "obs_gap": _q(og), "reward_gap": _q(rg)}


def physics_flops(kept: dict, envs: int, substeps: int) -> float:
    f = kept["factor"]
    M = f["At"].shape[0]
    w = arrow.work(f["limbs"], f["s_lo"], M)
    return envs * (arrow.gram_flops(kept["gram_rows"], M) + w["factor_flops"]
                   + substeps * w["resolve_flops"])


def arrow_counts(kept: dict) -> dict:
    f = kept["factor"]
    M, N = f["At"].shape[0], f["At"].shape[2]
    return dict(arrow.work(f["limbs"], f["s_lo"], M), envs=N, M=M)


def _precision(mode: str):
    """Full float32 for the reference; TF32 for the control (the nearest
    precision below the configuration's float32 with TF32 off)."""
    p = "tf32" if mode == "control" else "ieee"
    torch.backends.cuda.matmul.fp32_precision = p
    torch.backends.cudnn.conv.fp32_precision = p


def check_rollout(kept: dict, d: dict, params: dict, amp_scale: float,
                  device, mode: str) -> dict:
    """The kernels on the step's own LHS, the policy's μ on its first
    call's obs, and the first discriminator reward, against the plain
    reference (the control: the reference itself in bfloat16 for the
    solve and in TF32 for the networks)."""
    f, r = kept["factor"], kept["resolve"]
    At, L, b, x = (t.to(device) for t in (f["At"], f["L"], r["b"], r["x"]))
    if mode == "control":
        L, x = solve.bf16_solve(At, b, f["chunks"])
    out = {"factor_gap": solve.factor_gap(At, L, f["chunks"]),
           "resolve_gap": solve.resolve_gap(At, b, x)}
    p = {k: v.to(device) for k, v in params.items()}
    pk = kept["policy"]
    _precision("ieee")
    o = policy.normalize(pk["obs"].to(device), pk["mean"].to(device),
                         pk["var"].to(device))
    ref = policy.heads(p, d, o, critic=False)
    mu = pk["mu"].to(device)
    dk = kept["disc"]
    amp = policy.normalize(dk["amp"].to(device), dk["mean"].to(device),
                           dk["var"].to(device))

    def reward(logit):
        return -torch.log(torch.clamp(1 - torch.sigmoid(logit), min=1e-4)
                          ) * amp_scale
    r_ref = reward(policy.disc(p, amp))
    r_prog = dk["r"].to(device)
    if mode == "control":
        _precision("control")
        mu = policy.heads(p, d, o, critic=False)["mu"]
        r_prog = reward(policy.disc(p, amp))
        _precision("ieee")
    out["mu_gap"] = compare.rel_max(mu, ref["mu"])
    out["disc_gap"] = compare.rel_max(r_prog, r_ref)
    return out


def train_numbers(ref_fn, args, prog: dict, device, mode: str) -> dict:
    """The training numbers: the reference's steps from the same start on
    the same inputs, against the program's (`prog`: losses, m1, params
    after the steps, start) or, for the control, against the reference run
    again in TF32."""
    _precision("ieee")
    losses, m1, g1, p3 = ref_fn(*args)
    if mode == "control":
        _precision("control")
        c_losses, c_m1, _, c_p3 = ref_fn(*args)
        _precision("ieee")
        prog = dict(prog, losses=c_losses, m1=c_m1, params=c_p3)
    p0 = {k: v.to(device) for k, v in prog["start"].items()}
    prog_p = {k: v.to(device) for k, v in prog["params"].items()}
    return compare.training(
        prog["losses"], losses, {k: v.to(device) for k, v in
                                 prog["m1"].items()}, m1,
        {k: prog_p[k] - p0[k] for k in p0}, {k: p3[k] - p0[k] for k in p0},
        g1)


def cpu(tree: dict) -> dict:
    return {k: v.detach().cpu().clone() for k, v in tree.items()}

