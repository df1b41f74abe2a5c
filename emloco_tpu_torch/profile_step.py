"""Where the rollout step's or the training epoch's time goes on the card.

    python3 -m emloco_tpu_torch.profile_step [--envs 4096] [--steps 3]
        [env.<field>=<value> ...]
    python3 -m emloco_tpu_torch.profile_step --train [--envs 1600]
        [--task terrain|getup|hand] [amp.<field>=<value> ...]
        [env.<field>=<value> ...] [engine.<field>=<value> ...]
    python3 -m emloco_tpu_torch.profile_step --value [--envs 1600]
        [amp.<field>=<value> ...] [env.<field>=<value> ...]
    python3 -m emloco_tpu_torch.profile_step --predictor [--preset jta]
        [--steps 3]

Builds the env and actor at the bench configuration (`rollout.build_bench`)
and times on the host, with a synchronize around each part: observe,
normalize + actor, the physics step alone (same state and targets) and the
whole env.step. Then traces `--steps` control steps with torch.profiler and
prints the CUDA kernels and the aten ops (with input shapes) by device time,
the kernel launches per step and the device's busy share: kernel time per
step over the control step's host time measured without the profiler, whose
own overhead inflates the traced wall time. One JSON object per line.

With `--train` the unit is one epoch of the bench's training configuration
(`rollout.build_train_bench`): after a warm-up epoch, the host times of its
three parts (rollout, prepare: GAE + norms + replay + demos, update), then
the next epoch traced part by part, with the same tables for each part and
the epoch's device time, launches and busy share. The crowd epoch is
`--train amp.network=sept_cnn env.group_obs=true env.group_size=100
env.velocity_map=true`, the bfloat16 one `--train amp.hidden_bf16=true`;
`--task getup|hand` breaks down the getup (its schedules applied at epoch
0: fall resets only, the discriminator's reward alone) or the hand task's
epoch (`rollout.build_train_bench(task=...)`). `engine.<field>=<value>`
replaces a field of the engine (the task's: self-contact and mesh colliders
for getup).

With `--value` the unit is one LocoVal epoch (`rollout.build_value_bench`),
broken down the same way into its two parts: collect (the frozen policy's
32 control steps with the return latching) and update (one AdamW step of
the valuenet on the epoch's samples).

With `--predictor` the unit is one train step of the trajectory predictor
at a preset's full width (`prediction.presets`: jta, jrdb or lstm) on a
batch of 10 synthetic scenes of 4 people, with the EmLoco loss through a
ValuePoseNet from a fixed seed where the preset uses it: the host time of
`--steps` steps after a warm-up, then the same steps traced.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import torch

from . import device as _device
from .physics import step as physics_step
from .rollout import (TASKS, TRAIN_AMP, build_bench, build_train_bench,
                      build_value_bench, parse_overrides)


def _host_ms(fn, reps):
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3, out


def _report(traced, units, unit, host_ms, card, top):
    """The traced kernels and aten ops by device time, per `unit`, with the
    launches and the device's busy share over `host_ms` per unit; returns
    (device ms, launches) per unit."""
    prof, wall_ms = traced

    def device_us(e):
        us = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if us is None else us

    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted(((device_us(e), e.count, e.key)
                      for e in prof.key_averages() if e.device_type == cuda),
                     reverse=True)
    ops = sorted(((device_us(e), e.count, e.key, e.input_shapes)
                  for e in prof.key_averages(group_by_input_shape=True)
                  if e.device_type != cuda and e.key.startswith("aten::")
                  and device_us(e) > 0), key=lambda row: row[0], reverse=True)
    per_ms = sum(k[0] for k in kernels) / 1e3 / units
    launches = sum(k[1] for k in kernels) / units
    print(json.dumps({
        f"profiled_{unit}s": units, "profiled_wall_ms": wall_ms,
        f"device_kernel_ms_per_{unit}": per_ms,
        "device_busy_share": per_ms / host_ms,
        f"kernel_launches_per_{unit}": launches, "card": card}), flush=True)
    for us, count, name in kernels[:top]:
        print(json.dumps({"kernel": name[:120],
                          f"device_ms_per_{unit}": us / 1e3 / units,
                          f"launches_per_{unit}": count / units,
                          "share": us / 1e3 / units / per_ms}), flush=True)
    for us, count, name, shapes in ops[:top]:
        print(json.dumps({"op": name, "input_shapes": str(shapes)[:160],
                          f"device_ms_per_{unit}": us / 1e3 / units,
                          f"calls_per_{unit}": count / units}), flush=True)
    return per_ms, launches


def _profile(fn, units):
    """`units` calls of `fn` under torch.profiler → ((profile, wall ms),
    fn's last result)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t = time.perf_counter()
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        for _ in range(units):
            out = fn()
        torch.cuda.synchronize()
    return (prof, (time.perf_counter() - t) * 1e3), out


def _epoch(ts, parts, steps, card, top, **info):
    """One epoch run part by part: `parts` is [(name, fn)], each fn taking
    the previous part's outputs (the first part: ts) and returning a tuple
    that starts with the new ts. The host time of each part, synchronized;
    then the next epoch traced part by part (each part's device time,
    launches and busy share over its untraced host time, with its top
    kernels and ops) and the epoch's totals."""
    host, out = {}, (ts,)
    _, t = _host_split(0.0)
    for name, fn in parts:
        out = fn(*out)
        host[name], t = _host_split(t)
    epoch_ms = sum(host.values())
    print(json.dumps({
        "host_ms_per_epoch": host, "epoch_ms": epoch_ms,
        "env_steps_per_s": steps / epoch_ms * 1e3, **info, "card": card}),
        flush=True)
    out, device = out[:1], {}
    for name, fn in parts:
        traced, out = _profile(lambda: fn(*out), 1)
        device[name] = _report(traced, 1, name, host[name], card, top)
    dev_ms = sum(d[0] for d in device.values())
    print(json.dumps({
        "device_kernel_ms_per_epoch": dev_ms,
        "kernel_launches_per_epoch": sum(d[1] for d in device.values()),
        "device_busy_share": dev_ms / epoch_ms, "card": card}), flush=True)


def _train(args, dev, card):
    """The bench's training epoch (rollout, prepare: GAE + norms + replay +
    demos, update) after a warm-up epoch."""
    envs = args.envs or 1600
    agent, ts = build_train_bench(
        envs, dev, amp=dataclasses.replace(TRAIN_AMP, **args.amp_fields),
        task=args.task, **args.env_fields)
    if args.task == "getup":
        upd = agent.env.cfg.getup_update_epoch
        ts = ts.replace(env_state=agent.env.update_getup_schedule(
            ts.env_state, 0, upd))
        ts = agent.update_getup_reward_schedule(ts, 0, upd)
    ts, _ = agent.train_epoch(ts)                        # warm-up
    _epoch(ts, [("rollout", agent.rollout), ("prepare", agent.prepare),
                ("update", agent.update)], agent.cfg.horizon * envs, card,
           args.top, updates_per_epoch=agent.cfg.mini_epochs
           * agent.cfg.num_minibatches, num_envs=envs)


def _value(args, dev, card):
    """The LocoVal epoch at the training configuration (collect: the frozen
    policy's rollout with the return latching, update: one AdamW step of
    the valuenet) after a warm-up epoch."""
    envs = args.envs or 1600
    trainer, vts = build_value_bench(
        envs, dev, amp=dataclasses.replace(TRAIN_AMP, **args.amp_fields),
        env_fields=args.env_fields)
    vts, _ = trainer.train_epoch(vts)                    # warm-up
    _epoch(vts, [("collect", trainer._collect), ("update", trainer.update)],
           trainer.cfg.horizon * envs, card, args.top, num_envs=envs)


def _predictor(args, dev, card):
    """`--steps` train steps of the predictor preset after a warm-up."""
    from .learning import ValuePoseNet
    from .prediction.data import SyntheticScenes
    from .prediction.presets import configs
    from .prediction.train import PredictorTrainer
    mcfg, pcfg = configs(args.preset)
    vnet = ValuePoseNet(generator=torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    trainer = PredictorTrainer(mcfg, pcfg, vnet=vnet, device=dev)
    ts = trainer.init(0, vnet_params=dict(vnet.named_parameters()))
    batch = SyntheticScenes(num_people=4, seed=0).batch(10)
    state = [trainer.train_step(ts, *batch)[0]]          # warm-up

    def step():
        state[0], _ = trainer.train_step(state[0], *batch)

    host_ms, _ = _host_ms(step, args.steps)
    print(json.dumps({"preset": args.preset, "host_ms_per_step": host_ms,
                      "steps_per_s": 1e3 / host_ms, "batch": 10,
                      "card": card}), flush=True)
    _report(_profile(step, args.steps)[0], args.steps, "step", host_ms,
            card, args.top)


def _host_split(t):
    """(ms since `t` after a synchronize, now)."""
    torch.cuda.synchronize()
    now = time.perf_counter()
    return (now - t) * 1e3, now


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=None,
                    help="envs (default 4096; 1600 with --train or --value)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--train", action="store_true",
                    help="break down one training epoch instead")
    ap.add_argument("--value", action="store_true",
                    help="break down one LocoVal training epoch instead")
    ap.add_argument("--task", choices=TASKS, default="terrain",
                    help="the task of --train")
    ap.add_argument("--predictor", action="store_true",
                    help="break down one predictor train step instead")
    ap.add_argument("--preset", default="jta",
                    help="the predictor preset of --predictor")
    ap.add_argument("overrides", nargs="*",
                    help="amp.<field>=<value> (--train, --value), "
                         "env.<field>=<value> and engine.<field>=<value>")
    args = ap.parse_args(argv)
    args.amp_fields, args.env_fields = parse_overrides(args.overrides,
                                                       args.task)
    if args.amp_fields and not (args.train or args.value):
        raise SystemExit("amp.<field> overrides need --train or --value")
    if args.task != "terrain" and not args.train:
        raise SystemExit("--task needs --train")
    dev = _device.resolve(None)
    _device.full_float32(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    if args.train:
        return _train(args, dev, card)
    if args.value:
        return _value(args, dev, card)
    if args.predictor:
        return _predictor(args, dev, card)

    envs = args.envs or 4096
    r = build_bench(envs, dev, **args.env_fields)
    cfg, env = r.cfg, r.env
    state = env.reset(torch.Generator(device=dev).manual_seed(0))
    for _ in range(2):                                   # warm-up
        state, *_ = r.control_step(state)

    obs_ms, o = _host_ms(lambda: env.observe(state), args.steps)
    act_ms, mu = _host_ms(lambda: r.act(o), args.steps)
    target = (mu.reshape(-1, 23, 3) * env.pd_action_scale[None]
              * env.action_mask[None])
    phys_ms, _ = _host_ms(lambda: physics_step(
        env.model, env.terrain, state.physics, target, cfg.engine, env.tree),
        args.steps)
    step_ms, _ = _host_ms(lambda: env.step(state, mu), args.steps)
    control_ms = obs_ms + act_ms + step_ms
    print(json.dumps({
        "host_ms_per_call": {"observe": obs_ms, "normalize_actor": act_ms,
                             "physics_step": phys_ms, "env_step": step_ms,
                             "env_step_minus_physics": step_ms - phys_ms},
        "control_step_ms": control_ms,
        "env_steps_per_s": envs / control_ms * 1e3,
        "num_envs": envs, "card": card}), flush=True)

    steps = [state]

    def control_step():
        steps[0], *_ = r.control_step(steps[0])

    _report(_profile(control_step, args.steps)[0], args.steps, "step",
            control_ms, card, args.top)


if __name__ == "__main__":
    main()
