"""Train the locomotion policy with PPO + AMP at the bench's training
configuration.

    python3 -m emloco_tpu_torch.train [--epochs 10] [--num-envs 1600]
        [--seed 0] [--device cuda] [--task terrain|getup|hand]
        [amp.<field>=<value> ...] [env.<field>=<value> ...]
        [engine.<field>=<value> ...]

The counterpart of the JAX package's `train-policy` loop (cli/run.py:94-175)
without checkpoints, resume, mesh or profiling. It builds
`rollout.build_train_bench` for the task (the env class of `cli/run.py:81-88`;
`getup` with self-contact and SMPL-fixture mesh colliders by default; fields
of AMPConfig, of the task's env config and of its engine may be replaced
with `amp.<field>=<value>`, `env.<field>=<value>` and
`engine.<field>=<value>`) and prints one JSON line an epoch: the epoch's
metrics, its seconds and env-steps/s including the update. For `getup`
every epoch first applies the fall-bank schedule and the reward schedule at
its epoch number, as `cli/run.py:148-156` does. Runs on the CUDA card unless
`--device cpu` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from . import device as _device
from .rollout import TASKS, TRAIN_AMP, build_train_bench, parse_overrides


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--num-envs", type=int, default=1600)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    ap.add_argument("--task", choices=TASKS, default="terrain")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    amp_fields, env_fields = parse_overrides(args.overrides, args.task)
    dev = _device.resolve(args.device)
    if dev.type == "cuda":
        # the networks' float32 GEMMs and convs in full float32, not TF32
        # (the physics step sets this for itself)
        torch.backends.cuda.matmul.fp32_precision = "ieee"
        torch.backends.cudnn.conv.fp32_precision = "ieee"
    agent, ts = build_train_bench(
        args.num_envs, dev, args.seed,
        dataclasses.replace(TRAIN_AMP, **amp_fields), args.task,
        **env_fields)
    env = agent.env
    steps = agent.cfg.horizon * args.num_envs
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for _ in range(args.epochs):
        t = time.perf_counter()
        if args.task == "getup":
            ep, upd = ts.epoch, env.cfg.getup_update_epoch
            ts = ts.replace(env_state=env.update_getup_schedule(
                ts.env_state, ep, upd))
            ts = agent.update_getup_reward_schedule(ts, ep, upd)
        ts, metrics = agent.train_epoch(ts)
        metrics = {k: v.item() for k, v in metrics.items()}
        dt = time.perf_counter() - t
        print(json.dumps({"epoch": ts.epoch, **metrics, "seconds": dt,
                          "env_steps_per_s": steps / dt,
                          "replay_filled": ts.replay_filled,
                          "device": name}), flush=True)
    return ts


if __name__ == "__main__":
    main()
