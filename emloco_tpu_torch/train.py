"""Train the locomotion policy with PPO + AMP at the bench's training
configuration.

    python3 -m emloco_tpu_torch.train [--epochs 10] [--num-envs 1600]
        [--seed 0] [--device cuda] [--task terrain|getup|hand]
        [--out DIR] [--save-every 200] [--resume PATH]
        [amp.<field>=<value> ...] [env.<field>=<value> ...]
        [engine.<field>=<value> ...]

The counterpart of the JAX package's `train-policy` loop (cli/run.py:94-175)
without mesh or profiling. It builds `rollout.build_train_bench` for the
task (the env class of `cli/run.py:81-88`; `getup` with self-contact and
SMPL-fixture mesh colliders by default; fields of AMPConfig, of the task's
env config and of its engine may be replaced with `amp.<field>=<value>`,
`env.<field>=<value>` and `engine.<field>=<value>`) and prints one JSON line
an epoch: the epoch's metrics, its seconds and env-steps/s including the
update. For `getup` every epoch first applies the fall-bank schedule and the
reward schedule at its absolute epoch number, as `cli/run.py:148-156` does.

With `--out DIR` it writes `policy_<epoch:08d>.ckpt` there after every
`--save-every`-th epoch and after the last (`utils.checkpoint.save_policy`:
params in the flax layout, the three norms, the Adam state, the metadata
`epoch`). `--resume PATH` starts from a policy file of either package: its
params and norms, and its value norm and Adam state where it has them;
epochs are numbered on from the file's (its metadata, else its name), as
the JAX CLI numbers them. Runs on the CUDA card unless `--device cpu` is
given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from . import device as _device
from .parallel import mesh as pmesh
from .rollout import TASKS, TRAIN_AMP, build_train_bench, parse_overrides
from .utils.checkpoint import (checkpoint_epoch, load_pytree,
                               restore_policy, save_policy)


def run_epochs(agent, ts, start: int, epochs: int, on_epoch=None,
               out: str | None = None, save_every: int = 200):
    """The loop of `cmd_train_policy` (cli/run.py:146-172): epochs
    `start` … `start + epochs − 1` (absolute), each first applying the
    getup env's fall-bank and reward schedules at its number where the env
    has them, then `train_epoch`; `on_epoch(ep, ts, metrics, seconds)` gets
    the metrics as floats and the epoch's seconds; with `out`,
    `policy_<ep:08d>.ckpt` after every `save_every`-th epoch and the
    last (under the agent's mesh, rank 0 writes it while the others wait).
    Returns the TrainState."""
    env, mesh = agent.env, agent.mesh
    last = start + epochs - 1
    for ep in range(start, start + epochs):
        t = time.perf_counter()
        if hasattr(env, "update_getup_schedule"):
            upd = env.cfg.getup_update_epoch
            ts = ts.replace(env_state=env.update_getup_schedule(
                ts.env_state, ep, upd))
            ts = agent.update_getup_reward_schedule(ts, ep, upd)
        ts, metrics = agent.train_epoch(ts)
        metrics = {k: v.item() for k, v in metrics.items()}
        if on_epoch is not None:
            on_epoch(ep, ts, metrics, time.perf_counter() - t)
        if out and (ep and ep % save_every == 0 or ep == last):
            if mesh is None or mesh.rank == 0:
                save_policy(os.path.join(out, f"policy_{ep:08d}.ckpt"), ts,
                            ep)
            pmesh.barrier(mesh)
    return ts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--num-envs", type=int, default=1600)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    ap.add_argument("--task", choices=TASKS, default="terrain")
    ap.add_argument("--out", default=None,
                    help="directory for policy checkpoints (none without)")
    ap.add_argument("--save-every", type=int, default=200)
    ap.add_argument("--resume", default=None,
                    help="policy checkpoint of either package")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    amp_fields, env_fields = parse_overrides(args.overrides, args.task)
    dev = _device.resolve(args.device)
    _device.full_float32(dev)
    agent, ts = build_train_bench(
        args.num_envs, dev, args.seed,
        dataclasses.replace(TRAIN_AMP, **amp_fields), args.task,
        **env_fields)
    if args.resume:
        tree, meta = load_pytree(args.resume)
        ts = restore_policy(ts, tree)
        ts = ts.replace(epoch=checkpoint_epoch(args.resume, meta) + 1)
    steps = agent.cfg.horizon * args.num_envs
    name = _device.name(dev)

    def report(ep, ts, metrics, dt):
        print(json.dumps({"epoch": ts.epoch, **metrics, "seconds": dt,
                          "env_steps_per_s": steps / dt,
                          "replay_filled": ts.replay_filled,
                          "device": name}), flush=True)

    return run_epochs(agent, ts, ts.epoch, args.epochs, report, args.out,
                      args.save_every)


if __name__ == "__main__":
    main()
