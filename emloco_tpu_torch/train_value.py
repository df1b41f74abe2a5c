"""Train the LocoVal function from rollouts of the frozen policy at the
bench's training configuration.

    python3 -m emloco_tpu_torch.train_value [--epochs 10] [--num-envs 1600]
        [--seed 0] [--device cuda] [--nopose] [--novel] [--vru]
        [--games N] [--out output/valuenet] [--save-every 200]
        [--policy PATH] [--resume PATH]
        [amp.<field>=<value> ...] [env.<field>=<value> ...]

The counterpart of the JAX package's `train-valuenet` (cli/run.py:176-223).
The frozen policy is the bench agent's, drawn from `--seed`, or with
`--policy PATH` a policy file's params and obs / AMP norms (either
package's file). `--resume PATH` starts from a valuenet file's parameters
(a fresh optimizer, as the JAX CLI) and numbers the epochs on from the
number in its name. It builds `rollout.build_value_bench` (the valuenet
without the initial pose with `--nopose`, without the initial velocity
with `--novel`, on 5 waypoints with `--vru`; fields of AMPConfig and
EnvConfig may be replaced as in `python3 -m emloco_tpu_torch.train`),
prints one JSON line an epoch (the metrics, seconds, env-steps/s with the
update, the device) and writes `valuenet_<epoch:08d>.ckpt` to `--out` every
`--save-every` epochs and after the last, in the JAX package's format. With
`--games N` it then evaluates the valuenet over N read-only rollout epochs
(the value half of `eval-policy`) and prints the latched episodes' `mse`
and `corr`. Runs on the CUDA card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from . import device as _device
from .rollout import TRAIN_AMP, build_value_bench, parse_overrides
from .utils.checkpoint import (checkpoint_epoch, load_pytree, load_valuenet,
                               restore_policy, save_valuenet)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--num-envs", type=int, default=1600)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    ap.add_argument("--nopose", action="store_true")
    ap.add_argument("--novel", action="store_true")
    ap.add_argument("--vru", action="store_true")
    ap.add_argument("--games", type=int, default=0,
                    help="evaluation rollout epochs after training")
    ap.add_argument("--out", default="output/valuenet")
    ap.add_argument("--save-every", type=int, default=200)
    ap.add_argument("--policy", default=None,
                    help="policy checkpoint of either package")
    ap.add_argument("--resume", default=None, help="valuenet checkpoint")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    amp_fields, env_fields = parse_overrides(args.overrides)
    dev = _device.resolve(args.device)
    _device.full_float32(dev)
    use = dict(use_pose=not args.nopose, use_vel=not args.novel)
    trainer, vts = build_value_bench(
        args.num_envs, dev, args.seed,
        dataclasses.replace(TRAIN_AMP, **amp_fields), env_fields,
        num_waypoints=5 if args.vru else 13, **use)
    if args.policy:
        tree, _ = load_pytree(args.policy)
        vts = vts.replace(policy=restore_policy(vts.policy, tree,
                                                full=False))
    start = 0
    if args.resume:
        vts = vts.replace(vnet_params=load_valuenet(args.resume, dev))
        start = checkpoint_epoch(args.resume) + 1
        vts = vts.replace(epoch=start)
    steps = trainer.cfg.horizon * args.num_envs
    name = _device.name(dev)

    def report(ep, vts, metrics, dt):
        print(json.dumps({"epoch": vts.epoch, **metrics, "seconds": dt,
                          "env_steps_per_s": steps / dt, "device": name}),
              flush=True)

    vts = run_epochs(trainer, vts, start, args.epochs, use, args.out,
                     args.save_every, report)
    if args.games:
        vts, preds, targets = trainer.collect_predictions(vts, args.games)
        mse, corr = trainer.prediction_stats(preds, targets)
        print(json.dumps({"games": args.games, "latched": len(preds),
                          "mse": mse, "corr": corr, "device": name}),
              flush=True)
    return vts


def run_epochs(trainer, vts, start: int, epochs: int, use: dict, out: str,
               save_every: int, on_epoch=None):
    """The loop of `cmd_train_valuenet` (cli/run.py:213-222): epochs
    `start` … `start + epochs − 1`, `on_epoch(ep, vts, metrics, seconds)`
    with the metrics as floats, `valuenet_<ep:08d>.ckpt` in `out` (the
    metadata config `use`) after every `save_every`-th epoch and the last.
    Returns the ValueTrainState."""
    last = start + epochs - 1
    for ep in range(start, start + epochs):
        t = time.perf_counter()
        vts, metrics = trainer.train_epoch(vts)
        metrics = {k: v.item() for k, v in metrics.items()}
        if on_epoch is not None:
            on_epoch(ep, vts, metrics, time.perf_counter() - t)
        if ep and ep % save_every == 0 or ep == last:
            save_valuenet(os.path.join(out, f"valuenet_{ep:08d}.ckpt"),
                          vts.vnet_params, use)
    return vts


if __name__ == "__main__":
    main()
