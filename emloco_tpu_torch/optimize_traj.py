"""Optimize sampled trajectories against a trained LocoVal function.

    python3 -m emloco_tpu_torch.optimize_traj --valuenet PATH
        [--batch-size 10] [--steps 200] [--seed 0] [--device cuda]
        [--gif] [--out output/optimize_traj]

The counterpart of the JAX package's `optimize-traj` (cli/run.py:556-584).
It loads a valuenet checkpoint of either package (its metadata says whether
the net reads the initial pose and velocity), draws `--batch-size`
procedural trajectories from a generator seeded with `--seed`, with a zero
initial pose and the first segment's velocity, and runs `--steps` Adam
steps on their coordinates against exp(−value), the origin pinned. It
prints one JSON line: the mean value before and after, the seconds of the
steps and the device. `--gif` records the trajectories and writes the first
one's optimization to `<--out>/traj_opt.gif` (matplotlib; without it the
command raises). Runs on the CUDA card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from . import convert
from . import device as _device
from .analysis import (animate_optimization, optimize_trajectory,
                       sample_candidate_trajs)
from .learning.networks import ValuePoseNet
from .utils.checkpoint import load_pytree


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--valuenet", required=True)
    ap.add_argument("--batch-size", type=int, default=10)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    ap.add_argument("--gif", action="store_true")
    ap.add_argument("--out", default="output/optimize_traj")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    _device.full_float32(dev)
    tree, meta = load_pytree(args.valuenet)
    vcfg = (meta or {}).get("config") or {}
    use_pose = bool(vcfg.get("use_pose", False))
    use_vel = bool(vcfg.get("use_vel", False))
    vnet = ValuePoseNet(use_pose=use_pose, use_vel=use_vel, device=dev)
    params = {k: v.to(dev)
              for k, v in convert.valuenet_state_dict(tree).items()}
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    B = args.batch_size
    trajs = sample_candidate_trajs(gen, B)
    init_pose = (torch.zeros((B, 24, 3), device=dev) if use_pose
                 else None)
    init_vel = (trajs[:, 1] - trajs[:, 0]) / 0.4 if use_vel else None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t = time.perf_counter()
    out, values, *snaps = optimize_trajectory(
        vnet, params, trajs, init_pose, init_vel, steps=args.steps,
        record_trajs=args.gif)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t
    name = _device.name(dev)
    line = {"value_before": values[0].mean().item(),
            "value_after": values[-1].mean().item(),
            "batch_size": B, "steps": args.steps, "seconds": dt,
            "device": name}
    if args.gif:
        os.makedirs(args.out, exist_ok=True)
        line["gif"] = animate_optimization(
            snaps[0], values, os.path.join(args.out, "traj_opt.gif"))
    print(json.dumps(line), flush=True)
    return dict(traj0=trajs, traj=out, values=values, seconds=dt)


if __name__ == "__main__":
    main()
