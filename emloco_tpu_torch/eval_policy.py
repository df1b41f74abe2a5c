"""Evaluate the LocoVal function's value prediction on rollouts of the
frozen policy, optionally over the reference's four-condition grid.

    python3 -m emloco_tpu_torch.eval_policy [--policy PATH]
        [--valuenet PATH] [--nopose] [--novel] [--games 4] [--grid]
        [--plots] [--out output/eval_policy] [--num-envs 1600] [--seed 0]
        [--device cuda] [amp.<field>=<value> ...] [env.<field>=<value> ...]
        [engine.<field>=<value> ...]

The counterpart of the JAX package's `eval-policy` (cli/run.py:226-283).
Each condition builds `rollout.build_value_bench` on the env's own
trajectory configuration (no heading-inverted paths, as the JAX command),
loads `--policy` (the params and obs / AMP norms of either package's
policy file) and `--valuenet` (either package's file; fresh weights from
`--seed` + 1 without), collects `--games` read-only rollout epochs and
prints one JSON line: the latched episodes, the valuenet's mse and
correlation against their realized returns (mse null when none latched),
the seconds and the device. `--grid` runs the reference's ablation
(eval_policy.sh, _nopose, _trajonly, _novel): real (hybrid_init_prob 0) or
random (1) trajectories, with or without the initial heading alignment.
`--plots` writes the value scatter and histograms of the same rollouts and
a 90-step rollout GIF with reward overlays to `--out` (matplotlib; without
it the command raises before any rollout). Runs on the CUDA card unless
`--device cpu` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

import torch

from . import device as _device
from .envs import EnvConfig
from .rollout import TRAIN_AMP, build_value_bench, parse_overrides
from .utils.checkpoint import load_pytree, load_valuenet, restore_policy

GRID = (
    ("real+heading", dict(hybrid_init_prob=0.0, init_heading=True)),
    ("real-noheading", dict(hybrid_init_prob=0.0, init_heading=False)),
    ("random+heading", dict(hybrid_init_prob=1.0, init_heading=True)),
    ("random-noheading", dict(hybrid_init_prob=1.0, init_heading=False)),
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--policy", default=None,
                    help="policy checkpoint of either package")
    ap.add_argument("--valuenet", default=None,
                    help="valuenet checkpoint of either package")
    ap.add_argument("--nopose", action="store_true")
    ap.add_argument("--novel", action="store_true")
    ap.add_argument("--games", type=int, default=4)
    ap.add_argument("--grid", action="store_true")
    ap.add_argument("--plots", action="store_true")
    ap.add_argument("--out", default="output/eval_policy")
    ap.add_argument("--num-envs", type=int, default=1600)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    if args.plots:
        import matplotlib  # noqa: F401  (fail before the rollouts)
    amp_fields, env_fields = parse_overrides(args.overrides)
    dev = _device.resolve(args.device)
    _device.full_float32(dev)
    policy = load_pytree(args.policy)[0] if args.policy else None
    vnet_params = load_valuenet(args.valuenet, dev) if args.valuenet else None
    traj0 = env_fields.get("traj", EnvConfig().traj)
    results = []
    for cond, traj_fields in (GRID if args.grid else (("default", {}),)):
        fields = dict(env_fields,
                      traj=dataclasses.replace(traj0, **traj_fields))
        trainer, vts = build_value_bench(
            args.num_envs, dev, args.seed,
            dataclasses.replace(TRAIN_AMP, **amp_fields), fields,
            hard_negatives=False, use_pose=not args.nopose,
            use_vel=not args.novel)
        if policy is not None:
            vts = vts.replace(policy=restore_policy(vts.policy, policy,
                                                    full=False))
        if vnet_params is not None:
            vts = vts.replace(vnet_params=vnet_params)
        vts, line = evaluate(trainer, vts, cond, traj_fields, args.games,
                             args.out if args.plots else None)
        results.append(line)
        del trainer, vts
    return results


def evaluate(trainer, vts, cond: str, traj_fields: dict, games: int,
             plots_out: str | None = None):
    """One condition of `cmd_eval_policy` (cli/run.py:248-283): `games`
    read-only rollout epochs, the valuenet's mse and correlation against
    the latched returns, printed as one JSON line; with `plots_out` the
    value scatter, histograms and a rollout GIF there. Returns (vts, the
    line)."""
    dev = vts.cum_reward.device
    num_envs = vts.cum_reward.shape[0]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t = time.perf_counter()
    vts, preds, targets = trainer.collect_predictions(vts, games)
    dt = time.perf_counter() - t
    mse, corr = trainer.prediction_stats(preds, targets)
    line = {"condition": cond, **traj_fields, "games": games,
            "num_envs": num_envs, "latched": len(preds),
            "mse": mse if math.isfinite(mse) else None, "corr": corr,
            "seconds": dt,
            "env_steps_per_s": games * trainer.cfg.horizon * num_envs / dt,
            "device": _device.name(dev)}
    if not len(preds):
        line["note"] = ("no episodes latched: more --games or shorter "
                        "episodes")
    if plots_out is not None:
        from .learning.players import save_eval_artifacts
        vts, arts = save_eval_artifacts(trainer, vts, plots_out, name=cond,
                                        preds=preds, targets=targets)
        line["artifacts"] = {k: v for k, v in arts.items()
                             if isinstance(v, str)}
    print(json.dumps(line), flush=True)
    return vts, line


if __name__ == "__main__":
    main()
