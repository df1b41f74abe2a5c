"""Random-search hyper-sweep of the trajectory predictor.

    python3 -m emloco_tpu_torch.tune_predictor [--trials 20] [--epochs 3]
        [--preset jta|jrdb|lstm] [--batch-size 10] [--batches 20]
        [--valuenet PATH] [--ndjson PATH] [--seed 0] [--device cuda]
        [--out output/tune_predictor] [model.<field>=<value> ...]
        [predict.<field>=<value> ...]

The counterpart of the JAX package's `tune-predictor` (cli/run.py:
489-512; reference hyper_tuning_jta.py and hyper_tuning_monitor.py). Each
trial draws lr, the value-loss weight, dropout and the local and global
layer counts from `prediction.tuning.DEFAULT_SPACE` (numpy's RandomState
from `--seed`, the JAX package's draws), trains `--epochs` epochs of
`--batches` batches on the scenes of `train_predictor` (the preset and
overrides as there) and scores the best evaluated ade_min. Every trial is
appended to `<--out>/trials.jsonl`; a rerun resumes after the trials
logged there. It prints one JSON line a trial of this run and the sweep's
summary, and exits non-zero when a trial of this run raised (its error is
in the log). Runs on the CUDA card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import os

from . import device as _device
from .prediction.presets import configs
from .prediction.tuning import SweepLog, predictor_objective, run_sweep
from .train_predictor import arguments, dataset, valuenet


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    arguments(ap)
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--out", default="output/tune_predictor")
    args = ap.parse_args(argv)
    mcfg, pcfg = configs(args.preset, args.overrides)
    dev = _device.resolve(args.device)
    _device.full_float32(dev)
    return run(args, mcfg, pcfg, dataset(args), dataset(args, 1), dev)


def run(args, mcfg, pcfg, ds, eval_ds, dev):
    """`cmd_tune_predictor` (cli/run.py:489-512) on the scenes `ds` and
    `eval_ds`: args.valuenet, args.epochs, args.batch_size, args.batches,
    args.seed, args.trials and args.out as the flags say. Returns (the
    summary, this run's trials); exits non-zero when one of them raised."""
    vnet, vp = valuenet(args, dev)
    objective = predictor_objective(
        {"model": mcfg, "predict": pcfg}, ds, eval_ds,
        epochs=max(1, args.epochs), batch_size=args.batch_size,
        batches_per_epoch=args.batches, vnet=vnet, vnet_params=vp,
        seed=args.seed, device=dev)
    log_path = os.path.join(args.out, "trials.jsonl")
    done = len(SweepLog(log_path).trials())
    summary = run_sweep(objective, num_trials=args.trials,
                        log_path=log_path, seed=args.seed)
    trials = SweepLog(log_path).trials()[done:]
    name = _device.name(dev)
    for t in trials:
        print(json.dumps({**t, "device": name}), flush=True)
    print(json.dumps({"summary": summary, "log": log_path, "resumed_after":
                      done, "device": name}), flush=True)
    failed = [t["trial"] for t in trials if "error" in t]
    if failed:
        raise SystemExit(f"tune_predictor: trials {failed} raised; see "
                         f"{log_path}")
    return summary, trials


if __name__ == "__main__":
    main()
