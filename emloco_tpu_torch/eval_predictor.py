"""Evaluate a trained trajectory predictor, with the LocoVal filter when a
valuenet is given.

    python3 -m emloco_tpu_torch.eval_predictor --predictor PATH
        [--preset jta|jrdb|lstm] [--valuenet PATH] [--batch-size 10]
        [--batches 20] [--threshold 0.7] [--sweep-thresholds]
        [--all-frames] [--ndjson PATH] [--seed 0] [--device cuda]
        [model.<field>=<value> ...] [predict.<field>=<value> ...]

The counterpart of the JAX package's `eval-predictor` (cli/run.py:427-487)
without `--plots`. It reads a predictor file of either package, scores
`--batches` batches of scenes from `--seed` + 2 (`evaluate_with_filter`:
ADE/FDE, and with `--valuenet` the LocoVal filter at `--threshold`) and
prints them as one JSON line with the seconds, scenes/s and the device;
`--sweep-thresholds` adds the filter-threshold sweep and `--all-frames`
the observation-length sweep, one JSON line each. Runs on the CUDA card
unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from . import device as _device
from .prediction.evaluate import (evaluate_with_filter,
                                  filter_threshold_sweep,
                                  observation_length_sweep)
from .prediction.presets import configs
from .prediction.train import PredictorTrainer
from .train_predictor import arguments, dataset, valuenet


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    arguments(ap)
    ap.add_argument("--predictor", required=True)
    ap.add_argument("--threshold", type=float, default=0.7)
    ap.add_argument("--sweep-thresholds", action="store_true")
    ap.add_argument("--all-frames", action="store_true")
    args = ap.parse_args(argv)
    mcfg, pcfg = configs(args.preset, args.overrides)
    dev = _device.resolve(args.device)
    _device.full_float32(dev)
    name = _device.name(dev)
    trainer = PredictorTrainer(mcfg, pcfg, device=dev)
    ds = dataset(args, 2)
    params = trainer.params_from(
        trainer.load_checkpoint(args.predictor)["params"])
    vnet, vp = valuenet(args, dev)
    zf = pcfg.pose_z_flip

    def timed(fn, *a, **kw):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        out = fn(*a, **kw)
        return out, time.perf_counter() - t

    out, dt = timed(evaluate_with_filter, trainer, params, ds,
                    args.batch_size, args.batches, vnet=vnet,
                    vnet_params=vp, threshold=args.threshold,
                    pose_z_flip=zf)
    result = {"evaluate": out, "seconds": dt,
              "scenes_per_s": args.batch_size * args.batches / dt,
              "device": name}
    print(json.dumps(result), flush=True)
    if args.sweep_thresholds and vnet is not None:
        sweep, dt = timed(filter_threshold_sweep, trainer, params, ds,
                          args.batch_size, args.batches, vnet=vnet,
                          vnet_params=vp, pose_z_flip=zf)
        result["threshold_sweep"] = sweep
        print(json.dumps({"threshold_sweep": sweep, "seconds": dt,
                          "device": name}), flush=True)
    if args.all_frames:
        sweep, dt = timed(observation_length_sweep, trainer, params, ds,
                          args.batch_size, args.batches)
        result["obs_length_sweep"] = sweep
        print(json.dumps({"obs_length_sweep": sweep, "seconds": dt,
                          "device": name}), flush=True)
    return result


if __name__ == "__main__":
    main()
