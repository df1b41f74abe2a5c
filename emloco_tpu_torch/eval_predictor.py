"""Evaluate a trained trajectory predictor, with the LocoVal filter when a
valuenet is given.

    python3 -m emloco_tpu_torch.eval_predictor --predictor PATH
        [--preset jta|jrdb|lstm] [--valuenet PATH] [--batch-size 10]
        [--batches 20] [--threshold 0.7] [--sweep-thresholds]
        [--all-frames] [--plots] [--out output/eval_predictor]
        [--ndjson PATH] [--seed 0] [--device cuda]
        [model.<field>=<value> ...] [predict.<field>=<value> ...]

The counterpart of the JAX package's `eval-predictor` (cli/run.py:427-487).
It reads a predictor file of either package, scores `--batches` batches of
scenes from `--seed` + 2 (`evaluate_with_filter`: ADE/FDE, and with
`--valuenet` the LocoVal filter at `--threshold`) and prints them as one
JSON line with the seconds, scenes/s and the device; `--sweep-thresholds`
adds the filter-threshold sweep and `--all-frames` the observation-length
sweep, one JSON line each. `--plots` (it needs `--valuenet`) collects the
predictions and values of `--batches` batches (`collect_vis_data`, on the
device) and writes to `--out` (refused without `--plots`) the vis_dict, the
comparison grid, the value-binned ADE bars, the value histogram and up to 3
per-sample 3-D plots, one JSON line of paths; without matplotlib it raises.
Runs on the CUDA card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from . import device as _device
from .prediction import visualize as V
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
    ap.add_argument("--plots", action="store_true",
                    help="with --valuenet: vis_dict and plots in --out")
    ap.add_argument("--out", default=None,
                    help="--plots: the directory (output/eval_predictor)")
    args = ap.parse_args(argv)
    if args.out is not None and not args.plots:
        ap.error("--out is read only with --plots")
    if args.plots:
        if not args.valuenet:
            ap.error("--plots needs --valuenet (the plots show values)")
        args.out = args.out or "output/eval_predictor"
        import matplotlib  # noqa: F401  (fail before the evaluation)
    mcfg, pcfg = configs(args.preset, args.overrides)
    dev = _device.resolve(args.device)
    _device.full_float32(dev)
    return run(args, mcfg, pcfg, dataset(args, 2), dev)


def run(args, mcfg, pcfg, ds, dev):
    """`cmd_eval_predictor` (cli/run.py:427-486) on the scenes `ds`:
    args.predictor, args.valuenet, args.batch_size, args.batches,
    args.threshold, args.sweep_thresholds, args.all_frames, args.plots and
    args.out as the flags say. Returns the printed results."""
    name = _device.name(dev)
    trainer = PredictorTrainer(mcfg, pcfg, device=dev)
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
    if args.plots:
        result["plots"] = plots(trainer, params, ds, args, vnet, vp, zf)
        print(json.dumps({"plots": result["plots"], "device": name}),
              flush=True)
    return result


def plots(trainer, params, ds, args, vnet, vp, zf) -> dict:
    """cli/run.py:463-486: the vis_dict and its plots in args.out."""
    vis = V.collect_vis_data(trainer, params, ds, args.batch_size,
                             args.batches, vnet=vnet, vnet_params=vp,
                             pose_z_flip=zf)
    os.makedirs(args.out, exist_ok=True)
    out = {"vis_dict": os.path.join(args.out, "vis_dict.pkl")}
    V.save_vis_dict(out["vis_dict"], vis)
    n = min(3, vis["pred"].shape[0])
    out["comparison"] = V.plot_prediction_comparison(
        {"model": vis}, list(range(n)),
        os.path.join(args.out, "pred_comparison.png"), value_threshold=0.7)
    ades = np.linalg.norm(vis["pred"] - vis["gt"][:, :, None],
                          axis=-1).mean(1)                   # (S, M)
    out["value_ade"] = os.path.join(args.out, "value_ade.png")
    V.plot_value_ade_bars(vis["values"], ades, out["value_ade"])
    out["value_hist"] = V.plot_value_histogram(
        {"pred": vis["values"]}, os.path.join(args.out, "value_hist.png"))
    out["vis3d"] = V.save_3d_plots(vis, os.path.join(args.out, "vis3d"),
                                   num_samples=min(4, n))
    return out


if __name__ == "__main__":
    main()
