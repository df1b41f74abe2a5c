"""Train the trajectory predictor, with the EmLoco loss through a frozen
LocoVal function when a valuenet is given.

    python3 -m emloco_tpu_torch.train_predictor [--preset jta|jrdb|lstm]
        [--epochs 30] [--batch-size 10] [--batches 20] [--valuenet PATH]
        [--resume PATH] [--ndjson PATH] [--seed 0] [--device cuda]
        [--out output/predictor] [model.<field>=<value> ...]
        [predict.<field>=<value> ...]

The counterpart of the JAX package's `train-predictor` (cli/run.py:
286-339) without a mesh. The preset holds the `model` and `predict`
sections of configs/jta_predictor.yaml, jrdb_predictor.yaml or
jta_lstm.yaml (`prediction.presets`); fields of TransMotionConfig and
PredictTrainConfig may be replaced with `model.<field>=<value>` and
`predict.<field>=<value>`. The scenes are `SyntheticScenes(num_people=4)`
from `--seed` (the evaluation's from `--seed` + 1), or the windows of an
ndjson export with `--ndjson`. `--valuenet` loads a valuenet file of
either package as ValuePoseNet with pose and velocity; `--resume` starts
from a predictor file's params. It prints one JSON line an epoch (the
mean trajectory loss, the evaluation's ADE/FDE, seconds, train steps/s,
the device) and writes `predictor_best.ckpt` (the params with the best
evaluated ade_min) to `--out`, a file the JAX package's `eval-predictor`
reads. Runs on the CUDA card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import os
import time

from . import device as _device
from .learning.networks import ValuePoseNet
from .parallel import mesh as pmesh
from .prediction.data import NdjsonScenes, SyntheticScenes
from .prediction.presets import PRESETS, configs
from .prediction.train import PredictorTrainer
from .utils.checkpoint import load_valuenet
from .utils.logging import print_json


def arguments(ap: argparse.ArgumentParser):
    """The flags both predictor entry points take."""
    ap.add_argument("--preset", choices=sorted(PRESETS), default="jta")
    ap.add_argument("--batch-size", type=int, default=10)
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--valuenet", default=None,
                    help="valuenet checkpoint of either package")
    ap.add_argument("--ndjson", default=None,
                    help="trajnet++ ndjson scenes (synthetic without)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    ap.add_argument("overrides", nargs="*")


def dataset(args, seed_offset: int = 0):
    """The scenes of `cli/run.py:_pred_dataset`: the ndjson windows, else
    synthetic scenes of 4 people, from `--seed` + `seed_offset`."""
    if args.ndjson:
        return NdjsonScenes(args.ndjson, seed=args.seed + seed_offset)
    return SyntheticScenes(num_people=4, seed=args.seed + seed_offset)


def valuenet(args, dev):
    """(ValuePoseNet with pose and velocity, its state_dict) from
    `--valuenet`, or (None, None)."""
    if not args.valuenet:
        return None, None
    return (ValuePoseNet(use_pose=True, use_vel=True, device=dev),
            load_valuenet(args.valuenet, dev))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    arguments(ap)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--resume", default=None,
                    help="predictor checkpoint of either package")
    ap.add_argument("--out", default="output/predictor")
    args = ap.parse_args(argv)
    mcfg, pcfg = configs(args.preset, args.overrides)
    dev = _device.resolve(args.device)
    _device.full_float32(dev)
    return run(args, mcfg, pcfg, dataset(args), dataset(args, 1), dev)


def run(args, mcfg, pcfg, ds, eval_ds, dev, mesh=None):
    """`cmd_train_predictor` (cli/run.py:297-338) on the scenes `ds` and
    `eval_ds`: args.valuenet, args.seed, args.batch_size, args.batches,
    args.epochs, args.resume and args.out as the flags say; under a batch
    `mesh` each rank trains on its block of every batch (`fit`), and rank
    0 prints and writes the checkpoint while the others wait. Returns (ts,
    history, best params)."""
    main_rank = mesh is None or mesh.rank == 0
    name = _device.name(dev)
    vnet, vp = valuenet(args, dev)
    trainer = PredictorTrainer(mcfg, pcfg, vnet=vnet, device=dev)
    batch = ds.batch(args.batch_size)
    ts = trainer.init(args.seed, batch, vnet_params=vp)
    if args.resume:
        blob = trainer.load_checkpoint(args.resume)
        ts = ts.replace(params=trainer.params_from(blob["params"]))

    def log(entry):
        if main_rank:
            print_json({**entry, "device": name})

    t = time.perf_counter()
    ts, history, best = trainer.fit(
        ts, ds, epochs=args.epochs, batches_per_epoch=args.batches,
        batch_size=args.batch_size, eval_dataset=eval_ds, log=log,
        mesh=mesh)
    path = os.path.join(args.out, "predictor_best.ckpt")
    if main_rank:
        trainer.save_checkpoint(path, ts.replace(params=best))
        print_json({"checkpoint": path, "epochs": args.epochs,
                    "steps": ts.step, "seconds": time.perf_counter() - t,
                    "device": name})
    pmesh.barrier(mesh)
    return ts, history, best


if __name__ == "__main__":
    main()
