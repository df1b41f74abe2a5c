"""Train the EqMotion baseline on ETH-UCY pedestrian scenes, with the EmLoco
loss through a frozen LocoVal function and its test-time filter when a
valuenet is given.

    python3 -m emloco_tpu_torch.train_eqmotion [--ethucy PATH[,PATH...]]
        [--ethucy-val PATH] [--arch compact|full] [--channels 64]
        [--valuenet PATH] [--valueloss-w 0.1] [--value-loss-mode all|wta]
        [--apply-decay] [--threshold 0.7] [--epochs 1000] [--batch-size 10]
        [--batches 20] [--seed 0] [--device cuda] [--out output/eqmotion]
        [eqmotion.<field>=<value> ...]

The counterpart of the JAX package's `train-eqmotion` (cli/run.py:
341-424; reference main_eth_diverse.py:145-230). The windows come from
the raw ETH-UCY annotation files of `--ethucy` (`ethucy_windows`, shuffled
full batches each epoch), evaluated on `--ethucy-val` or the same files;
without `--ethucy`, `--batches` synthetic scenes an epoch and 256 for the
evaluation. `--arch full` trains the architecture-exact model
(EqMotionFullEth, `--channels` equivariant channels) in place of the
compact one; fields of EqMotionConfig may be replaced with
`eqmotion.<field>=<value>`. `--valuenet` loads a valuenet file of either
package as ValuePoseNet with the initial velocity only. `--apply-decay`
takes the reference's staircase: the rate × 0.8 every 2 epochs' steps.
Adam at 5e-4 otherwise. It prints one JSON line an epoch (the last batch's
wta and value_loss, seconds, steps/s, the device), then the evaluation
(ADE/FDE, and with a valuenet ade_filtered_min and mean_value at
`--threshold`), and writes `eqmotion.ckpt` to `--out` in the JAX
package's format. Runs on the CUDA card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from . import convert
from . import device as _device
from .learning.networks import ValuePoseNet
from .prediction.eqmotion import (Adam, EqMotionConfig, EqMotionTrainer,
                                  ethucy_batches, ethucy_windows,
                                  synthetic_eth_batch)
from .prediction.eqmotion_full import EqMotionFullEth, eth_full_config
from .utils.checkpoint import load_pytree

LR = 5e-4                   # main_eth_diverse.py --lr
DECAY, DECAY_EPOCHS = 0.8, 2  # --lr_gamma, --epoch_decay
EVAL_SCENES = 256


def config(overrides) -> EqMotionConfig:
    """EqMotionConfig with `eqmotion.<field>=<value>` replaced."""
    fields = {}
    base = EqMotionConfig()
    for item in overrides:
        key, sep, value = item.partition("=")
        part, _, name = key.partition(".")
        if not sep or part != "eqmotion" or not hasattr(base, name):
            raise SystemExit(f"bad override {item!r}: expected "
                             "eqmotion.<field>=<value>")
        fields[name] = type(getattr(base, name))(value)
    return dataclasses.replace(base, **fields)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ethucy", default=None,
                    help="ETH-UCY annotation file(s), comma-separated")
    ap.add_argument("--ethucy-val", default=None)
    ap.add_argument("--arch", choices=["compact", "full"],
                    default="compact")
    ap.add_argument("--channels", type=int, default=64,
                    help="--arch full: equivariant channels (zara1: 128)")
    ap.add_argument("--valuenet", default=None,
                    help="valuenet checkpoint of either package")
    ap.add_argument("--valueloss-w", type=float, default=0.1)
    ap.add_argument("--value-loss-mode", choices=["all", "wta"],
                    default="all")
    ap.add_argument("--apply-decay", action="store_true")
    ap.add_argument("--threshold", type=float, default=0.7)
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--batch-size", type=int, default=10)
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    ap.add_argument("--out", default="output/eqmotion")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    cfg = config(args.overrides)
    dev = _device.resolve(args.device)
    _device.full_float32(dev)
    return run(args, cfg, dev)


def run(args, cfg: EqMotionConfig, dev, on_epoch=None):
    """`cmd_train_eqmotion` (cli/run.py:341-424) at the configuration
    `cfg`: args.ethucy, args.ethucy_val, args.arch, args.channels,
    args.valuenet, args.valueloss_w, args.value_loss_mode,
    args.apply_decay, args.threshold, args.epochs, args.batch_size,
    args.batches, args.seed and args.out as the flags say;
    `on_epoch(ep, metrics)` after each epoch. Returns (trainer, ts, the
    evaluation)."""
    name = _device.name(dev)
    vnet, vp = None, None
    if args.valuenet:
        tree, _ = load_pytree(args.valuenet)
        vnet = ValuePoseNet(use_pose=False, use_vel=True, device=dev)
        vp = convert.valuenet_state_dict(tree)
    model = None
    if args.arch == "full":
        model = EqMotionFullEth(eth_full_config(
            past=cfg.past_length, future=cfg.future_length, nmode=cfg.nmode,
            channels=args.channels), device=dev)
    s_init, s_data = (int(s) for s in np.random.SeedSequence(
        args.seed).generate_state(2, np.uint64))
    gen = torch.Generator(device=dev).manual_seed(s_data)
    if args.ethucy:
        tr_past, tr_future = ethucy_windows(args.ethucy, cfg.past_length,
                                            cfg.future_length)
        ev_past, ev_future = ethucy_windows(args.ethucy_val or args.ethucy,
                                            cfg.past_length,
                                            cfg.future_length)
        steps_per_epoch = max(1, tr_past.shape[0] // args.batch_size)
        print(json.dumps({"train_windows": tr_past.shape[0],
                          "eval_windows": ev_past.shape[0]}), flush=True)
    else:
        steps_per_epoch = args.batches
    tx = (Adam(LR, DECAY_EPOCHS * steps_per_epoch, DECAY)
          if args.apply_decay else Adam(LR))
    trainer = EqMotionTrainer(
        cfg, lr=tx, vnet=vnet, valueloss_w=args.valueloss_w if vnet else 0.0,
        value_loss_mode=args.value_loss_mode, model=model, device=dev)
    ts, vp = trainer.init(s_init, vnet_params=vp)
    for ep in range(args.epochs):
        if args.ethucy:
            batches = ethucy_batches(tr_past, tr_future, args.batch_size,
                                     gen, device=dev)
        else:
            batches = (synthetic_eth_batch(gen, args.batch_size,
                                           past=cfg.past_length,
                                           future=cfg.future_length)
                       for _ in range(args.batches))
        t = time.perf_counter()
        steps, aux = 0, {}
        for past, future in batches:
            ts, aux = trainer.train_step(ts, vp, past, future)
            steps += 1
        m = {k: v.item() for k, v in aux.items()}
        dt = time.perf_counter() - t
        print(json.dumps({"epoch": ep, **m, "seconds": dt,
                          "steps_per_s": steps / dt, "device": name}),
              flush=True)
        if on_epoch is not None:
            on_epoch(ep, m)
    if args.ethucy:
        ev_in = (ev_past, ev_future)
    else:
        ev_in = synthetic_eth_batch(gen, EVAL_SCENES, past=cfg.past_length,
                                    future=cfg.future_length)
    ev = trainer.evaluate(ts.params, *ev_in, vnet_params=vp,
                          threshold=args.threshold)
    path = os.path.join(args.out, "eqmotion.ckpt")
    trainer.save_checkpoint(path, ts.params, metadata={
        "cfg": str(cfg), "arch": args.arch, "channels": args.channels})
    print(json.dumps({"evaluate": ev, "threshold": args.threshold,
                      "checkpoint": path, "steps": ts.step,
                      "device": name}), flush=True)
    return trainer, ts, ev


if __name__ == "__main__":
    main()
