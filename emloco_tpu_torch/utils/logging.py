"""Metrics logging: console + JSONL + TensorBoard event files (port of
emloco_tpu/utils/logging.py).

`MetricsLogger` writes the JAX package's `<name>.metrics.jsonl` rows (the
metrics as floats, `step` and `wall_s`), the same scalars to an event file
under `<out_dir>/tb` (`utils.tracking.TBWriter`) and the same stderr line.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, out_dir: Optional[str] = None, name: str = "run",
                 print_every: int = 1, use_tensorboard: bool = True):
        self.out_dir = out_dir
        self.print_every = print_every
        self._fh = None
        self._tb = None
        self._t0 = time.perf_counter()
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self._fh = open(os.path.join(out_dir, f"{name}.metrics.jsonl"),
                            "a")
            if use_tensorboard:
                from .tracking import TBWriter
                self._tb = TBWriter(os.path.join(out_dir, "tb"),
                                    filename_suffix=f".{name}")

    def log(self, step: int, metrics: dict, prefix: str = ""):
        row = {("%s%s" % (prefix, k)): (float(v) if hasattr(v, "__float__")
                                        else v)
               for k, v in metrics.items()}
        row["step"] = step
        row["wall_s"] = round(time.perf_counter() - self._t0, 2)
        if self._fh:
            self._fh.write(json.dumps(row) + "\n")
            self._fh.flush()
        if self._tb:
            self._tb.scalars(step, {k: v for k, v in row.items()
                                    if isinstance(v, float)})
        if step % self.print_every == 0:
            pretty = " ".join(f"{k}={v:.4g}" for k, v in row.items()
                              if isinstance(v, float) and k not in
                              ("step", "wall_s"))
            print(f"[{step}] {pretty}", file=sys.stderr)

    def close(self):
        if self._fh:
            self._fh.close()
        if self._tb:
            self._tb.close()


def print_json(obj):
    """`obj` as one JSON line on stdout in a single write, so that the lines
    of processes sharing the stdout (the ranks of a mesh) stay whole also
    when stdout is unbuffered."""
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()

