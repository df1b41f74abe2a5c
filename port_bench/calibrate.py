"""Readings of a cell's compared numbers, for setting its limits.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1 2 3 ...
        [--faults unchanged half_batch skip_substep --fault-seeds 7 8 9]

For each seed, in one process: the driver's set-up (the first steps
through the window's own call), then the check of what the program
produced against the plain reference (`program`), and the check of the
reference itself in the nearest precision below the configuration's put in
the program's place (`control`: TF32 for the networks and the physics
step's Gram, bfloat16 for the solves, the latching and the state the
observation and the reward read). For each fault and fault seed, the set-up with
the fault planted in the program, then the check (`fault:<name>`). One
JSON line per reading, then one line with each number's lower reading
(the largest over the sound runs) and upper reading (the smallest over
the control and the faults). No window is measured. Runs on the CUDA card
only.
"""
import argparse
import gc
import json
import math
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def readings(cell, seeds, faults, fault_seeds, device):
    import torch

    from port_bench import core
    wl = core.load_json("workloads", cell)
    cfg = core.load_json("configs", wl["config"])
    runs = [(s, None) for s in seeds] + [(s, f) for f in faults
                                         for s in fault_seeds]
    for seed, fault in runs:
        t0 = time.perf_counter()
        drv = core.load_module("drivers", wl["driver"]).Driver()
        ctx = core.Context(cell=cell, workload=wl, config=cfg, seed=seed,
                           device=device, spans=core.Spans(False, device))
        drv.setup(ctx, fault=fault)
        kept = drv.release()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        modes = ["program", "control"] if fault is None else ["program"]
        for mode in modes:
            nums = drv.check(kept, mode)
            yield {"seed": seed,
                   "mode": mode if fault is None else f"fault:{fault}",
                   "numbers": nums, "seconds": time.perf_counter() - t0}
        del drv, kept
        gc.collect()


def summary(lines):
    lower, upper = {}, {}
    for r in lines:
        for k, v in r["numbers"].items():
            if r["mode"] == "program":
                lower[k] = max(lower.get(k, -math.inf), v)
            else:
                upper[k] = min(upper.get(k, math.inf), v)
    return {k: {"lower": lower.get(k), "upper": upper.get(k)}
            for k in lower}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    lines = []
    for r in readings(args.workload, args.seeds, args.faults,
                      args.fault_seeds, torch.device("cuda", 0)):
        lines.append(r)
        print(json.dumps(r), flush=True)
    print(json.dumps({"workload": args.workload,
                      "summary": summary(lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
