"""Run one cell of the port's benchmark once, on the CUDA card.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Loads, warms up, measures whole units for `--seconds`, checks the first
steps against the plain reference, and prints one JSON line last on
standard output (`correct`, `attempted`, `failed`, `metrics`, `device`,
with `--trace 1` also `breakdown`, and `checks`: each number compared
beside its limit). The card's name, its power limit and clocks, and the
torch version go on an earlier line. Without a CUDA card it prints no
result and exits 3; if a module of JAX or of the JAX package is loaded
once the window has closed, it names it and exits 4.
"""
import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache of the program and of torch at a fixed path in the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = os.path.join(_ROOT, "build", "port_bench", _sub)
    os.makedirs(os.environ[_var], exist_ok=True)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from port_bench import core
    chips = core.load_json("workloads", args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available. No result.",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    print(json.dumps({"card": torch.cuda.get_device_name(dev),
                      "nvidia_smi": core.nvidia_smi(),
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    out = core.run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), dev, _T_START)
    bad = core.forbidden_modules()
    if bad:
        print("port_bench: forbidden modules loaded: " + " ".join(bad),
              file=sys.stderr)
        return 4
    for name, v in out.pop("numbers").items():
        print(f"number {name} {v!r}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
