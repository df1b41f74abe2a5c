"""Microbenchmark of merged-LHS Gram strategies at the probe's size (N =
4,096 envs, M = 304 rows, C = 75): the port of scripts/gram_kernel_probe.py,
with its operands, its variants' names and their order.

Variants (each a JSON line with its ms, the best of 3 repetitions of ITERS
calls):
  einsum_envlast        (w∘R)ᵀR + diag as one bf16 `torch.bmm` with float32
                        output, moved env-last (C, C, N)
  einsum_bm             the same, batch-major (N, C, C)
  kernel_at_b           linalg.gram_diag(R, w, d): R itself as both operands
  kernel_dual           gram_dual(Rt, R, d): the lhs Rt = (w∘R)ᵀ arrives
                        pre-transposed (N, C, M), the envs of a block in turn
  kernel_dual_batched8  gram_dual_batched, 8 envs a block in flight together
  kernel_dual_batched32 the same, 32 envs a block
  kernel_at_b32         gram_diag again (it has no block size in the port)
  build_rt_xla          the torch ops that build Rt
  relayout_pallas       linalg.to_env_last on the (N, 75, 75) output
  xla_transpose         permute(1, 2, 0).contiguous() of the same
then the largest |kernel_at_b − einsum_bm| and |kernel_dual − einsum_bm|.

On the card:
    python3 -m emloco_tpu_torch.scripts.gram_kernel_probe
CPU check (N = 64, ITERS = 2; on the CPU the kernels' plain versions run):
    python3 -m emloco_tpu_torch.scripts.gram_kernel_probe --check --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..device import resolve
from ..physics import linalg
from ..physics.linalg import (  # noqa: F401  (the probe's kernels)
    gram_dual, gram_dual_batched, gram_dual_plain)

M, C = 304, 75


def operands(n: int, device) -> tuple:
    """(R, w, d, Rt) as the JAX probe makes them: R randn, w rand, d rand
    from np.random.RandomState(0), cast from float64 to bf16 (R, w) and
    float32 (d); wR = w∘R in bf16 and Rt = wRᵀ (N, C, M), contiguous."""
    rng = np.random.RandomState(0)
    R = torch.from_numpy(rng.randn(n, M, C)).to(torch.bfloat16).to(device)
    w = torch.from_numpy(rng.rand(n, M)).to(torch.bfloat16).to(device)
    d = torch.from_numpy(rng.rand(n, C)).to(torch.float32).to(device)
    Rt = (w[..., None] * R).transpose(1, 2).contiguous()
    return R, w, d, Rt


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16 batches with float32 output: one library call on the
    card; the CPU has none, so there the same function on float32 copies
    (each product of two bf16 values is exact in float32)."""
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, iters: int, device, reps: int = 3):
    """(best ms per call over `reps` runs of `iters` calls, last output)."""
    out = fn()
    _sync(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        _sync(device)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best * 1e3, out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="N = 64 envs, 2 calls a repetition")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    n, iters = (64, 2) if args.check else (4096, 16)
    R, w, d, Rt = operands(n, dev)

    def einsum_bm():
        At = _bmm_f32((w[..., None] * R).transpose(1, 2), R)
        At.diagonal(dim1=1, dim2=2).add_(d)
        return At

    outs = {}
    variants = (
        ("einsum_envlast",
         lambda: einsum_bm().permute(1, 2, 0).contiguous(), {}),
        ("einsum_bm", einsum_bm, {}),
        ("kernel_at_b", lambda: linalg.gram_diag(R, w, d), {}),
        ("kernel_dual", lambda: gram_dual(Rt, R, d), {}),
        ("kernel_dual_batched8", lambda: gram_dual_batched(Rt, R, d), {}),
        ("kernel_dual_batched32",
         lambda: gram_dual_batched(Rt, R, d, block_envs=32), {}),
        ("kernel_at_b32", lambda: linalg.gram_diag(R, w, d),
         {"note": "one env per block in the port"}),
        ("build_rt_xla",
         lambda: (w[..., None] * R).transpose(1, 2).contiguous(), {}),
        ("relayout_pallas", lambda: linalg.to_env_last(outs["einsum_bm"]),
         {}),
        ("xla_transpose",
         lambda: outs["einsum_bm"].permute(1, 2, 0).contiguous(), {}),
    )
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({"probe": "gram_kernel_probe", "device": kind,
                      "num_envs": n, "rows": M, "cols": C, "iters": iters}),
          flush=True)
    ms = {}
    for name, fn, extra in variants:
        ms[name], outs[name] = timed(fn, iters, dev)
        print(json.dumps({"variant": name, "ms": ms[name], **extra}),
              flush=True)
    errs = {}
    for name in ("kernel_at_b", "kernel_dual"):
        errs[name] = (outs[name] - outs["einsum_bm"]).abs().max().item()
        print(json.dumps({"variant": name,
                          "max_abs_err_vs_einsum": errs[name]}), flush=True)
    return {"device": kind, "ms": ms, "out": outs,
            "max_abs_err_vs_einsum": errs,
            "operands": {"R": R, "w": w, "d": d, "Rt": Rt}}


if __name__ == "__main__":
    main()
