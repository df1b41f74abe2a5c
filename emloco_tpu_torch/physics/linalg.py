"""Batched kernels of the engine's LHS assembly and SPD solves: the weighted
Gram, block-arrow and dense Cholesky, and the env-last relayout.

Port of the seven kernels of emloco_tpu/physics/pallas_linalg.py, with the
compositions built on them, and of the two kernels of
scripts/gram_kernel_probe.py (on no path of the engine; the probe's port,
emloco_tpu_torch/scripts/gram_kernel_probe.py, runs them):

  kernel (wrapper here)          CUDA source (csrc/)       engine branch
  cholesky_factor_blocked_t      block_arrow_cholesky.cu   TGS (default)
  cholesky_resolve_blocked_t     block_arrow_cholesky.cu   TGS (default)
  cholesky_solve_blocked_t       block_arrow_solve.cu      implicit substeps
  cholesky_resolve_blocked       block_arrow_solve.cu      TGS, batch-major
  cholesky_solve_soa_t           dense_cholesky.cu         dense solver
  to_env_last                    to_env_last.cu            batch-major, gram
  gram_diag                      gram_diag.cu              gram_kernel
  gram_dual, gram_dual_batched   gram_dual.cu              (the probe)
  cholesky_solve_blocked   = to_env_last + cholesky_solve_blocked_t
  cholesky_factor_blocked  = to_env_last + cholesky_factor_blocked_t
  cholesky_solve_soa       = permute + cholesky_solve_soa_t

On a CUDA tensor each wrapper launches its hand-written kernel or raises; on
a CPU tensor it runs the plain PyTorch version below, which follows the
Pallas kernel's column order (`_factor_body` / `_triangular_solves`,
`_chol_solve_kernel`) or, for the Gram, sums over the rows in ascending
order, and which the kernel repeats operation for operation. The probe's
two kernels sum on the tensor cores, in their own order: they agree with
gram_dual_plain to float32 rounding of the sums, and with each other to the
bit.

For the block-arrow entry points the block structure is the caller's:
`chunks` lists old DoF ranges in new order (the permutation as contiguous
moves), `limbs` the dense diagonal blocks in new order, `s_lo` the start of
the trailing shared block. The matrix must be zero outside that pattern
(true by construction for the engine's reduced-coordinate matrices); then
the factorization is exact.

Unlike the Pallas kernel, which leaves scratch values above the diagonal,
the factor returned here is lower triangular: its upper triangle is zero.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

# launches of each kernel since the last reset (the plain path adds none)
LAUNCHES = {"cholesky_factor_blocked_t": 0, "cholesky_resolve_blocked_t": 0,
            "cholesky_solve_blocked_t": 0, "cholesky_resolve_blocked": 0,
            "cholesky_solve_soa_t": 0, "to_env_last": 0, "gram_diag": 0,
            "gram_dual": 0, "gram_dual_batched": 0}

PIVOT_MIN = 1e-12
GRAM_MAX_C = 80      # gram_diag's kernel: 10 x 10 blocks of 8 x 8 output
                     # tiles; gram_dual's: 5 m16 x 10 n8 tensor-core tiles


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _plan(chunks, limbs, s_lo):
    """(perm int32 (M,), limbs int32 (n_limbs, 2)) for the C interface."""
    perm = np.concatenate([np.arange(lo, hi) for lo, hi in chunks])
    perm = perm.astype(np.int32)
    if sorted(perm.tolist()) != list(range(len(perm))):
        raise ValueError("chunks must tile 0..M-1 exactly once")
    lim = np.ascontiguousarray(np.asarray(limbs, np.int32).reshape(-1, 2))
    if not (0 <= s_lo <= len(perm)):
        raise ValueError("s_lo outside the system")
    return perm, lim


def arrow_pattern(limbs, s_lo: int, M: int) -> np.ndarray:
    """(M, M) bool: the lower-triangular entries (new order, diagonal
    included) that a block-arrow factor can make nonzero."""
    keep = np.zeros((M, M), bool)
    for lo, hi in limbs:
        keep[lo:hi, lo:hi] = True
        keep[s_lo:M, lo:hi] = True
    keep[s_lo:M, s_lo:M] = True
    return np.tril(keep)


def _check(t: torch.Tensor, name: str, shape, device=None):
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def _check_system(At: torch.Tensor, name: str, M: int | None = None) -> int:
    """Validate a batched (M, M, N) system (M = its first dim unless
    given); returns N."""
    if At.dim() != 3 or At.shape[-1] < 1:
        raise ValueError(f"{name} must be (M, M, N) with N ≥ 1, got "
                         f"{tuple(At.shape)}")
    M = At.shape[0] if M is None else M
    _check(At, name, (M, M, At.shape[-1]))
    return At.shape[-1]


def _launch(name: str, dev: torch.device, fn, *args):
    """Call a kernel's C entry point on the current stream of `dev`; raise
    on the CUDA error it returns, else count the launch."""
    with torch.cuda.device(dev):
        err = fn(*args, ctypes.c_void_p(
            torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel: CUDA error {err}")
    LAUNCHES[name] += 1


def _lib():
    from .. import build
    return build.load()


def _launch_shape(fn, *args) -> dict | None:
    shape = (ctypes.c_int * 3)()
    if fn(*args, shape) != 0:
        return None
    return dict(envs_per_block=shape[0], threads=shape[1],
                dynamic_smem_bytes=shape[2])


def _arrow_launch_shape(kernel, entry, chunks, limbs, s_lo) -> dict:
    perm, lim = _plan(tuple(chunks), tuple(limbs), s_lo)
    shape = _launch_shape(getattr(_lib(), entry), len(perm),
                          perm.ctypes.data, len(lim), lim.ctypes.data, s_lo)
    if shape is None:
        raise ValueError(f"the {kernel} kernel cannot take limbs {limbs}, "
                         f"s_lo = {s_lo}, M = {len(perm)}")
    return shape


@functools.lru_cache(maxsize=None)
def factor_launch_shape(chunks, limbs, s_lo: int) -> dict:
    """The factor kernel's launch for this block structure, from its plan in
    csrc/block_arrow_cholesky.cu: envs (one warp each), threads and dynamic
    shared memory bytes a block. Raises ValueError where the kernel cannot
    take it: limbs that do not tile [0, s_lo) in order, a column with more
    than 32 rows below its pivot, or a block's envs past its shared memory.
    Builds the kernels' library on first use."""
    return _arrow_launch_shape("factor", "emloco_block_arrow_factor_shape",
                               chunks, limbs, s_lo)


@functools.lru_cache(maxsize=None)
def solve_launch_shape(chunks, limbs, s_lo: int) -> dict:
    """The launch of the fused solve and the batch-major resolve
    (csrc/block_arrow_solve.cu) and of the resolve
    (csrc/block_arrow_cholesky.cu), which share one plan, as
    factor_launch_shape: their block also holds each env's two vectors."""
    return _arrow_launch_shape("solve", "emloco_block_arrow_solve_shape",
                               chunks, limbs, s_lo)


@functools.lru_cache(maxsize=None)
def gram_launch_shape(C: int, rows_bf16: bool) -> dict:
    """gram_diag's launch for C columns, from its plan in csrc/gram_diag.cu:
    envs, threads and dynamic shared memory bytes a CTA, and CTAs an SM on
    the current card (the occupancy query). Builds the kernels' library on
    first use; needs a card."""
    shape = (ctypes.c_int * 4)()
    err = _lib().emloco_gram_diag_shape(C, int(rows_bf16), shape)
    if err != 0:
        raise ValueError(f"gram_diag's launch for C = {C}: CUDA error {err}")
    return dict(envs_per_block=shape[0], threads=shape[1],
                dynamic_smem_bytes=shape[2], blocks_per_sm=shape[3])


@functools.lru_cache(maxsize=None)
def dense_launch_shape(M: int) -> dict:
    """The dense solve kernel's launch for M, from its plan in
    csrc/dense_cholesky.cu, as factor_launch_shape. Raises ValueError for an
    M past a block's shared memory (M > 83)."""
    shape = _launch_shape(_lib().emloco_dense_cholesky_shape, M)
    if shape is None:
        raise ValueError(f"the dense solve kernel cannot take M = {M}")
    return shape


# ---------------------------------------------------------------------------
# Plain versions (CPU path, tests, and the kernels' check on the card)
# ---------------------------------------------------------------------------

def factor_blocked_plain(At: torch.Tensor, chunks, limbs, s_lo: int):
    """Permute A (M, M, N) limbs-first and factor it column by column as
    `_factor_body` does, pivots clamped to PIVOT_MIN. Returns the lower-
    triangular L (M, M, N) in permuted order."""
    perm = torch.as_tensor(_plan(tuple(chunks), tuple(limbs), s_lo)[0],
                           dtype=torch.long, device=At.device)
    w = At[perm][:, perm].clone()
    M = w.shape[0]

    def fcol(k, hi, couple):
        d = w[k, k]
        s = torch.sqrt(torch.where(d < PIVOT_MIN, PIVOT_MIN, d))
        w[k, k] = s
        if k + 1 < hi:
            col_g = w[k + 1:hi, k] / s
            w[k + 1:hi, k] = col_g
        if couple:
            col_s = w[s_lo:M, k] / s
            w[s_lo:M, k] = col_s
        if k + 1 < hi:
            w[k + 1:hi, k + 1:hi] = (w[k + 1:hi, k + 1:hi]
                                     - col_g[:, None] * col_g[None, :])
            if couple:
                w[s_lo:M, k + 1:hi] = (w[s_lo:M, k + 1:hi]
                                       - col_s[:, None] * col_g[None, :])
        if couple:
            w[s_lo:M, s_lo:M] = (w[s_lo:M, s_lo:M]
                                 - col_s[:, None] * col_s[None, :])

    for lo, hi in limbs:
        for k in range(lo, hi):
            fcol(k, hi, couple=True)
    for k in range(s_lo, M):
        fcol(k, M, couple=False)
    upper = torch.ones(M, M, dtype=torch.bool, device=w.device).triu(1)
    return w.masked_fill(upper[:, :, None], 0.0)


def _dot(L, z, k, lo, hi):
    """Σ_{i=lo}^{hi-1} L[i,k]·z[i], accumulated in row order as the kernel
    does (so both round alike)."""
    acc = torch.zeros_like(z[0])
    for i in range(lo, hi):
        acc = acc + L[i, k] * z[i]
    return acc


def resolve_blocked_plain(L: torch.Tensor, bt: torch.Tensor, chunks, limbs,
                          s_lo: int):
    """Solve L Lᵀ (P x) = P b with the permuted factor L (M, M, N) from
    factor_blocked_plain; b, x (M, N) in the original order."""
    perm = torch.as_tensor(_plan(tuple(chunks), tuple(limbs), s_lo)[0],
                           dtype=torch.long, device=L.device)
    M = L.shape[0]
    y = bt[perm].clone()
    for lo, hi in limbs:
        for k in range(lo, hi):
            yk = y[k] / L[k, k]
            y[k] = yk
            if k + 1 < hi:
                y[k + 1:hi] = y[k + 1:hi] - L[k + 1:hi, k] * yk
            y[s_lo:M] = y[s_lo:M] - L[s_lo:M, k] * yk
    for k in range(s_lo, M):
        yk = y[k] / L[k, k]
        y[k] = yk
        if k + 1 < M:
            y[k + 1:M] = y[k + 1:M] - L[k + 1:M, k] * yk

    z = torch.empty_like(y)
    for k in range(M - 1, s_lo - 1, -1):
        z[k] = (y[k] - _dot(L, z, k, k + 1, M)) / L[k, k]
    for lo, hi in limbs:
        for k in range(hi - 1, lo - 1, -1):
            acc = _dot(L, z, k, s_lo, M)
            if k + 1 < hi:
                acc = acc + _dot(L, z, k, k + 1, hi)
            z[k] = (y[k] - acc) / L[k, k]
    x = torch.empty_like(z)
    x[perm] = z
    return x


def solve_blocked_plain(At: torch.Tensor, bt: torch.Tensor, chunks, limbs,
                        s_lo: int):
    """The fused solve: exactly factor_blocked_plain then
    resolve_blocked_plain, A (M, M, N), b (M, N) → x (M, N)."""
    return resolve_blocked_plain(factor_blocked_plain(At, chunks, limbs, s_lo),
                                 bt, chunks, limbs, s_lo)


def resolve_blocked_bm_plain(L: torch.Tensor, b: torch.Tensor, chunks, limbs,
                             s_lo: int):
    """resolve_blocked_plain with a batch-major b, x (N, M)."""
    return resolve_blocked_plain(L, b.T, chunks, limbs,
                                 s_lo).T.contiguous()


def to_env_last_plain(A: torch.Tensor, out_rows: int | None = None):
    """(N, X, Y) → (X', Y, N), X' = out_rows or X: rows X'.. are dropped."""
    return A[:, :out_rows].permute(1, 2, 0).contiguous()


def gram_diag_plain(R: torch.Tensor, w: torch.Tensor, diag: torch.Tensor,
                    out_rows: int | None = None):
    """At[n, :C] = R[n]ᵀ(w[n]∘R[n]) + diag(diag[n]) in float32, R (N, M, C)
    and w (N, M) in the row dtype, diag (N, C) float32 → (N, C', C),
    C' = out_rows or C. w∘R is formed in float32, where the product of two
    bf16 values is exact (as the JAX kernel's float32 dot receives it), and
    the M outer products are summed in ascending row order. The staging
    rows C:C' hold NaN, so that any reader of them shows up."""
    N, M, C = R.shape
    Rf = R.float()
    rw = Rf * w.float()[..., None]
    acc = torch.zeros((N, C, C), dtype=torch.float32, device=R.device)
    for m in range(M):
        acc = acc + rw[:, m, :, None] * Rf[:, m, None, :]
    out = torch.full((N, out_rows or C, C), float("nan"),
                     dtype=torch.float32, device=R.device)
    out[:, :C] = acc + torch.diag_embed(diag)
    return out


def gram_dual_plain(Rt: torch.Tensor, R: torch.Tensor, diag: torch.Tensor):
    """out[n] = Rt[n] R[n] + diag(diag[n]) in float32, Rt (N, C, M) and
    R (N, M, C) in bf16, diag (N, C) float32 → (N, C, C). Each product of
    two bf16 values is formed in float32, where it is exact, the M products
    are summed in ascending m, then the diagonal is added (as
    gram_diag_plain does)."""
    N, C, M = Rt.shape
    A, B = Rt.float(), R.float()
    acc = torch.zeros((N, C, C), dtype=torch.float32, device=R.device)
    for m in range(M):
        acc = acc + A[:, :, m, None] * B[:, m, None, :]
    return acc + torch.diag_embed(diag)


def solve_soa_plain(At: torch.Tensor, bt: torch.Tensor):
    """Dense right-looking Cholesky solve as `_chol_solve_kernel` does it:
    A (M, M, N), b (M, N) → x (M, N), pivots clamped to PIVOT_MIN, step k
    updating the trailing (M−k−1)² block, dot products summed in row
    order."""
    M = At.shape[0]
    w = At.clone()
    for k in range(M):
        d = w[k, k]
        s = torch.sqrt(torch.where(d < PIVOT_MIN, PIVOT_MIN, d))
        w[k, k] = s
        if k + 1 < M:
            col = w[k + 1:, k] / s
            w[k + 1:, k] = col
            w[k + 1:, k + 1:] = (w[k + 1:, k + 1:]
                                 - col[:, None] * col[None, :])
    y = torch.empty_like(bt)
    for k in range(M):
        acc = torch.zeros_like(bt[0])
        for j in range(k):
            acc = acc + w[k, j] * y[j]
        y[k] = (bt[k] - acc) / w[k, k]
    x = torch.empty_like(bt)
    for k in range(M - 1, -1, -1):
        x[k] = (y[k] - _dot(w, x, k, k + 1, M)) / w[k, k]
    return x


# ---------------------------------------------------------------------------
# Wrappers: kernel on a CUDA tensor, plain version on a CPU tensor
# ---------------------------------------------------------------------------

def cholesky_factor_blocked_t(At: torch.Tensor, chunks, limbs, s_lo: int):
    """Factor A (M, M, N) → permuted-order lower-triangular L (M, M, N).
    Pair with cholesky_resolve_blocked_t to reuse one factorization over
    several solves. On the card it raises ValueError on a block structure
    the kernel cannot take (factor_launch_shape)."""
    chunks, limbs = tuple(chunks), tuple(limbs)
    perm, lim = _plan(chunks, limbs, s_lo)
    M = len(perm)
    N = _check_system(At, "At", M)
    if At.device.type == "cpu":
        return factor_blocked_plain(At, chunks, limbs, s_lo)
    factor_launch_shape(chunks, limbs, s_lo)
    lib = _lib()
    L = torch.empty_like(At)
    _launch("cholesky_factor_blocked_t", At.device,
            lib.emloco_block_arrow_factor, At.data_ptr(), L.data_ptr(), N, M,
            perm.ctypes.data, len(lim), lim.ctypes.data, s_lo)
    return L


def cholesky_resolve_blocked_t(L: torch.Tensor, bt: torch.Tensor, chunks,
                               limbs, s_lo: int):
    """Solve with a factor from cholesky_factor_blocked_t: L (M, M, N),
    b (M, N) → x (M, N). Reads only L's entries in the block-arrow pattern.
    On the card it raises ValueError on a block structure the kernel cannot
    take (solve_launch_shape)."""
    chunks, limbs = tuple(chunks), tuple(limbs)
    perm, lim = _plan(chunks, limbs, s_lo)
    M = len(perm)
    N = _check_system(L, "L", M)
    _check(bt, "b", (M, N), device=L.device)
    if L.device.type == "cpu":
        return resolve_blocked_plain(L, bt, chunks, limbs, s_lo)
    solve_launch_shape(chunks, limbs, s_lo)
    x = torch.empty_like(bt)
    _launch("cholesky_resolve_blocked_t", L.device,
            _lib().emloco_block_arrow_resolve, L.data_ptr(), bt.data_ptr(),
            x.data_ptr(), N, M, perm.ctypes.data, len(lim), lim.ctypes.data,
            s_lo)
    return x


def cholesky_solve_blocked_t(At: torch.Tensor, bt: torch.Tensor, chunks,
                             limbs, s_lo: int):
    """Fused block-arrow solve, env-last: A (M, M, N), b (M, N) → x (M, N).
    A must be zero outside the block-arrow pattern of (chunks, limbs,
    s_lo), as for cholesky_factor_blocked_t (its entries outside the
    pattern are not read). On the card it raises ValueError on a block structure the
    kernel cannot take (solve_launch_shape)."""
    chunks, limbs = tuple(chunks), tuple(limbs)
    perm, lim = _plan(chunks, limbs, s_lo)
    M = len(perm)
    N = _check_system(At, "At", M)
    _check(bt, "b", (M, N), device=At.device)
    if At.device.type == "cpu":
        return solve_blocked_plain(At, bt, chunks, limbs, s_lo)
    solve_launch_shape(chunks, limbs, s_lo)
    x = torch.empty_like(bt)
    _launch("cholesky_solve_blocked_t", At.device,
            _lib().emloco_block_arrow_solve, At.data_ptr(), bt.data_ptr(),
            x.data_ptr(), N, M, perm.ctypes.data, len(lim), lim.ctypes.data,
            s_lo)
    return x


def cholesky_resolve_blocked(L: torch.Tensor, b: torch.Tensor, chunks,
                             limbs, s_lo: int):
    """Batch-major resolve with an env-last factor from
    cholesky_factor_blocked: L (M, M, N), b (N, M) → x (N, M), the env-last
    resolve's solution transposed, to the bit. On the card it raises
    ValueError on a block structure the kernel cannot take
    (solve_launch_shape)."""
    chunks, limbs = tuple(chunks), tuple(limbs)
    perm, lim = _plan(chunks, limbs, s_lo)
    M = len(perm)
    N = _check_system(L, "L", M)
    _check(b, "b", (N, M), device=L.device)
    if L.device.type == "cpu":
        return resolve_blocked_bm_plain(L, b, chunks, limbs, s_lo)
    solve_launch_shape(chunks, limbs, s_lo)
    x = torch.empty_like(b)
    _launch("cholesky_resolve_blocked", L.device,
            _lib().emloco_block_arrow_resolve_bm, L.data_ptr(), b.data_ptr(),
            x.data_ptr(), N, M, perm.ctypes.data, len(lim), lim.ctypes.data,
            s_lo)
    return x


def cholesky_solve_soa_t(At: torch.Tensor, bt: torch.Tensor):
    """Dense Cholesky solve, env-last: A (M, M, N) SPD, b (M, N) →
    x (M, N). On the card it raises ValueError for an M the kernel cannot
    take (dense_launch_shape)."""
    N = _check_system(At, "At")
    M = At.shape[0]
    _check(bt, "b", (M, N), device=At.device)
    if At.device.type == "cpu":
        return solve_soa_plain(At, bt)
    dense_launch_shape(M)
    lib = _lib()
    x = torch.empty_like(bt)
    _launch("cholesky_solve_soa_t", At.device,
            lib.emloco_dense_cholesky_solve, At.data_ptr(), bt.data_ptr(),
            x.data_ptr(), N, M)
    return x


def to_env_last(A: torch.Tensor, out_rows: int | None = None):
    """Relayout batch-major (N, X, Y) → env-last (X', Y, N), X' = out_rows
    or X, 1 ≤ X' ≤ X: rows X'.. of each env are dropped."""
    if A.dim() != 3 or A.shape[0] < 1 or A.shape[2] < 1:
        raise ValueError(f"A must be (N, X, Y) with N, Y ≥ 1, got "
                         f"{tuple(A.shape)}")
    N, X, Y = A.shape
    Xo = X if out_rows is None else out_rows
    if not 1 <= Xo <= X:
        raise ValueError(f"out_rows must lie in [1, {X}], got {out_rows}")
    _check(A, "A", (N, X, Y))
    if A.device.type == "cpu":
        return to_env_last_plain(A, Xo)
    lib = _lib()
    out = torch.empty((Xo, Y, N), dtype=A.dtype, device=A.device)
    _launch("to_env_last", A.device, lib.emloco_to_env_last, A.data_ptr(),
            out.data_ptr(), N, X * Y, Xo * Y)
    return out


def gram_diag(R: torch.Tensor, w: torch.Tensor, diag: torch.Tensor,
              out_rows: int | None = None):
    """Batched weighted Gram + diagonal, batch-major: R (N, M, C) in bf16 or
    float32, w (N, M) in R's dtype, diag (N, C) float32 → At (N, C', C)
    float32, C' = out_rows or C, with At[n, :C] = R[n]ᵀ(w[n]∘R[n]) +
    diag(diag[n]). Rows C:C' are the staging pad of to_env_last and are
    left unwritten. The engine's M is its merged row count: 256 (capsule
    contacts), 352 (with self-contact), 480 (mesh colliders), 576 (both)."""
    if R.dim() != 3 or min(R.shape) < 1:
        raise ValueError(f"R must be (N, M, C) with N, M, C ≥ 1, got "
                         f"{tuple(R.shape)}")
    if R.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"R must be bfloat16 or float32, got {R.dtype}")
    N, M, C = R.shape
    if C > GRAM_MAX_C:
        raise ValueError(f"R has {C} columns; gram_diag takes at most "
                         f"{GRAM_MAX_C}")
    Co = C if out_rows is None else out_rows
    if Co < C:
        raise ValueError(f"out_rows must be at least {C}, got {out_rows}")
    for t, name, shape in ((R, "R", (N, M, C)), (w, "w", (N, M))):
        if t.dtype != R.dtype:
            raise TypeError(f"{name} must be {R.dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != R.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{R.device}")
    _check(diag, "diag", (N, C), device=R.device)
    if R.device.type == "cpu":
        return gram_diag_plain(R, w, diag, Co)
    lib = _lib()
    out = torch.empty((N, Co, C), dtype=torch.float32, device=R.device)
    _launch("gram_diag", R.device, lib.emloco_gram_diag, R.data_ptr(),
            w.data_ptr(), diag.data_ptr(), out.data_ptr(), N, M, C, Co,
            int(R.dtype == torch.bfloat16))
    return out


def _gram_dual_args(Rt, R, diag, block_envs):
    """Validate the probe kernels' operands; returns (N, M, C)."""
    if Rt.dim() != 3 or min(Rt.shape) < 1:
        raise ValueError(f"Rt must be (N, C, M) with N, C, M ≥ 1, got "
                         f"{tuple(Rt.shape)}")
    N, C, M = Rt.shape
    if C > GRAM_MAX_C:
        raise ValueError(f"Rt has {C} rows; gram_dual takes at most "
                         f"{GRAM_MAX_C}")
    for t, name, shape in ((Rt, "Rt", (N, C, M)), (R, "R", (N, M, C))):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != Rt.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{Rt.device}")
    _check(diag, "diag", (N, C), device=Rt.device)
    if not 1 <= block_envs <= N:
        raise ValueError(f"block_envs must lie in [1, {N}], got "
                         f"{block_envs}")
    if N % block_envs:
        raise ValueError(f"N = {N} envs is not a multiple of block_envs = "
                         f"{block_envs}")
    return N, M, C


def _gram_dual_launch(name, Rt, R, diag, block_envs):
    """The plain version on the CPU, else kernel `name` (C entry point
    emloco_<name>)."""
    N, M, C = _gram_dual_args(Rt, R, diag, block_envs)
    if Rt.device.type == "cpu":
        return gram_dual_plain(Rt, R, diag)
    out = torch.empty((N, C, C), dtype=torch.float32, device=Rt.device)
    _launch(name, Rt.device, getattr(_lib(), f"emloco_{name}"),
            Rt.data_ptr(), R.data_ptr(), diag.data_ptr(), out.data_ptr(), N,
            M, C, block_envs)
    return out


def gram_dual(Rt: torch.Tensor, R: torch.Tensor, diag: torch.Tensor,
              block_envs: int = 8):
    """The probe's Gram of two operands: Rt (N, C, M) = (w∘R)ᵀ and
    R (N, M, C) in bf16, diag (N, C) float32 → (N, C, C) float32,
    out[n] = Rt[n] R[n] + diag(diag[n]); C ≤ 80, N a multiple of
    block_envs. On the card, one block per `block_envs` envs, taken one after
    another."""
    return _gram_dual_launch("gram_dual", Rt, R, diag, block_envs)


def gram_dual_batched(Rt: torch.Tensor, R: torch.Tensor, diag: torch.Tensor,
                      block_envs: int = 8):
    """gram_dual with two of the block's envs in flight together, the block
    in rounds of two (one env at a time where block_envs is odd); the same
    bits as gram_dual on the card."""
    return _gram_dual_launch("gram_dual_batched", Rt, R, diag, block_envs)


# ---------------------------------------------------------------------------
# Compositions (no kernel of their own), batch-major in and out
# ---------------------------------------------------------------------------

def cholesky_solve_blocked(A: torch.Tensor, b: torch.Tensor, chunks, limbs,
                           s_lo: int):
    """Block-arrow solve, batch-major: A (N, M, M), b (N, M) → x (N, M)
    (a transposed view of the env-last solution)."""
    return cholesky_solve_blocked_t(to_env_last(A), b.T.contiguous(), chunks,
                                    limbs, s_lo).T


def cholesky_factor_blocked(A: torch.Tensor, chunks, limbs, s_lo: int):
    """Batch-major A (N, M, M) → permuted env-last L (M, M, N) for
    cholesky_resolve_blocked."""
    return cholesky_factor_blocked_t(to_env_last(A), chunks, limbs, s_lo)


def cholesky_solve_soa(A: torch.Tensor, b: torch.Tensor):
    """Dense solve, batch-major: A (N, M, M), b (N, M) → x (N, M) (a
    transposed view). The relayout is a plain copy, as in the JAX package,
    where XLA moves the axis outside any Pallas kernel."""
    return cholesky_solve_soa_t(A.permute(1, 2, 0).contiguous(),
                                b.T.contiguous()).T
