"""The engine's linear solve judged in float64.

The LHS A (M, M, N) is stored env-last; the factor L is the lower
Cholesky factor of A with its rows and columns in the order `chunks`
lists (old DoF ranges in new order); the resolve gives x (M, N) with
A x = b. The gaps are per env, the worst env's kept.
"""
from __future__ import annotations

import torch


def _perm(chunks, device):
    return torch.cat([torch.arange(lo, hi, device=device)
                      for lo, hi in chunks])


def _batch(t):
    return t.permute(2, 0, 1).double()              # (N, M, M)


def factor_gap(At, L, chunks) -> float:
    """max over envs of max |L Lᵀ − P A Pᵀ| / max |A|."""
    p = _perm(chunks, At.device)
    A = _batch(At)[:, p][:, :, p]
    Lb = torch.tril(_batch(L))
    d = (Lb @ Lb.transpose(1, 2) - A).abs().amax((1, 2))
    return float((d / A.abs().amax((1, 2)).clamp_min(1e-300)).max())


def resolve_gap(At, b, x) -> float:
    """max over envs of max |x − A⁻¹b| / max |A⁻¹b|, A⁻¹b in float64."""
    ref = torch.linalg.solve(_batch(At), b.T.double()[..., None])[..., 0]
    d = (x.T.double() - ref).abs().amax(1)
    return float((d / ref.abs().amax(1).clamp_min(1e-300)).max())


def bf16_solve(At, b, chunks):
    """The control: the factor and the solution stored in bfloat16 (the
    factorization and the triangular solves computed in float32 from the
    float32 A: A rounded to bfloat16 first is no longer positive definite
    for every env), in the program's layouts."""
    def r(t):
        return t.to(torch.bfloat16).float()
    p = _perm(chunks, At.device)
    A = At.permute(2, 0, 1)[:, p][:, :, p]
    Lb = r(torch.linalg.cholesky(A))
    bp = r(b.T)[:, p]
    y = torch.cholesky_solve(bp[..., None], Lb)[..., 0]
    x = torch.empty_like(y)
    x[:, p] = y
    return Lb.permute(1, 2, 0).contiguous(), r(x).T.contiguous()
