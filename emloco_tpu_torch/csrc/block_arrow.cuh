// Device code shared by the block-arrow Cholesky kernels
// (block_arrow_cholesky.cu: factor, resolve; block_arrow_solve.cu: fused
// solve, batch-major resolve): the plan, the permuted load of A, the
// in-place factor and the two triangular sweeps. Every block-arrow kernel
// goes through these functions, so the fused and the split kernels do the
// same float32 operations in the same order and agree to the bit.
//
// Layout. A, L are (M, M, N) and env-last vectors (M, N), row-major with the
// env axis N last: element (i, j) of env e sits at (i*M + j)*N + e. Thread e
// owns env e, so a warp's 32 loads of one matrix element are 128 contiguous
// bytes. A batch-major vector (N, M) puts element i of env e at e*M + i.
//
// Structure. The reduced-coordinate matrix is block-arrow once its DoFs are
// ordered limbs-first: dense limb blocks on the diagonal, couplings only into
// a trailing shared block, zero between limbs. The permutation (perm[new] =
// old DoF) and the block bounds (limbs, s_lo) come from the caller, derived
// from the kinematic tree (emloco_tpu_torch/physics/reduced.py _arrow_blocks);
// nothing here is specific to the humanoid. A factorization in that order
// has no fill-in, so each column updates only rest-of-limb + shared rows.
//
// Numerics. The plain PyTorch versions' operations
// (emloco_tpu_torch/physics/linalg.py) in the same order: column by column,
// sums in row order, pivots clamped to 1e-12 before sqrt (NaN passes through,
// as jnp.maximum lets it). Built with -fmad=false so no multiply-add is
// contracted.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace emloco {

constexpr int kMaxM = 128;
constexpr int kMaxLimbs = 16;
constexpr int kThreads = 128;

struct ArrowPlan {
  int m;                  // system size
  int s_lo;               // first row of the shared block (new order)
  int n_limbs;
  int limb_lo[kMaxLimbs];  // dense limb blocks [lo, hi) in new order
  int limb_hi[kMaxLimbs];
  int perm[kMaxM];        // perm[new index] = old DoF index
};

// Host-side plan from the caller's arrays; false if it does not fit.
inline bool make_plan(int m, const int* perm, int n_limbs, const int* limbs,
                      int s_lo, ArrowPlan* p) {
  if (m < 1 || m > kMaxM || n_limbs < 0 || n_limbs > kMaxLimbs ||
      s_lo < 0 || s_lo > m)
    return false;
  p->m = m;
  p->s_lo = s_lo;
  p->n_limbs = n_limbs;
  for (int i = 0; i < n_limbs; ++i) {
    p->limb_lo[i] = limbs[2 * i];
    p->limb_hi[i] = limbs[2 * i + 1];
  }
  for (int i = 0; i < m; ++i) p->perm[i] = perm[i];
  return true;
}

__device__ __forceinline__ float clamp_pivot(float d) {
  return d < 1e-12f ? 1e-12f : d;   // NaN compares false and passes through
}

// Element (i, j) of env e in an env-last (m, m, n) matrix.
template <class T>
struct EnvLastMat {
  T* p;
  int m;
  size_t n;
  int e;
  __device__ __forceinline__ T& operator()(int i, int j) const {
    return p[((size_t)i * m + j) * n + e];
  }
};

// Element i of one env's vector: p[i*stride + off] — env-last with
// (stride, off) = (n, e), batch-major with (1, e*m).
template <class T>
struct EnvVec {
  T* p;
  size_t stride;
  size_t off;
  __device__ __forceinline__ T& operator()(int i) const {
    return p[(size_t)i * stride + off];
  }
};

// L = permuted copy of A's lower triangle (new order); upper triangle zero.
__device__ __forceinline__ void load_permuted(const EnvLastMat<const float>& a,
                                              const EnvLastMat<float>& l,
                                              const ArrowPlan& p) {
  const int m = p.m;
  for (int i = 0; i < m; ++i) {
    const int pi = p.perm[i];
    for (int j = 0; j <= i; ++j) l(i, j) = a(pi, p.perm[j]);
    for (int j = i + 1; j < m; ++j) l(i, j) = 0.0f;
  }
}

// In-place block-arrow Cholesky of the permuted lower triangle in l.
__device__ __forceinline__ void arrow_factor(const EnvLastMat<float>& l,
                                             const ArrowPlan& p) {
  const int m = p.m;
  // limb columns: scale the column, then update rest-of-limb and shared rows
  for (int b = 0; b < p.n_limbs; ++b) {
    const int hi = p.limb_hi[b];
    for (int k = p.limb_lo[b]; k < hi; ++k) {
      const float s = sqrtf(clamp_pivot(l(k, k)));
      l(k, k) = s;
      for (int i = k + 1; i < hi; ++i) l(i, k) = l(i, k) / s;
      for (int i = p.s_lo; i < m; ++i) l(i, k) = l(i, k) / s;
      for (int i = k + 1; i < hi; ++i) {
        const float ci = l(i, k);
        for (int j = k + 1; j <= i; ++j) l(i, j) = l(i, j) - ci * l(j, k);
      }
      for (int i = p.s_lo; i < m; ++i) {
        const float ci = l(i, k);
        for (int j = k + 1; j < hi; ++j) l(i, j) = l(i, j) - ci * l(j, k);
        for (int j = p.s_lo; j <= i; ++j) l(i, j) = l(i, j) - ci * l(j, k);
      }
    }
  }
  // shared block: dense Cholesky of the remaining Schur complement
  for (int k = p.s_lo; k < m; ++k) {
    const float s = sqrtf(clamp_pivot(l(k, k)));
    l(k, k) = s;
    for (int i = k + 1; i < m; ++i) l(i, k) = l(i, k) / s;
    for (int i = k + 1; i < m; ++i) {
      const float ci = l(i, k);
      for (int j = k + 1; j <= i; ++j) l(i, j) = l(i, j) - ci * l(j, k);
    }
  }
}

// Solve L Lᵀ (P x) = P b with the permuted factor: b and x indexed by old
// DoF, y a scratch vector in new order. The forward sweep is column-
// oriented (each column pushes into later rows), the backward sweep row-
// oriented dot products over the pattern; z in new order is written
// straight into x at its un-permuted row.
template <class L>
__device__ __forceinline__ void arrow_solves(const L& l,
                                             const EnvVec<const float>& b,
                                             const EnvVec<float>& y,
                                             const EnvVec<float>& x,
                                             const ArrowPlan& p) {
  const int m = p.m;
  for (int i = 0; i < m; ++i) y(i) = b(p.perm[i]);

  for (int q = 0; q < p.n_limbs; ++q) {
    const int hi = p.limb_hi[q];
    for (int k = p.limb_lo[q]; k < hi; ++k) {
      const float yk = y(k) / l(k, k);
      y(k) = yk;
      for (int i = k + 1; i < hi; ++i) y(i) = y(i) - l(i, k) * yk;
      for (int i = p.s_lo; i < m; ++i) y(i) = y(i) - l(i, k) * yk;
    }
  }
  for (int k = p.s_lo; k < m; ++k) {
    const float yk = y(k) / l(k, k);
    y(k) = yk;
    for (int i = k + 1; i < m; ++i) y(i) = y(i) - l(i, k) * yk;
  }

  for (int k = m - 1; k >= p.s_lo; --k) {
    float acc = 0.0f;
    for (int i = k + 1; i < m; ++i) acc = acc + l(i, k) * x(p.perm[i]);
    x(p.perm[k]) = (y(k) - acc) / l(k, k);
  }
  for (int q = 0; q < p.n_limbs; ++q) {
    const int lo = p.limb_lo[q], hi = p.limb_hi[q];
    for (int k = hi - 1; k >= lo; --k) {
      float acc = 0.0f;
      for (int i = p.s_lo; i < m; ++i) acc = acc + l(i, k) * x(p.perm[i]);
      if (k + 1 < hi) {
        float acc_l = 0.0f;
        for (int i = k + 1; i < hi; ++i)
          acc_l = acc_l + l(i, k) * x(p.perm[i]);
        acc = acc + acc_l;
      }
      x(p.perm[k]) = (y(k) - acc) / l(k, k);
    }
  }
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace emloco
