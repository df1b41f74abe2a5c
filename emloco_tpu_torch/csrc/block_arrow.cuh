// Device code shared by the block-arrow Cholesky kernels
// (block_arrow_cholesky.cu: factor, resolve; block_arrow_solve.cu: fused
// solve, batch-major resolve): the plan, the permuted load of A, the
// in-place factor and the two triangular sweeps, one thread per env; and
// the factor in shared memory, one warp per env (packed_factor_warp, at the
// end), which the dense solve of dense_cholesky.cu runs too. Both factors
// give every entry the same float32 operations in the same order, so the
// fused and the split kernels agree to the bit.
//
// Layout. A, L are (M, M, N) and env-last vectors (M, N), row-major with the
// env axis N last: element (i, j) of env e sits at (i*M + j)*N + e. A warp's
// 32 loads of one matrix element for 32 consecutive envs are 128 contiguous
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

// ---------------------------------------------------------------------------
// The factor in shared memory, one warp per env: the block-arrow factor of
// block_arrow_cholesky.cu and, with no limbs (s_lo = 0), the dense solve of
// dense_cholesky.cu.
//
// Packing. The env's in-pattern lower triangle (new order) is stored column
// by column: column k holds its pivot, then the rows of its pattern below
// it, R_k = [k+1, col_hi[k]) then [s_lo, M) — col_hi[k] is the end of k's
// limb, or M for a shared column, whose second segment is empty. Column k
// starts at off[k]; the humanoid's 1,437 entries fill off[M], a dense 75x75
// triangle's 2,850. For a row R_k[t] and a column j = R_k[u], u <= t, the
// pattern of column j from row j on is exactly R_k from u on, so entry
// (R_k[t], j) sits at off[j] + t - u: a column step's lanes update
// consecutive words of column j.
// ---------------------------------------------------------------------------

constexpr int kMaxSmem = 232448;         // H100: 227 KB a block

struct PackedPlan {
  int m;
  int s_lo;
  int stride;             // floats per env in shared memory (odd)
  int perm[kMaxM];        // perm[new index] = old DoF index
  int col_hi[kMaxM];      // end of column k's first row segment
  int off[kMaxM + 1];     // column k's first entry; off[m] entries in all
};

// Host-side plan; false unless the limbs tile [0, s_lo) in order and no
// column has more than max_below rows below its pivot. perm null: the
// identity. The caller checks its block's shared memory.
inline bool make_packed_plan(int m, const int* perm, int n_limbs,
                             const int* limbs, int s_lo, int max_below,
                             PackedPlan* p) {
  if (m < 1 || m > kMaxM || n_limbs < 0 || s_lo < 0 || s_lo > m) return false;
  p->m = m;
  p->s_lo = s_lo;
  int k = 0;
  for (int b = 0; b < n_limbs; ++b) {
    const int lo = limbs[2 * b], hi = limbs[2 * b + 1];
    if (lo != k || hi <= lo || hi > s_lo) return false;
    for (; k < hi; ++k) p->col_hi[k] = hi;
  }
  if (k != s_lo) return false;
  for (; k < m; ++k) p->col_hi[k] = m;
  p->off[0] = 0;
  for (k = 0; k < m; ++k) {
    const int hi = p->col_hi[k];
    const int below = hi - k - 1 + (hi < m ? m - s_lo : 0);
    if (below > max_below) return false;
    p->off[k + 1] = p->off[k] + 1 + below;
  }
  p->stride = p->off[m] | 1;          // odd: the envs on distinct banks
  for (int i = 0; i < m; ++i) p->perm[i] = perm ? perm[i] : i;
  return true;
}

// Row t of column j's packed entries (t = 0 the pivot), in new order.
__device__ __forceinline__ int packed_row(const PackedPlan& p, int j, int t) {
  const int h1 = p.col_hi[j] - j;
  return t < h1 ? j + t : p.s_lo + t - h1;
}

// The inverse: row i's place in column j's packed entries (i >= j), or -1
// outside the pattern.
__device__ __forceinline__ int packed_slot(const PackedPlan& p, int i, int j) {
  const int h1 = p.col_hi[j] - j;
  if (i - j < h1) return i - j;
  if (p.col_hi[j] < p.m && i >= p.s_lo) return h1 + i - p.s_lo;
  return -1;
}

// A block's envs e0.. (env el at smem + el*stride) gather their packed
// entries from the env-last (m, m, n) A through perm, coalesced: thread tid
// takes env tid % kEnvs, so consecutive threads read consecutive envs of one
// element, and the entries tid / kEnvs + r * kThreads / kEnvs, kLoads loads
// in flight. Envs past n read zeros.
template <int kEnvs, int kThreads, int kLoads>
__device__ __forceinline__ void gather_packed(const float* __restrict__ a,
                                              float* smem, const PackedPlan& p,
                                              const int e0, const int n) {
  constexpr int kStep = kThreads / kEnvs;
  const int el = threadIdx.x % kEnvs, e = e0 + el, m = p.m;
  const int total = p.off[m];
  const size_t sn = (size_t)n;
  int j = 0;                                // the column of packed entry pe
  for (int p0 = threadIdx.x / kEnvs; p0 < total; p0 += kLoads * kStep) {
    float v[kLoads];
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int pe = p0 + q * kStep;
      if (pe < total) {
        while (pe >= p.off[j + 1]) ++j;
        const int i = packed_row(p, j, pe - p.off[j]);
        v[q] = e < n ? a[((size_t)p.perm[i] * m + p.perm[j]) * sn + e] : 0.0f;
      }
    }
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int pe = p0 + q * kStep;
      if (pe < total) smem[el * p.stride + pe] = v[q];
    }
  }
}

// One panel of the warp factor below: columns k..k+NP-1 of one limb (or of
// the shared block). Lane t owns the rows R_k[t + 32s], s < RPL, and keeps
// their entries c[q][s] of the panel's columns in registers. Each panel
// column is scaled, then updates the panel's later columns; then every
// trailing entry is read once, takes the NP updates l -= c_i*c_j in
// ascending column order, and is written once.
template <int NP, int RPL>
__device__ __forceinline__ void packed_panel(float* L, const PackedPlan& p,
                                             const int lane, const int k,
                                             const int n1, const int nr) {
  float c[NP][RPL];
  int cb[NP];       // column k+q holds row R_k[t], t >= q, at cb[q] + t
#pragma unroll
  for (int q = 0; q < NP; ++q) cb[q] = p.off[k + q] + 1 - q;
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    const int base = cb[q] - 1 + q;
    const float s = sqrtf(clamp_pivot(L[base]));
    __syncwarp();
    if (lane == 0) L[base] = s;
#pragma unroll
    for (int sl = 0; sl < RPL; ++sl) {
      const int t = lane + 32 * sl;
      c[q][sl] = 0.0f;
      if (t >= q && t < nr) {
        c[q][sl] = L[cb[q] + t] / s;
        L[cb[q] + t] = c[q][sl];
      }
    }
    __syncwarp();
#pragma unroll
    for (int r = q + 1; r < NP; ++r) {        // column k+r = R_k[r-1]
      const float cj = L[cb[q] + r - 1];
#pragma unroll
      for (int sl = 0; sl < RPL; ++sl) {
        const int t = lane + 32 * sl;
        if (t >= r - 1 && t < nr) {
          float* const e = L + cb[r] + t;
          *e = *e - c[q][sl] * cj;
        }
      }
    }
    __syncwarp();
  }
  // the trailing columns j = R_k[u], u >= NP-1: entry (R_k[t], j) at
  // base = off[j] - u, plus t. Column j's rows below its pivot are R_k from
  // u+1 on, so the next column of the same segment starts nr - u words
  // later; the shared segment (u = n1) starts at off[s_lo].
  int base = p.off[k + NP] - (NP - 1);
  for (int u = NP - 1; u < nr; ++u) {
    if (u == n1) base = p.off[p.s_lo] - n1;
    float cj[NP];
#pragma unroll
    for (int q = 0; q < NP; ++q) cj[q] = L[cb[q] + u];
#pragma unroll
    for (int sl = 0; sl < RPL; ++sl) {
      const int t = lane + 32 * sl;
      if (t >= u && t < nr) {
        float* const e = L + base + t;
        float v = *e;
#pragma unroll
        for (int q = 0; q < NP; ++q) v = v - c[q][sl] * cj[q];
        *e = v;
      }
    }
    base += nr - u - 1;
  }
  __syncwarp();
}

// Right-looking block-arrow Cholesky of one env's packed triangle L in
// shared memory by the 32 lanes of a warp, RPL rows a lane (a plan with at
// most 32*RPL rows below a pivot), in panels of 8, 4, 2 or 1 columns that
// stay inside a limb (or the shared block). Every entry takes its updates
// in ascending k, as arrow_factor does, so the two agree to the bit.
template <int RPL>
__device__ __forceinline__ void packed_factor_warp(float* L,
                                                   const PackedPlan& p,
                                                   const int lane) {
  const int m = p.m;
  for (int k = 0; k < m;) {
    const int hi = p.col_hi[k];
    const int n1 = hi - k - 1;
    const int nr = n1 + (hi < m ? m - p.s_lo : 0);      // |R_k|
    const int left = hi - k;
    if (left >= 8) {
      packed_panel<8, RPL>(L, p, lane, k, n1, nr);
      k += 8;
    } else if (left >= 4) {
      packed_panel<4, RPL>(L, p, lane, k, n1, nr);
      k += 4;
    } else if (left >= 2) {
      packed_panel<2, RPL>(L, p, lane, k, n1, nr);
      k += 2;
    } else {
      packed_panel<1, RPL>(L, p, lane, k, n1, nr);
      k += 1;
    }
  }
}

}  // namespace emloco
