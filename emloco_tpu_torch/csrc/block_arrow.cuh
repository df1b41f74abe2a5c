// Device code shared by the block-arrow Cholesky kernels
// (block_arrow_cholesky.cu: factor, resolve; block_arrow_solve.cu: fused
// solve, batch-major resolve) and the dense solve of dense_cholesky.cu.
//
// One design lives here: one warp per env with the env's packed triangle
// in shared memory (PackedPlan, gather_packed, packed_factor_warp,
// packed_solves_warp, solve_block), run by the factor, the resolve, the
// fused solve, the batch-major resolve and, with no limbs, the dense
// solve's factor. Each kernel gives every entry the same float32 operations
// in the same order as its plain version, so the fused and the split
// kernels, and the env-last and the batch-major resolves, agree to the bit.
//
// Layout. A, L are (M, M, N) and env-last vectors (M, N), row-major with the
// env axis N last: element (i, j) of env e sits at (i*M + j)*N + e. A warp's
// 32 loads of one matrix element for 32 consecutive envs are 128 contiguous
// bytes. A batch-major vector (N, M) puts element i of env e at e*M + i:
// a block's 32 envs of it are 32*M contiguous floats.
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

__device__ __forceinline__ float clamp_pivot(float d) {
  return d < 1e-12f ? 1e-12f : d;   // NaN compares false and passes through
}

// ---------------------------------------------------------------------------
// One warp per env, the env's packed triangle in shared memory: the factor
// and the resolve of block_arrow_cholesky.cu, the fused solve of
// block_arrow_solve.cu and, with no limbs (s_lo = 0), the dense solve's
// factor in dense_cholesky.cu.
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
  int n_limbs;
  int limb_lo[kMaxM];     // limb q is [limb_lo[q], col_hi[limb_lo[q]])
  int perm[kMaxM];        // perm[new index] = old DoF index
  int iperm[kMaxM];       // its inverse: iperm[old DoF index] = new index
  int col_hi[kMaxM];      // end of column k's first row segment
  int off[kMaxM + 1];     // column k's first entry; off[m] entries in all
};

// Host-side plan; false unless the limbs tile [0, s_lo) in order and no
// column has more than max_below rows below its pivot. perm null: the
// identity; else a permutation of 0..m-1 (the caller's check). The caller
// checks its block's shared memory.
inline bool make_packed_plan(int m, const int* perm, int n_limbs,
                             const int* limbs, int s_lo, int max_below,
                             PackedPlan* p) {
  if (m < 1 || m > kMaxM || n_limbs < 0 || s_lo < 0 || s_lo > m) return false;
  p->m = m;
  p->s_lo = s_lo;
  p->n_limbs = n_limbs;
  int k = 0;
  for (int b = 0; b < n_limbs; ++b) {
    const int lo = limbs[2 * b], hi = limbs[2 * b + 1];
    if (lo != k || hi <= lo || hi > s_lo) return false;
    p->limb_lo[b] = lo;
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
  for (int i = 0; i < m; ++i) {
    p->perm[i] = perm ? perm[i] : i;
    p->iperm[p->perm[i]] = i;
  }
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
// entries from the env-last (m, m, n) A through perm (kPermute; else A is
// already in new order, as a factor is), coalesced: thread tid takes env
// tid % kEnvs, so consecutive threads read consecutive envs of one element,
// and the entries tid / kEnvs + r * kThreads / kEnvs, kLoads loads in
// flight. Envs past n read zeros.
template <int kEnvs, int kThreads, int kLoads, bool kPermute = true>
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
        const int ai = kPermute ? p.perm[i] : i, aj = kPermute ? p.perm[j] : j;
        v[q] = e < n ? a[((size_t)ai * m + aj) * sn + e] : 0.0f;
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
// in ascending k, as factor_blocked_plain does, so the two agree to the bit.
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

// Launch shape for a C entry point's caller: shape[0] envs (= warps) a
// block, shape[1] threads a block, shape[2] dynamic shared memory a block
// in bytes. Returns 0, or cudaErrorInvalidValue where the plan refused
// (bytes 0).
inline int report_shape(size_t bytes, int envs, int threads, void* shape) {
  if (bytes == 0) return (int)cudaErrorInvalidValue;
  int* const out = static_cast<int*>(shape);
  out[0] = envs;
  out[1] = threads;
  out[2] = (int)bytes;
  return 0;
}

// The two triangular sweeps of one env by the 32 lanes of a warp, with the
// plain resolve's (resolve_blocked_plain) operations in its
// order: L the env's packed factor (at most 32 rows below a pivot), v its
// right-hand side in new order on entry and its solution in new order on
// exit, s m floats of scratch, all in shared memory.
//   Forward, column by column in ascending k: every lane forms
//   y_k = y_k / L(k,k); lane t takes row i = R_k[t], y_i = y_i - L(i,k)*y_k.
//   So each y_i takes its updates once per column of its pattern, in
//   ascending k, whichever lane applies them.
//   Backward, the shared columns from the last: every lane alike sums
//   acc = L(i,k)*z_i over the rows i > k in ascending order from 0, and
//   z_k = (y_k - acc) / L(k,k). Then lane t sums limb column k = t, t+32,
//   ... over the shared rows in ascending order from 0, into s[k]. Then, the
//   limbs being independent once the shared z are known, lane q takes limb
//   q from its last column: the sum over the later rows of the limb in
//   ascending order from 0 is added to s[k] (a limb's last column adds
//   nothing), and z_k = (y_k - acc) / L(k,k).
__device__ __forceinline__ void packed_solves_warp(const float* L, float* v,
                                                   float* s,
                                                   const PackedPlan& p,
                                                   const int lane) {
  const int m = p.m, s_lo = p.s_lo;
  for (int k = 0; k < m; ++k) {
    const int base = p.off[k];
    const int nr = p.off[k + 1] - base - 1;                 // |R_k| <= 32
    const float yk = v[k] / L[base];
    __syncwarp();
    if (lane == 0) v[k] = yk;
    if (lane < nr) {
      const int i = packed_row(p, k, lane + 1);
      v[i] = v[i] - L[base + 1 + lane] * yk;
    }
    __syncwarp();
  }

  for (int k = m - 1; k >= s_lo; --k) {
    const float* const col = L + p.off[k] - k;     // col[i] = L(i, k), i >= k
    float acc = 0.0f;
    for (int i = k + 1; i < m; ++i) acc = acc + col[i] * v[i];
    const float zk = (v[k] - acc) / col[k];
    __syncwarp();
    if (lane == 0) v[k] = zk;
    __syncwarp();
  }
  for (int k = lane; k < s_lo; k += 32) {
    // sh[i] = L(i, k) for the shared rows i >= s_lo
    const float* const sh = L + p.off[k] + p.col_hi[k] - k - s_lo;
    float acc = 0.0f;
    for (int i = s_lo; i < m; ++i) acc = acc + sh[i] * v[i];
    s[k] = acc;
  }
  __syncwarp();
  for (int q = lane; q < p.n_limbs; q += 32) {
    const int lo = p.limb_lo[q], hi = p.col_hi[lo];
    for (int k = hi - 1; k >= lo; --k) {
      const float* const col = L + p.off[k] - k;   // col[i] = L(i, k), i < hi
      float acc = s[k];
      if (k + 1 < hi) {
        float acc_l = 0.0f;
        for (int i = k + 1; i < hi; ++i) acc_l = acc_l + col[i] * v[i];
        acc = acc + acc_l;
      }
      v[k] = (v[k] - acc) / col[k];
    }
  }
  __syncwarp();
}

// The block-arrow kernels in shared memory (factor, resolve, fused solve):
// a block takes kArrowEnvs envs, one warp each. Shared memory holds the
// envs' packed triangles at p.stride floats, then, for the resolve and the
// fused solve, their vectors (v, s) at solve_vec_stride(m) floats (odd, so a
// gather's 32 envs of one element fall on distinct banks).
constexpr int kArrowEnvs = 32;
constexpr int kArrowThreads = 32 * kArrowEnvs;
constexpr int kArrowLoads = 8;         // global loads a thread keeps in flight

__host__ __device__ inline int solve_vec_stride(int m) { return 2 * m + 1; }

// The plan for this block structure and the block's dynamic shared memory in
// bytes, with vec_floats floats an env after the triangles; 0 if the kernel
// cannot take it (limbs that do not tile [0, s_lo) in order, more than 32
// rows below a pivot, or past a block's shared memory).
inline size_t arrow_plan(int m, const void* perm, int n_limbs,
                         const void* limbs, int s_lo, int vec_floats,
                         PackedPlan* p) {
  if (!make_packed_plan(m, static_cast<const int*>(perm), n_limbs,
                        static_cast<const int*>(limbs), s_lo, 32, p))
    return 0;
  const size_t bytes = sizeof(float) * kArrowEnvs * (p->stride + vec_floats);
  return bytes <= (size_t)kMaxSmem ? bytes : 0;
}

// arrow_plan for the resolve and the fused solve.
inline size_t solve_plan(int m, const void* perm, int n_limbs,
                         const void* limbs, int s_lo, PackedPlan* p) {
  return arrow_plan(m, perm, n_limbs, limbs, s_lo, solve_vec_stride(m), p);
}

// One block of the fused solve (kFactor: A (m, m, n) gathered through perm,
// then factored) or of a resolve (L (m, m, n) already in new order,
// gathered as it is): the block gathers its envs' packed triangles and b
// through perm, coalesced across envs, each warp factors (kFactor) and
// sweeps its env, and the block writes x through perm, coalesced. b and x
// are env-last (m, n), consecutive threads on consecutive envs of one
// element, or with kBatchMajor batch-major (n, m), consecutive threads on
// consecutive elements of the block's 32 * m contiguous floats, element j of
// an env placed at new index iperm[j]. No scratch in device memory.
template <bool kFactor, bool kBatchMajor = false>
__device__ __forceinline__ void solve_block(float* smem,
                                            const float* __restrict__ a,
                                            const float* __restrict__ b,
                                            float* __restrict__ x,
                                            const PackedPlan& p, const int n) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int e0 = blockIdx.x * kArrowEnvs, m = p.m, vs = solve_vec_stride(m);
  const size_t sn = (size_t)n;
  float* const vecs = smem + kArrowEnvs * p.stride;

  gather_packed<kArrowEnvs, kArrowThreads, kArrowLoads, kFactor>(a, smem, p,
                                                                  e0, n);
  for (int idx = tid; idx < m * kArrowEnvs; idx += kArrowThreads) {
    if (kBatchMajor) {
      const int el = idx / m, j = idx - el * m;
      if (e0 + el < n)
        vecs[el * vs + p.iperm[j]] = b[(size_t)e0 * m + idx];
    } else {
      const int el = idx % kArrowEnvs, i = idx / kArrowEnvs, e = e0 + el;
      if (e < n) vecs[el * vs + i] = b[(size_t)p.perm[i] * sn + e];
    }
  }
  __syncthreads();

  if (e0 + w < n) {
    float* const L = smem + w * p.stride;
    float* const v = vecs + w * vs;
    if (kFactor) packed_factor_warp<1>(L, p, lane);
    packed_solves_warp(L, v, v + m, p, lane);
  }
  __syncthreads();

  for (int idx = tid; idx < m * kArrowEnvs; idx += kArrowThreads) {
    if (kBatchMajor) {
      const int el = idx / m, j = idx - el * m;
      if (e0 + el < n)
        x[(size_t)e0 * m + idx] = vecs[el * vs + p.iperm[j]];
    } else {
      const int el = idx % kArrowEnvs, i = idx / kArrowEnvs, e = e0 + el;
      if (e < n) x[(size_t)p.perm[i] * sn + e] = vecs[el * vs + i];
    }
  }
}

}  // namespace emloco
