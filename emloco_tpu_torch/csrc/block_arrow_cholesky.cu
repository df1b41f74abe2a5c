// Block-arrow Cholesky factor and resolve for batched 75x75 SPD systems,
// env-last layout. Built with plain nvcc into a shared library with a C
// interface (see emloco_tpu_torch/build.py).
//
// Replaces two Pallas TPU kernels of emloco_tpu/physics/pallas_linalg.py:
//   emloco_block_arrow_factor  <- cholesky_factor_blocked_t
//       (_chol_factor_blocked_kernel, _permute_matrix_in, _factor_body)
//   emloco_block_arrow_resolve <- cholesky_resolve_blocked_t
//       (_chol_resolve_blocked_kernel, _permute_vec_in/_out,
//        _triangular_solves)
//
// Layout, structure and numerics: see block_arrow.cuh. The factor runs
// packed_factor_warp, the resolve arrow_solves (as do the fused solve and
// the batch-major resolve of block_arrow_solve.cu, with arrow_factor, which
// rounds every entry as packed_factor_warp does).
//
// Bounds on the H100 (3.35 TB/s HBM, 67 TFLOP/s f32):
//   factor:  must read A's in-pattern lower triangle (1,437 floats) and
//            write the dense L (75*75 floats): 28 KB per env, 116 MB at
//            4,096 envs -> 0.035 ms. About 31k flops per env (127 MFLOP at
//            4,096 envs) are far below the compute roof, so bytes bound it.
//            Design: a block takes kEnvs = 32 envs, one warp each (1,024
//            threads). It gathers its envs' in-pattern entries through
//            perm, once, 32 consecutive envs per element (128-byte loads,
//            kLoads in flight a thread), into dynamic shared memory, packed
//            column by column (block_arrow.cuh): 32 * 1,437 * 4 = 183,936
//            bytes a block, one block an SM, 128 blocks for 4,096 envs, one
//            wave. Each warp factors its env there in panels of up to 8
//            columns of a limb, one lane per row below the panel (at most
//            14 limb + 15 shared rows); then the block writes the dense L,
//            128 bytes a warp store. A's lower entries outside the pattern
//            (1,413 floats, zero in the engine's matrices, which the bound
//            leaves out) are copied from A to L untouched, as the plain
//            version leaves them. No working copy in device memory. ptxas
//            (sm_90a): 51 registers, no spill.
//            What limits it now (PERF.md): instruction issue in the factor
//            in shared memory, with half the lanes idle on average in a
//            panel's triangular update; the gather's reads through perm;
//            the 5,625-float dense write.
//   resolve: reads the in-pattern lower triangle of L (1,437 floats = 5.7 KB
//            per env) plus b and x: 26 MB at 4,096 envs -> 0.008 ms; one
//            thread per env, the two sweeps keep y in a scratch vector the
//            wrapper allocates and write z straight into x at its
//            un-permuted row.

#include "block_arrow.cuh"

namespace {

using emloco::ArrowPlan;
using emloco::EnvLastMat;
using emloco::EnvVec;
using emloco::PackedPlan;

constexpr int kEnvs = 32;              // envs (= warps) a block
constexpr int kFactorThreads = 32 * kEnvs;
constexpr int kLoads = 8;              // global loads a thread keeps in flight

// The plan for this block structure and its dynamic shared memory a block,
// in bytes; 0 if the kernel cannot take it (a column with more than 32 rows
// below its pivot, or kEnvs envs past a block's shared memory).
size_t factor_plan(int m, const void* perm, int n_limbs, const void* limbs,
                   int s_lo, PackedPlan* p) {
  if (!emloco::make_packed_plan(m, static_cast<const int*>(perm), n_limbs,
                                static_cast<const int*>(limbs), s_lo, 32, p))
    return 0;
  const size_t bytes = sizeof(float) * kEnvs * p->stride;
  return bytes <= (size_t)emloco::kMaxSmem ? bytes : 0;
}

__global__ void __launch_bounds__(kFactorThreads)
factor_kernel(const float* __restrict__ a, float* __restrict__ l,
              const PackedPlan p, const int n) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int m = p.m;
  const int e = blockIdx.x * kEnvs + lane;     // this lane's env in I/O
  const size_t sn = (size_t)n;

  // A's in-pattern entries: warp w takes packed entries w, w+32, ...; lanes
  // the envs
  emloco::gather_packed<kEnvs, kFactorThreads, kLoads>(
      a, smem, p, blockIdx.x * kEnvs, n);
  __syncthreads();

  if (blockIdx.x * kEnvs + w < n)
    emloco::packed_factor_warp<1>(smem + w * p.stride, p, lane);
  __syncthreads();

  // the dense L: the factor in the pattern, A's other lower entries copied
  // through untouched (as the plain version leaves them), zero above the
  // diagonal; warp w takes entries w, w+32, ... of the m*m, kLoads in flight
  const float* const mine = smem + lane * p.stride;
  const int mm = m * m;
  for (int p0 = w; p0 < mm; p0 += kLoads * kEnvs) {
    float v[kLoads];
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int idx = p0 + q * kEnvs, i = idx / m, j = idx - i * m;
      v[q] = 0.0f;
      if (idx < mm && j <= i) {
        const int t = emloco::packed_slot(p, i, j);
        if (t >= 0)
          v[q] = mine[p.off[j] + t];
        else if (e < n)
          v[q] = a[((size_t)p.perm[i] * m + p.perm[j]) * sn + e];
      }
    }
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int idx = p0 + q * kEnvs;
      if (idx < mm && e < n) l[(size_t)idx * sn + e] = v[q];
    }
  }
}

__global__ void __launch_bounds__(emloco::kThreads)
resolve_kernel(const float* __restrict__ l, const float* __restrict__ b,
               float* __restrict__ x, float* __restrict__ y,
               const ArrowPlan p, const int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const size_t sn = (size_t)n;
  emloco::arrow_solves(EnvLastMat<const float>{l, p.m, sn, e},
                       EnvVec<const float>{b, sn, (size_t)e},
                       EnvVec<float>{y, sn, (size_t)e},
                       EnvVec<float>{x, sn, (size_t)e}, p);
}

}  // namespace

extern "C" {

// A (m, m, n) -> L (m, m, n), permuted order, lower triangle (upper zero).
// perm: m ints (host); limbs: n_limbs (lo, hi) pairs (host). Launches on
// `stream`, allocates nothing, returns cudaGetLastError()
// (cudaErrorInvalidValue for a block structure factor_plan refuses).
int emloco_block_arrow_factor(const void* a, void* l, int n, int m,
                              const void* perm, int n_limbs,
                              const void* limbs, int s_lo, void* stream) {
  PackedPlan p;
  const size_t bytes = factor_plan(m, perm, n_limbs, limbs, s_lo, &p);
  if (n < 1 || bytes == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  factor_kernel<<<(n + kEnvs - 1) / kEnvs, kFactorThreads, bytes,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(l), p, n);
  return (int)cudaGetLastError();
}

// emloco_block_arrow_factor's launch for this block structure: shape[0]
// envs (= warps) a block, shape[1] threads a block, shape[2] dynamic shared
// memory a block in bytes. Returns 0, or cudaErrorInvalidValue where the
// factor would refuse it.
int emloco_block_arrow_factor_shape(int m, const void* perm, int n_limbs,
                                    const void* limbs, int s_lo,
                                    void* shape) {
  PackedPlan p;
  const size_t bytes = factor_plan(m, perm, n_limbs, limbs, s_lo, &p);
  if (bytes == 0) return (int)cudaErrorInvalidValue;
  int* const out = static_cast<int*>(shape);
  out[0] = kEnvs;
  out[1] = kFactorThreads;
  out[2] = (int)bytes;
  return 0;
}

// L (m, m, n) from emloco_block_arrow_factor, b (m, n) -> x (m, n);
// y (m, n) is scratch the caller allocates.
int emloco_block_arrow_resolve(const void* l, const void* b, void* x,
                               void* y, int n, int m, const void* perm,
                               int n_limbs, const void* limbs, int s_lo,
                               void* stream) {
  ArrowPlan p;
  if (n < 1 ||
      !emloco::make_plan(m, static_cast<const int*>(perm), n_limbs,
                         static_cast<const int*>(limbs), s_lo, &p))
    return (int)cudaErrorInvalidValue;
  resolve_kernel<<<emloco::blocks_for(n), emloco::kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(l), static_cast<const float*>(b),
      static_cast<float*>(x), static_cast<float*>(y), p, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
