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
// Layout, structure and numerics: see block_arrow.cuh. Both kernels run
// one warp per env with the env's packed triangle in shared memory: the
// factor packed_factor_warp, the resolve packed_solves_warp (the fused solve
// of block_arrow_solve.cu runs both, so it equals factor + resolve bit for
// bit).
//
// Bounds on the H100 (3.35 TB/s HBM, 67 TFLOP/s f32):
//   factor:  must read A's in-pattern lower triangle (1,437 floats) and
//            write the dense L (75*75 floats): 28 KB per env, 116 MB at
//            4,096 envs -> 0.035 ms. About 31k flops per env (127 MFLOP at
//            4,096 envs) are far below the compute roof, so bytes bound it.
//            Design: a block takes kArrowEnvs = 32 envs, one warp each (1,024
//            threads). It gathers its envs' in-pattern entries through
//            perm, once, 32 consecutive envs per element (128-byte loads,
//            kArrowLoads in flight a thread), into dynamic shared memory,
//            packed column by column (block_arrow.cuh): 32 * 1,437 * 4 =
//            183,936 bytes a block, one block an SM, 128 blocks for 4,096
//            envs, one wave. Each warp factors its env there in panels of
//            up to 8 columns of a limb, one lane per row below the panel
//            (at most 14 limb + 15 shared rows); then the block writes the
//            dense L, 128 bytes a warp store. A's lower entries outside the
//            pattern (1,413 floats, zero in the engine's matrices, which
//            the bound leaves out) are copied from A to L untouched, as the
//            plain version leaves them. No working copy in device memory.
//            ptxas (sm_90a): 51 registers, no spill.
//            What limits it now (PERF.md): instruction issue in the factor
//            in shared memory, with half the lanes idle on average in a
//            panel's triangular update; the gather's reads through perm;
//            the 5,625-float dense write.
//   resolve: must read the in-pattern lower triangle of L (1,437 floats)
//            and b, and write x: 6.3 KB per env, 26 MB at 4,096 envs ->
//            0.0078 ms; 2 * (2 * 1,362 + 75) flops per env, far below the
//            compute roof, so bytes bound it.
//            Design: solve_block<false> of block_arrow.cuh, the fused
//            solve's block without its factor: 32 envs a block, one warp
//            each; the block gathers L's in-pattern entries (L is in new
//            order: no perm) and b through perm into shared memory, each
//            warp runs the two sweeps there (packed_solves_warp: the
//            forward sweep a lane per row of a column, the backward sums on
//            one lane per shared column, then per limb column, then per
//            limb), the block writes x through perm, coalesced. Only L's
//            in-pattern entries are read, as the plain resolve and the
//            Pallas _triangular_solves read only those. 203,264 bytes of
//            dynamic shared memory a block, 128 blocks for 4,096 envs, one
//            wave; no scratch in device memory. ptxas (sm_90a): 32
//            registers, no spill.
//            What limits it now (PERF.md): the sweeps in shared memory, not
//            device memory (the gather's 26 MB take about a sixth of its
//            time at the card's rate): 75 forward column steps, each a
//            division on every lane and two warp syncs, with at most 29 of
//            the 32 lanes busy; the backward sums on one lane a column (the
//            shared block), then a lane a limb (5 of 32 busy).

#include "block_arrow.cuh"

namespace {

using emloco::kArrowEnvs;
using emloco::kArrowLoads;
using emloco::kArrowThreads;
using emloco::PackedPlan;

// The factor's plan: the packed triangles alone.
size_t factor_plan(int m, const void* perm, int n_limbs, const void* limbs,
                   int s_lo, PackedPlan* p) {
  return emloco::arrow_plan(m, perm, n_limbs, limbs, s_lo, 0, p);
}

__global__ void __launch_bounds__(kArrowThreads)
factor_kernel(const float* __restrict__ a, float* __restrict__ l,
              const PackedPlan p, const int n) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int m = p.m;
  const int e = blockIdx.x * kArrowEnvs + lane;     // this lane's env in I/O
  const size_t sn = (size_t)n;

  // A's in-pattern entries: warp w takes packed entries w, w+32, ...; lanes
  // the envs
  emloco::gather_packed<kArrowEnvs, kArrowThreads, kArrowLoads>(
      a, smem, p, blockIdx.x * kArrowEnvs, n);
  __syncthreads();

  if (blockIdx.x * kArrowEnvs + w < n)
    emloco::packed_factor_warp<1>(smem + w * p.stride, p, lane);
  __syncthreads();

  // the dense L: the factor in the pattern, A's other lower entries copied
  // through untouched (as the plain version leaves them), zero above the
  // diagonal; warp w takes entries w, w+32, ... of the m*m, kArrowLoads in
  // flight
  const float* const mine = smem + lane * p.stride;
  const int mm = m * m;
  for (int p0 = w; p0 < mm; p0 += kArrowLoads * kArrowEnvs) {
    float v[kArrowLoads];
#pragma unroll
    for (int q = 0; q < kArrowLoads; ++q) {
      const int idx = p0 + q * kArrowEnvs, i = idx / m, j = idx - i * m;
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
    for (int q = 0; q < kArrowLoads; ++q) {
      const int idx = p0 + q * kArrowEnvs;
      if (idx < mm && e < n) l[(size_t)idx * sn + e] = v[q];
    }
  }
}

__global__ void __launch_bounds__(kArrowThreads)
resolve_kernel(const float* __restrict__ l, const float* __restrict__ b,
               float* __restrict__ x, const PackedPlan p, const int n) {
  extern __shared__ float smem[];
  emloco::solve_block<false>(smem, l, b, x, p, n);
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
  factor_kernel<<<(n + kArrowEnvs - 1) / kArrowEnvs, kArrowThreads, bytes,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(l), p, n);
  return (int)cudaGetLastError();
}

// emloco_block_arrow_factor's launch for this block structure (see
// emloco::report_shape).
int emloco_block_arrow_factor_shape(int m, const void* perm, int n_limbs,
                                    const void* limbs, int s_lo,
                                    void* shape) {
  PackedPlan p;
  return emloco::report_shape(factor_plan(m, perm, n_limbs, limbs, s_lo, &p),
                              kArrowEnvs, kArrowThreads, shape);
}

// L (m, m, n) from emloco_block_arrow_factor, b (m, n) -> x (m, n). perm:
// m ints (host); limbs: n_limbs (lo, hi) pairs (host). Launches on
// `stream`, allocates nothing, returns cudaGetLastError()
// (cudaErrorInvalidValue for a block structure solve_plan refuses). Its
// launch is the fused solve's (emloco_block_arrow_solve_shape).
int emloco_block_arrow_resolve(const void* l, const void* b, void* x, int n,
                               int m, const void* perm, int n_limbs,
                               const void* limbs, int s_lo, void* stream) {
  PackedPlan p;
  const size_t bytes = emloco::solve_plan(m, perm, n_limbs, limbs, s_lo, &p);
  if (n < 1 || bytes == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      resolve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  resolve_kernel<<<(n + kArrowEnvs - 1) / kArrowEnvs,
                   kArrowThreads, bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(l), static_cast<const float*>(b),
      static_cast<float*>(x), p, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
