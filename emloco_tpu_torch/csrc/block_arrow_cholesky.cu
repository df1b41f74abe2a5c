// Block-arrow Cholesky factor and resolve for batched 75x75 SPD systems,
// env-last layout, one thread per env. Built with plain nvcc into a shared
// library with a C interface (see emloco_tpu_torch/build.py).
//
// Replaces two Pallas TPU kernels of emloco_tpu/physics/pallas_linalg.py:
//   emloco_block_arrow_factor  <- cholesky_factor_blocked_t
//       (_chol_factor_blocked_kernel, _permute_matrix_in, _factor_body)
//   emloco_block_arrow_resolve <- cholesky_resolve_blocked_t
//       (_chol_resolve_blocked_kernel, _permute_vec_in/_out,
//        _triangular_solves)
//
// Layout, structure and numerics: see block_arrow.cuh, whose factor and
// sweeps both kernels call (as do the fused solve and the batch-major
// resolve of block_arrow_solve.cu).
//
// Bounds on the H100 (3.35 TB/s HBM, 67 TFLOP/s f32):
//   factor:  must read A's in-pattern lower triangle (1,437 floats) and
//            write the dense L (75*75 floats): 28 KB per env, 116 MB at
//            4,096 envs -> 0.035 ms. About 31k flops per env (127 MFLOP at
//            4,096 envs) are far below the compute roof, so bytes bound it.
//            This first design reads A's whole lower triangle (2,850
//            floats, out-of-pattern zeros included) and factors in place in
//            device memory: about 15k multiply-subtracts per env, each
//            reading two entries of L and writing one (178 KB per env, 6.3x
//            the minimum), go through L1/L2, and the lower triangle of L at
//            4,096 envs (46 MB) about fills the 50 MB L2.
//   resolve: reads the in-pattern lower triangle of L (1,437 floats = 5.7 KB
//            per env) plus b and x: 26 MB at 4,096 envs -> 0.008 ms; the two
//            sweeps keep y in a scratch vector the wrapper allocates and
//            write z straight into x at its un-permuted row.

#include "block_arrow.cuh"

namespace {

using emloco::ArrowPlan;
using emloco::EnvLastMat;
using emloco::EnvVec;

__global__ void __launch_bounds__(emloco::kThreads)
factor_kernel(const float* __restrict__ a, float* __restrict__ l,
              const ArrowPlan p, const int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const EnvLastMat<float> L{l, p.m, (size_t)n, e};
  emloco::load_permuted(EnvLastMat<const float>{a, p.m, (size_t)n, e}, L, p);
  emloco::arrow_factor(L, p);
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
// `stream`, allocates nothing, returns cudaGetLastError().
int emloco_block_arrow_factor(const void* a, void* l, int n, int m,
                              const void* perm, int n_limbs,
                              const void* limbs, int s_lo, void* stream) {
  ArrowPlan p;
  if (n < 1 ||
      !emloco::make_plan(m, static_cast<const int*>(perm), n_limbs,
                         static_cast<const int*>(limbs), s_lo, &p))
    return (int)cudaErrorInvalidValue;
  factor_kernel<<<emloco::blocks_for(n), emloco::kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(l), p, n);
  return (int)cudaGetLastError();
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
