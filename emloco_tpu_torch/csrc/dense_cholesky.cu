// Dense Cholesky solve for batched SPD systems, env-last layout, one thread
// per env. Built with plain nvcc into the same shared library as the
// block-arrow kernels (see emloco_tpu_torch/build.py).
//
// Replaces the Pallas TPU kernel of emloco_tpu/physics/pallas_linalg.py
//   emloco_dense_cholesky_solve <- cholesky_solve_soa_t (_chol_solve_kernel)
// a right-looking Cholesky whose step k updates the trailing (M-k-1)^2 block
// only, then the forward and backward triangular solves.
//
// Layout as in block_arrow.cuh: A and the scratch W are (M, M, N), b and x
// (M, N), env axis last, so a warp's 32 loads of one element are 128
// contiguous bytes.
//
// Numerics. The operations of the plain PyTorch version
// (emloco_tpu_torch/physics/linalg.py solve_soa_plain) in the same order:
// pivots clamped to 1e-12 before sqrt (NaN passes through), the trailing
// update w[i,j] -= c_i*c_j, the dot products summed in row order. The TPU
// kernel updates the full square trailing block; this one updates its lower
// triangle only, which is all the solves read, so the result is the same.
// y lives in x: the backward sweep reads y[k] before it overwrites x[k].
//
// Bounds on the H100 (3.35 TB/s HBM, 67 TFLOP/s f32), M = 75, 4,096 envs:
// must read A's lower triangle (2,850 floats) and b, and write x: 12 KB per
// env, 49 MB -> 0.015 ms; the factor's ~M^3/3 and the solves' 2*M^2
// flops (155k per env, 0.63 GFLOP) take 0.0095 ms, so bytes bound it. This
// first design factors in place in the scratch W in device memory: about
// 70k read-modify-writes per env go through L1/L2, and W's lower triangle
// (47 MB at 4,096 envs) about fills the 50 MB L2.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float clamp_pivot(float d) {
  return d < 1e-12f ? 1e-12f : d;   // NaN compares false and passes through
}

__global__ void __launch_bounds__(kThreads)
dense_solve_kernel(const float* __restrict__ a, float* __restrict__ w,
                   const float* __restrict__ b, float* __restrict__ x,
                   const int m, const int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const size_t sn = (size_t)n;
#define A_(i, j) a[((size_t)(i) * m + (j)) * sn + e]
#define W_(i, j) w[((size_t)(i) * m + (j)) * sn + e]
#define B_(i) b[(size_t)(i) * sn + e]
#define X_(i) x[(size_t)(i) * sn + e]

  for (int i = 0; i < m; ++i)
    for (int j = 0; j <= i; ++j) W_(i, j) = A_(i, j);

  for (int k = 0; k < m; ++k) {
    const float s = sqrtf(clamp_pivot(W_(k, k)));
    W_(k, k) = s;
    for (int i = k + 1; i < m; ++i) W_(i, k) = W_(i, k) / s;
    for (int i = k + 1; i < m; ++i) {
      const float ci = W_(i, k);
      for (int j = k + 1; j <= i; ++j) W_(i, j) = W_(i, j) - ci * W_(j, k);
    }
  }

  // forward L y = b, row k against the finished y[:k]
  for (int k = 0; k < m; ++k) {
    float acc = 0.0f;
    for (int j = 0; j < k; ++j) acc = acc + W_(k, j) * X_(j);
    X_(k) = (B_(k) - acc) / W_(k, k);
  }
  // backward Lᵀ x = y, column k below the diagonal
  for (int k = m - 1; k >= 0; --k) {
    float acc = 0.0f;
    for (int i = k + 1; i < m; ++i) acc = acc + W_(i, k) * X_(i);
    X_(k) = (X_(k) - acc) / W_(k, k);
  }
#undef A_
#undef W_
#undef B_
#undef X_
}

}  // namespace

extern "C" {

// A (m, m, n), b (m, n) -> x (m, n); w (m, m, n) is scratch the caller
// allocates (its lower triangle ends up holding L). Launches on `stream`,
// allocates nothing, returns cudaGetLastError().
int emloco_dense_cholesky_solve(const void* a, void* w, const void* b,
                                void* x, int n, int m, void* stream) {
  if (n < 1 || m < 1) return (int)cudaErrorInvalidValue;
  dense_solve_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(w),
      static_cast<const float*>(b), static_cast<float*>(x), m, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
