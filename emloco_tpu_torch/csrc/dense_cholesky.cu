// Dense Cholesky solve for batched SPD systems, env-last layout, one warp
// per env with the env's matrix in shared memory. Built with plain nvcc into
// the same shared library as the block-arrow kernels (see
// emloco_tpu_torch/build.py).
//
// Replaces the Pallas TPU kernel of emloco_tpu/physics/pallas_linalg.py
//   emloco_dense_cholesky_solve <- cholesky_solve_soa_t (_chol_solve_kernel)
// a right-looking Cholesky whose step k updates the trailing (M-k-1)^2 block
// only, then the forward and backward triangular solves.
//
// Layout: A is (M, M, N) and b, x are (M, N), env axis last, so element
// (i, j) of consecutive envs is contiguous.
//
// Bounds on the H100 (3.35 TB/s HBM, 67 TFLOP/s f32), M = 75, 4,096 envs:
// must read A's lower triangle (2,850 floats) and b, and write x: 12 KB per
// env, 49 MB -> 0.015 ms; the factor's ~M^3/3 and the solves' 2*M^2 flops
// (155k per env, 0.63 GFLOP) take 0.0095 ms, so bytes bound it.
//
// Design. A block takes kEnvs = 16 envs, one warp each (512 threads). The
// block reads its envs' lower triangles once, coalesced across the envs (16
// consecutive floats per element, kLoads loads in flight a thread), into
// dynamic shared memory: per env the triangle packed column by column as
// block_arrow.cuh's factor in shared memory packs a block-arrow one with no
// limbs (column j holds rows j..M-1 from off[j]), padded to an odd stride,
// then b. At M = 75 that is 16 * (2,851 + 75) * 4 = 187,264 bytes a block,
// one block an SM; 4,096 envs make 256 blocks, two waves on 132 SMs. Each
// warp factors its env there with that factor (packed_factor_warp), three
// rows a lane, in panels of 8, 4, 2 or 1 columns. The forward
// sweep pushes each solved y_k into the later rows' sums held by their
// lanes; the backward sweep runs one lane per env (4 lanes in each of 4
// warps), its sums read from shared memory; x is written back coalesced.
// No scratch in device memory. ptxas (sm_90a): 64 registers, no spill.
// What limits it now (PERF.md): instruction issue in the factor's trailing
// updates (lanes past a column's last row idle, index and predicate work
// beside each multiply-subtract); the backward sweep's serial sums; the
// second wave.
//
// Numerics. The operations of the plain PyTorch version
// (emloco_tpu_torch/physics/linalg.py solve_soa_plain) in the same order:
// pivots clamped to 1e-12 before sqrt (NaN passes through), each element's
// update w[i,j] -= c_i*c_j once per column in ascending k, the forward sums
// per row in ascending j from 0, the backward dot products in row order.
// The TPU kernel updates the full square trailing block; this one updates
// its lower triangle only, which is all the solves read.

#include "block_arrow.cuh"

namespace {

using emloco::PackedPlan;

constexpr int kEnvs = 16;                 // envs (= warps) per block
constexpr int kThreads = 32 * kEnvs;
constexpr int kSlots = 3;                 // rows per lane in a column step
constexpr int kLoads = 8;                 // global loads in flight a thread
constexpr int kBackLanes = 4;             // backward sweep: lanes a warp

// The plan for m (no limbs, identity perm) and its dynamic shared memory a
// block, in bytes: kEnvs triangles at an odd stride, then their vectors; 0
// if the kernel cannot take m (more than 32 * kSlots rows below a pivot, or
// past a block's shared memory: m > 83).
size_t dense_plan(int m, PackedPlan* p) {
  if (!emloco::make_packed_plan(m, nullptr, 0, nullptr, 0, 32 * kSlots, p))
    return 0;
  const size_t bytes = sizeof(float) * kEnvs * (p->stride + m);
  return bytes <= (size_t)emloco::kMaxSmem ? bytes : 0;
}

__global__ void __launch_bounds__(kThreads)
dense_solve_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ x, const PackedPlan p, const int n) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * kEnvs;
  const int m = p.m;
  const size_t sn = (size_t)n;
  float* const vecs = smem + kEnvs * p.stride;    // b, then y, then x

  emloco::gather_packed<kEnvs, kThreads, kLoads>(a, smem, p, e0, n);
  for (int idx = tid; idx < m * kEnvs; idx += kThreads) {
    const int el = idx % kEnvs, i = idx / kEnvs, e = e0 + el;
    if (e < n) vecs[el * m + i] = b[(size_t)i * sn + e];
  }
  __syncthreads();

  const int lane = tid & 31, w = tid >> 5;
  if (e0 + w < n) {
    float* const L = smem + w * p.stride;
    float* const v = vecs + w * m;
    emloco::packed_factor_warp<kSlots>(L, p, lane);

    // forward L y = b: y_k pushed into the later rows' sums, which start
    // at 0 and take the y_j in ascending j
    float acc[kSlots];
#pragma unroll
    for (int q = 0; q < kSlots; ++q) acc[q] = 0.0f;
    for (int k = 0; k < m; ++k) {
      const int base = p.off[k];
#pragma unroll
      for (int q = 0; q < kSlots; ++q)
        if (lane + 32 * q == k) v[k] = (v[k] - acc[q]) / L[base];
      __syncwarp();
      const float yk = v[k];
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        const int r = lane + 32 * q;
        if (r > k && r < m) acc[q] = acc[q] + L[base + r - k] * yk;
      }
    }
  }
  __syncthreads();

  // backward Lᵀ x = y, one lane per env (kBackLanes lanes in each of the
  // first warps): column k below the diagonal, row order
  {
    const int el = w * kBackLanes + lane;
    if (lane < kBackLanes && el < kEnvs && e0 + el < n) {
      const float* const L = smem + el * p.stride;
      float* const v = vecs + el * m;
      for (int k = m - 1; k >= 0; --k) {
        const float* const col = L + p.off[k] - k;
        float sum = 0.0f;
#pragma unroll 4
        for (int i = k + 1; i < m; ++i) sum = sum + col[i] * v[i];
        v[k] = (v[k] - sum) / col[k];
      }
    }
  }
  __syncthreads();

  for (int idx = tid; idx < m * kEnvs; idx += kThreads) {
    const int el = idx % kEnvs, i = idx / kEnvs, e = e0 + el;
    if (e < n) x[(size_t)i * sn + e] = vecs[el * m + i];
  }
}

}  // namespace

extern "C" {

// A (m, m, n), b (m, n) -> x (m, n). Launches on `stream`, allocates
// nothing, returns cudaGetLastError() (cudaErrorInvalidValue for an m
// dense_plan refuses).
int emloco_dense_cholesky_solve(const void* a, const void* b, void* x, int n,
                                int m, void* stream) {
  PackedPlan p;
  const size_t bytes = dense_plan(m, &p);
  if (n < 1 || bytes == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dense_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dense_solve_kernel<<<(n + kEnvs - 1) / kEnvs, kThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(x), p, n);
  return (int)cudaGetLastError();
}

// emloco_dense_cholesky_solve's launch for m (see emloco::report_shape).
int emloco_dense_cholesky_shape(int m, void* shape) {
  PackedPlan p;
  return emloco::report_shape(dense_plan(m, &p), kEnvs, kThreads, shape);
}

}  // extern "C"
