// Fused block-arrow Cholesky solve and batch-major resolve for batched
// 75x75 SPD systems. Built with plain nvcc into the same shared library as
// block_arrow_cholesky.cu (see emloco_tpu_torch/build.py).
//
// Replaces two Pallas TPU kernels of emloco_tpu/physics/pallas_linalg.py:
//   emloco_block_arrow_solve      <- cholesky_solve_blocked_t
//       (_chol_solve_blocked_kernel: permute in, _factor_body,
//        _triangular_solves, permute out)
//   emloco_block_arrow_resolve_bm <- cholesky_resolve_blocked
//       (_chol_resolve_blocked_bm_kernel: env-last L, batch-major b and x)
//
// Bounds on the H100 (3.35 TB/s HBM, 67 TFLOP/s f32), 4,096 envs:
//   solve:      must read A's in-pattern lower triangle (1,437 floats) and
//               b, and write x: 6.3 KB per env, 26 MB -> 0.0078 ms; the
//               factor's and sweeps' 37k flops per env (0.15 GFLOP) are
//               below the compute roof, so bytes bound it.
//               Design: the TPU kernel kept its factor in VMEM; this one
//               keeps it in shared memory (solve_block<true> of
//               block_arrow.cuh). A block takes 32 envs, one warp each
//               (1,024 threads); it gathers their in-pattern entries of A
//               through perm (the factor's gather_packed, 128-byte loads, 8
//               in flight a thread) and b through perm; each warp factors
//               its env with packed_factor_warp, the factor kernel's code,
//               then runs packed_solves_warp, the resolve's code, so the
//               fused solve equals factor + resolve bit for bit; the block
//               writes x through perm, coalesced. 32 * (1,437 + 151) * 4 =
//               203,264 bytes of dynamic shared memory a block, one block an
//               SM, 128 blocks for 4,096 envs, one wave. No scratch in device
//               memory, and no dense factor written. ptxas (sm_90a): 54
//               registers, no spill.
//               What limits it now (PERF.md): instruction issue in the factor
//               in shared memory, as in the factor kernel (the fused solve
//               takes less than the factor kernel, which also writes the
//               dense L); then the sweeps' dependent chains, as in the
//               resolve. How the time splits between the parts is not
//               measured.
//   resolve_bm: as the env-last resolve, 26 MB -> 0.0078 ms.
//               Design: solve_block<false, true>, the env-last resolve's
//               block (block_arrow_cholesky.cu) with batch-major b and x: a
//               block's 32 envs of b are 32 * 75 contiguous floats, read by
//               consecutive threads at consecutive addresses and placed in
//               shared memory at each element's new index (PackedPlan's
//               inverse permutation); x is written back the same way. The
//               gather of L and the sweeps (packed_solves_warp) are the
//               env-last resolve's, so the two agree to the bit. The same
//               plan and launch: 203,264 bytes of dynamic shared memory a
//               block, 128 blocks for 4,096 envs, one wave.
//               What held the first design back (one thread per env): L read
//               from device memory by every thread, b and x at e*M + i (a
//               warp's 32 accesses to one element 300 bytes apart, one
//               sector each), and a scratch vector in device memory.

#include "block_arrow.cuh"

namespace {

using emloco::PackedPlan;

__global__ void __launch_bounds__(emloco::kArrowThreads)
solve_kernel(const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ x, const PackedPlan p, const int n) {
  extern __shared__ float smem[];
  emloco::solve_block<true>(smem, a, b, x, p, n);
}

__global__ void __launch_bounds__(emloco::kArrowThreads)
resolve_bm_kernel(const float* __restrict__ l, const float* __restrict__ b,
                  float* __restrict__ x, const PackedPlan p, const int n) {
  extern __shared__ float smem[];
  emloco::solve_block<false, true>(smem, l, b, x, p, n);
}

}  // namespace

extern "C" {

// A (m, m, n), b (m, n) -> x (m, n). perm: m ints (host); limbs: n_limbs
// (lo, hi) pairs (host). Launches on `stream`, allocates nothing, returns
// cudaGetLastError() (cudaErrorInvalidValue for a block structure
// solve_plan refuses).
int emloco_block_arrow_solve(const void* a, const void* b, void* x, int n,
                             int m, const void* perm, int n_limbs,
                             const void* limbs, int s_lo, void* stream) {
  PackedPlan p;
  const size_t bytes = emloco::solve_plan(m, perm, n_limbs, limbs, s_lo, &p);
  if (n < 1 || bytes == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  solve_kernel<<<(n + emloco::kArrowEnvs - 1) / emloco::kArrowEnvs,
                 emloco::kArrowThreads, bytes,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(x), p, n);
  return (int)cudaGetLastError();
}

// emloco_block_arrow_solve's launch for this block structure, and that of
// emloco_block_arrow_resolve and emloco_block_arrow_resolve_bm, which have
// the same plan (see emloco::report_shape).
int emloco_block_arrow_solve_shape(int m, const void* perm, int n_limbs,
                                   const void* limbs, int s_lo, void* shape) {
  PackedPlan p;
  return emloco::report_shape(
      emloco::solve_plan(m, perm, n_limbs, limbs, s_lo, &p),
      emloco::kArrowEnvs, emloco::kArrowThreads, shape);
}

// L (m, m, n) env-last from emloco_block_arrow_factor, b (n, m)
// batch-major -> x (n, m) batch-major; the arguments otherwise as
// emloco_block_arrow_solve's, and its launch (solve_plan).
int emloco_block_arrow_resolve_bm(const void* l, const void* b, void* x,
                                  int n, int m, const void* perm,
                                  int n_limbs, const void* limbs, int s_lo,
                                  void* stream) {
  PackedPlan p;
  const size_t bytes = emloco::solve_plan(m, perm, n_limbs, limbs, s_lo, &p);
  if (n < 1 || bytes == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      resolve_bm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  resolve_bm_kernel<<<(n + emloco::kArrowEnvs - 1) / emloco::kArrowEnvs,
                      emloco::kArrowThreads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(l), static_cast<const float*>(b),
      static_cast<float*>(x), p, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
