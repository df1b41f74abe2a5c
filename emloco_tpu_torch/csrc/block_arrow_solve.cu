// Fused block-arrow Cholesky solve and batch-major resolve for batched
// 75x75 SPD systems, one thread per env. Built with plain nvcc into the
// same shared library as block_arrow_cholesky.cu (see
// emloco_tpu_torch/build.py).
//
// Replaces two Pallas TPU kernels of emloco_tpu/physics/pallas_linalg.py:
//   emloco_block_arrow_solve      <- cholesky_solve_blocked_t
//       (_chol_solve_blocked_kernel: permute in, _factor_body,
//        _triangular_solves, permute out)
//   emloco_block_arrow_resolve_bm <- cholesky_resolve_blocked
//       (_chol_resolve_blocked_bm_kernel: env-last L, batch-major b and x)
//
// Both run the factor and the sweeps of block_arrow.cuh, the same code as
// the factor and resolve kernels, so the fused solve equals factor + resolve
// bit for bit and the batch-major resolve equals the env-last one
// transposed. The TPU kernel kept its factor in VMEM; here it goes to an
// (M, M, N) scratch in device memory that the wrapper allocates (on the
// TPU the fused kernel's point was one HBM read of A; on this first GPU
// design the factor's read-modify-writes go through L1/L2 as in the split
// kernels).
//
// Bounds on the H100 (3.35 TB/s HBM, 67 TFLOP/s f32), 4,096 envs:
//   solve:      must read A's in-pattern lower triangle (1,437 floats) and
//               b, and write x: 6.3 KB per env, 26 MB -> 0.0078 ms; the
//               factor's and sweeps' 37k flops per env (0.15 GFLOP) are
//               below the compute roof, so bytes bound it.
//   resolve_bm: as the env-last resolve, 26 MB -> 0.0078 ms. Thread e reads
//               b and writes x at e*M + i: a warp's 32 accesses to one
//               element are 300 bytes apart (uncoalesced, one sector each).
//               This first design does no staging through shared memory;
//               each env's 75 b values and 75 x values are touched once on
//               read and up to twice on write, so the cost is 150 sectors
//               per env against 1,437 coalesced reads of L.

#include "block_arrow.cuh"

namespace {

using emloco::ArrowPlan;
using emloco::EnvLastMat;
using emloco::EnvVec;

__global__ void __launch_bounds__(emloco::kThreads)
solve_kernel(const float* __restrict__ a, float* __restrict__ l,
             const float* __restrict__ b, float* __restrict__ x,
             float* __restrict__ y, const ArrowPlan p, const int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const size_t sn = (size_t)n;
  const EnvLastMat<float> L{l, p.m, sn, e};
  emloco::load_permuted(EnvLastMat<const float>{a, p.m, sn, e}, L, p);
  emloco::arrow_factor(L, p);
  emloco::arrow_solves(L, EnvVec<const float>{b, sn, (size_t)e},
                       EnvVec<float>{y, sn, (size_t)e},
                       EnvVec<float>{x, sn, (size_t)e}, p);
}

__global__ void __launch_bounds__(emloco::kThreads)
resolve_bm_kernel(const float* __restrict__ l, const float* __restrict__ b,
                  float* __restrict__ x, float* __restrict__ y,
                  const ArrowPlan p, const int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const size_t sn = (size_t)n;
  const size_t row = (size_t)e * p.m;
  emloco::arrow_solves(EnvLastMat<const float>{l, p.m, sn, e},
                       EnvVec<const float>{b, 1, row},
                       EnvVec<float>{y, sn, (size_t)e},
                       EnvVec<float>{x, 1, row}, p);
}

}  // namespace

extern "C" {

// A (m, m, n), b (m, n) -> x (m, n). l (m, m, n) and y (m, n) are scratch
// the caller allocates (l ends up holding the permuted factor). perm: m
// ints (host); limbs: n_limbs (lo, hi) pairs (host). Launches on `stream`,
// allocates nothing, returns cudaGetLastError().
int emloco_block_arrow_solve(const void* a, void* l, const void* b, void* x,
                             void* y, int n, int m, const void* perm,
                             int n_limbs, const void* limbs, int s_lo,
                             void* stream) {
  ArrowPlan p;
  if (n < 1 ||
      !emloco::make_plan(m, static_cast<const int*>(perm), n_limbs,
                         static_cast<const int*>(limbs), s_lo, &p))
    return (int)cudaErrorInvalidValue;
  solve_kernel<<<emloco::blocks_for(n), emloco::kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(l),
      static_cast<const float*>(b), static_cast<float*>(x),
      static_cast<float*>(y), p, n);
  return (int)cudaGetLastError();
}

// L (m, m, n) env-last from emloco_block_arrow_factor, b (n, m)
// batch-major -> x (n, m) batch-major; y (m, n) is scratch.
int emloco_block_arrow_resolve_bm(const void* l, const void* b, void* x,
                                  void* y, int n, int m, const void* perm,
                                  int n_limbs, const void* limbs, int s_lo,
                                  void* stream) {
  ArrowPlan p;
  if (n < 1 ||
      !emloco::make_plan(m, static_cast<const int*>(perm), n_limbs,
                         static_cast<const int*>(limbs), s_lo, &p))
    return (int)cudaErrorInvalidValue;
  resolve_bm_kernel<<<emloco::blocks_for(n), emloco::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(l), static_cast<const float*>(b),
      static_cast<float*>(x), static_cast<float*>(y), p, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
