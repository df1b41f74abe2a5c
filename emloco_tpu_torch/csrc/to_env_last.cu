// Batch-major -> env-last relayout with a row crop, built with plain nvcc
// into the same shared library as the solver kernels (see
// emloco_tpu_torch/build.py).
//
// Replaces the Pallas TPU kernel of emloco_tpu/physics/pallas_linalg.py
//   emloco_to_env_last <- to_env_last (_to_env_last_kernel)
// which moves A (N, X, Y) to (X', Y, N), X' = out_rows <= X. The TPU kernel
// pads X to a multiple of 16 for its (8, 128) tiling and crops after; rows
// X'..X-1 are never read here, so no padding is needed.
//
// Design. Seen as matrices, the input is (N, K) with K = X*Y and the output
// (K', N) with K' = X'*Y, the first K' columns of each input row: a 2-D
// transpose. Each block moves one 32x32 tile through shared memory padded
// by one column (so the transposed read hits 32 distinct banks): the read
// is coalesced along K, the write along N.
//
// Bound on the H100 (3.35 TB/s HBM): reads and writes K'*N floats; at
// (4,096, 75, 75) that is 2 * 5,625 * 4 * 4,096 = 184 MB -> 0.055 ms. No
// arithmetic.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;   // threads per block: kTile x kRows

__global__ void __launch_bounds__(kTile * kRows)
to_env_last_kernel(const float* __restrict__ a, float* __restrict__ out,
                   const int n, const int k_in, const int k_out) {
  __shared__ float tile[kTile][kTile + 1];
  const int e0 = blockIdx.x * kTile;
  const int c0 = blockIdx.y * kTile;
  for (int r = threadIdx.y; r < kTile; r += kRows) {
    const int e = e0 + r, c = c0 + threadIdx.x;
    if (e < n && c < k_out) tile[r][threadIdx.x] = a[(size_t)e * k_in + c];
  }
  __syncthreads();
  for (int r = threadIdx.y; r < kTile; r += kRows) {
    const int c = c0 + r, e = e0 + threadIdx.x;
    if (c < k_out && e < n) out[(size_t)c * n + e] = tile[threadIdx.x][r];
  }
}

}  // namespace

extern "C" {

// a (n, k_in) -> out (k_out, n) with out[c, e] = a[e, c], c < k_out <= k_in.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
int emloco_to_env_last(const void* a, void* out, int n, int k_in, int k_out,
                       void* stream) {
  const int tiles_k = (k_out + kTile - 1) / kTile;
  if (n < 1 || k_out < 1 || k_out > k_in || tiles_k > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kTile - 1) / kTile, tiles_k);
  to_env_last_kernel<<<grid, dim3(kTile, kRows), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(out), n, k_in,
      k_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
