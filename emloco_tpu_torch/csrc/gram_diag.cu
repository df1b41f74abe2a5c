// Batched weighted Gram + diagonal, batch-major, built with plain nvcc into
// the same shared library as the solver kernels (see
// emloco_tpu_torch/build.py).
//
// Replaces the Pallas TPU kernel of emloco_tpu/physics/pallas_linalg.py
//   emloco_gram_diag <- gram_diag (_gram_diag_kernel)
// which forms, per env n, At[n, :C] = R[n]^T (w[n] o R[n]) + diag(d[n]) for
// R (N, M, C) and w (N, M) in the row dtype (bf16 or float32), d (N, C) and
// At (N, C', C) float32, rows C..C'-1 (the to_env_last staging pad) left
// unwritten. The engine calls it with M = 256 merged Jacobian rows and
// C = 75 generalized velocities.
//
// Numerics, shared with gram_diag_plain in physics/linalg.py:
//   rw[m, c]  = float(R[m, c]) * float(w[m]), one float32 product (exact
//               for bf16 rows: two 8-bit significands);
//   acc[c, d] = sum over m = 0, 1, ..., M-1 of rw[m, c] * float(R[m, d]),
//               in float32, in ascending m;
//   At[c, d]  = acc[c, d] + (c == d ? d[c] : 0).
// The library is built with -fmad=false, so float32 rows take one rounded
// product and one rounded sum per term, as the plain version does. For bf16
// rows the term rw * R has at most 16 + 8 significant bits and is exact in
// float32, so a fused multiply-add rounds once, exactly where the product
// and the sum do: the bf16 instantiation uses fmaf at half the
// instructions, with the same bits.
//
// Design. One block of 256 threads per env (4,096 blocks at 4,096 envs, all
// 132 SMs busy). The C x C output is cut into 5 x 5 tiles, one per thread
// (15 x 15 = 225 threads at C = 75; C <= 80), each tile's 25 sums in
// registers. R streams through shared memory 32 rows at a time, as float32
// rows and as w o R rows, with contiguous element loads (a 75-element bf16
// row is not 16-byte aligned); each thread then reads 5 + 5 values per row
// for 25 multiply-adds. Every entry is computed: the sum for (c, d) is not
// mirrored from (d, c).
//
// Bound on the H100 at 4,096 envs, M = 256, C = 75, bf16 rows: reading R,
// w and d once and writing the 75 x 75 float32 sums once moves 253 MB ->
// 0.076 ms at 3.35 TB/s; the 2 * 256 * 75^2 * 4,096 = 11.8 GFLOP are bf16
// products with float32 sums, 0.012 ms at the tensor cores' 989 TFLOP/s. So
// bytes bound it. This first design runs on the CUDA cores (67 TFLOP/s
// float32, about 0.18 ms for these flops) and issues two shared-memory
// loads for every 2.5 multiply-adds, so it sits well above the bound; a
// tensor-core design sums in another order and is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 5;     // outputs per thread: kTile x kTile
constexpr int kMaxC = 80;    // (kMaxC / kTile)^2 = 256 thread tiles
constexpr int kChunk = 32;   // rows of R staged in shared memory at a time

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// acc + a * b, rounded as gram_diag_plain rounds it (see the head note)
template <typename T>
__device__ __forceinline__ float mac(float acc, float a, float b) {
  if constexpr (std::is_same<T, float>::value)
    return __fadd_rn(acc, __fmul_rn(a, b));
  else
    return __fmaf_rn(a, b, acc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_diag_kernel(const T* __restrict__ r, const T* __restrict__ w,
                 const float* __restrict__ dg, float* __restrict__ out,
                 const int m_rows, const int c, const int out_rows) {
  __shared__ float rw_s[kChunk][kMaxC];
  __shared__ float r_s[kChunk][kMaxC];
  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  const int tiles = (c + kTile - 1) / kTile;
  const bool owner = tid < tiles * tiles;
  const int c0 = (tid / tiles) * kTile;
  const int d0 = (tid % tiles) * kTile;
  const T* re = r + (size_t)e * m_rows * c;
  const T* we = w + (size_t)e * m_rows;

  float acc[kTile][kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[i][j] = 0.0f;

  for (int m0 = 0; m0 < m_rows; m0 += kChunk) {
    const int km = min(kChunk, m_rows - m0);
    // rows m0..m0+km-1 are km * c contiguous elements; columns c..kMaxC-1
    // of the staging arrays are read only for outputs that are not written
    for (int i = tid; i < km * c; i += kThreads) {
      const int mm = i / c, cc = i - mm * c;
      const float rv = to_f32(re[(size_t)m0 * c + i]);
      r_s[mm][cc] = rv;
      rw_s[mm][cc] = __fmul_rn(rv, to_f32(we[m0 + mm]));
    }
    __syncthreads();
    if (owner) {
      for (int mm = 0; mm < km; ++mm) {
        float a[kTile], b[kTile];
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
          a[i] = rw_s[mm][c0 + i];
          b[i] = r_s[mm][d0 + i];
        }
#pragma unroll
        for (int i = 0; i < kTile; ++i)
#pragma unroll
          for (int j = 0; j < kTile; ++j)
            acc[i][j] = mac<T>(acc[i][j], a[i], b[j]);
      }
    }
    __syncthreads();
  }
  if (!owner) return;
  float* oe = out + (size_t)e * out_rows * c;
  const float* de = dg + (size_t)e * c;
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    const int row = c0 + i;
    if (row >= c) continue;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int col = d0 + j;
      if (col < c)
        oe[(size_t)row * c + col] =
            __fadd_rn(acc[i][j], row == col ? de[row] : 0.0f);
    }
  }
}

}  // namespace

extern "C" {

// r (n, m, c) and w (n, m) bf16 when rows_bf16 else float32, d (n, c)
// float32 -> out (n, out_rows, c) float32, rows c..out_rows-1 untouched;
// 1 <= c <= 80 and out_rows >= c. Launches on `stream`, allocates
// nothing, returns cudaGetLastError().
int emloco_gram_diag(const void* r, const void* w, const void* d, void* out,
                     int n, int m, int c, int out_rows, int rows_bf16,
                     void* stream) {
  if (n < 1 || m < 1 || c < 1 || c > kMaxC || out_rows < c)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows_bf16)
    gram_diag_kernel<__nv_bfloat16><<<n, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(r),
        static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(d),
        static_cast<float*>(out), m, c, out_rows);
  else
    gram_diag_kernel<float><<<n, kThreads, 0, s>>>(
        static_cast<const float*>(r), static_cast<const float*>(w),
        static_cast<const float*>(d), static_cast<float*>(out), m, c,
        out_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
