// Batched Gram of two bf16 operands on the tensor cores, built with plain nvcc
// into the same shared library as the other kernels (see
// emloco_tpu_torch/build.py).
//
// Replaces the two Pallas TPU kernels of scripts/gram_kernel_probe.py
//   emloco_gram_dual         <- gram_dual (:63, _dual_kernel)
//   emloco_gram_dual_batched <- gram_dual_batched (:97, _dual_batched_kernel)
// which form, per env n, out[n] = Rt[n] R[n] + diag(d[n]) for Rt (N, C, M)
// = (w o R)^T pre-transposed and R (N, M, C) in bf16, d (N, C) and out
// (N, C, C) float32, blocks of `block_envs` envs per grid step. They probe
// the operand layouts of a matrix-unit design of gram_diag; the probe runs
// them at N = 4,096 envs, M = 304 rows and C = 75 columns.
//
// Numerics. Every product of two bf16 values is exact in float32; the sums
// run on the tensor cores, mma.sync m16n8k16 with float32 accumulators, one
// k16 step after another in ascending m. Within a step the tensor core sums
// in its own order, so the result is not gram_dual_plain's bits: it lies
// within a few float32 roundings of the M-term sum (chip_smoke.py holds it to
// 2^-13 of the sum of |products| per entry). Both kernels call the same
// device function for one env's 16-row tile and one k16 step, over the same
// steps in the same order, so they give the same bits as each other. The
// diagonal is added in the epilogue with one rounded float32 add.
//
// Operands. A = Rt[n] (c, m) is row-major with k = m contiguous: the native
// operand of the row-major A fragment, which plain ldmatrix feeds (the TPU
// probe's "native AB" form). With M a multiple of 8 its rows are 16-byte
// aligned (608 bytes at M = 304) and go to shared memory as 16-byte vectors.
// B = R[n] (m, c) has c contiguous, so the col-major B fragment needs
// ldmatrix.trans over rows of c, and those rows are 150 bytes long, not
// 16-byte aligned. An env's R block (M x C bf16, 45,600 bytes at M = 304) is
// read as 16-byte vectors of the flat block and restaged in shared memory
// with a row stride of 88 bf16 (176 bytes: 16-byte aligned, an odd number of
// 16-byte units, so the 8 rows of one ldmatrix phase hit distinct banks),
// columns C..79 zero. That restaging is the Hopper form of the transpose the
// TPU probe measured against Mosaic's. A's shared rows take a stride of
// KC + 8 bf16 for the same reason. M streams through shared memory in chunks
// of KC rows (a multiple of 16); a partial last k16 step is zero-filled in
// both operands.
//
// Design. gram_dual, the TPU kernel's loop of per-env dots: one CTA per
// block of envs, 5 warps, warp w owning output rows 16w..16w+15 and all 10
// n8 column tiles (40 float32 accumulators a thread), the block's envs one
// after another. gram_dual_batched, the TPU's one batched dot per block: one
// CTA per block, one warp per env, all the block's envs in flight together.
// A warp cannot keep an env's whole 80 x 80 sum in registers (200 floats a
// thread), so it makes 5 passes, one 16-row tile each, and each pass streams
// all of M again: B is read from device memory (or L2) 5 times.
//
// Bound on the H100 at the probe's shapes (4,096 envs, M = 304, C = 75):
// reading Rt and R in bf16 (373.6 MB) and d (1.2 MB) and writing the 75 x 75
// float32 output (92.2 MB) moves 466.9 MB -> 0.139 ms at 3.35 TB/s; the
// 2 * 304 * 75^2 * 4,096 = 14.0 GFLOP take 0.0142 ms at 989 TFLOP/s bf16.
// So bytes bound both. This first design keeps one chunk in shared memory at
// a time (a barrier before and after each), with no copy in flight while the
// tensor cores work; gram_dual_batched also reads B 5 times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxC = 80;            // 5 m16 row tiles x 10 n8 column tiles
constexpr int kRowTiles = kMaxC / 16;
constexpr int kColTiles = kMaxC / 8;
constexpr int kSB = 88;              // shared row stride of B, bf16
constexpr int kDualWarps = kRowTiles;
constexpr int kDualKc = 64;          // rows of M per chunk in gram_dual
constexpr int kMaxBatchEnvs = 32;    // one warp per env, 1,024 threads

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One env's 16-row tile, one k16 step: acc[j] (output columns 8j..8j+7) +=
// A[16 x 16] B[16 x 8j..8j+7]. `a` points at the tile's first row and the
// step's first k in shared memory (row stride `sa`), `b` at the step's first
// k row (stride kSB). Shared by both kernels, so both sum alike.
__device__ __forceinline__ void row_tile_k16(float (&acc)[kColTiles][4],
                                             const bf16* a, int sa,
                                             const bf16* b, int lane) {
  // lanes 0-15: rows 0-15 at k 0; lanes 16-31: rows 0-15 at k 8 ->
  // a0..a3 = (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
  uint32_t af[4];
  ldsm_x4(af, a + (lane & 15) * sa + (lane >> 4) * 8);
#pragma unroll
  for (int j = 0; j < kColTiles / 2; ++j) {
    // transposed: lanes 0-15 k rows 0-15 at columns 16j, lanes 16-31 at
    // 16j + 8 -> b0, b1 of column tile 2j, then of 2j + 1
    uint32_t bfr[4];
    ldsm_x4_trans(bfr, b + (lane & 15) * kSB + j * 16 + (lane >> 4) * 8);
    mma_bf16(acc[2 * j], af, bfr[0], bfr[1]);
    mma_bf16(acc[2 * j + 1], af, bfr[2], bfr[3]);
  }
}

// Rows row0..row0+rows-1 of Rt[e], k = m0..m0+kc16-1, for `envs` envs from
// `rt` on: into dst + env * env_stride + row * sa + k, zero where the row is
// at or past c or k at or past kc (kc16 = kc rounded up to 16). Eight k at a
// time: one 16-byte load when `vec` (rows 16-byte aligned) and all eight lie
// inside.
__device__ __forceinline__ void load_a(bf16* dst, int sa, int env_stride,
                                       const bf16* __restrict__ rt, int envs,
                                       int m, int c, int row0, int rows,
                                       int m0, int kc, bool vec, int tid,
                                       int nthr) {
  const int kc16 = (kc + 15) & ~15;
  const int groups = kc16 / 8;
  const int per_env = rows * groups;
  for (int i = tid; i < envs * per_env; i += nthr) {
    const int e = i / per_env;
    const int rr = (i - e * per_env) / groups;
    const int k = (i - e * per_env - rr * groups) * 8;
    const int row = row0 + rr;
    bf16* out = dst + e * env_stride + rr * sa + k;
    const bf16* src = rt + ((size_t)e * c + row) * m + m0 + k;
    if (row < c && vec && k + 8 <= kc) {
      *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        out[q] = (row < c && k + q < kc) ? src[q] : __float2bfloat16(0.0f);
    }
  }
}

// Rows m0..m0+kc-1 of R[e] (M x C, c contiguous), for `envs` envs from `r`
// on: into dst + env * env_stride + k * kSB + col, columns c..kMaxC-1 and
// rows kc..kc16-1 zero. The chunk is kc * c contiguous elements of the env's
// flat block; with `vec` (the env blocks and the chunk 16-byte aligned) it
// is read as 16-byte vectors, each scattered over the rows it spans.
__device__ __forceinline__ void load_b(bf16* dst, int env_stride,
                                       const bf16* __restrict__ r, int envs,
                                       int m, int c, int m0, int kc, bool vec,
                                       int tid, int nthr) {
  const int kc16 = (kc + 15) & ~15;
  const int flat = kc * c;
  if (vec) {
    const int nv = flat / 8;
    for (int i = tid; i < envs * nv; i += nthr) {
      const int e = i / nv;
      const int v = i - e * nv;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          r + (size_t)e * m * c + (size_t)m0 * c + v * 8);
      const bf16* x = reinterpret_cast<const bf16*>(&raw);
      int k = (v * 8) / c;
      int col = v * 8 - k * c;
      bf16* out = dst + e * env_stride;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        out[k * kSB + col] = x[q];
        if (++col == c) {
          col = 0;
          ++k;
        }
      }
    }
  } else {
    for (int i = tid; i < envs * flat; i += nthr) {
      const int e = i / flat;
      const int f = i - e * flat;
      const int k = f / c;
      dst[e * env_stride + k * kSB + (f - k * c)] =
          r[(size_t)e * m * c + (size_t)m0 * c + f];
    }
  }
  // zero pad: columns c..kMaxC-1 of rows 0..kc16-1, then columns 0..c-1 of
  // rows kc..kc16-1
  const int pad_cols = kMaxC - c;
  const int per_env = kc16 * pad_cols + (kc16 - kc) * c;
  for (int i = tid; i < envs * per_env; i += nthr) {
    const int e = i / per_env;
    int p = i - e * per_env;
    int k, col;
    if (p < kc16 * pad_cols) {
      k = p / pad_cols;
      col = c + (p - k * pad_cols);
    } else {
      p -= kc16 * pad_cols;
      k = kc + p / c;
      col = p - (k - kc) * c;
    }
    dst[e * env_stride + k * kSB + col] = __float2bfloat16(0.0f);
  }
}

// out[row, col] = acc + (row == col ? d[row] : 0) for rows row0..row0+15 and
// columns 0..79 of the fragment, inside the c x c output
__device__ __forceinline__ void store_tile(const float (&acc)[kColTiles][4],
                                           float* __restrict__ oe,
                                           const float* __restrict__ de,
                                           int row0, int c, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kColTiles; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + g + 8 * h;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = 8 * j + 2 * t + q;
        if (row < c && col < c)
          oe[(size_t)row * c + col] =
              __fadd_rn(acc[j][2 * h + q], row == col ? de[row] : 0.0f);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[kColTiles][4]) {
#pragma unroll
  for (int j = 0; j < kColTiles; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.0f;
}

// the block's envs in turn, all 5 warps on one env
__global__ void __launch_bounds__(kDualWarps * 32)
gram_dual_kernel(const bf16* __restrict__ rt, const bf16* __restrict__ r,
                 const float* __restrict__ dg, float* __restrict__ out,
                 const int m, const int c, const int block_envs,
                 const bool vec_a, const bool vec_b) {
  constexpr int sa = kDualKc + 8;
  __shared__ __align__(16) bf16 as[kMaxC * sa];
  __shared__ __align__(16) bf16 bs[kDualKc * kSB];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nthr = kDualWarps * 32;
  const bool busy = warp * 16 < c;
  for (int i = 0; i < block_envs; ++i) {
    const size_t e = (size_t)blockIdx.x * block_envs + i;
    float acc[kColTiles][4];
    zero(acc);
    for (int m0 = 0; m0 < m; m0 += kDualKc) {
      const int kc = min(kDualKc, m - m0);
      load_a(as, sa, 0, rt + e * c * m, 1, m, c, 0, kMaxC, m0, kc, vec_a, tid,
             nthr);
      load_b(bs, 0, r + e * m * c, 1, m, c, m0, kc, vec_b, tid, nthr);
      __syncthreads();
      if (busy)
        for (int s = 0; s < kc; s += 16)
          row_tile_k16(acc, as + warp * 16 * sa + s, sa, bs + s * kSB, lane);
      __syncthreads();
    }
    if (busy) store_tile(acc, out + e * c * c, dg + e * c, warp * 16, c, lane);
  }
}

// the block's envs at the same time, one warp each, one 16-row tile per pass
// over M; shared memory (dynamic): B chunks of all envs, then their A tiles
__global__ void __launch_bounds__(kMaxBatchEnvs * 32)
gram_dual_batched_kernel(const bf16* __restrict__ rt,
                         const bf16* __restrict__ r,
                         const float* __restrict__ dg,
                         float* __restrict__ out, const int m, const int c,
                         const int kc_max, const bool vec_a,
                         const bool vec_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int envs = blockDim.x >> 5;
  const int sa = kc_max + 8;
  const int b_stride = kc_max * kSB;
  bf16* bs = reinterpret_cast<bf16*>(smem);
  bf16* as = bs + envs * b_stride;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t e0 = (size_t)blockIdx.x * envs;
  const bf16* rt0 = rt + e0 * c * m;
  const bf16* r0 = r + e0 * m * c;
  for (int row0 = 0; row0 < c; row0 += 16) {
    float acc[kColTiles][4];
    zero(acc);
    for (int m0 = 0; m0 < m; m0 += kc_max) {
      const int kc = min(kc_max, m - m0);
      load_a(as, sa, 16 * sa, rt0, envs, m, c, row0, 16, m0, kc, vec_a, tid,
             blockDim.x);
      load_b(bs, b_stride, r0, envs, m, c, m0, kc, vec_b, tid, blockDim.x);
      __syncthreads();
      for (int s = 0; s < kc; s += 16)
        row_tile_k16(acc, as + warp * 16 * sa + s, sa,
                     bs + warp * b_stride + s * kSB, lane);
      __syncthreads();
    }
    const size_t e = e0 + warp;
    store_tile(acc, out + e * c * c, dg + e * c, row0, c, lane);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// rows of M per chunk of gram_dual_batched: 64 for up to 8 envs, fewer for
// more, so that the shared memory stays near 110 KB
int batched_kc(int block_envs) {
  const int kc = (512 / block_envs) & ~15;
  return kc < 16 ? 16 : (kc > 64 ? 64 : kc);
}

}  // namespace

extern "C" {

// rt (n, c, m) and r (n, m, c) bf16, d (n, c) float32 -> out (n, c, c)
// float32; 1 <= c <= 80, m >= 1, n a positive multiple of block_envs >= 1.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
int emloco_gram_dual(const void* rt, const void* r, const void* d, void* out,
                     int n, int m, int c, int block_envs, void* stream) {
  if (n < 1 || m < 1 || c < 1 || c > kMaxC || block_envs < 1 ||
      n % block_envs != 0)
    return (int)cudaErrorInvalidValue;
  const bool vec_a = m % 8 == 0 && aligned16(rt);
  const bool vec_b = (m * c) % 8 == 0 && aligned16(r);
  gram_dual_kernel<<<n / block_envs, kDualWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(rt), static_cast<const bf16*>(r),
      static_cast<const float*>(d), static_cast<float*>(out), m, c,
      block_envs, vec_a, vec_b);
  return (int)cudaGetLastError();
}

// as emloco_gram_dual, with block_envs <= 32 (one warp per env)
int emloco_gram_dual_batched(const void* rt, const void* r, const void* d,
                             void* out, int n, int m, int c, int block_envs,
                             void* stream) {
  if (n < 1 || m < 1 || c < 1 || c > kMaxC || block_envs < 1 ||
      block_envs > kMaxBatchEnvs || n % block_envs != 0)
    return (int)cudaErrorInvalidValue;
  const int kc = batched_kc(block_envs);
  const size_t bytes =
      (size_t)block_envs * (kc * kSB + 16 * (kc + 8)) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      gram_dual_batched_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const bool vec_a = m % 8 == 0 && aligned16(rt);
  const bool vec_b = (m * c) % 8 == 0 && aligned16(r);
  gram_dual_batched_kernel<<<n / block_envs, block_envs * 32, bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(rt), static_cast<const bf16*>(r),
      static_cast<const float*>(d), static_cast<float*>(out), m, c, kc,
      vec_a, vec_b);
  return (int)cudaGetLastError();
}

}  // extern "C"
