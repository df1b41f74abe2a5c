// Batched weighted Gram + diagonal, batch-major, built with plain nvcc into
// the same shared library as the solver kernels (see
// emloco_tpu_torch/build.py).
//
// Replaces the Pallas TPU kernel of emloco_tpu/physics/pallas_linalg.py
//   emloco_gram_diag <- gram_diag (_gram_diag_kernel)
// which forms, per env n, At[n, :C] = R[n]^T (w[n] o R[n]) + diag(d[n]) for
// R (N, M, C) and w (N, M) in the row dtype (bf16 or float32), d (N, C) and
// At (N, C', C) float32, rows C..C'-1 (the to_env_last staging pad) left
// unwritten. The engine calls it with C = 75 generalized velocities and M
// merged Jacobian rows: 256 with the capsule ground contacts, 352 with the
// self-contact pairs added, 480 with the mesh colliders, 576 with both.
//
// Numerics, shared with gram_diag_plain in physics/linalg.py:
//   rw[m, c]  = float(R[m, c]) * float(w[m]), one float32 product (exact
//               for bf16 rows: two 8-bit significands);
//   acc[c, d] = sum over m = 0, 1, ..., M-1 of rw[m, c] * float(R[m, d]),
//               in float32, in ascending m;
//   At[c, d]  = acc[c, d] + (c == d ? d[c] : 0).
// The library is built with -fmad=false, so float32 rows take one rounded
// product and one rounded sum per term, as the plain version does. For bf16
// rows the term rw * R is a product of three 8-bit significands, at most 24
// significant bits, exact in float32, so a fused multiply-add rounds once,
// exactly where the product and the sum do: the bf16 instantiation uses
// fmaf at half the instructions, with the same bits.
//
// The mirror. For bf16 rows the terms of (c, d) and of (d, c) are the same
// exact products, R[m, c] w[m] R[m, d], summed in the same order, so the
// plain output is symmetric to the bit: the bf16 instantiation sums only
// the lower triangle (d <= c) and writes each sum to (c, d) and (d, c). The
// premise is that the products are exact, which holds unless R * w or the
// term falls below float32's normal range (about 1.2e-38), where a product
// rounds. Float32 rows round each product, so the two orders differ; their
// instantiation sums every entry.
//
// Bound on the H100 at 4,096 envs, M = 256 (the default contacts; at
// M = 576, 452 MB -> 0.135 ms), C = 75, bf16 rows: reading R,
// w and d once and writing the 75 x 75 float32 sums once moves 253 MB ->
// 0.076 ms at 3.35 TB/s; the 2 * 256 * 75^2 * 4,096 = 11.8 GFLOP are bf16
// products with float32 sums, 0.012 ms at the tensor cores' 989 TFLOP/s. So
// bytes bound it. A tensor-core sum runs in its own order and would not give
// the plain version's bits, so this kernel runs on the CUDA cores (67
// TFLOP/s float32, 33.5 T multiply-adds/s): the lower triangle's 2,850 sums
// are 2.99 G multiply-adds, 0.089 ms, just above the bytes bound.
//
// Design. A CTA takes kEnvs envs (4 for bf16 rows, 2 for float32). The
// C x C output is cut into 8 x 8 tiles, one per compute thread, its 64 sums
// in registers: the lower triangle's 55 tiles at C = 75 (80 padded), or all
// 100 for float32 rows; 4 x 55 = 220 of 224 compute threads busy. Helper
// warps (2 for bf16 rows, 1 for float32) feed them, so that no compute warp
// issues a copy or restages:
// - R and w come in by bulk copies, kRows = 16 rows of each env a chunk
//   (one copy for R's kRows * C contiguous elements and one for w's, one
//   lane each, on the stage's mbarrier `full`), into a ring of kStages = 2
//   stages; the next chunk is in flight while this one is restaged.
// - The helpers restage each chunk, a row a lane, into a float32 buffer
//   pair, w o R and R (bf16 read from the flat chunk as 32-bit words and
//   funnel shifts by the row's parity, converted and multiplied in
//   registers); column block j's halves go to columns 4j and 40 + 4j, and a
//   row is kS = 84 floats, so that the 16-byte stores of 8 consecutive rows
//   hit distinct banks. kBufs = 2 pairs let them restage the next chunk
//   while the compute warps sum this one (mbarriers `ready`, `spent`).
// - Each compute thread sums a chunk's rows, four 16-byte shared loads per
//   row for 64 fused multiply-adds.
// At the end each env's C x C sums, the diagonal added, are staged in shared
// memory (lower triangle and its mirror), at the same offset modulo 16
// bytes as in `out`, and written out as one run of 16-byte stores: an
// env's 75 x 75 floats are not a multiple of 16 bytes, and the unstaged
// (N, 75, 75) output puts odd envs off a 16-byte boundary.
// Shared memory at C = 75 (Layout below): bf16 rows 107,056 bytes a CTA of
// 288 threads, float32 rows 63,280 bytes and 256 threads; 2 CTAs an SM
// either way (the launch bounds; on bf16 rows they leave 96 registers a
// thread).
// What held the first design back (one block of 256 threads an env, 5 x 5
// tiles): every entry summed, ten shared loads per 25 multiply-adds, loads
// and sums taking turns between two barriers a chunk, 31 idle threads.
// What holds this one (PERF.md): the compute warps' shared loads and fused
// multiply-adds together, the helpers' restage beside them, and the
// epilogue's staging, whose stores of 8 x 8 tiles meet 8-way bank conflicts.
//
// Shapes that bulk copies cannot take (M * sizeof(row) not a multiple of 16
// bytes, or R or w not 16-byte aligned): the helpers fill each stage with
// plain loads when it is due, instead of waiting on its mbarrier.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "async_copy.cuh"

namespace {

using bf16 = __nv_bfloat16;
using emloco::round16;

constexpr int kMaxC = 80;              // 10 blocks of 8 columns
constexpr int kBlocks = kMaxC / 8;
constexpr int kHalf = kMaxC / 2;       // restaged column of block j's half 1
constexpr int kRows = 16;              // rows of M a chunk
constexpr int kStages = 2;             // the ring of bulk-copied chunks
constexpr int kBufs = 2;               // restaged float32 buffer pairs
// float row stride of a restaged row: 84 = 20 mod 32 banks, so that the
// helpers' 16-byte stores of 8 consecutive rows (one a lane) hit distinct
// banks
constexpr int kS = kMaxC + 4;

// bf16 rows: the lower triangle of tiles, 4 envs a CTA, 2 helper warps;
// float32 rows: all tiles, 2 envs a CTA, 1 helper warp (twice the sums a
// restaged row). kCompute threads own the tiles; the helper warps follow
// them.
template <typename T>
struct Cfg {
  static constexpr bool kLower = std::is_same<T, bf16>::value;
  static constexpr int kEnvs = kLower ? 4 : 2;
  static constexpr int kHelpers = kLower ? 2 : 1;
  static constexpr int kTiles =
      kLower ? kBlocks * (kBlocks + 1) / 2 : kBlocks * kBlocks;
  static constexpr int kCompute = (kEnvs * kTiles + 31) / 32 * 32;
  static constexpr int kThreads = kCompute + 32 * kHelpers;
};

// Dynamic shared memory of a CTA for C = c: [mbarriers][diagonals, kMaxC
// floats an env][ring: kStages x kEnvs stages of one env's chunk: R's flat
// kRows x c elements (32 bytes of slack for the restage's word loads), then
// w's kRows][kBufs x kEnvs buffer pairs: w o R, then R, kRows x kS floats
// each]. The output staging, kEnvs x (c * c + 3) floats, reuses the ring
// and the buffers once the sums are done.
template <typename T>
struct Layout {
  size_t bars, diag, w_off, stage, ring, buf, pipe, out_env, total;
  __host__ __device__ explicit Layout(int c)
      : bars(round16(8 * (kStages + 2 * kBufs))),
        diag((size_t)Cfg<T>::kEnvs * kMaxC * 4),
        w_off(round16((size_t)kRows * c * sizeof(T)) + 32),
        stage(w_off + round16(kRows * sizeof(T))),
        ring((size_t)kStages * Cfg<T>::kEnvs * stage),
        buf((size_t)2 * kRows * kS * 4),
        pipe(ring + (size_t)kBufs * Cfg<T>::kEnvs * buf),
        out_env(round16(((size_t)c * c + 3) * 4)),
        total(bars + diag +
              (pipe > Cfg<T>::kEnvs * out_env ? pipe
                                              : Cfg<T>::kEnvs * out_env)) {}
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// acc + a * b, rounded as gram_diag_plain rounds it (see the head note)
template <typename T>
__device__ __forceinline__ float mac(float acc, float a, float b) {
  if constexpr (std::is_same<T, float>::value)
    return __fadd_rn(acc, __fmul_rn(a, b));
  else
    return __fmaf_rn(a, b, acc);
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + kHalf) = make_float4(v[4], v[5], v[6], v[7]);
}

// Restage one row of a chunk: the row's c elements start at element s0 of
// the flat chunk (16-byte aligned); pair[4j + 40h] gets w o R and
// pair[kRows * kS + 4j + 40h] R, column block j's half h, as float32, zero
// past c. bf16: 32-bit words, funnel-shifted by the row's parity, each
// word loaded once.
__device__ __forceinline__ void restage_row(float* pair, const bf16* flat,
                                            int s0, int c, int nj, float wv) {
  const uint32_t* words = reinterpret_cast<const uint32_t*>(flat) + (s0 >> 1);
  const uint32_t sh = (s0 & 1) * 16;
  uint32_t prev = words[0];
#pragma unroll 2
  for (int j = 0; j < nj; ++j) {
    uint32_t x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = words[4 * j + 1 + i];
    float v[8], vw[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t p = __funnelshift_r(i == 0 ? prev : x[i - 1], x[i], sh);
      v[2 * i] = __uint_as_float(p << 16);
      v[2 * i + 1] = __uint_as_float(p & 0xFFFF0000u);
    }
    prev = x[3];
    if (j == nj - 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (8 * j + i >= c) v[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) vw[i] = __fmul_rn(v[i], wv);
    store8(pair + 4 * j, vw);
    store8(pair + kRows * kS + 4 * j, v);
  }
}

__device__ __forceinline__ void restage_row(float* pair, const float* flat,
                                            int s0, int c, int nj, float wv) {
#pragma unroll 2
  for (int j = 0; j < nj; ++j) {
    float v[8], vw[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = 8 * j + i < c ? flat[s0 + 8 * j + i] : 0.0f;
      vw[i] = __fmul_rn(v[i], wv);
    }
    store8(pair + 4 * j, vw);
    store8(pair + kRows * kS + 4 * j, v);
  }
}

// a barrier of `threads` threads, named `id` (0 is __syncthreads's)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <typename T>
__global__ void __launch_bounds__(Cfg<T>::kThreads, 2)
gram_diag_kernel(const T* __restrict__ r, const T* __restrict__ w,
                 const float* __restrict__ dg, float* __restrict__ out,
                 const int n, const int m, const int c, const int out_rows,
                 const bool vec) {
  constexpr int G = Cfg<T>::kEnvs, kCompute = Cfg<T>::kCompute;
  constexpr int kHelpers = Cfg<T>::kHelpers;
  constexpr bool kLower = Cfg<T>::kLower;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<T> L(c);
  const int tid = threadIdx.x, lane = tid & 31;
  const int e0 = blockIdx.x * G, ng = min(G, n - e0);
  // full[s]: stage s landed; ready[b]: buffer pair b restaged; spent[b]:
  // every compute warp is done with buffer pair b
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* ready = full + kStages;
  uint64_t* spent = ready + kBufs;
  float* dsm = reinterpret_cast<float*>(smem + L.bars);
  unsigned char* ring = smem + L.bars + L.diag;
  float* bufs = reinterpret_cast<float*>(ring + L.ring);
  const size_t buf_floats = L.buf / 4;
  const int nj = (c + 7) / 8;                     // column blocks
  const int tiles = kLower ? nj * (nj + 1) / 2 : nj * nj;
  const int nq = (m + kRows - 1) / kRows;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) emloco::mbar_init(&full[s], 1);
    for (int b = 0; b < kBufs; ++b) {
      emloco::mbar_init(&ready[b], kHelpers);
      emloco::mbar_init(&spent[b], kCompute / 32);
    }
    emloco::mbar_init_fence();
  }
  for (int i = tid; i < ng * c; i += Cfg<T>::kThreads)
    dsm[i / c * kMaxC + i % c] = dg[(size_t)e0 * c + i];
  __syncthreads();

  if (tid >= kCompute) {
    // The helper warps. Chunk q of every env comes into stage q % kStages:
    // by bulk copies, lanes 0..2 ng-1 of helper 0 one copy each (R, then w,
    // of env lane / 2), issued kStages chunks ahead once every helper has
    // restaged the stage's last chunk; or, without vec, by the helpers'
    // plain loads when it is due. The helpers restage chunk q into buffer
    // pair q % kBufs, a row a lane, once the compute warps are done with
    // chunk q - kBufs.
    const int h = (tid - kCompute) >> 5;
    auto fetch = [&](int q) {
      const int s = q % kStages, m0 = q * kRows, kc = min(kRows, m - m0);
      if (lane == 0)
        emloco::mbar_arrive_tx(&full[s], ng * kc * (c + 1) * sizeof(T));
      __syncwarp();
      if (lane < 2 * ng) {
        const int g = lane >> 1;
        unsigned char* st = ring + (s * G + g) * L.stage;
        const size_t row = (size_t)(e0 + g) * m + m0;
        if (lane & 1)
          emloco::bulk_copy(st + L.w_off, w + row, kc * sizeof(T), &full[s]);
        else
          emloco::bulk_copy(st, r + row * c, kc * c * sizeof(T), &full[s]);
      }
    };
    if (vec && h == 0)
      for (int q = 0; q < min(kStages, nq); ++q) fetch(q);
    for (int q = 0; q < nq; ++q) {
      const int s = q % kStages, b = q % kBufs;
      const int m0 = q * kRows, kc = min(kRows, m - m0);
      if (vec) {
        emloco::mbar_wait(&full[s], (q / kStages) & 1);
      } else {
        if (kHelpers > 1 && q >= kStages)   // the others are done with s
          emloco::mbar_wait(&ready[(q - kStages) % kBufs],
                            ((q - kStages) / kBufs) & 1);
        for (int gg = 0; gg < ng; ++gg) {
          unsigned char* st = ring + (s * G + gg) * L.stage;
          const size_t row = (size_t)(e0 + gg) * m + m0;
          for (int i = lane + 32 * h; i < kc * c; i += 32 * kHelpers)
            reinterpret_cast<T*>(st)[i] = r[row * c + i];
          for (int i = lane + 32 * h; i < kc; i += 32 * kHelpers)
            reinterpret_cast<T*>(st + L.w_off)[i] = w[row + i];
        }
        named_sync(2, 32 * kHelpers);
      }
      if (q >= kBufs) emloco::mbar_wait(&spent[b], (q / kBufs - 1) & 1);
      float* bq = bufs + (size_t)b * G * buf_floats;
      for (int rr = lane + 32 * h; rr < ng * kRows; rr += 32 * kHelpers) {
        const int gg = rr / kRows, k = rr - gg * kRows;
        if (k >= kc) continue;
        const T* st = reinterpret_cast<const T*>(ring + (s * G + gg) * L.stage);
        restage_row(bq + gg * buf_floats + k * kS, st, k * c, c, nj,
                    to_f32(reinterpret_cast<const T*>(
                        ring + (s * G + gg) * L.stage + L.w_off)[k]));
      }
      __syncwarp();
      if (lane == 0) emloco::mbar_arrive(&ready[b]);
      if (vec && h == 0 && q + kStages < nq) {
        // every helper is done with stage s
        if (kHelpers > 1) emloco::mbar_wait(&ready[b], (q / kBufs) & 1);
        emloco::fence_proxy_async();
        __syncwarp();
        fetch(q + kStages);
      }
    }
    return;
  }

  // a compute thread: env g, tile (bi, bj) = rows 8 bi.., columns 8 bj..
  const int g = tid / tiles, tl = tid - g * tiles;
  const bool active = g < ng;
  int bi = 0, bj = tl;
  if (kLower) {
    while ((bi + 1) * (bi + 2) / 2 <= tl) ++bi;
    bj = tl - bi * (bi + 1) / 2;
  } else {
    bi = tl / nj;
    bj = tl - bi * nj;
  }
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int q = 0; q < nq; ++q) {
    const int b = q % kBufs, kc = min(kRows, m - q * kRows);
    emloco::mbar_wait(&ready[b], (q / kBufs) & 1);
    if (active) {
      const float* bq = bufs + (size_t)b * G * buf_floats + g * buf_floats;
      const float* pa = bq + 4 * bi;
      const float* pb = bq + kRows * kS + 4 * bj;
#pragma unroll 2
      for (int k = 0; k < kc; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(pa + k * kS);
        const float4 a1 = *reinterpret_cast<const float4*>(pa + k * kS + kHalf);
        const float4 b0 = *reinterpret_cast<const float4*>(pb + k * kS);
        const float4 b1 = *reinterpret_cast<const float4*>(pb + k * kS + kHalf);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = mac<T>(acc[i][j], a[i], b[j]);
      }
    }
    __syncwarp();
    if (lane == 0) emloco::mbar_arrive(&spent[b]);
  }

  // epilogue: stage each env's output at its offset modulo 16 bytes in
  // `out`, then write it out. The helpers have restaged every chunk, so the
  // ring and the buffers are free once the compute threads are done.
  named_sync(1, kCompute);
  float* stg = reinterpret_cast<float*>(ring);
  const size_t env_floats = L.out_env / 4;
  auto out_of = [&](int gg) { return out + (size_t)(e0 + gg) * out_rows * c; };
  auto phase_of = [&](int gg) {
    return (int)(reinterpret_cast<uintptr_t>(out_of(gg)) >> 2) & 3;
  };
  if (active) {
    float* st = stg + g * env_floats + phase_of(g);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = 8 * bi + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * bj + j;
        if (row < c && col < c && (!kLower || col <= row)) {
          const float v =
              __fadd_rn(acc[i][j], row == col ? dsm[g * kMaxC + row] : 0.0f);
          st[row * c + col] = v;
          if (kLower) st[col * c + row] = v;
        }
      }
    }
  }
  named_sync(1, kCompute);
  const int cc = c * c;
  for (int gg = 0; gg < ng; ++gg) {
    float* oe = out_of(gg);
    const int phase = phase_of(gg);
    const float* st = stg + gg * env_floats + phase;
    const int head = min((4 - phase) & 3, cc), n4 = (cc - head) >> 2;
    if (tid < head) oe[tid] = st[tid];
    for (int i = tid; i < n4; i += kCompute)
      reinterpret_cast<float4*>(oe + head)[i] =
          reinterpret_cast<const float4*>(st + head)[i];
    for (int i = head + 4 * n4 + tid; i < cc; i += kCompute) oe[i] = st[i];
  }
}

// set the kernel's shared memory for c; (threads, bytes) via the pointers
template <typename T>
cudaError_t prepare(int c, int* threads, size_t* bytes) {
  *threads = Cfg<T>::kThreads;
  *bytes = Layout<T>(c).total;
  cudaError_t err =
      cudaFuncSetAttribute(gram_diag_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)*bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(gram_diag_kernel<T>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T>
int launch(const void* r, const void* w, const void* d, void* out, int n,
           int m, int c, int out_rows, void* stream) {
  int threads;
  size_t bytes;
  cudaError_t err = prepare<T>(c, &threads, &bytes);
  if (err != cudaSuccess) return (int)err;
  const bool vec = (m * sizeof(T)) % 16 == 0 && emloco::aligned16(r) &&
                   emloco::aligned16(w);
  constexpr int G = Cfg<T>::kEnvs;
  gram_diag_kernel<T><<<(n + G - 1) / G, threads, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(r), static_cast<const T*>(w),
      static_cast<const float*>(d), static_cast<float*>(out), n, m, c,
      out_rows, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_shape(int c, int* out) {
  int threads;
  size_t bytes;
  cudaError_t err = prepare<T>(c, &threads, &bytes);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, gram_diag_kernel<T>, threads, bytes);
  if (err != cudaSuccess) return (int)err;
  out[0] = Cfg<T>::kEnvs;
  out[1] = threads;
  out[2] = (int)bytes;
  out[3] = ctas;
  return 0;
}

}  // namespace

extern "C" {

// r (n, m, c) and w (n, m) bf16 when rows_bf16 else float32, d (n, c)
// float32 -> out (n, out_rows, c) float32, rows c..out_rows-1 untouched;
// 1 <= c <= 80 and out_rows >= c. Launches on `stream`, allocates nothing,
// returns cudaGetLastError().
int emloco_gram_diag(const void* r, const void* w, const void* d, void* out,
                     int n, int m, int c, int out_rows, int rows_bf16,
                     void* stream) {
  if (n < 1 || m < 1 || c < 1 || c > kMaxC || out_rows < c)
    return (int)cudaErrorInvalidValue;
  return rows_bf16 ? launch<bf16>(r, w, d, out, n, m, c, out_rows, stream)
                   : launch<float>(r, w, d, out, n, m, c, out_rows, stream);
}

// emloco_gram_diag's launch for c columns: shape[0] envs a CTA, shape[1]
// threads, shape[2] dynamic shared memory bytes, shape[3] CTAs an SM on the
// current device (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns
// 0, or the CUDA error.
int emloco_gram_diag_shape(int c, int rows_bf16, void* shape) {
  if (c < 1 || c > kMaxC) return (int)cudaErrorInvalidValue;
  int* const out = static_cast<int*>(shape);
  return rows_bf16 ? launch_shape<bf16>(c, out) : launch_shape<float>(c, out);
}

}  // extern "C"
