// Batched Gram of two bf16 operands on the tensor cores, fed by asynchronous
// bulk copies, built with plain nvcc into the same shared library as the
// other kernels (see emloco_tpu_torch/build.py).
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
// Bound on the H100 at the probe's shapes: reading Rt and R in bf16
// (373.6 MB) and d (1.2 MB) and writing the 75 x 75 float32 output
// (92.2 MB) moves 466.9 MB -> 0.139 ms at 3.35 TB/s; the 2 * 304 * 75^2 *
// 4,096 = 14.0 GFLOP take 0.0142 ms at 989 TFLOP/s bf16. Bytes bound both
// kernels by 10x, so the design is about keeping device memory busy: every
// Rt and R byte is read from device memory once per launch, by both
// kernels, by one bulk copy into shared memory.
//
// Numerics. Every product of two bf16 values is exact in float32; the sums
// run on the tensor cores, mma.sync m16n8k16 with float32 accumulators, one
// k16 step after another in ascending m from 0, the last step zero-filled
// past M in both operands. Within a step the tensor core sums in its own
// order, so the result is not gram_dual_plain's bits: it lies within a few
// float32 roundings of the M-term sum (chip_smoke.py holds it to 2^-13 of
// the sum of |products| per entry). Both kernels run one device function
// for one env's 16-row tile and one k16 step over the same steps in the same
// order, and one epilogue that adds the diagonal with one rounded float32
// add, so they give the same bits as each other (and as the first design,
// which took the same steps).
//
// Design. One CTA per block of envs. A group of 5 tensor-core warps works
// on one env, warp w owning output rows 16w..16w+15 and all 10 n8 column
// tiles (40 float32 accumulators a thread); 3 helper warps serve the group.
// gram_dual runs one group, which takes the block's envs one after another
// (the TPU kernel's loop of per-env dots); gram_dual_batched runs two
// groups, so two envs of the block are in flight together and the block
// goes by in rounds of two (the TPU's one batched dot per block, sized to
// shared memory). Every operand byte comes in by one cp.async.bulk copy
// that completes on an mbarrier, and the copies run on across env
// boundaries: the next env's first chunks are in flight while this env
// finishes and writes its output. No __syncthreads() runs after set-up.
// The copy and mbarrier helpers are async_copy.cuh's, shared with
// gram_diag.cu.
// - A (Rt). A tensor-core warp reads only its own 16 rows of A, so it loads
//   them itself, into a ring of kAStages = 2 slots of its own (`afull`):
//   chunks of kKa = 160 columns (rows of M), one bulk copy a row (a row
//   segment of kc * 2 bytes), landing straight in the ldmatrix layout at a
//   row stride of kKa + 8 bf16 (336 bytes, an odd number of 16-byte units,
//   so the 8 rows of one ldmatrix phase hit distinct banks). It refills a
//   slot as soon as it is done with it; no other warp waits for that. A
//   bulk copy holds the warp that starts it for a while, so one warp
//   starting all of Rt's row segments for a CTA cannot keep device memory
//   busy; here Rt's 150 copies an env (M = 304) are 288-320 bytes each,
//   spread over the 5 warps that need them.
// - B (R). R's rows are 150 bytes long at C = 75, not 16-byte aligned, so
//   they cannot land in an ldmatrix layout. Its chunks of kKr = 32 rows are
//   kc * C contiguous elements: helper h takes chunks h, h + 3, ..., keeps
//   kRStages = 2 of them in flight in its own ring (one bulk copy an env,
//   `rfull`), and restages each into the ldmatrix.trans layout (row stride
//   kSB = 88 bf16, one 16-byte store per 8 elements, built from five 32-bit
//   shared loads and funnel shifts; the columns past C of the last unit
//   written as zeros) in restage buffer q % kRestage, once the tensor-core
//   warps have released the chunk that buffer held (`rbempty`); then it
//   tells them (`ready`). With kRestage = 4 buffers the restage runs up to
//   three chunks ahead of the tensor cores and off their path. The buffers
//   are zeroed once, so the column units past C stay zero.
// - The output. A warp's 16 rows of an env are contiguous in `out`; it
//   stages them (plus the diagonal) in the A slot it has just finished
//   with, at the same offset modulo 16 bytes as in `out`, and writes them
//   out as one run with 16-byte stores, consecutive lanes on consecutive
//   addresses (a bulk store cannot take it: an env's 22,500 bytes at C = 75
//   put odd envs' rows off a 16-byte boundary), then refills the slot. The
//   two diagonal values a lane adds are loaded at the env's first chunk, so
//   the epilogue waits on no load from device memory.
// What held the first design back, and what this one does about it:
// it loaded each chunk synchronously between two __syncthreads(), with no
// copy in flight while the tensor cores worked (here the rings keep the
// next chunks in flight); it restaged R with eight 2-byte shared stores per
// 16-byte load, on the tensor-core warps, and rewrote the zero pad for
// every chunk (here 16-byte stores on helper warps, pad zeroed once); it
// stored straight from the mma fragments, in partial sectors (here
// coalesced from shared memory); and gram_dual_batched, one warp per env,
// streamed all of M five times, one 16-row tile a pass, reading R five
// times (here both kernels read every byte once).
//
// Shared memory at C = 75 (Layout below): a helper's R stage is 4,832
// bytes (32 x 75 bf16 + 32 bytes of slack for the restage's loads), a group
// adds four 5,632-byte restage buffers, a tensor-core warp two 5,376-byte
// slots. gram_dual: 1 group = 105,472 bytes, 256 threads, 2 CTAs an SM
// (two such CTAs fit the SM's 228 KB, and at ptxas's 128 registers a thread
// their 512 threads fill its 65,536 registers); at
// 8 envs a block 512 CTAs = 1.94 waves over 132 SMs, at 32 envs a block 128
// CTAs on 128 SMs, one each. gram_dual_batched: 2 groups = 210,944 bytes,
// 512 threads, 1 CTA an SM; at 8 envs a block 512 CTAs = 3.88 waves, at 32
// envs a block 128 CTAs, 0.97 of a wave. Either way 10 tensor-core warps an
// SM on 512 CTAs.
//
// Shapes that bulk copies cannot take (a 1-D bulk copy needs a 16-byte
// aligned address and a size that is a multiple of 16): Rt unless M is a
// multiple of 8 and its data 16-byte aligned (`vec_a`); R unless M * C is a
// multiple of 8 and its data 16-byte aligned (`vec_b`). A warp then fills
// its slot with plain loads, or a helper its stage (its lanes, 2 bytes
// each), before arriving on the same mbarrier; the rest does not know the
// difference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "async_copy.cuh"

namespace {

using bf16 = __nv_bfloat16;
using emloco::aligned16;
using emloco::bulk_copy;
using emloco::fence_proxy_async;
using emloco::mbar_arrive;
using emloco::mbar_arrive_tx;
using emloco::mbar_init;
using emloco::mbar_wait;
using emloco::round16;
using emloco::smem_addr;

constexpr int kMaxC = 80;            // 5 m16 row tiles x 10 n8 column tiles
constexpr int kRowTiles = kMaxC / 16;
constexpr int kColTiles = kMaxC / 8;
constexpr int kKr = 32;              // rows of M per chunk of R
constexpr int kKa = 160;             // columns (rows of M) per chunk of Rt
constexpr int kSa = kKa + 8;         // shared row stride of A (Rt), bf16
constexpr int kSB = 88;              // shared row stride of restaged B, bf16
constexpr int kHelpers = 3;          // helper warps of a group, chunks in turn
constexpr int kRStages = 2;          // depth of each helper's ring of R
constexpr int kAStages = 2;          // depth of each warp's ring of A
constexpr int kRestage = 4;          // restage buffers of a group
constexpr int kBatchGroups = 2;      // envs in flight in gram_dual_batched
static_assert(kKa % kKr == 0 && kKr % 16 == 0, "chunks of whole k16 steps");
// The helper of chunk q waits on buffer q % kRestage's `rbempty` for chunk
// q - kRestage; a parity wait is only sound once the phase before (chunk
// q - 2 kRestage) is known complete, which the helper's own previous chunk,
// q - kHelpers, implies while kHelpers <= kRestage.
static_assert(kHelpers <= kRestage, "rbempty's parity waits");

// Dynamic shared memory of a CTA with `groups` envs in flight, C = c:
// [mbarriers][per group: its helpers' rings of R (kHelpers x kRStages flat
// chunks), its kRestage restage buffers][per tensor-core warp: kAStages
// slots of 16 rows of A]
struct Layout {
  size_t f, rb, slot, bars, group, total;
  __host__ __device__ Layout(int c, int groups)
      : f(round16((size_t)kKr * c * 2) + 32),
        rb((size_t)kKr * kSB * 2),
        slot((size_t)16 * kSa * 2),
        bars(round16(8 * groups * (kHelpers * kRStages + 2 * kRestage +
                                   kRowTiles * kAStages))),
        group(kHelpers * kRStages * f + kRestage * rb),
        total(bars + groups * group + groups * kRowTiles * kAStages * slot) {}
};
// a slot also stages its warp's 16 output rows (float32, up to 3 floats
// into the slot) at the end of an env
static_assert(16 * kSa * 2 >= (16 * kMaxC + 3) * 4, "slot holds 16 rows");

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
// A[16 x 16] B[16 x 8j..8j+7]. `a` is this lane's ldmatrix row address at
// the step's first k: row (lane & 15) of the tile, k + 8 for lanes 16-31 ->
// a0..a3 = (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15); `b`
// points at the step's first k row of B (stride kSB). Both kernels run it,
// so both sum alike.
__device__ __forceinline__ void row_tile_k16(float (&acc)[kColTiles][4],
                                             const bf16* a, const bf16* b,
                                             int lane) {
  uint32_t af[4];
  ldsm_x4(af, a);
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

// Restage one env's chunk of R, by one warp: rows k < kc16 of rb (stride
// kSB), column units 8j..8j+7 for j < nj = ceil(c / 8), from the flat chunk
// (kc x c, landed 16-byte aligned): element (k, col) = flat[k * c + col] for
// k < kc and col < c, else zero. Lane (kr, j) = (lane / nj, lane % nj) takes
// rows kr, kr + 32 / nj, ... (at most kPasses of them: nj <= 10); a unit is
// one 16-byte store, built from the five 32-bit words of `flat` that hold
// its 8 elements (a chunk's 32 bytes of slack cover the words read past its
// end). All loads are made before the first store.
constexpr int kPasses = (kKr + 2) / 3;
__device__ __forceinline__ void restage(bf16* __restrict__ rb,
                                        const bf16* __restrict__ flat, int c,
                                        int kc, int kc16, int nj, int lane) {
  const int rpp = 32 / nj, kr = lane / nj, j = lane - kr * nj;
  if (kr >= rpp) return;
  const int valid = c - 8 * j;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(flat);
  uint32_t x[kPasses][5];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int k = kr + p * rpp, s = k * c + 8 * j;
    if (k < kc)
#pragma unroll
      for (int i = 0; i < 5; ++i) x[p][i] = words[(s >> 1) + i];
  }
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int k = kr + p * rpp;
    if (k >= kc16) break;
    uint32_t o[4] = {0u, 0u, 0u, 0u};
    if (k < kc) {
      const uint32_t sh = ((k * c) & 1) * 16;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[i] = __funnelshift_r(x[p][i], x[p][i + 1], sh) &
               ((2 * i < valid ? 0xFFFFu : 0u) |
                (2 * i + 1 < valid ? 0xFFFF0000u : 0u));
    }
    *reinterpret_cast<uint4*>(rb + k * kSB + 8 * j) =
        make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// st[(row - row0) * c + col] = acc + (row == col ? d[row] : 0) for rows
// row0..row0+15 and columns 0..79 of the fragment, inside the c x c output;
// dv[h] = d[row0 + lane / 4 + 8h], this lane's two rows
__device__ __forceinline__ void stage_tile(const float (&acc)[kColTiles][4],
                                           float* __restrict__ st,
                                           const float (&dv)[2], int row0,
                                           int c, int lane) {
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
          st[(g + 8 * h) * c + col] =
              __fadd_rn(acc[j][2 * h + q], row == col ? dv[h] : 0.0f);
      }
    }
  }
}

// G envs in flight: G groups of kRowTiles tensor-core warps, then kHelpers
// helper warps per group. The block's envs go by in rounds of G. A group's
// R chunk q is chunk q % nr of round q / nr, fetched and restaged by helper
// q % kHelpers (its ring stage q / kHelpers % kRStages) into restage buffer
// q % kRestage; a warp's A chunk qa is chunk qa % na of round qa / na (its
// slot qa % kAStages).
template <int G>
__global__ void __launch_bounds__(G * (kRowTiles + kHelpers) * 32,
                                  G == 1 ? 2 : 1)
gram_kernel(const bf16* __restrict__ rt, const bf16* __restrict__ r,
            const float* __restrict__ dg, float* __restrict__ out,
            const int m, const int c, const int block_envs, const bool vec_a,
            const bool vec_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(c, G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int busy = (c + 15) / 16;          // tensor-core warps with rows
  // barriers: per group rfull[kHelpers * kRStages], ready[kRestage],
  // rbempty[kRestage], then per tensor-core warp afull[kAStages]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  constexpr int kRing = kHelpers * kRStages;
  constexpr int kGroupBars = kRing + 2 * kRestage;
  if (tid == 0) {
    for (int g = 0; g < G; ++g) {
      uint64_t* gb = bars + g * kGroupBars;
      for (int i = 0; i < kRing; ++i) mbar_init(&gb[i], 1);
      for (int i = 0; i < kRestage; ++i) {
        mbar_init(&gb[kRing + i], 1);
        mbar_init(&gb[kRing + kRestage + i], busy);
      }
    }
    for (int i = 0; i < G * kRowTiles * kAStages; ++i)
      mbar_init(&bars[G * kGroupBars + i], 1);
    emloco::mbar_init_fence();
  }
  // the restage buffers, once: their column units past c stay zero
  for (int g = 0; g < G; ++g) {
    uint4* rb = reinterpret_cast<uint4*>(smem + L.bars + g * L.group +
                                         kRing * L.f);
    for (int i = tid; i < (int)(kRestage * L.rb / 16); i += blockDim.x)
      rb[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  const int nr = (m + kKr - 1) / kKr, na = (m + kKa - 1) / kKa;
  const int rounds = block_envs / G;
  const int chunks = rounds * nr;
  const size_t e0 = (size_t)blockIdx.x * block_envs;
  const int helper = warp - G * kRowTiles;   // >= 0: a helper warp
  const int g = helper < 0 ? warp / kRowTiles : helper / kHelpers;
  uint64_t* rfull = bars + g * kGroupBars;
  uint64_t* ready = rfull + kRing;
  uint64_t* rbempty = ready + kRestage;
  unsigned char* mine = smem + L.bars + g * L.group;
  bf16* rbs = reinterpret_cast<bf16*>(mine + kRing * L.f);
  const size_t rb_elems = L.rb / 2;

  if (helper >= 0) {
    // helper h of group g: its chunks q = h, h + kHelpers, ...; keeps
    // kRStages of them in flight (one bulk copy an env), restages each into
    // buffer q % kRestage once the tensor-core warps are done with chunk
    // q - kRestage, tells them
    const int h = helper - g * kHelpers;
    auto fetch = [&](int q) {
      const int s = h * kRStages + q / kHelpers % kRStages, round = q / nr;
      const int m0 = (q - round * nr) * kKr, kc = min(kKr, m - m0);
      const bf16* src = r + ((e0 + (size_t)round * G + g) * m + m0) * c;
      bf16* f = reinterpret_cast<bf16*>(mine + s * L.f);
      if (vec_b) {
        if (lane == 0) {
          mbar_arrive_tx(&rfull[s], kc * c * 2);
          bulk_copy(f, src, kc * c * 2, &rfull[s]);
        }
      } else {
        for (int i = lane; i < kc * c; i += 32) f[i] = src[i];
        __syncwarp();
        if (lane == 0) mbar_arrive(&rfull[s]);
      }
    };
    const int nj = (c + 7) / 8;
    for (int i = 0; i < kRStages && h + i * kHelpers < chunks; ++i)
      fetch(h + i * kHelpers);
    for (int q = h; q < chunks; q += kHelpers) {
      const int s = h * kRStages + q / kHelpers % kRStages;
      const int b = q % kRestage, round = q / nr;
      const int kc = min(kKr, m - (q - round * nr) * kKr);
      mbar_wait(&rfull[s], (q / kHelpers / kRStages) & 1);
      if (q >= kRestage) mbar_wait(&rbempty[b], (q / kRestage - 1) & 1);
      restage(rbs + b * rb_elems, reinterpret_cast<bf16*>(mine + s * L.f), c,
              kc, (kc + 15) & ~15, nj, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(&ready[b]);
      if (q + kHelpers * kRStages < chunks) {
        fence_proxy_async();
        __syncwarp();
        fetch(q + kHelpers * kRStages);
      }
    }
    return;
  }

  // tensor-core warp wi of group g: output rows 16wi..16wi+15 of its env
  const int wi = warp - g * kRowTiles;
  const int row0 = wi * 16;
  const int rows = min(16, c - row0);
  if (rows <= 0) return;
  // this lane's A row in a slot (rows past c read row c - 1: their output
  // rows are never stored) and k half
  const int a_off = min(lane & 15, rows - 1) * kSa + (lane >> 4) * 8;
  unsigned char* my_slots = smem + L.bars + G * L.group +
                            (size_t)warp * kAStages * L.slot;
  uint64_t* afull = bars + G * kGroupBars + warp * kAStages;
  const int a_chunks = rounds * na;

  // this warp's rows of A chunk qa into its slot, by bulk copies (lanes
  // 0..rows-1, one row each) or, without vec_a, by plain loads
  auto fill_a = [&](int qa) {
    const int round = qa / na, m0 = (qa - round * na) * kKa;
    const int kc = min(kKa, m - m0);
    const bf16* src =
        rt + (((e0 + (size_t)round * G + g) * c + row0) * m + m0);
    bf16* a = reinterpret_cast<bf16*>(my_slots + (qa % kAStages) * L.slot);
    uint64_t* bar = &afull[qa % kAStages];
    if (vec_a) {
      if (lane == 0) mbar_arrive_tx(bar, rows * kc * 2);
      __syncwarp();
      if (lane < rows)
        bulk_copy(a + lane * kSa, src + (size_t)lane * m, kc * 2, bar);
    } else {
      for (int i = lane; i < rows * kc; i += 32) {
        const int rr = i / kc, k = i - rr * kc;
        a[rr * kSa + k] = src[(size_t)rr * m + k];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    }
  };

  for (int qa = 0; qa < min(kAStages, a_chunks); ++qa) fill_a(qa);
  float acc[kColTiles][4], dv[2];
  for (int q = 0, round = 0, cr = 0; q < chunks;
       ++q, round += cr == nr - 1, cr = cr == nr - 1 ? 0 : cr + 1) {
    const int m0 = cr * kKr, kc = min(kKr, m - m0);
    const int ca = m0 / kKa, a_col = m0 - ca * kKa;
    const int qa = round * na + ca, kca = min(kKa, m - ca * kKa);
    unsigned char* slot = my_slots + (qa % kAStages) * L.slot;
    bf16* a = reinterpret_cast<bf16*>(slot);
    if (a_col == 0) {
      mbar_wait(&afull[qa % kAStages], (qa / kAStages) & 1);
      // a partial last k16 step: zero this warp's rows of A past M
      const int padw = ((kca + 15) & ~15) - kca;
      for (int i = lane; i < rows * padw; i += 32) {
        const int rr = i / padw;
        a[rr * kSa + kca + (i - rr * padw)] = __float2bfloat16(0.0f);
      }
      __syncwarp();
    }
    if (cr == 0) {
#pragma unroll
      for (int j = 0; j < kColTiles; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
      // the diagonal of this lane's rows, loaded long before the epilogue
      const float* de = dg + (e0 + (size_t)round * G + g) * c;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + (lane >> 2) + 8 * h;
        dv[h] = row < c ? de[row] : 0.0f;
      }
    }
    const int b = q % kRestage;
    mbar_wait(&ready[b], (q / kRestage) & 1);
    const bf16* rb = rbs + b * rb_elems;
    for (int k = 0; k < kc; k += 16)
      row_tile_k16(acc, a + a_off + a_col + k, rb + k * kSB, lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(&rbempty[b]);
    if (a_col + kc < kca) continue;
    // the last chunk of R on this chunk of A: the slot is free
    if (cr == nr - 1) {
      // epilogue: stage this warp's rows of the env's output in the slot at
      // the same offset modulo 16 bytes as in `out`, then write them out as
      // one run (rows row0.. are contiguous): 16-byte stores, single floats
      // at the two ends
      const size_t e = e0 + (size_t)round * G + g;
      float* oe = out + (e * c + row0) * c;
      const int phase = (int)(reinterpret_cast<uintptr_t>(oe) >> 2) & 3;
      float* st = reinterpret_cast<float*>(slot) + phase;
      stage_tile(acc, st, dv, row0, c, lane);
      __syncwarp();
      const int n = rows * c, head = min((4 - phase) & 3, n);
      const int n4 = (n - head) >> 2;
      if (lane < head) oe[lane] = st[lane];
      for (int i = lane; i < n4; i += 32)
        reinterpret_cast<float4*>(oe + head)[i] =
            reinterpret_cast<const float4*>(st + head)[i];
      for (int i = head + 4 * n4 + lane; i < n; i += 32) oe[i] = st[i];
    }
    if (qa + kAStages < a_chunks) {
      fence_proxy_async();
      __syncwarp();
      fill_a(qa + kAStages);
    }
  }
}

// set the kernel's shared memory for c; returns (threads, bytes) via out
template <int G>
cudaError_t prepare(int c, int* threads, size_t* bytes) {
  *threads = G * (kRowTiles + kHelpers) * 32;
  *bytes = Layout(c, G).total;
  cudaError_t err = cudaFuncSetAttribute(
      gram_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)*bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(gram_kernel<G>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int G>
int launch(const void* rt, const void* r, const void* d, void* out, int n,
           int m, int c, int block_envs, void* stream) {
  int threads;
  size_t bytes;
  cudaError_t err = prepare<G>(c, &threads, &bytes);
  if (err != cudaSuccess) return (int)err;
  const bool vec_a = m % 8 == 0 && aligned16(rt);
  const bool vec_b = (m * c) % 8 == 0 && aligned16(r);
  gram_kernel<G><<<n / block_envs, threads, bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(rt), static_cast<const bf16*>(r),
      static_cast<const float*>(d), static_cast<float*>(out), m, c,
      block_envs, vec_a, vec_b);
  return (int)cudaGetLastError();
}

bool valid(int n, int m, int c, int block_envs) {
  return n >= 1 && m >= 1 && c >= 1 && c <= kMaxC && block_envs >= 1 &&
         n % block_envs == 0;
}

}  // namespace

extern "C" {

// rt (n, c, m) and r (n, m, c) bf16, d (n, c) float32 -> out (n, c, c)
// float32; 1 <= c <= 80, m >= 1, n a positive multiple of block_envs >= 1.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
int emloco_gram_dual(const void* rt, const void* r, const void* d, void* out,
                     int n, int m, int c, int block_envs, void* stream) {
  if (!valid(n, m, c, block_envs)) return (int)cudaErrorInvalidValue;
  return launch<1>(rt, r, d, out, n, m, c, block_envs, stream);
}

// as emloco_gram_dual, two envs of the block in flight together where
// block_envs is even (one at a time where it is odd)
int emloco_gram_dual_batched(const void* rt, const void* r, const void* d,
                             void* out, int n, int m, int c, int block_envs,
                             void* stream) {
  if (!valid(n, m, c, block_envs)) return (int)cudaErrorInvalidValue;
  return block_envs % kBatchGroups == 0
             ? launch<kBatchGroups>(rt, r, d, out, n, m, c, block_envs,
                                    stream)
             : launch<1>(rt, r, d, out, n, m, c, block_envs, stream);
}

}  // extern "C"
