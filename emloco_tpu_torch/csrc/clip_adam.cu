// The optimizer step of the agent and the trajectory predictors in two
// launches, built with plain nvcc into the same shared library as the solver
// kernels (see emloco_tpu_torch/build.py).
//
// Replaces no Pallas kernel. The JAX package leaves this step to XLA, which
// fuses optax's chain(clip_by_global_norm(max_norm), adam(lr)) over the whole
// parameter tree on the TPU; in PyTorch the same step is about a dozen small
// kernels a leaf (learning/fused_adam.py, `clip_adam_plain`). This kernel is
// the fusion XLA does there.
//
// Function, over L leaves g, p, m, v (n_i elements each, all float32 or all
// float64) and the int32 step count c:
//   norm = sqrt(sum g^2); keep = norm < max_norm; finite = every g finite
//   g_c = keep ? g : g / norm * max_norm
//   m' = (1 - b1) g_c + b1 m;  v' = (1 - b2) (g_c g_c) + b2 v
//   u = (m' / bc1) / (sqrt(v' / bc2) + eps),  bc_k = 1 - b_k^(c + 1)
//   p' = p + u * step,  step = -lr, or -(lr * decay^floor(c / T)) (optax's
//   staircase exponential_decay at the count before the step);  c' = c + 1
// b1 0.9, b2 0.999, eps 1e-8. Under `guard` a nonfinite gradient anywhere
// leaves everything as it was (p' = p, m' = m, v' = v, c' = c); without it
// the arithmetic runs on, NaN included. Each element repeats the plain
// version's roundings: no fused multiply-adds (-fmad=false), IEEE division
// and square root, the bias corrections and the decayed rate in float32
// through powf and c * (1 / T), as PyTorch's CUDA kernels compute them for
// the plain version. Only the norm's sum is taken in another order (in
// float64, rounded once), so where the clip engages the results may part
// from the plain version's by the norm's few ulp.
//
// Design. Two launches on the caller's stream, no host sync, no atomics:
//  * pass 1 (clip_adam_norm): kPartials blocks walk the tiles of the leaves
//    (kThreads x kVecs vectors of 16 bytes, each tile inside one leaf) and
//    write one sum of g^2 (float64) and one nonfinite flag a block;
//  * pass 2 (clip_adam_step): every block sums all the partials in one fixed
//    order, so every block and every run reads the same norm, derives keep,
//    finite and the scalars from the count on the device, and writes p', m'
//    and v' for its tiles; block 0 writes c' and finite.
// The leaves are a table in the kernel's parameters (__grid_constant__:
// pointers, sizes, output offsets, first tiles), so the gradients are read
// where autograd left them, without a copy. The outputs are three flat
// buffers whose leaf offsets are multiples of 16 bytes. A leaf whose inputs
// are not all 16-byte aligned (a view into a larger buffer, such as the
// mesh's all-reduce) and each leaf's ragged tail take scalar loads. A table
// holds at most kCap leaves (the agent's network has 29, TransMotion 162);
// more are refused.
//
// Bound on the H100 (3.35 TB/s HBM): g, p, m, v read and p', m', v'
// written, 28 bytes a float32 parameter: 11.19 M parameters (the agent at
// the bench's training configuration) 0.094 ms, 3.03 M (TransMotion) 0.025
// ms. Pass 2 reads g a second time, from L2 in part. A handful of flops a
// byte: bandwidth-bound.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kCap = 256;          // most leaves, the table's rows
constexpr int kThreads = 256;
constexpr int kVecs = 2;           // 16-byte vectors a thread a tile
constexpr int kPartials = 512;     // pass-1 blocks (and partials)
constexpr int kStepBlocks = 1024;  // most pass-2 blocks

struct Leaves {
  const void* g[kCap];
  const void* p[kCap];
  const void* m[kCap];
  const void* v[kCap];
  long long n[kCap];     // elements
  long long out[kCap];   // offset in the flat outputs, in elements
  int tile0[kCap + 1];   // first tile of each leaf; tile0[count] = tiles
  int count;
};

struct Scalars {
  double max_norm, lr, decay;
  int transition_steps;  // 0: the constant rate lr
  int guard;
};

template <typename T>
struct alignas(16) Vec {
  T c[16 / sizeof(T)];
};

// The leaf that holds tile t: tile0[i] <= t < tile0[i + 1] (leaves without
// a tile are never returned). Uniform over the block.
__device__ __forceinline__ int leaf_of(const Leaves& L, int t) {
  int lo = 0, hi = L.count;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (L.tile0[mid] <= t) lo = mid; else hi = mid;
  }
  return lo;
}

// Elements e.. of a leaf of n into x; returns how many are there (0 past
// the end). One 16-byte load where the leaf is aligned and whole there.
template <typename T>
__device__ __forceinline__ int load(const T* a, long long e, long long n,
                                    bool vec, T (&x)[16 / sizeof(T)]) {
  constexpr int kVec = 16 / sizeof(T);
  if (e >= n) return 0;
  if (vec && e + kVec <= n) {
    const Vec<T> w = *reinterpret_cast<const Vec<T>*>(a + e);
#pragma unroll
    for (int j = 0; j < kVec; ++j) x[j] = w.c[j];
    return kVec;
  }
  const int k = static_cast<int>(n - e < kVec ? n - e : kVec);
#pragma unroll
  for (int j = 0; j < kVec; ++j) x[j] = j < k ? a[e + j] : T(0);
  return k;
}

template <typename T>
__device__ __forceinline__ void store(T* a, long long e, int k,
                                      const T (&x)[16 / sizeof(T)]) {
  constexpr int kVec = 16 / sizeof(T);
  if (k == kVec) {
    Vec<T> w;
#pragma unroll
    for (int j = 0; j < kVec; ++j) w.c[j] = x[j];
    *reinterpret_cast<Vec<T>*>(a + e) = w;
    return;
  }
  // unrolled with a guard, so that x stays in registers
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    if (j < k) a[e + j] = x[j];
}

// The block's sum and OR, in one fixed order; every thread gets both.
__device__ void block_reduce(double& s, int& bad) {
  __shared__ double ws[kThreads / 32];
  __shared__ int wb[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, o);
    bad |= __shfl_down_sync(0xffffffffu, bad, o);
  }
  if (threadIdx.x % 32 == 0) {
    ws[threadIdx.x / 32] = s;
    wb[threadIdx.x / 32] = bad;
  }
  __syncthreads();
  s = 0.0;
  bad = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    s += ws[w];
    bad |= wb[w];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
clip_adam_norm(const __grid_constant__ Leaves L, double* __restrict__ part_sq,
               int* __restrict__ part_bad) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr long long kTile = (long long)kThreads * kVecs * kVec;
  double s = 0.0;
  int bad = 0;
  const int tiles = L.tile0[L.count];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int i = leaf_of(L, t);
    const T* g = static_cast<const T*>(L.g[i]);
    const long long n = L.n[i];
    const long long e0 = (t - L.tile0[i]) * kTile;
    const bool vec = (reinterpret_cast<uintptr_t>(g) & 15) == 0;
    T x[kVecs][kVec];
    int k[kVecs];
#pragma unroll
    for (int r = 0; r < kVecs; ++r)
      k[r] = load(g, e0 + (long long)(r * kThreads + threadIdx.x) * kVec, n,
                  vec, x[r]);
#pragma unroll
    for (int r = 0; r < kVecs; ++r) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        if (j < k[r]) {
          const T q = x[r][j] * x[r][j];
          s += static_cast<double>(q);
          bad |= !isfinite(x[r][j]);
        }
      }
    }
  }
  block_reduce(s, bad);
  if (threadIdx.x == 0) {
    part_sq[blockIdx.x] = s;
    part_bad[blockIdx.x] = bad;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
clip_adam_step(const __grid_constant__ Leaves L,
               const double* __restrict__ part_sq,
               const int* __restrict__ part_bad, const int n_part,
               const int* __restrict__ count, const Scalars sc,
               T* __restrict__ p_out, T* __restrict__ m_out,
               T* __restrict__ v_out, int* __restrict__ count_out,
               unsigned char* __restrict__ finite_out) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr long long kTile = (long long)kThreads * kVecs * kVec;
  double s = 0.0;
  int bad = 0;
  for (int j = threadIdx.x; j < n_part; j += kThreads) {
    s += part_sq[j];
    bad |= part_bad[j];
  }
  block_reduce(s, bad);
  const T norm = sqrt(static_cast<T>(s));
  const T max_norm = static_cast<T>(sc.max_norm);
  const bool keep = norm < max_norm;
  const bool skip = sc.guard && bad;
  const int c = *count;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *count_out = skip ? c : c + 1;
    *finite_out = bad ? 0 : 1;
  }
  // the scalars in float32, as the plain version's count.float() makes them
  const float cf = static_cast<float>(c + 1);
  const T bc1 = static_cast<T>(1.0f - powf(0.9f, cf));
  const T bc2 = static_cast<T>(1.0f - powf(0.999f, cf));
  T step;
  if (sc.transition_steps > 0) {
    const float q = floorf(static_cast<float>(c) *
                           (1.0f / static_cast<float>(sc.transition_steps)));
    const float rate = static_cast<float>(sc.lr) *
                       powf(static_cast<float>(sc.decay), q);
    step = static_cast<T>(-rate);
  } else {
    step = static_cast<T>(-sc.lr);
  }
  const T one_b1 = static_cast<T>(1.0 - 0.9), b1 = static_cast<T>(0.9);
  const T one_b2 = static_cast<T>(1.0 - 0.999), b2 = static_cast<T>(0.999);
  const T eps = static_cast<T>(1e-8);

  const int tiles = L.tile0[L.count];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int i = leaf_of(L, t);
    const T* g = static_cast<const T*>(L.g[i]);
    const T* p = static_cast<const T*>(L.p[i]);
    const T* m = static_cast<const T*>(L.m[i]);
    const T* v = static_cast<const T*>(L.v[i]);
    const long long n = L.n[i], o = L.out[i];
    const long long e0 = (t - L.tile0[i]) * kTile;
    const bool vec = ((reinterpret_cast<uintptr_t>(g) |
                       reinterpret_cast<uintptr_t>(p) |
                       reinterpret_cast<uintptr_t>(m) |
                       reinterpret_cast<uintptr_t>(v)) & 15) == 0;
    T xg[kVecs][kVec], xp[kVecs][kVec], xm[kVecs][kVec], xv[kVecs][kVec];
    int k[kVecs];
#pragma unroll
    for (int r = 0; r < kVecs; ++r) {
      const long long e = e0 + (long long)(r * kThreads + threadIdx.x) * kVec;
      k[r] = load(g, e, n, vec, xg[r]);
      load(p, e, n, vec, xp[r]);
      load(m, e, n, vec, xm[r]);
      load(v, e, n, vec, xv[r]);
    }
#pragma unroll
    for (int r = 0; r < kVecs; ++r) {
      if (k[r] == 0) continue;
      if (!skip) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const T gc = keep ? xg[r][j] : xg[r][j] / norm * max_norm;
          const T mo = one_b1 * gc + b1 * xm[r][j];
          const T vo = one_b2 * (gc * gc) + b2 * xv[r][j];
          const T u = (mo / bc1) / (sqrt(vo / bc2) + eps);
          xp[r][j] = xp[r][j] + u * step;
          xm[r][j] = mo;
          xv[r][j] = vo;
        }
      }
      const long long e =
          o + e0 + (long long)(r * kThreads + threadIdx.x) * kVec;
      store(p_out, e, k[r], xp[r]);
      store(m_out, e, k[r], xm[r]);
      store(v_out, e, k[r], xv[r]);
    }
  }
}

template <typename T>
int run(int leaves, const long long* table, const int* count, T* out,
        long long total, int* count_out, unsigned char* finite_out,
        const Scalars& sc, void* work, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr long long kTile = (long long)kThreads * kVecs * kVec;
  if (leaves > kCap) return (int)cudaErrorInvalidValue;
  double* part_sq = static_cast<double*>(work);
  int* part_bad = reinterpret_cast<int*>(part_sq + kPartials);
  Leaves L;
  L.count = leaves;
  L.tile0[0] = 0;
  for (int i = 0; i < leaves; ++i) {
    const long long n = table[4 * leaves + i], o = table[5 * leaves + i];
    if (n < 0 || o < 0 || o % kVec != 0 || o + n > total)
      return (int)cudaErrorInvalidValue;
    L.g[i] = reinterpret_cast<const void*>(table[i]);
    L.p[i] = reinterpret_cast<const void*>(table[leaves + i]);
    L.m[i] = reinterpret_cast<const void*>(table[2 * leaves + i]);
    L.v[i] = reinterpret_cast<const void*>(table[3 * leaves + i]);
    L.n[i] = n;
    L.out[i] = o;
    const long long tiles = L.tile0[i] + (n + kTile - 1) / kTile;
    if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
    L.tile0[i + 1] = static_cast<int>(tiles);
  }
  clip_adam_norm<T><<<kPartials, kThreads, 0, stream>>>(L, part_sq, part_bad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles = L.tile0[L.count];
  const int blocks = tiles < 1 ? 1 : (tiles < kStepBlocks ? tiles
                                                         : kStepBlocks);
  clip_adam_step<T><<<blocks, kThreads, 0, stream>>>(
      L, part_sq, part_bad, kPartials, count, sc, out, out + total,
      out + 2 * total, count_out, finite_out);
  err = cudaGetLastError();
  return err == cudaSuccess ? 0 : (int)err;
}

}  // namespace

extern "C" {

// out[0] the most leaves a step takes, out[1] the partials: the work buffer
// holds out[1] * (8 + 4) bytes.
int emloco_clip_adam_shape(int* out) {
  out[0] = kCap;
  out[1] = kPartials;
  return 0;
}

// One step over `leaves` leaves of `elem_bytes` (4: float32, 8: float64)
// elements. table: int64 (6, leaves), rows the addresses of g, p, m, v, the
// element counts and the offsets in the outputs (multiples of 16 bytes).
// out: p', m', v' flat, each `total` elements, one after the other, 16-byte
// aligned. count, count_out: int32; finite_out: one byte (bool).
// transition_steps 0: the constant rate lr. Launches on `stream`, allocates
// nothing, returns the first launch error or 0 (cudaErrorInvalidValue for
// more than kCap leaves).
int emloco_clip_adam(int elem_bytes, int leaves, const long long* table,
                     const void* count, void* out, long long total,
                     void* count_out, void* finite_out, double max_norm,
                     double lr, int transition_steps, double decay, int guard,
                     void* work, void* stream) {
  if (leaves < 1 || total < 0 || transition_steps < 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const Scalars sc{max_norm, lr, decay, transition_steps, guard};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(count);
  int* co = static_cast<int*>(count_out);
  unsigned char* fo = static_cast<unsigned char*>(finite_out);
  if (elem_bytes == 4)
    return run<float>(leaves, table, c, static_cast<float*>(out), total, co,
                      fo, sc, work, st);
  if (elem_bytes == 8)
    return run<double>(leaves, table, c, static_cast<double*>(out), total, co,
                       fo, sc, work, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
