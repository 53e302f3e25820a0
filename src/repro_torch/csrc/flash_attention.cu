// Fused attention forward for Hopper (sm_90a), bound with ctypes.
//
// K7 flash_attention_fwd replaces flash_attention_pallas
//    (src/repro/kernels/flash_attention/kernel.py): causal and
//    sliding-window softmax attention, softmax(q k^T * scale) v, computed
//    one key tile at a time with a running max, sum and accumulator in
//    f32 (online softmax), so the (S, S) score matrix never exists.
//
// What bounds it on this card
//   At model widths it is bound by operations: 4·D per visible (query, key)
//   pair, which the tensor cores could run at 989 TFLOP/s in bf16. This
//   first kernel runs them on the CUDA cores in f32 (a wgmma path is for a
//   later change). A block owns 64 query rows of one head and keeps them in
//   shared memory; for each 64-key tile it stages K, forms the 64 x 64
//   scores with 4 x 4 register tiles per thread, stages V in the same
//   buffer while one warp per 8 rows updates the softmax state, and
//   accumulates P V into registers (4 rows x D/16 columns per thread).
//   Rows and keys owned by a thread are 16 apart, and rows in shared memory
//   are padded by one float, so the loads are conflict-free or broadcasts.
//
// What the TPU kernel did that this design drops
//   * The grid's KV axis ran in order with the softmax state in VMEM
//     scratch; here each block loops over its key tiles itself, with the
//     state in registers and shared memory.
//   * Key tiles above the causal diagonal or wholly outside the window are
//     not visited at all (the loop bounds exclude them), where the TPU
//     kernel stepped through them with pl.when. Blocks are issued heaviest
//     first (the last query tiles see the most keys under a causal mask).
//   * GQA: query head h reads KV head h / (H / KV) directly, where the
//     wrapper repeated K and V H / KV times.
//   * No sequence padding: loads past the end read zeros, keys past the end
//     are masked and query rows past the end are not stored.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kSide = 16;                    // 16 x 16 threads
constexpr int kRows = kBlockQ / kSide;       // query rows per thread: 4
constexpr int kKeys = kBlockK / kSide;       // keys per thread in the scores: 4
constexpr int kRowsPerWarp = kBlockQ / (kThreads / 32);  // softmax rows per warp: 8
constexpr float kNegInit = -1.0e30f;         // running max before any key, as on the TPU

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr int smem_bytes() {
  // q tile, k/v tile (both padded rows), score tile (padded), row max/sum/scale
  return static_cast<int>(sizeof(float)) *
         (2 * kBlockQ * (D + 1) + kBlockQ * (kBlockK + 1) + 3 * kBlockQ);
}

// Stage rows [row0, row0 + 64) of a (s_len, D) matrix into a padded f32 tile.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int row0, int s_len) {
  for (int idx = threadIdx.x; idx < kBlockK * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int g = row0 + r;
    dst[r * (D + 1) + d] = g < s_len ? to_f32(src[static_cast<long long>(g) * D + d]) : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int heads, int kv_heads,
                       int s_len, int causal, int window, float scale, int q_tiles) {
  constexpr int DP = D + 1;
  constexpr int KP = kBlockK + 1;
  constexpr int DJ = D / kSide;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* kv = qs + kBlockQ * DP;
  float* ps = kv + kBlockK * DP;
  float* row_m = ps + kBlockQ * KP;
  float* row_l = row_m + kBlockQ;
  float* row_a = row_l + kBlockQ;

  const int tid = threadIdx.x;
  const int ty = tid / kSide, tx = tid % kSide;
  const int lane = tid % 32, warp = tid / 32;
  const int qt = q_tiles - 1 - static_cast<int>(blockIdx.x);  // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int kvh = h / (heads / kv_heads);
  const long long q_off = static_cast<long long>(bh) * s_len * D;
  const long long kv_off = (static_cast<long long>(b) * kv_heads + kvh) * s_len * D;
  const int q0 = qt * kBlockQ;

  stage<T, D>(qs, q + q_off, q0, s_len);
  if (tid < kBlockQ) {
    row_m[tid] = kNegInit;
    row_l[tid] = 0.0f;
  }

  // Key tiles that hold a visible key for some row of this query tile.
  const int q_last = min(q0 + kBlockQ, s_len) - 1;
  int kt_end = (s_len + kBlockK - 1) / kBlockK;
  if (causal) kt_end = min(kt_end, q_last / kBlockK + 1);
  int kt_begin = 0;
  const long long first_key = static_cast<long long>(q0) - window + 1;  // q - k < window
  if (first_key > 0) kt_begin = static_cast<int>(first_key / kBlockK);

  float acc[kRows][DJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's V is no longer read
    stage<T, D>(kv, k + kv_off, k0, s_len);
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kw[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty + kSide * i) * DP + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kw[j] = kv[(tx + kSide * j) * DP + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qv[i], kw[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kSide * i;
      const int qi = q0 + r;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int c = tx + kSide * j;
        const int kj = k0 + c;
        const bool visible = kj < s_len && (!causal || qi >= kj) &&
                             static_cast<long long>(qi) - kj < window;
        ps[r * KP + c] = visible ? s[i][j] * scale : -INFINITY;
      }
    }
    __syncthreads();  // scores are complete and K is no longer read

    stage<T, D>(kv, v + kv_off, k0, s_len);
    // Online softmax: warp w updates rows 8w .. 8w + 7, two keys per lane.
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const float x0 = ps[r * KP + lane];
      const float x1 = ps[r * KP + lane + 32];
      float mx = fmaxf(x0, x1);
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(x0 - m_new);  // a masked key (-inf) gives 0
      const float p1 = expf(x1 - m_new);
      float sum = p0 + p1;
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
      ps[r * KP + lane] = p0;
      ps[r * KP + lane + 32] = p1;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        row_a[r] = alpha;
        row_l[r] = alpha * row_l[r] + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();  // P, the row scales and V are in place

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float alpha = row_a[ty + kSide * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float pv[kRows], vv[DJ];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty + kSide * i) * KP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = kv[c * DP + tx + kSide * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty + kSide * i;
    const int qi = q0 + r;
    if (qi >= s_len) continue;
    const float l = row_l[r];
    const float inv = l == 0.0f ? 0.0f : 1.0f / l;  // a row that sees no key gives zeros
    T* dst = o + q_off + static_cast<long long>(qi) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dst[tx + kSide * j] = from_f32<T>(acc[i][j] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int heads,
           int kv_heads, int s_len, int causal, int window, float scale, cudaStream_t s) {
  constexpr int bytes = smem_bytes<D>();
  // Above 48 KB a block's dynamic shared memory must be allowed first; the
  // attribute belongs to the current device, so it is set at every launch.
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (s_len + kBlockQ - 1) / kBlockQ;
  const dim3 grid(q_tiles, batch * heads);
  flash_attention_kernel<T, D><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), heads, kv_heads, s_len, causal, window, scale, q_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int batch, int heads,
             int kv_heads, int s_len, int head_dim, int causal, int window, float scale,
             cudaStream_t s) {
  switch (head_dim) {
    case 32: return launch<T, 32>(q, k, v, o, batch, heads, kv_heads, s_len, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, batch, heads, kv_heads, s_len, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, batch, heads, kv_heads, s_len, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point. q and o are contiguous (batch, heads, s_len, head_dim)
// device arrays, k and v (batch, kv_heads, s_len, head_dim), all of one
// type `dtype`: 0 f32, 1 bf16. head_dim is 32, 64 or 128; heads is a
// multiple of kv_heads. `window` bounds q - k from above (INT_MAX for no
// window); `causal` also masks k > q. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments it cannot take). Does not
// synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int batch, int heads, int kv_heads, int s_len, int head_dim,
                                   int dtype, int causal, int window, float scale,
                                   void* stream) {
  if (batch < 1 || heads < 1 || kv_heads < 1 || heads % kv_heads || s_len < 1)
    return cudaErrorInvalidValue;
  if (static_cast<long long>(batch) * heads > 65535) return cudaErrorInvalidValue;  // grid.y
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(q, k, v, o, batch, heads, kv_heads, s_len, head_dim, causal, window, scale, s);
    case 1: return dispatch<__nv_bfloat16>(q, k, v, o, batch, heads, kv_heads, s_len, head_dim, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
