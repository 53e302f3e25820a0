// Fused attention forward for Hopper (sm_90a), bound with ctypes.
//
// K7 replaces flash_attention_pallas
//    (src/repro/kernels/flash_attention/kernel.py): causal and
//    sliding-window softmax attention, softmax(q k^T * scale) v, computed
//    one key tile at a time with a running max, sum and accumulator in
//    f32 (online softmax), so the (S, S) score matrix never exists. Two
//    kernels serve it; the wrapper picks one by type.
//
// What bounds it on this card
//   At model widths it is bound by operations: 4·D per visible (query, key)
//   pair, which only the tensor cores run at the card's rate (989 TFLOP/s
//   in bf16).
//
// flash_attention_tc: bf16, on the tensor cores
//   A block owns 128 query rows of one head: its first warpgroup is the
//   producer, whose one thread loads Q once by TMA and then streams 128-key
//   tiles of K and V through a double-buffered mbarrier ring; the two other
//   warpgroups own 64 query rows each. Per key tile a consumer forms
//   S = Q K^T with wgmma (Q and K both K-major: D is the reduction), runs
//   the online softmax on the f32 accumulator fragment in registers (a row
//   lies across the 4 threads of a quad, so its max needs two shuffles; the
//   row sums stay per thread until the end; exp2 with log2(e) folded into
//   the scale), splits P into two bf16 terms in registers, hi + lo, as the
//   A operands of O += P V, and reads V from shared memory MN-major with the
//   transpose bit. Only tiles on the causal diagonal, the window's edge or the end of
//   the sequence are masked; the others are not looked at element by
//   element. Rows of 64 bytes (D = 32) use the 64-byte swizzle, longer rows
//   the 128-byte one in 64-column chunks. K and V are described by 3-D
//   tensor maps over (D, S, B·KV), so loads past S read TMA's zeros and
//   never the next head's rows.
//   The TPU kernel multiplied P in f32. One bf16 rounding of P (2^-9
//   relative) leaves the bf16 output tolerance on rows that see few keys,
//   so P is carried as hi = bf16(P) and lo = bf16(P - hi), about 2^-17
//   relative, at the price of a second P V product (half again the
//   operations of S and P V at one rounding).
//
// flash_attention_fwd: f32, on the CUDA cores
//   A tensor-core f32 route would be TF32, whose rounding the f32 tolerance
//   does not admit. A block owns 64 query rows of one head and keeps them in
//   shared memory; for each 64-key tile it stages K, forms the 64 x 64
//   scores with 4 x 4 register tiles per thread, stages V in the same
//   buffer while one warp per 8 rows updates the softmax state, and
//   accumulates P V into registers (4 rows x D/16 columns per thread).
//   Rows and keys owned by a thread are 16 apart, and rows in shared memory
//   are padded by one float, so the loads are conflict-free or broadcasts.
//
// What the TPU kernel did that these designs drop
//   * The grid's KV axis ran in order with the softmax state in VMEM
//     scratch; here each block loops over its key tiles itself, with the
//     state in registers (and, for f32, shared memory).
//   * Key tiles above the causal diagonal or wholly outside the window are
//     not visited at all (the loop bounds exclude them), where the TPU
//     kernel stepped through them with pl.when. Blocks are issued heaviest
//     first (the last query tiles see the most keys under a causal mask).
//   * GQA: query head h reads KV head h / (H / KV) directly, where the
//     wrapper repeated K and V H / KV times.
//   * No sequence padding: loads past the end read zeros, keys past the end
//     are masked and query rows past the end are not stored.

#include <atomic>
#include <climits>
#include <cmath>
#include <cstdint>
#include <initializer_list>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

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

template <int D>
constexpr int smem_bytes() {
  // q tile, k/v tile (both padded rows), score tile (padded), row max/sum/scale
  return static_cast<int>(sizeof(float)) *
         (2 * kBlockQ * (D + 1) + kBlockQ * (kBlockK + 1) + 3 * kBlockQ);
}

// Stage rows [row0, row0 + 64) of a (s_len, D) matrix into a padded tile.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int row0, int s_len) {
  for (int idx = threadIdx.x; idx < kBlockK * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int g = row0 + r;
    dst[r * (D + 1) + d] = g < s_len ? src[static_cast<long long>(g) * D + d] : 0.0f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int heads, int kv_heads,
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

  stage<D>(qs, q + q_off, q0, s_len);
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
    stage<D>(kv, k + kv_off, k0, s_len);
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

    stage<D>(kv, v + kv_off, k0, s_len);
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
    float* dst = o + q_off + static_cast<long long>(qi) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dst[tx + kSide * j] = acc[i][j] * inv;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int heads,
           int kv_heads, int s_len, int causal, int window, float scale, cudaStream_t s) {
  constexpr int bytes = smem_bytes<D>();
  // Above 48 KB a block's dynamic shared memory must be allowed first.
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t err =
      hopper::allow_smem(flash_attention_kernel<D>, bytes, hopper::current_device(), smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (s_len + kBlockQ - 1) / kBlockQ;
  const dim3 grid(q_tiles, batch * heads);
  flash_attention_kernel<D><<<grid, kThreads, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), heads, kv_heads, s_len, causal, window, scale, q_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point of the CUDA-core route. q and o are contiguous (batch,
// heads, s_len, head_dim) f32 device arrays, k and v (batch, kv_heads,
// s_len, head_dim) (bf16 takes flash_attention_tc). head_dim is 32, 64 or
// 128; heads is a multiple of kv_heads. `window` bounds q - k from above (INT_MAX for no
// window); `causal` also masks k > q. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments it cannot take). Does not
// synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int batch, int heads, int kv_heads, int s_len, int head_dim,
                                   int causal, int window, float scale, void* stream) {
  if (batch < 1 || heads < 1 || kv_heads < 1 || heads % kv_heads || s_len < 1)
    return cudaErrorInvalidValue;
  if (static_cast<long long>(batch) * heads > 65535) return cudaErrorInvalidValue;  // grid.y
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return launch<32>(q, k, v, o, batch, heads, kv_heads, s_len, causal, window, scale, s);
    case 64: return launch<64>(q, k, v, o, batch, heads, kv_heads, s_len, causal, window, scale, s);
    case 128: return launch<128>(q, k, v, o, batch, heads, kv_heads, s_len, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The tensor-core route (bf16)
// ---------------------------------------------------------------------------

namespace {

constexpr int kTcConsumers = 2;                 // consumer warpgroups, 64 query rows each
constexpr int kTcQ = 64 * kTcConsumers;         // query rows per block
constexpr int kTcKV = 128;                      // keys per tile
constexpr int kTcThreads = 128 * (kTcConsumers + 1);
constexpr int kTcStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

// Rows of D bf16 values are stored as `kChunks` stacks of kRow-byte rows.
template <int D> struct Attn {
  static constexpr int kRow = D >= 64 ? 128 : 64;  // swizzle span in bytes
  static constexpr int kChunk = kRow / 2;          // D columns per chunk
  static constexpr int kChunks = D / kChunk;
  static constexpr int kQBytes = kTcQ * D * 2;
  static constexpr int kKVBytes = kTcKV * D * 2;
  static constexpr int kSmem = kQBytes + 2 * kTcStages * kKVBytes + 1024 + (2 * kTcStages + 1) * 8;
};

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o,
                          int heads, int kv_heads, int s_len, int causal, int window, float scale,
                          int q_tiles) {
  using namespace hopper;
  using A = Attn<D>;
  constexpr int kRow = A::kRow;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* q_tile = smem;
  uint8_t* kv_tiles = smem + A::kQBytes;  // stage s: K at 2s, V at 2s + 1
  uint64_t* full = reinterpret_cast<uint64_t*>(kv_tiles + 2 * kTcStages * A::kKVBytes);
  uint64_t* empty = full + kTcStages;
  uint64_t* q_full = empty + kTcStages;

  // Heaviest first: every head's last query tile, then the ones before.
  const int bh_count = gridDim.x / q_tiles;
  const int qt = q_tiles - 1 - static_cast<int>(blockIdx.x) / bh_count;
  const int bh = static_cast<int>(blockIdx.x) % bh_count;
  const int b = bh / heads, h = bh % heads;
  const int kv_row = b * kv_heads + h / (heads / kv_heads);
  const int q0 = qt * kTcQ;

  // Key tiles that hold a visible key for some row of this query tile.
  const int q_last = min(q0 + kTcQ, s_len) - 1;
  int kt_end = (s_len + kTcKV - 1) / kTcKV;
  if (causal) kt_end = min(kt_end, q_last / kTcKV + 1);
  int kt_begin = 0;
  const long long first_key = static_cast<long long>(q0) - window + 1;  // q - k < window
  if (first_key > 0) kt_begin = static_cast<int>(min(first_key / kTcKV, static_cast<long long>(kt_end)));

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kTcConsumers);
    }
    mbar_init(q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    regs_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, A::kQBytes);
#pragma unroll
      for (int c = 0; c < A::kChunks; ++c)
        tma_load_3d(q_tile + c * kTcQ * kRow, &map_q, q_full, c * A::kChunk, q0, bh);
      for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
        const int st = it % kTcStages;
        uint8_t* k_tile = kv_tiles + 2 * st * A::kKVBytes;
        uint8_t* v_tile = k_tile + A::kKVBytes;
        mbar_wait(&empty[st], ((it / kTcStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * A::kKVBytes);
#pragma unroll
        for (int c = 0; c < A::kChunks; ++c) {
          tma_load_3d(k_tile + c * kTcKV * kRow, &map_k, &full[st], c * A::kChunk, kt * kTcKV, kv_row);
          tma_load_3d(v_tile + c * kTcKV * kRow, &map_v, &full[st], c * A::kChunk, kt * kTcKV, kv_row);
        }
      }
    }
  } else {
    regs_inc<240>();
    const int c = wg - 1;
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x / 32) % 4;
    const int row0 = q0 + c * 64 + 16 * warp + lane / 4;  // and row0 + 8
    const int qa = q0 + c * 64;                            // this warpgroup's rows [qa, qa + 63]
    const float sc = scale * kLog2e;
    float o_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.0f;
    float m_run[2] = {kNegInit, kNegInit};  // running max, in log2 units
    float l_run[2] = {0.0f, 0.0f};          // this thread's share of the row sums
    mbar_wait(q_full, 0);

    for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
      const int st = it % kTcStages;
      const uint8_t* k_tile = kv_tiles + 2 * st * A::kKVBytes;
      const uint8_t* v_tile = k_tile + A::kKVBytes;
      const int k0 = kt * kTcKV;
      mbar_wait(&full[st], (it / kTcStages) & 1);

      // S = Q K^T (64 x 128), D / 16 k slices
      float s[kTcKV / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int chunk = kk * 16 / A::kChunk;
        const int off = (kk * 16 % A::kChunk) * 2;
        const uint64_t dq = smem_desc(q_tile + chunk * kTcQ * kRow + c * 64 * kRow + off, 16,
                                      8 * kRow, kRow);
        const uint64_t dk = smem_desc(k_tile + chunk * kTcKV * kRow + off, 16, 8 * kRow, kRow);
        wgmma_bf16_ss<0>(s, dq, dk, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // Scale, mask, online softmax on the fragment.
      const bool whole = k0 + kTcKV <= s_len && (!causal || k0 + kTcKV - 1 <= qa) &&
                         static_cast<long long>(qa + 63) - k0 < window;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kTcKV / 2; ++i) {
        float x = s[i] * sc;
        if (!whole) {
          const int qi = row0 + ((i & 2) ? 8 : 0);
          const int kj = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
          const bool visible = kj < s_len && (!causal || qi >= kj) &&
                               static_cast<long long>(qi) - kj < window;
          if (!visible) x = -INFINITY;
        }
        s[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);
        alpha[r] = exp2f(m_run[r] - m_new);
        m_run[r] = m_new;
        l_run[r] *= alpha[r];
      }
      // P = hi + lo, two bf16 terms: one bf16 rounding of P (2^-9
      // relative) would leave the bf16 tolerance where few keys are seen.
      uint32_t p_hi[kTcKV / 16][4], p_lo[kTcKV / 16][4];
#pragma unroll
      for (int i = 0; i < kTcKV / 2; i += 2) {
        const int r = (i >> 1) & 1;
        const float p0 = exp2f(s[i] - m_run[r]);  // a masked key (-inf) gives 0
        const float p1 = exp2f(s[i + 1] - m_run[r]);
        l_run[r] += p0 + p1;
        const uint32_t hi = pack_bf16(p0, p1);
        p_hi[i / 8][(i % 8) / 2] = hi;
        p_lo[i / 8][(i % 8) / 2] =
            pack_bf16(p0 - __uint_as_float(hi << 16), p1 - __uint_as_float(hi & 0xFFFF0000u));
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o_acc[i] *= alpha[(i >> 1) & 1];

      // O += P V: 128 keys in k slices of 16; V (keys, D) read MN-major.
      fence_regs(o_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTcKV / 16; ++kk) {
        const uint64_t dv = smem_desc(v_tile + kk * 16 * kRow, kTcKV * kRow, 8 * kRow, kRow);
        wgmma_bf16_rs(o_acc, p_hi[kk], dv);
        wgmma_bf16_rs(o_acc, p_lo[kk], dv);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o_acc);
      mbar_arrive(&empty[st]);
    }

    // Normalise in f32 and store bf16; a row that sees no key gives zeros.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(kFull, l, 1);
      l += __shfl_xor_sync(kFull, l, 2);
      inv[r] = l == 0.0f ? 0.0f : 1.0f / l;
    }
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int r = (i >> 1) & 1;
      const int qi = row0 + 8 * r;
      if (qi >= s_len) continue;
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      __nv_bfloat16* dst = o + (static_cast<long long>(bh) * s_len + qi) * D + col;
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          __floats2bfloat162_rn(o_acc[i] * inv[r], o_acc[i + 1] * inv[r]);
    }
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int batch, int heads,
              int kv_heads, int s_len, int causal, int window, float scale, cudaStream_t s) {
  using A = Attn<D>;
  CUtensorMap map_q, map_k, map_v;
  const uint64_t dims_q[3] = {D, static_cast<uint64_t>(s_len), static_cast<uint64_t>(batch) * heads};
  const uint64_t dims_kv[3] = {D, static_cast<uint64_t>(s_len), static_cast<uint64_t>(batch) * kv_heads};
  const uint64_t strides[2] = {D * 2, static_cast<uint64_t>(s_len) * D * 2};
  const uint32_t box_q[3] = {A::kChunk, kTcQ, 1};
  const uint32_t box_kv[3] = {A::kChunk, kTcKV, 1};
  if (!hopper::make_map(&map_q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, q, dims_q, strides, box_q, A::kRow) ||
      !hopper::make_map(&map_k, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, k, dims_kv, strides, box_kv, A::kRow) ||
      !hopper::make_map(&map_v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, v, dims_kv, strides, box_kv, A::kRow))
    return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t err = hopper::allow_smem(flash_attention_tc_kernel<D>, A::kSmem,
                                             hopper::current_device(), smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (s_len + kTcQ - 1) / kTcQ;
  const long long blocks = static_cast<long long>(q_tiles) * batch * heads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  flash_attention_tc_kernel<D><<<static_cast<unsigned>(blocks), kTcThreads, A::kSmem, s>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(o), heads, kv_heads, s_len, causal, window,
      scale, q_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point of the tensor-core route. q and o are contiguous (batch,
// heads, s_len, head_dim) bf16 device arrays, k and v (batch, kv_heads,
// s_len, head_dim), all 16-byte aligned; head_dim is 32, 64 or 128; heads
// is a multiple of kv_heads. `window` bounds q - k from above (INT_MAX for
// no window); `causal` also masks k > q. Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for arguments it cannot take, or a
// tensor map cuTensorMapEncodeTiled refuses). Does not synchronise.
extern "C" int flash_attention_tc(const void* q, const void* k, const void* v, void* o, int batch,
                                  int heads, int kv_heads, int s_len, int head_dim, int causal,
                                  int window, float scale, void* stream) {
  if (batch < 1 || heads < 1 || kv_heads < 1 || heads % kv_heads || s_len < 1)
    return cudaErrorInvalidValue;
  for (const void* p : {q, k, v, static_cast<const void*>(o)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return launch_tc<32>(q, k, v, o, batch, heads, kv_heads, s_len, causal, window, scale, s);
    case 64: return launch_tc<64>(q, k, v, o, batch, heads, kv_heads, s_len, causal, window, scale, s);
    case 128: return launch_tc<128>(q, k, v, o, batch, heads, kv_heads, s_len, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
