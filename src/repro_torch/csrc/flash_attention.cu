// Fused attention forward for Hopper (sm_90a), bound with ctypes.
//
// K7 replaces flash_attention_pallas
//    (src/repro/kernels/flash_attention/kernel.py): causal and
//    sliding-window softmax attention, softmax(q k^T * scale) v, computed
//    one key tile at a time with a running max, sum and accumulator in
//    f32 (online softmax), so the (S, S) score matrix never exists. Both
//    types run on the tensor cores, in two kernels of one structure; the
//    wrapper picks one by type.
//
// What bounds it on this card
//   At model widths it is bound by operations: 4·D per visible (query, key)
//   pair, which only the tensor cores run at the card's rate (989 TFLOP/s
//   in bf16, 495 in TF32).
//
// The structure both kernels share
//   A block owns 128 query rows of one head: its first warpgroup is the
//   producer, whose one thread loads Q once by TMA and then streams key
//   tiles of K and V through a double-buffered mbarrier ring; the two other
//   warpgroups own 64 query rows each. Per key tile a consumer forms
//   S = Q K^T with wgmma (Q and K both K-major: D is the reduction), runs
//   the online softmax on the f32 accumulator fragment in registers (a row
//   lies across the 4 threads of a quad, so its max needs two shuffles; the
//   row sums stay per thread until the end; exp2 with log2(e) folded into
//   the scale), and adds P V to its f32 output accumulator, P V formed by
//   wgmma with P in registers as the A operand. Only tiles on the causal diagonal, the
//   window's edge or the end of the sequence are masked; the others are not
//   looked at element by element. The tensor maps are 3-D, over (row, S,
//   heads), so loads past S read TMA's zeros and never the next head's rows.
//
// flash_attention_tc: bf16
//   128-key tiles; rows of 64 bytes (D = 32) use the 64-byte swizzle,
//   longer rows the 128-byte one in 64-column chunks. V is read from shared
//   memory MN-major with the transpose bit. The TPU kernel multiplied P in
//   f32. One bf16 rounding of P (2^-9 relative) leaves the bf16 output
//   tolerance on rows that see few keys, so P is carried as hi = bf16(P)
//   and lo = bf16(P - hi), about 2^-17 relative, at the price of a second
//   P V product (half again the operations of S and P V at one rounding).
//
// flash_attention_tf32: f32, as three TF32 products
//   One TF32 product keeps 11 significant bits of each operand, which the
//   f32 tolerance does not admit; three do, as in K6's f32 route
//   (ws_matmul.cu): x = big + small + r with big and small TF32 values
//   (hopper::split_tf32) and |r| <= 2^-22 |x|, so a.b = a_s.b_b + a_b.b_s +
//   a_b.b_b up to about 3 * 2^-22 |a|.|b|. Both products take it, the small
//   ones first: S = Q_s K_b + Q_b K_s + Q_b K_b and P V = P_s V_b +
//   P_b V_s + P_b V_b. Its bound is three times
//   the operations at half the bf16 rate, so the kernel is built to keep
//   the tensor cores fed:
//   * Operand planes. The prep kernel attention_operand_planes, launched
//     first in the same call, writes K's big and small planes as (2, B·KV,
//     S, D) and V's transposed as (2, B·KV, D, Sp), Sp = S rounded up to 32
//     with zeros past S: TF32 has no transpose bit, so the B operand of P V
//     must reach shared memory with the keys contiguous. Q, read once per
//     block, is split in the kernel: TMA loads it as it is, and each
//     consumer thread rounds the values of its own A fragments to big in
//     place (then a proxy fence and a barrier of its warpgroup) and keeps
//     small in registers, so Q_s K_b is a register-A product.
//   * P without a shuffle. The S accumulator gives a thread keys 2t and
//     2t + 1 of each 8-key slice (t = lane % 4), and the TF32 A fragment
//     takes columns t and t + 4. P V sums over keys, so the prep writes each
//     8-key group of V^T in the order 0, 2, 4, 6, 1, 3, 5, 7, and P's
//     fragment is the accumulator's registers reordered. P is split in
//     registers: big = cvt.rna.tf32(P), small = cvt.rna.tf32(P - big).
//   * Accuracy over long rows. The tensor cores' f32 accumulation
//     truncates at every k step; summed over a whole row into one
//     accumulator (about 1,500 steps at 4096 keys) that left 6-7x the plain
//     f32 version's error against float64. Each tile's P V is summed in a
//     fresh accumulator, half of D at a time, and added to O on the CUDA
//     cores (an FMA with the rescale by alpha that O takes anyway), which
//     brings the error to the plain version's (tools/k7_variants.py).
//   * Shared memory. f32 planes take four times bf16's bytes, so the tiles
//     are chosen by D (Tf32Attn): Q's big plane for 128 rows, 64 KB at
//     D = 128, and two stages of K's and V^T's planes, 16 * keys * D bytes
//     each: 32-key tiles at D = 128 (192 KB in all), 64-key tiles at D = 32
//     and 64. Q's small plane in registers (4 * D / 8 a thread, 64 at
//     D = 128) is what lets two consumers share the ring: both of Q's
//     planes in shared memory would leave room for one stage.
//   The planes' limit is K6's: values below about 2^-120, whose small plane
//   is subnormal, keep fewer bits, so outputs made of such V values (or
//   logits made of such Q and K) miss the f32 tolerance.
//
// What the TPU kernel did that these designs drop
//   * The grid's KV axis ran in order with the softmax state in VMEM
//     scratch; here each block loops over its key tiles itself, with the
//     state in registers.
//   * Key tiles above the causal diagonal or wholly outside the window are
//     not visited at all (the loop bounds exclude them), where the TPU
//     kernel stepped through them with pl.when. Blocks are issued heaviest
//     first (the last query tiles see the most keys under a causal mask).
//   * GQA: query head h reads KV head h / (H / KV) directly, where the
//     wrapper repeated K and V H / KV times.
//   * No sequence padding: loads past the end read zeros, keys past the end
//     are masked and query rows past the end are not stored.

#include <algorithm>
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
constexpr float kNegInit = -1.0e30f;            // running max before any key, as on the TPU
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTcConsumers = 2;                 // consumer warpgroups, 64 query rows each
constexpr int kTcQ = 64 * kTcConsumers;         // query rows per block
constexpr int kTcThreads = 128 * (kTcConsumers + 1);
constexpr int kTcStages = 2;

}  // namespace

// ---------------------------------------------------------------------------
// bf16: flash_attention_tc
// ---------------------------------------------------------------------------

namespace {

constexpr int kTcKV = 128;  // keys per tile

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

// ---------------------------------------------------------------------------
// f32: attention_operand_planes and flash_attention_tf32
// ---------------------------------------------------------------------------

namespace {

constexpr int kPlaneKeys = 32;  // V^T's planes pad the keys to a multiple of this

// The tf32 kernel's key tile and shared memory, by D. Rows of f32 values
// are stored as D / 32 stacks of 128-byte (32-value) rows, 128-byte swizzle.
template <int D> struct Tf32Attn {
  static constexpr int kKeys = D == 128 ? 32 : 64;  // keys per tile
  static constexpr int kChunks = D / 32;
  static constexpr int kQBytes = kTcQ * D * 4;       // Q, then its big plane
  static constexpr int kKBytes = kKeys * D * 4;      // one plane of a K tile
  static constexpr int kVBytes = D * kKeys * 4;      // one plane of a V^T tile
  static constexpr int kStageBytes = 2 * (kKBytes + kVBytes);
  static constexpr int kSmem = kQBytes + kTcStages * kStageBytes + 1024 + (2 * kTcStages + 1) * 8;
};

// The byte offset of element (row, col) in a stack of 128-byte rows of f32
// whose base is 1024-byte aligned, as TMA's 128-byte swizzle places it (the
// 16-byte unit XOR row % 8).
__device__ __forceinline__ int swizzle128(int row, int col) {
  return (row * 128 + col * 4) ^ ((row & 7) << 4);
}

// Blocks [0, k_blocks) split K, float4 by float4 (grid-stride); the others
// each transpose one 32 x 32 tile of V (tile t: column tile t % d_tiles,
// key tile (t / d_tiles) % s_tiles, head t / (d_tiles * s_tiles)) into
// V^T's planes, position p of each 8-key group holding key
// 2 (p % 4) + p / 4: the order 0, 2, 4, 6, 1, 3, 5, 7.
__global__ void __launch_bounds__(256)
attention_operand_planes_kernel(const float* __restrict__ k, const float* __restrict__ v,
                                float* __restrict__ kp, float* __restrict__ vtp, int bkv, int s_len,
                                int d, int sp, long long k_vec4, int k_blocks, int s_tiles,
                                int d_tiles) {
  __shared__ float tile[32][33];
  if (static_cast<int>(blockIdx.x) < k_blocks) {
    const float4* src = reinterpret_cast<const float4*>(k);
    float4* big = reinterpret_cast<float4*>(kp);
    float4* small = big + k_vec4;
    for (long long i = blockIdx.x * 256LL + threadIdx.x; i < k_vec4; i += k_blocks * 256LL) {
      const float4 x = src[i];
      float4 b, s;
      hopper::split_tf32(x.x, b.x, s.x);
      hopper::split_tf32(x.y, b.y, s.y);
      hopper::split_tf32(x.z, b.z, s.z);
      hopper::split_tf32(x.w, b.w, s.w);
      big[i] = b;
      small[i] = s;
    }
    return;
  }
  const int t = blockIdx.x - k_blocks;
  const int d0 = (t % d_tiles) * 32;
  const int s0 = (t / d_tiles % s_tiles) * 32;
  const int z = t / (d_tiles * s_tiles);
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const float* vz = v + static_cast<long long>(z) * s_len * d;
  for (int i = ty; i < 32; i += 8) {
    const int key = s0 + i;
    tile[i][tx] = key < s_len ? vz[static_cast<long long>(key) * d + d0 + tx] : 0.0f;
  }
  __syncthreads();
  const int key = 8 * (tx / 8) + ((tx & 3) << 1) + ((tx >> 2) & 1);  // the key at position s0 + tx
  const long long size = static_cast<long long>(bkv) * d * sp;
  for (int i = ty; i < 32; i += 8) {
    float b, s;
    hopper::split_tf32(tile[key][i], b, s);
    const long long at = (static_cast<long long>(z) * d + d0 + i) * sp + s0 + tx;
    vtp[at] = b;
    vtp[size + at] = s;
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_tf32_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_vt, float* __restrict__ o,
                            int heads, int kv_heads, int bkv, int s_len, int causal, int window,
                            float scale, int q_tiles) {
  using namespace hopper;
  using A = Tf32Attn<D>;
  constexpr int kKeys = A::kKeys;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* q_tile = smem;
  uint8_t* stages = smem + A::kQBytes;  // a stage: K_b, K_s, V^T_b, V^T_s
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kTcStages * A::kStageBytes);
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
  int kt_end = (s_len + kKeys - 1) / kKeys;
  if (causal) kt_end = min(kt_end, q_last / kKeys + 1);
  int kt_begin = 0;
  const long long first_key = static_cast<long long>(q0) - window + 1;  // q - k < window
  if (first_key > 0) kt_begin = static_cast<int>(min(first_key / kKeys, static_cast<long long>(kt_end)));

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
        tma_load_3d(q_tile + c * kTcQ * 128, &map_q, q_full, c * 32, q0, bh);
      for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
        const int st = it % kTcStages;
        uint8_t* stage = stages + st * A::kStageBytes;
        mbar_wait(&empty[st], ((it / kTcStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], A::kStageBytes);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
#pragma unroll
          for (int c = 0; c < A::kChunks; ++c)
            tma_load_3d(stage + p * A::kKBytes + c * kKeys * 128, &map_k, &full[st], c * 32,
                        kt * kKeys, p * bkv + kv_row);
#pragma unroll
          for (int c = 0; c < kKeys / 32; ++c)
            tma_load_3d(stage + 2 * A::kKBytes + p * A::kVBytes + c * D * 128, &map_vt, &full[st],
                        kt * kKeys + c * 32, 0, p * bkv + kv_row);
        }
      }
    }
  } else {
    regs_inc<240>();
    const int c = wg - 1;
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x / 32) % 4;
    const int t = lane % 4;
    const int row0 = q0 + c * 64 + 16 * warp + lane / 4;  // and row0 + 8
    const int qa = q0 + c * 64;                            // this warpgroup's rows [qa, qa + 63]
    const float sc = scale * kLog2e;
    uint8_t* q_mine = q_tile + c * 64 * 128;  // its rows in each 128-byte stack
    // Descriptors of k slice kk (8 values of the reduction): Q_b's rows of
    // this warpgroup, a K plane's tile (kKeys rows of D), a V^T plane's
    // tile (D rows of kKeys).
    const auto q_desc = [&](int kk) {
      return smem_desc(q_mine + (kk / 4) * kTcQ * 128 + (kk % 4) * 32, 16, 8 * 128, 128);
    };
    const auto k_desc = [&](const uint8_t* tile, int kk) {
      return smem_desc(tile + (kk / 4) * kKeys * 128 + (kk % 4) * 32, 16, 8 * 128, 128);
    };
    const auto v_desc = [&](const uint8_t* tile, int kk) {
      return smem_desc(tile + (kk / 4) * D * 128 + (kk % 4) * 32, 16, 8 * 128, 128);
    };

    // Split Q: each thread rounds the values of its own A fragments (rows
    // r, r + 8, columns t, t + 4 of every k slice) to big in place and
    // keeps small, the A operand of Q_s K_b.
    mbar_wait(q_full, 0);
    uint32_t q_s[D / 8][4];
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 16 * warp + lane / 4 + 8 * (j & 1);
        const int col = (kk % 4) * 8 + t + 4 * (j >> 1);
        float* x = reinterpret_cast<float*>(q_mine + (kk / 4) * kTcQ * 128 + swizzle128(r, col));
        float big, small;
        split_tf32(*x, big, small);
        *x = big;
        q_s[kk][j] = __float_as_uint(small);
      }
    }
    fence_proxy_async();
    bar_sync(1 + c, 128);

    float o_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.0f;
    float m_run[2] = {kNegInit, kNegInit};  // running max, in log2 units
    float l_run[2] = {0.0f, 0.0f};          // this thread's share of the row sums

    for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
      const int st = it % kTcStages;
      const uint8_t* k_b = stages + st * A::kStageBytes;
      const uint8_t* k_s = k_b + A::kKBytes;
      const uint8_t* v_b = k_s + A::kKBytes;
      const uint8_t* v_s = v_b + A::kVBytes;
      const int k0 = kt * kKeys;
      mbar_wait(&full[st], (it / kTcStages) & 1);

      // S = Q_s K_b + Q_b K_s + Q_b K_b (64 x kKeys), D / 8 k slices each
      float s[kKeys / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) wgmma_tf32_rs(s, q_s[kk], k_desc(k_b, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) wgmma_tf32_ss(s, q_desc(kk), k_desc(k_s, kk), 1);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) wgmma_tf32_ss(s, q_desc(kk), k_desc(k_b, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // Scale, mask, online softmax on the fragment.
      const bool whole = k0 + kKeys <= s_len && (!causal || k0 + kKeys - 1 <= qa) &&
                         static_cast<long long>(qa + 63) - k0 < window;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        float x = s[i] * sc;
        if (!whole) {
          const int qi = row0 + ((i & 2) ? 8 : 0);
          const int kj = k0 + 8 * (i / 4) + 2 * t + (i & 1);
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
      // P's big and small parts as A fragments of P V. Slice j of 8 keys
      // holds s[4j] (row r, key 2t), s[4j + 1] (r, 2t + 1), s[4j + 2]
      // (r + 8, 2t) and s[4j + 3] (r + 8, 2t + 1); the fragment is (r,
      // column t), (r + 8, t), (r, t + 4), (r + 8, t + 4), and V^T's
      // column t holds key 2t, column t + 4 key 2t + 1.
      uint32_t p_b[kKeys / 8][4], p_s[kKeys / 8][4];
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        const float p[4] = {exp2f(s[4 * j] - m_run[0]), exp2f(s[4 * j + 2] - m_run[1]),
                            exp2f(s[4 * j + 1] - m_run[0]), exp2f(s[4 * j + 3] - m_run[1])};
        l_run[0] += p[0] + p[2];  // a masked key (-inf) gives 0
        l_run[1] += p[1] + p[3];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          p_b[j][x] = cvt_rna_tf32(p[x]);
          p_s[j][x] = cvt_rna_tf32(p[x] - __uint_as_float(p_b[j][x]));
        }
      }
      // O = alpha O + P_s V_b + P_b V_s + P_b V_b, kKeys / 8 k slices each.
      // The tensor cores' f32 sums truncate at each k step, which over a
      // whole row (some 1,500 steps at 4096 keys) left 6-7x the plain f32
      // version's error; so each tile's P V goes into a fresh accumulator,
      // half of D at a time (N = D / 2, so that it fits beside Q's small
      // plane), and is added to O on the CUDA cores.
      constexpr int kParts = D >= 64 ? 2 : 1;
      constexpr int kPart = D / kParts / 2;
#pragma unroll
      for (int part = 0; part < kParts; ++part) {
        float pv[kPart];
        const int off = part * (D / kParts) * 128;
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) wgmma_tf32_rs(pv, p_s[j], v_desc(v_b + off, j), j > 0);
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) wgmma_tf32_rs(pv, p_b[j], v_desc(v_s + off, j), 1);
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) wgmma_tf32_rs(pv, p_b[j], v_desc(v_b + off, j), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(pv);
#pragma unroll
        for (int i = 0; i < kPart; ++i)
          o_acc[part * kPart + i] = fmaf(o_acc[part * kPart + i], alpha[(i >> 1) & 1], pv[i]);
      }
      mbar_arrive(&empty[st]);
    }

    // Normalise and store; a row that sees no key gives zeros.
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
      const int col = 8 * (i / 4) + 2 * t;
      float* dst = o + (static_cast<long long>(bh) * s_len + qi) * D + col;
      *reinterpret_cast<float2*>(dst) = make_float2(o_acc[i] * inv[r], o_acc[i + 1] * inv[r]);
    }
  }
}

int launch_planes(const void* k, const void* v, void* k_planes, void* vt_planes, int bkv, int s_len,
                  int d, cudaStream_t s) {
  const int sp = (s_len + kPlaneKeys - 1) / kPlaneKeys * kPlaneKeys;
  const long long k_vec4 = static_cast<long long>(bkv) * s_len * d / 4;
  const int k_blocks = static_cast<int>(std::min<long long>(4096, (k_vec4 + 255) / 256));
  const int s_tiles = sp / 32, d_tiles = d / 32;
  const long long blocks = k_blocks + static_cast<long long>(bkv) * s_tiles * d_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  attention_operand_planes_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), static_cast<float*>(k_planes),
      static_cast<float*>(vt_planes), bkv, s_len, d, sp, k_vec4, k_blocks, s_tiles, d_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tf32(const void* q, const void* k, const void* v, void* planes, void* o, int batch,
                int heads, int kv_heads, int s_len, int causal, int window, float scale,
                cudaStream_t s) {
  using A = Tf32Attn<D>;
  const int bkv = batch * kv_heads;
  const uint64_t sp = (s_len + kPlaneKeys - 1) / kPlaneKeys * kPlaneKeys;
  float* k_planes = static_cast<float*>(planes);
  float* vt_planes = k_planes + 2ull * bkv * s_len * D;
  const int err = launch_planes(k, v, k_planes, vt_planes, bkv, s_len, D, s);
  if (err != cudaSuccess) return err;
  CUtensorMap map_q, map_k, map_vt;
  const uint64_t dims_q[3] = {D, static_cast<uint64_t>(s_len), static_cast<uint64_t>(batch) * heads};
  const uint64_t dims_k[3] = {D, static_cast<uint64_t>(s_len), 2ull * bkv};
  const uint64_t strides_qk[2] = {D * 4, static_cast<uint64_t>(s_len) * D * 4};
  const uint64_t dims_vt[3] = {sp, D, 2ull * bkv};
  const uint64_t strides_vt[2] = {sp * 4, sp * D * 4};
  const uint32_t box_q[3] = {32, kTcQ, 1};
  const uint32_t box_k[3] = {32, A::kKeys, 1};
  const uint32_t box_vt[3] = {32, D, 1};
  if (!hopper::make_map(&map_q, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, q, dims_q, strides_qk, box_q, 128) ||
      !hopper::make_map(&map_k, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, k_planes, dims_k, strides_qk, box_k, 128) ||
      !hopper::make_map(&map_vt, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, vt_planes, dims_vt, strides_vt, box_vt, 128))
    return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t set = hopper::allow_smem(flash_attention_tf32_kernel<D>, A::kSmem,
                                             hopper::current_device(), smem_set);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int q_tiles = (s_len + kTcQ - 1) / kTcQ;
  const long long blocks = static_cast<long long>(q_tiles) * batch * heads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  flash_attention_tf32_kernel<D><<<static_cast<unsigned>(blocks), kTcThreads, A::kSmem, s>>>(
      map_q, map_k, map_vt, static_cast<float*>(o), heads, kv_heads, bkv, s_len, causal, window,
      scale, q_tiles);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

}  // namespace

// C entry point of the prep kernel. k and v are contiguous (bkv, s_len,
// head_dim) f32 device arrays, 16-byte aligned; head_dim is 32, 64 or 128.
// Writes k_planes (2, bkv, s_len, head_dim), K's big and small planes, and
// vt_planes (2, bkv, head_dim, sp), those of V transposed, sp = s_len
// rounded up to a multiple of 32, each 8-key group in the order 0, 2, 4, 6,
// 1, 3, 5, 7 and zeros past s_len (see the note at the top). Returns
// cudaGetLastError() after the launch. Does not synchronise.
extern "C" int attention_operand_planes(const void* k, const void* v, void* k_planes,
                                        void* vt_planes, int bkv, int s_len, int head_dim,
                                        void* stream) {
  if (bkv < 1 || s_len < 1 || (head_dim != 32 && head_dim != 64 && head_dim != 128) ||
      !aligned16({k, v, k_planes}))
    return cudaErrorInvalidValue;
  return launch_planes(k, v, k_planes, vt_planes, bkv, s_len, head_dim,
                       static_cast<cudaStream_t>(stream));
}

// C entry point of the f32 route: the prep kernel into `planes`, then the
// tensor-core kernel. q and o are contiguous (batch, heads, s_len,
// head_dim) f32 device arrays, k and v (batch, kv_heads, s_len, head_dim),
// q, k and v 16-byte aligned; `planes` is f32 scratch of 2 * batch *
// kv_heads * head_dim * (s_len + sp) elements (sp as for
// attention_operand_planes); head_dim is 32, 64 or 128; heads is a
// multiple of kv_heads. `window` bounds q - k from above (INT_MAX for no
// window); `causal` also masks k > q. Returns cudaGetLastError() after the
// launches (cudaErrorInvalidValue for arguments it cannot take, or a
// tensor map cuTensorMapEncodeTiled refuses). Does not synchronise.
extern "C" int flash_attention_tf32(const void* q, const void* k, const void* v, void* planes,
                                    void* o, int batch, int heads, int kv_heads, int s_len,
                                    int head_dim, int causal, int window, float scale,
                                    void* stream) {
  if (batch < 1 || heads < 1 || kv_heads < 1 || heads % kv_heads || s_len < 1)
    return cudaErrorInvalidValue;
  if (static_cast<long long>(batch) * kv_heads * 2 > INT_MAX || !aligned16({q, k, v, planes}))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return launch_tf32<32>(q, k, v, planes, o, batch, heads, kv_heads, s_len, causal, window, scale, s);
    case 64: return launch_tf32<64>(q, k, v, planes, o, batch, heads, kv_heads, s_len, causal, window, scale, s);
    case 128: return launch_tf32<128>(q, k, v, planes, o, batch, heads, kv_heads, s_len, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
