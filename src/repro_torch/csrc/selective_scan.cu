// Mamba's selective scan, forward, for Hopper (sm_90a), bound with ctypes.
//
// L3 replaces no TPU kernel: the JAX package scans with lax.associative_scan,
//    an XLA program, and the port's plain route (models/ssm.py) renders it as
//    a chunked Hillis-Steele scan in PyTorch, whose (B, chunk, d_inner, N)
//    float32 tensors are written and read a few dozen times a chunk. Per
//    channel d and state n it computes, over the tokens t in order,
//        delta_t = softplus(dt_t + dt_bias)
//        h_t     = exp(delta_t * A[d, n]) * h_{t-1} + delta_t * u_t * B_t[n]
//        y_t     = (sum_n h_t[n] * C_t[n] + D * u_t) * silu(z_t)
//    with u, dt, z (B, S, d_inner) and B, C (B, S, N) in the served type, A,
//    D and dt_bias in f32. The state never leaves the registers: no
//    (B, S, d_inner, N) tensor exists, and y is written once, in the served
//    type.
//
// What bounds it on this card
//   Bytes: u, dt and z read once and y written once, 8 bytes a (token,
//   channel) in bf16 (B and C are N values a token, shared by every channel);
//   at Jamba's width (S 7680, d_inner 8192) 0.50 GB, 0.15 ms at 3.35 TB/s.
//   The work is about 7 operations a (token, channel, state), one of them
//   the exponential of delta * A on the SFU pipe, a sixteenth of the FMA
//   rate: about 0.3 ms at B 1, where d_inner x N = 131,072 recurrences are
//   all the parallelism the card has. The kernel reads 0.91 ms on an H100
//   (tools/scan_variants.py): dropping its exponentials or its staging
//   arithmetic moves it by under 10%, so its time is the latency of the
//   token-by-token chain through shared memory and shuffles at the few
//   warps the card holds. The first design, one (token, warp) step at a
//   time through shared memory, read 1.10 ms. What this one does about it:
//   fewer, wider shared-memory operations (2.8 a (token, warp) against 10)
//   and 4 blocks an SM, so that d_inner 8192's 512 blocks are one wave (at
//   138 registers, 3 fit and two waves read 1.42 ms).
//
// Design
//   * Parallel over (batch, channel, state), sequential over tokens. A block
//     owns 16 channels of one sequence; 8 neighbouring lanes share a
//     channel, each carrying 2 of its 16 states in registers across the
//     whole sequence: at d_inner 8192, 512 blocks of 128 threads, four warps
//     to each scheduler.
//   * Tokens are staged 64 at a time in shared memory. Each thread loads the
//     next chunk's u, dt, z, B and C into registers while it scans the
//     current one (warps read rows of 16 channels), and converts them once
//     on the way in: delta = softplus(dt + dt_bias) (log1p, exact for the
//     tiny delta of long memory), delta * u and silu(z), one thread for each
//     (token, channel), not each of the 8 that read them.
//   * A channel's per-token values lie along its own row (16-byte aligned,
//     rows 4 banks apart), so a lane reads 4 tokens' delta or delta * u in
//     one load, a warp's 4 channels in one pass; a token's B and C are
//     interleaved, so a lane reads its two states' (B, C) pairs in one load,
//     the channel's 8 lanes one row.
//   * The 8 lanes' partial sums of 8 tokens are reduced by one butterfly of
//     7 shuffles (half the tokens handed across at each step), which leaves
//     lane p of the channel with the whole sum of token p: the 8 lanes then
//     finish 8 tokens' y at once, and nobody waits on one lane.
//   * exp(delta * A) is one ex2.approx of delta * (A log2 e), A log2 e held
//     in registers: a single SFU instruction a (token, channel, state).
//   * Tokens past the end are staged as zeros: they only decay the state,
//     which is not read again, and their y is not written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kState = 16;                          // N: the state of a channel
constexpr int kSplit = 8;                           // lanes sharing a channel
constexpr int kPerThread = kState / kSplit;         // states a lane carries
constexpr int kChannels = 16;                       // channels a block
constexpr int kThreads = kChannels * kSplit;        // 128
constexpr int kChunk = 64;                          // tokens staged at a time
constexpr int kGroup = kSplit;                      // tokens a butterfly sums, one a lane
constexpr int kStride = kChunk + 4;                 // floats of a channel's staged row
constexpr int kLoads = kChunk * kChannels / kThreads;  // of u, dt, z a thread a chunk
constexpr int kBcLoads = kChunk * kState / kThreads;   // of B and of C
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kPerThread == 2, "a lane's (B, C) pairs are one float4");
static_assert(kGroup == 8 && 32 % kSplit == 0, "the butterfly sums 8 tokens over 8 lanes");
static_assert(kThreads % kChannels == 0 && kThreads % kState == 0, "staging layout");
static_assert(kChunk % kGroup == 0 && kStride % 4 == 0, "whole groups, aligned rows");

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// One SFU instruction, within 2 ulp; 0 below 2^-126.
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// F.softplus at its default threshold of 20; log1p keeps tiny values exact.
__device__ __forceinline__ float softplus(float x) {
  return x > 20.f ? x : log1pf(exp2_sfu(x * kLog2e));
}
__device__ __forceinline__ float silu(float x) {
  return __fdividef(x, 1.f + exp2_sfu(-x * kLog2e));
}

// v[g] summed over the 8 lanes of a channel (lanes 8k .. 8k + 7, p = lane %
// 8), returned to lane p for g = p: at each step a lane hands the half of
// its tokens that its partner keeps across, and adds the half it keeps.
__device__ __forceinline__ float butterfly8(const float (&v)[8], int p) {
  float four[4], two[2];
  const bool hi4 = p & 4, hi2 = p & 2, hi1 = p & 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    four[i] = (hi4 ? v[i + 4] : v[i]) + __shfl_xor_sync(0xffffffffu, hi4 ? v[i] : v[i + 4], 4);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    two[i] = (hi2 ? four[i + 2] : four[i]) +
             __shfl_xor_sync(0xffffffffu, hi2 ? four[i] : four[i + 2], 2);
  return (hi1 ? two[1] : two[0]) + __shfl_xor_sync(0xffffffffu, hi1 ? two[0] : two[1], 1);
}

struct Operand {
  const void* p;
  long long batch_stride;  // elements
  long long token_stride;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
selective_scan_fwd_kernel(Operand u_op, Operand dt_op, Operand z_op, Operand b_op, Operand c_op,
                          const float* __restrict__ a, const float* __restrict__ dskip,
                          const float* __restrict__ dt_bias, T* __restrict__ y, int seq,
                          int d_inner) {
  __shared__ __align__(16) float s_delta[kChannels][kStride];
  __shared__ __align__(16) float s_du[kChannels][kStride];  // delta * u
  __shared__ __align__(16) float s_u[kChannels][kStride];
  __shared__ __align__(16) float s_gate[kChannels][kStride];  // silu(z)
  __shared__ __align__(16) float s_y[kChannels][kStride];
  __shared__ __align__(16) float s_bc[kChunk][kState][2];  // (B, C) of each state

  const int tid = threadIdx.x;
  const int ch = tid / kSplit;  // this lane's channel in the block
  const int part = tid % kSplit;  // which of its states, and which token of a group
  const int d0 = blockIdx.x * kChannels;
  const long long bi = blockIdx.y;
  // staging: thread tid loads column tid % kChannels of rows tid / kChannels + 8i
  const int col = tid % kChannels;
  const int bc_col = tid % kState;

  const T* u = static_cast<const T*>(u_op.p) + bi * u_op.batch_stride + d0 + col;
  const T* dt = static_cast<const T*>(dt_op.p) + bi * dt_op.batch_stride + d0 + col;
  const T* z = static_cast<const T*>(z_op.p) + bi * z_op.batch_stride + d0 + col;
  const T* bm = static_cast<const T*>(b_op.p) + bi * b_op.batch_stride + bc_col;
  const T* cm = static_cast<const T*>(c_op.p) + bi * c_op.batch_stride + bc_col;
  T* out = y + bi * seq * d_inner + d0 + col;
  const float bias = dt_bias[d0 + col];

  float a2[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j)
    a2[j] = a[static_cast<long long>(d0 + ch) * kState + part * kPerThread + j] * kLog2e;
  const float dsk = dskip[d0 + ch];

  float ru[kLoads], rdt[kLoads], rz[kLoads], rb[kBcLoads], rc[kBcLoads];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const long long tok = t0 + i * (kThreads / kChannels) + tid / kChannels;
      const bool in = tok < seq;
      ru[i] = in ? load(u + tok * u_op.token_stride) : 0.f;
      rdt[i] = in ? load(dt + tok * dt_op.token_stride) : 0.f;
      rz[i] = in ? load(z + tok * z_op.token_stride) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBcLoads; ++i) {
      const long long tok = t0 + i * (kThreads / kState) + tid / kState;
      const bool in = tok < seq;
      rb[i] = in ? load(bm + tok * b_op.token_stride) : 0.f;
      rc[i] = in ? load(cm + tok * c_op.token_stride) : 0.f;
    }
  };

  float h[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) h[j] = 0.f;

  fetch(0);
  for (int t0 = 0; t0 < seq; t0 += kChunk) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int t = i * (kThreads / kChannels) + tid / kChannels;
      const float delta = softplus(rdt[i] + bias);
      s_delta[col][t] = delta;
      s_du[col][t] = delta * ru[i];
      s_u[col][t] = ru[i];
      s_gate[col][t] = silu(rz[i]);
    }
#pragma unroll
    for (int i = 0; i < kBcLoads; ++i) {
      const int t = i * (kThreads / kState) + tid / kState;
      *reinterpret_cast<float2*>(&s_bc[t][bc_col][0]) = make_float2(rb[i], rc[i]);
    }
    __syncthreads();
    if (t0 + kChunk < seq) fetch(t0 + kChunk);  // in flight during the scan below

    for (int t = 0; t < kChunk; t += kGroup) {
      const float4 d_lo = *reinterpret_cast<const float4*>(&s_delta[ch][t]);
      const float4 d_hi = *reinterpret_cast<const float4*>(&s_delta[ch][t + 4]);
      const float4 u_lo = *reinterpret_cast<const float4*>(&s_du[ch][t]);
      const float4 u_hi = *reinterpret_cast<const float4*>(&s_du[ch][t + 4]);
      const float deltas[kGroup] = {d_lo.x, d_lo.y, d_lo.z, d_lo.w, d_hi.x, d_hi.y, d_hi.z, d_hi.w};
      const float dus[kGroup] = {u_lo.x, u_lo.y, u_lo.z, u_lo.w, u_hi.x, u_hi.y, u_hi.z, u_hi.w};
      float acc[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        // (B, C) of this lane's states 2 part and 2 part + 1
        const float4 bc = *reinterpret_cast<const float4*>(&s_bc[t + g][part * kPerThread][0]);
        h[0] = fmaf(exp2_sfu(deltas[g] * a2[0]), h[0], dus[g] * bc.x);
        h[1] = fmaf(exp2_sfu(deltas[g] * a2[1]), h[1], dus[g] * bc.z);
        acc[g] = fmaf(h[1], bc.w, h[0] * bc.y);
      }
      const float sum = butterfly8(acc, part);  // token t + part of the channel
      s_y[ch][t + part] = (sum + dsk * s_u[ch][t + part]) * s_gate[ch][t + part];
    }
    __syncthreads();
    // the next chunk's staging writes only what this sync saw read
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int t = i * (kThreads / kChannels) + tid / kChannels;
      if (t0 + t < seq) store(out + static_cast<long long>(t0 + t) * d_inner, s_y[col][t]);
    }
  }
}

template <typename T>
int launch(const Operand* ops, const void* a, const void* dskip, const void* dt_bias, void* y,
           int batch, int seq, int d_inner, cudaStream_t stream) {
  const dim3 grid(d_inner / kChannels, batch);
  selective_scan_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      ops[0], ops[1], ops[2], ops[3], ops[4], static_cast<const float*>(a),
      static_cast<const float*>(dskip), static_cast<const float*>(dt_bias), static_cast<T*>(y),
      seq, d_inner);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point. u, dt and z are (batch, seq, d_inner) and b and c
// (batch, seq, 16) device arrays of one type (dtype 0 bf16, 1 f32), each
// with unit stride along its last dim and the given batch and token strides
// in elements; a is (d_inner, 16), dskip and dt_bias (d_inner,), contiguous
// f32; y is a contiguous (batch, seq, d_inner) array of the inputs' type.
// d_inner must be a multiple of 16. Returns the launch's CUDA error code.
extern "C" int selective_scan_fwd(const void* u, const void* dt, const void* z, const void* b,
                                  const void* c, const void* a, const void* dskip,
                                  const void* dt_bias, void* y, int batch, int seq, int d_inner,
                                  long long u_bs, long long u_ts, long long dt_bs, long long dt_ts,
                                  long long z_bs, long long z_ts, long long b_bs, long long b_ts,
                                  long long c_bs, long long c_ts, int dtype, void* stream) {
  if (batch < 1 || seq < 1 || d_inner < kChannels || d_inner % kChannels || batch > 65535)
    return cudaErrorInvalidValue;
  const Operand ops[5] = {{u, u_bs, u_ts}, {dt, dt_bs, dt_ts}, {z, z_bs, z_ts}, {b, b_bs, b_ts},
                          {c, c_bs, c_ts}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<__nv_bfloat16>(ops, a, dskip, dt_bias, y, batch, seq, d_inner, s);
    case 1: return launch<float>(ops, a, dskip, dt_bias, y, batch, seq, d_inner, s);
    default: return cudaErrorInvalidValue;
  }
}
