// L4: RMSNorm over rows in one pass, with RoPE fused for attention's q and k,
// for Hopper (sm_90a), bound with ctypes.
//
// L4 replaces no TPU kernel: the JAX package leaves rms_norm and apply_rope
//    to XLA (src/repro/models/layers.py:76), which fuses each into one loop.
//    The port's torch route (models/layers.py) runs them as chains of
//    float32 PyTorch passes: an RMSNorm is 9 launches (upcast, square, mean,
//    + eps, rsqrt, multiply, the weight's upcast, multiply, cast back), each
//    moving a float32 copy of the rows; RoPE 8 a layer, with a cat.
//
// What bounds it on this card
//   Bytes. A row is read once and written once, with a few operations an
//   element: at (7680, 4096) bf16 that is 2 x 62.9 MB, 0.038 ms at
//   3.35 TB/s; Qwen3-8B's q and k of a 7680-token prompt are 78.6 MB a
//   layer, read and written, 0.047 ms.
//
// Design
//   * A group of tpr threads (a power of two) owns a row. A thread reads its
//     vectors with 16-byte loads (8 bf16 or 4 floats), all issued before any
//     arithmetic, and keeps them in registers through the sum of squares,
//     so the row is read from memory once: at most 8 vectors a thread, tpr
//     chosen so that a thread holds about 4. A 4096-wide bf16 row is a block
//     of 128 threads; a 16-wide row is one thread, 256 rows a block; 7680
//     rows of 4096 give 7680 blocks, about 3.6 waves of 16 blocks an SM.
//   * The sum of squares is float32: a warp-shuffle butterfly within the
//     group, then, for rows wider than a warp's reach, one shared-memory
//     step across the block's warps.
//   * x's rows are read where they lie: up to three leading dims with any
//     strides (16-byte aligned), so the einsum's permuted (B, H, S, hd) view
//     of q and k and the slices of Mamba's x_proj product are read in place,
//     with no copy. y is written contiguous, the layout K7 takes.
//   * RoPE: a row is one head's hd values. Its threads take the first half's
//     vectors and each the matching vector of the second half too, so the
//     rotation's partner is in the thread's own registers (no shuffle); the
//     (B, S, hd/2) float32 cos and sin tables are read with the same
//     16-byte loads.
//   * Arithmetic in the torch route's order of roundings: the sum of squares
//     in float32 (only its order differs), times 1/d, + eps, rsqrtf; x * r,
//     then * weight, each product rounded (no FMA contraction); with RoPE the
//     normed row rounded to x's type first, then x1 c - x2 s and x2 c + x1 s
//     with each product and sum rounded, as the torch route's separate
//     float32 passes round them. One rounding to x's type at the end.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMaxVecs = 8;    // 16-byte vectors a thread holds
constexpr int kMaxTpr = 512;   // threads a row
constexpr int kNarrowBlock = 256;  // block size where a row is a warp or less
constexpr int kRopeTpr = 32;   // RoPE: a half's vectors within one warp

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<bf16> { static constexpr int N = 8; };

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ uint32_t bf16_bits(float f) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(f)));
}

// 16 bytes of x's type as floats, and back (bf16: round to nearest even)
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = bf16_lo(w[j]);
    f[2 * j + 1] = bf16_hi(w[j]);
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = bf16_bits(f[2 * j]) | (bf16_bits(f[2 * j + 1]) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// x's type's rounding of a float
template <typename T> __device__ __forceinline__ float round_to(float f);
template <> __device__ __forceinline__ float round_to<float>(float f) { return f; }
template <> __device__ __forceinline__ float round_to<bf16>(float f) {
  return __bfloat162float(__float2bfloat16_rn(f));
}

// N consecutive values of a weight or table (16-byte aligned) as floats
template <int N>
__device__ __forceinline__ void load_floats(const float* p, float (&f)[N]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p) + j);
    f[4 * j] = q.x;
    f[4 * j + 1] = q.y;
    f[4 * j + 2] = q.z;
    f[4 * j + 3] = q.w;
  }
}
template <int N>
__device__ __forceinline__ void load_floats(const bf16* p, float (&f)[N]) {
  if constexpr (N == 8) {
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), f);
  } else {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    f[0] = bf16_lo(q.x);
    f[1] = bf16_hi(q.x);
    f[2] = bf16_lo(q.y);
    f[3] = bf16_hi(q.y);
  }
}

// Row r of rows = n0 * n1 * n2 lies at i0 s0 + i1 s1 + i2 s2 elements of x,
// (i0, i1, i2) its index, i2 the fastest; its RoPE tables at i0 c0 + i2 c2
// (batch and token). W is the weight's type (unused without NORM).
template <typename T, typename W, bool NORM, bool ROPE>
__global__ void __launch_bounds__(kMaxTpr) rms_norm_rows_kernel(
    const T* __restrict__ x, const W* __restrict__ weight, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, T* __restrict__ y, unsigned rows, unsigned n1, unsigned n2,
    long long s0, long long s1, long long s2, long long c0, long long c2, int d, int shift,
    int vecs, float inv_d, float eps) {
  constexpr int V = Vec<T>::N;
  constexpr int K = ROPE ? 2 : kMaxVecs;  // vectors a thread may hold
  __shared__ float partial[kMaxTpr / 32];
  const int tpr = 1 << shift;            // threads a row
  const int nv = d / V;                  // vectors a row
  const int sv = ROPE ? nv / 2 : tpr;    // vectors between a thread's own
  const int lane = threadIdx.x & (tpr - 1);
  // 32-bit index arithmetic (fewer than 2^31 rows): a 64-bit division is an
  // emulated sequence, and each thread divides once for its row
  const unsigned row = blockIdx.x * (blockDim.x >> shift) + (threadIdx.x >> shift);
  const bool live = row < rows && lane < sv;  // RoPE: lanes past a half hold nothing
  unsigned i0 = 0, i2 = 0;
  long long at = 0;
  if (live) {
    i2 = row % n2;
    const unsigned rest = row / n2;
    i0 = rest / n1;
    at = i0 * s0 + (rest % n1) * s1 + i2 * s2;
  }
  const uint4* xr = reinterpret_cast<const uint4*>(x + at);

  uint4 v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = lane + k * sv;
    v[k] = (k < vecs && live && i < nv) ? xr[i] : make_uint4(0u, 0u, 0u, 0u);
  }

  float r = 1.f;
  if constexpr (NORM) {
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < vecs) {
        float f[V];
        unpack(v[k], f);
#pragma unroll
        for (int j = 0; j < V; ++j) ss = fmaf(f[j], f[j], ss);
      }
    }
    // every lane of the warp takes part, live or not
    for (int off = (tpr < 32 ? tpr : 32) >> 1; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (tpr > 32) {  // one row a block
      if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
      __syncthreads();
      ss = 0.f;
      for (int j = 0; j < (tpr >> 5); ++j) ss += partial[j];
    }
    r = rsqrtf(__fadd_rn(__fmul_rn(ss, inv_d), eps));
  }
  if (!live) return;

  uint4* yr = reinterpret_cast<uint4*>(y + static_cast<long long>(row) * d);
  if constexpr (ROPE) {
    // v[0]: vector `lane` of the first half; v[1]: the same of the second
    float a[V], b[V], c[V], s[V], o1[V], o2[V];
    unpack(v[0], a);
    unpack(v[1], b);
    if constexpr (NORM) {
      float wa[V], wb[V];
      load_floats(weight + lane * V, wa);
      load_floats(weight + (lane + sv) * V, wb);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        a[j] = round_to<T>(__fmul_rn(__fmul_rn(a[j], r), wa[j]));
        b[j] = round_to<T>(__fmul_rn(__fmul_rn(b[j], r), wb[j]));
      }
    }
    const long long tab = i0 * c0 + i2 * c2 + static_cast<long long>(lane) * V;
    load_floats(cos_t + tab, c);
    load_floats(sin_t + tab, s);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      o1[j] = __fsub_rn(__fmul_rn(a[j], c[j]), __fmul_rn(b[j], s[j]));
      o2[j] = __fadd_rn(__fmul_rn(b[j], c[j]), __fmul_rn(a[j], s[j]));
    }
    yr[lane] = pack(o1);
    yr[lane + sv] = pack(o2);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = lane + k * sv;
      if (k < vecs && i < nv) {
        float f[V], w[V];
        unpack(v[k], f);
        load_floats(weight + i * V, w);
#pragma unroll
        for (int j = 0; j < V; ++j) f[j] = __fmul_rn(__fmul_rn(f[j], r), w[j]);
        yr[i] = pack(f);
      }
    }
  }
}

template <typename T, typename W, bool NORM, bool ROPE>
int launch(const void* x, const void* weight, const void* cos_t, const void* sin_t, void* y,
           long long rows, int n1, int n2, long long s0, long long s1, long long s2, long long c0,
           long long c2, int d, float eps, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  if (d < V || d % V) return cudaErrorInvalidValue;
  const int nv = d / V;
  int tpr = 1, shift = 0, vecs;
  if (ROPE) {
    if (nv % 2) return cudaErrorInvalidValue;
    while (tpr < nv / 2) tpr <<= 1, ++shift;
    if (tpr > kRopeTpr) return cudaErrorInvalidValue;
    vecs = 2;
  } else {
    while (tpr * 4 < nv && tpr < kMaxTpr) tpr <<= 1, ++shift;
    vecs = (nv + tpr - 1) / tpr;
    if (vecs > kMaxVecs) return cudaErrorInvalidValue;
  }
  const int block = tpr > 32 ? tpr : kNarrowBlock;
  const long long per_block = block / tpr;
  const long long grid = (rows + per_block - 1) / per_block;
  if (rows > INT_MAX || grid > INT_MAX) return cudaErrorInvalidValue;
  rms_norm_rows_kernel<T, W, NORM, ROPE><<<static_cast<int>(grid), block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(weight), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<T*>(y), static_cast<unsigned>(rows),
      static_cast<unsigned>(n1), static_cast<unsigned>(n2), s0, s1, s2, c0, c2, d, shift, vecs,
      1.0f / static_cast<float>(d), eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* weight, const void* cos_t, const void* sin_t, void* y,
             long long rows, int n1, int n2, long long s0, long long s1, long long s2,
             long long c0, long long c2, int d, float eps, int wtype, int rope, cudaStream_t s) {
#define L4_ARGS x, weight, cos_t, sin_t, y, rows, n1, n2, s0, s1, s2, c0, c2, d, eps, s
  if (wtype < 0) return rope ? launch<T, float, false, true>(L4_ARGS) : cudaErrorInvalidValue;
  if (wtype == 0)
    return rope ? launch<T, bf16, true, true>(L4_ARGS) : launch<T, bf16, true, false>(L4_ARGS);
  if (wtype == 1)
    return rope ? launch<T, float, true, true>(L4_ARGS) : launch<T, float, true, false>(L4_ARGS);
  return cudaErrorInvalidValue;
#undef L4_ARGS
}

}  // namespace

// C entry point. x holds rows = n0 * n1 * n2 rows of d values (dtype 0 bf16,
// 1 f32), row (i0, i1, i2) at i0 s0 + i1 s1 + i2 s2 elements, each row
// contiguous; its base and strides 16-byte aligned, d a multiple of 16 bytes.
// weight: d contiguous values (wtype 0 bf16, 1 f32), or -1 for none (RoPE
// alone). rope 1: cos and sin are float32 tables of d/2 contiguous values a
// (batch i0, token i2) at i0 c0 + i2 c2, 16-byte aligned, and d/2 at most 32
// vectors. y: rows x d contiguous values of x's type. Returns the launch's
// CUDA error code.
extern "C" int rms_norm_rows(const void* x, const void* weight, const void* cos_t,
                             const void* sin_t, void* y, long long rows, int n1, int n2,
                             long long s0, long long s1, long long s2, long long c0, long long c2,
                             int d, float eps, int dtype, int wtype, int rope, void* stream) {
  if (rows < 1 || n1 < 1 || n2 < 1 || (rope && (!cos_t || !sin_t)) || (wtype >= 0 && !weight))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<bf16>(x, weight, cos_t, sin_t, y, rows, n1, n2, s0, s1, s2, c0, c2, d, eps,
                            wtype, rope, s);
    case 1:
      return dispatch<float>(x, weight, cos_t, sin_t, y, rows, n1, n2, s0, s1, s2, c0, c2, d, eps,
                             wtype, rope, s);
    default:
      return cudaErrorInvalidValue;
  }
}
