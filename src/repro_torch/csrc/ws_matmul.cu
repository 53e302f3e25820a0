// Weight-stationary tiled GEMM for Hopper (sm_90a), bound with ctypes.
//
// K6 ws_matmul replaces ws_matmul_pallas (src/repro/kernels/ws_matmul/kernel.py):
//    out = a @ w for a (M, K) and w (K, N), with K innermost and a wide
//    accumulator: int8/int16 operands accumulate in 32 bits and wrap mod
//    2^32, as the TPU's int32 accumulator does; bf16/f32 operands
//    accumulate in f32.
//
// What bounds it on this card
//   At the shapes it serves it is bound by operations (2 per multiply-add),
//   and this kernel runs them on the CUDA cores: int16 has no tensor-core
//   path, and a tensor-core path (wgmma with TMA) for int8 and bf16 is for a
//   later change. A block owns a 128 x 128 output tile and walks K in steps
//   of 8: it stages the (128, 8) slice of a, transposed, and the (8, 128)
//   slice of w in shared memory, and each of its 256 threads keeps an 8 x 8
//   register tile of sums, so every 16 shared-memory loads feed 64
//   multiply-adds. A thread's rows and columns are 16 apart, so a warp's
//   loads are conflict-free (w) or broadcasts (a).
//
// What the TPU kernel did that this design drops
//   * The grid's K axis ran in order and carried the sum in VMEM scratch;
//     here each block loops over K itself, so the sum stays in registers.
//   * The wrapper zero-padded every dimension to a block multiple; here the
//     tile loads bound-check the true extents (zeros outside) and the
//     stores skip rows and columns past the end.
//   * Signed overflow is undefined in C++, so integer sums are kept in
//     uint32_t, which wraps exactly as the int32 accumulator on the TPU.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;          // output rows and columns per block
constexpr int kStep = 8;            // reduction rows per shared-memory stage
constexpr int kThreads = 256;       // 16 x 16 threads, each an 8 x 8 register tile
constexpr int kMicro = 8;
constexpr int kSide = 16;
constexpr int kPad = 4;             // keeps the transposed a stores conflict-free

template <typename T> struct Acc;
template <> struct Acc<int8_t> { using type = uint32_t; using out = int32_t; };
template <> struct Acc<int16_t> { using type = uint32_t; using out = int32_t; };
template <> struct Acc<__nv_bfloat16> { using type = float; using out = float; };
template <> struct Acc<float> { using type = float; using out = float; };

__device__ __forceinline__ uint32_t widen(int8_t x) { return static_cast<uint32_t>(static_cast<int32_t>(x)); }
__device__ __forceinline__ uint32_t widen(int16_t x) { return static_cast<uint32_t>(static_cast<int32_t>(x)); }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(float x) { return x; }

__device__ __forceinline__ uint32_t mad(uint32_t a, uint32_t b, uint32_t c) { return a * b + c; }
__device__ __forceinline__ float mad(float a, float b, float c) { return fmaf(a, b, c); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
ws_matmul_kernel(const T* __restrict__ a, const T* __restrict__ w,
                 typename Acc<T>::out* __restrict__ out, int m, int k, int n) {
  using A = typename Acc<T>::type;
  __shared__ A as[kStep][kTile + kPad];  // a slice, transposed: as[kk][row]
  __shared__ A ws[kStep][kTile];

  const int tid = threadIdx.x;
  const int ty = tid / kSide;
  const int tx = tid % kSide;
  const long long m0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long n0 = static_cast<long long>(blockIdx.y) * kTile;

  A acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = A(0);

  for (int k0 = 0; k0 < k; k0 += kStep) {
    // Each thread stages 4 values of a (128 x 8) and 4 of w (8 x 128).
#pragma unroll
    for (int s = 0; s < kTile * kStep / kThreads; ++s) {
      const int idx = tid + s * kThreads;
      const int ar = idx / kStep, ac = idx % kStep;
      const long long gr = m0 + ar;
      const int gk = k0 + ac;
      as[ac][ar] = (gr < m && gk < k) ? widen(a[gr * k + gk]) : A(0);
      const int wr = idx / kTile, wc = idx % kTile;
      const int gk2 = k0 + wr;
      const long long gc = n0 + wc;
      ws[wr][wc] = (gk2 < k && gc < n) ? widen(w[static_cast<long long>(gk2) * n + gc]) : A(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kStep; ++kk) {
      A av[kMicro], wv[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) av[i] = as[kk][ty + kSide * i];
#pragma unroll
      for (int j = 0; j < kMicro; ++j) wv[j] = ws[kk][tx + kSide * j];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] = mad(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const long long r = m0 + ty + kSide * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const long long c = n0 + tx + kSide * j;
      if (c < n) out[r * n + c] = static_cast<typename Acc<T>::out>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* a, const void* w, void* out, int m, int k, int n, cudaStream_t s) {
  const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  ws_matmul_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(w),
      static_cast<typename Acc<T>::out*>(out), m, k, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point. `a` (m, k) and `w` (k, n) are contiguous device arrays of
// one operand type, `dtype`: 0 int8, 1 int16, 2 bf16, 3 f32. `out` (m, n)
// is int32 for the integer types and f32 for the float ones; every element
// is written. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments it cannot take). Does not
// synchronise.
extern "C" int ws_matmul(const void* a, const void* w, void* out, int m, int k, int n,
                         int dtype, void* stream) {
  if (m < 1 || k < 1 || n < 1) return cudaErrorInvalidValue;
  if ((n + kTile - 1) / kTile > 65535) return cudaErrorInvalidValue;  // grid.y limit
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<int8_t>(a, w, out, m, k, n, s);
    case 1: return launch<int16_t>(a, w, out, m, k, n, s);
    case 2: return launch<__nv_bfloat16>(a, w, out, m, k, n, s);
    case 3: return launch<float>(a, w, out, m, k, n, s);
    default: return cudaErrorInvalidValue;
  }
}
