// Stream toggle counter for Hopper (sm_90a), bound with ctypes.
//
// K5 stream_toggles replaces toggle_count_pallas
//    (src/repro/kernels/toggle_count/kernel.py): the total number of bit
//    flips along the time axis of a (T, L) stream of int32 or int64 values,
//    sum over t < T - 1 and l < L of popcount((x[t, l] ^ x[t + 1, l]) & mask).
//
// What bounds it on this card
//   Each value is read once and costs an XOR, an AND and one or two
//   popcounts, so it is bound by bytes. The stream is walked as one flat
//   array: thread i pairs element i with element i + L, its successor row.
//   Neighbouring threads read neighbouring addresses, and a grid-stride loop
//   keeps the whole grid within a few MB of the stream, so the successor
//   row, which the threads L elements further on read as their own value,
//   is still in L2 and device memory sees each byte about once.
//
// What the TPU kernel did that this design drops
//   * The wrapper passed the stream twice, x[:-1] and x[1:], so that each
//     grid cell saw aligned blocks; that doubled the bytes read. Here the
//     kernel reads the successor row from the one stream.
//   * Per-cell int32 partials, summed on the host in int64, become one
//     64-bit atomicAdd per block into an int64 total.
//   * The lo/hi int32 planes of an int64 stream become native int64 with
//     __popcll. Values are sign-extended to 64 bits before the mask, so a
//     mask wider than an int32 element counts its sign copies; for int32
//     those bits all equal bit 31 of the XOR, so __popc of the low word plus
//     the mask's high popcount when that bit is set is exact.
//   * No padding to block multiples: the flat index is bounded by (T-1)·L.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;  // 16 blocks per SM of an H100

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ unsigned toggles(int32_t x, int32_t y, unsigned mask_lo,
                                            unsigned hi_bits) {
  const int32_t d = x ^ y;
  return __popc(static_cast<unsigned>(d) & mask_lo) + (d < 0 ? hi_bits : 0u);
}

__device__ __forceinline__ unsigned toggles(long long x, long long y, unsigned long long mask,
                                            unsigned) {
  return __popcll(static_cast<unsigned long long>(x ^ y) & mask);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stream_toggles_kernel(const T* __restrict__ x, unsigned long long* __restrict__ out,
                      long long pairs, long long lanes, unsigned long long mask) {
  const unsigned mask_lo = static_cast<unsigned>(mask);
  const unsigned hi_bits = __popc(static_cast<unsigned>(mask >> 32));
  unsigned long long cnt = 0;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < pairs;
       i += stride) {
    if constexpr (sizeof(T) == 4) {
      cnt += toggles(x[i], x[i + lanes], mask_lo, hi_bits);
    } else {
      cnt += toggles(x[i], x[i + lanes], mask, 0u);
    }
  }

  __shared__ unsigned long long part[kThreads / 32];
  cnt = warp_sum(cnt);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += part[w];
    if (total) atomicAdd(out, total);
  }
}

}  // namespace

// C entry point. `x` is a contiguous (t_len, lanes) device array of
// elem_bytes-wide signed integers (4 or 8); `out` is one int64, zeroed by
// the caller, that receives the total. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments it cannot take). Does not
// synchronise.
extern "C" int stream_toggles(const void* x, void* out, long long t_len, long long lanes,
                              int elem_bytes, unsigned long long mask, void* stream) {
  if (t_len < 2 || lanes < 1 || (elem_bytes != 4 && elem_bytes != 8)) return cudaErrorInvalidValue;
  const long long pairs = (t_len - 1) * lanes;
  long long blocks = (pairs + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* total = static_cast<unsigned long long*>(out);
  if (elem_bytes == 4) {
    stream_toggles_kernel<int32_t><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const int32_t*>(x), total, pairs, lanes, mask);
  } else {
    stream_toggles_kernel<long long><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const long long*>(x), total, pairs, lanes, mask);
  }
  return static_cast<int>(cudaGetLastError());
}
