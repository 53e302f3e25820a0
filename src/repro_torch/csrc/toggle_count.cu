// Stream toggle counter for Hopper (sm_90a), bound with ctypes.
//
// K5 stream_toggles replaces toggle_count_pallas
//    (src/repro/kernels/toggle_count/kernel.py): the total number of bit
//    flips along the time axis of a (T, L) stream of int32 or int64 values,
//    sum over t < T - 1 and l < L of popcount((x[t, l] ^ x[t + 1, l]) & mask).
//
// What bounds it on this card
//   Each value costs one logic op per 32-bit word and one or two popcounts,
//   far below the card's integer and popcount rates (64 and 16 a clock on
//   each SM) at 3.35 TB/s, so it is bound by bytes: the kernel has to read
//   each value once, with enough loads in flight to keep HBM busy.
//
// The design
//   * Columns are walked, not the flat array. A thread owns one 16-byte
//     group of lanes (4 int32 or 2 int64) and a chunk of time steps, and
//     keeps the predecessor row in registers, so each value is read from
//     device memory once, plus one seed row per chunk (row t0 - 1, as the
//     profiler's seeded windows do). Neighbouring threads own neighbouring
//     groups of a row, so a warp reads 512 contiguous bytes.
//   * 16-byte loads, kUnroll of them started before any is used, so each
//     thread keeps 64 bytes in flight.
//   * The time chunk is sized from (T, L) and the SM count: long enough
//     that the seed rows cost little (at least kMinChunk steps), short
//     enough that the grid holds about kItemsPerSm chunks for each SM,
//     several waves on narrow streams (T = 3136, L = 64) as on the wide
//     partial-sum streams (L up to 589,824).
//   * Ragged edges take a scalar path in the same kernel: lanes before the
//     first 16-byte boundary (a view with a storage offset) and after the
//     last whole group are walked one lane a thread. Where the row pitch is
//     not a multiple of 16 bytes the rows are not all aligned alike, and
//     every lane takes the scalar path.
//   * One total: each block sums its threads (REDUX per warp, no shuffles)
//     and adds one 64-bit atomic into the output, which the C entry zeroes
//     on the stream itself, so the caller allocates it uninitialised and
//     no fill kernel is launched from PyTorch.
//
// What the TPU kernel did that this design drops
//   * The wrapper passed the stream twice, x[:-1] and x[1:], which doubled
//     the bytes read; the lo/hi int32 planes of an int64 stream become
//     native int64 with __popcll; per-cell int32 partials summed on the
//     host become the one int64 total.
//   * Values are sign-extended to 64 bits before the mask, so a mask wider
//     than an int32 element counts its sign copies: for int32 those bits
//     all equal bit 31 of the XOR, so __popc of the low word plus the
//     mask's high popcount when that bit is set is exact.
//   * No padding to block multiples: every loop is bounded by T and L.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;                 // 16-byte loads in flight per thread
constexpr long long kItemsPerSm = 4096;    // (lane group, chunk) items per SM: two waves of 2048 threads
constexpr long long kMinChunk = 16;        // time steps per item, at least
constexpr long long kMaxChunk = 1 << 16;   // ... and at most, so a warp's count fits 32 bits

// The bus: the full 64-bit mask, and for int32 its low word and the number
// of its bits above bit 31 (the sign copies).
struct Bus {
  unsigned long long mask;
  unsigned mask_lo;
  unsigned hi_bits;
};

__device__ __forceinline__ unsigned toggles(int32_t x, int32_t y, const Bus& b) {
  const int32_t d = x ^ y;
  return __popc(static_cast<unsigned>(d) & b.mask_lo) + (d < 0 ? b.hi_bits : 0u);
}

__device__ __forceinline__ unsigned toggles(long long x, long long y, const Bus& b) {
  return __popcll(static_cast<unsigned long long>(x ^ y) & b.mask);
}

__device__ __forceinline__ unsigned toggles(int4 x, int4 y, const Bus& b) {
  return toggles(x.x, y.x, b) + toggles(x.y, y.y, b) + toggles(x.z, y.z, b) + toggles(x.w, y.w, b);
}

__device__ __forceinline__ unsigned toggles(longlong2 x, longlong2 y, const Bus& b) {
  return toggles(x.x, y.x, b) + toggles(x.y, y.y, b);
}

// A 16-byte group of lanes of element type T.
template <typename T> struct Group;
template <> struct Group<int32_t> { using type = int4; static constexpr int lanes = 4; };
template <> struct Group<long long> { using type = longlong2; static constexpr int lanes = 2; };

// Toggles of one column of V values (a lane group or one lane) from row
// t0 - 1 to row t1 - 1; `pitch` is the row pitch in V elements.
template <typename V>
__device__ __forceinline__ unsigned walk(const V* __restrict__ col, long long pitch, long long t0,
                                         long long t1, const Bus& b) {
  V prev = __ldg(col + (t0 - 1) * pitch);
  unsigned cnt = 0;
  long long t = t0;
  for (; t + kUnroll <= t1; t += kUnroll) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(col + (t + u) * pitch);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      cnt += toggles(prev, v[u], b);
      prev = v[u];
    }
  }
  for (; t < t1; ++t) {
    const V v = __ldg(col + t * pitch);
    cnt += toggles(prev, v, b);
    prev = v;
  }
  return cnt;
}

// Item i of the grid is (unit i % units, chunk i / units). Units
// [0, groups) are the 16-byte lane groups starting at lane `head`; the rest
// are single lanes: the `head` lanes before them, then the tail after them.
template <typename T>
__global__ void __launch_bounds__(kThreads)
stream_toggles_kernel(const T* __restrict__ x, unsigned long long* __restrict__ out,
                      long long t_len, long long lanes, long long head, long long groups,
                      long long units, long long t_chunk, Bus bus) {
  using V = typename Group<T>::type;
  constexpr int kGroupLanes = Group<T>::lanes;
  const long long item = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long unit = item % units;
  const long long t0 = (item / units) * t_chunk + 1;
  unsigned cnt = 0;
  if (t0 < t_len) {
    const long long t1 = min(t0 + t_chunk, t_len);
    if (unit < groups) {
      const V* col = reinterpret_cast<const V*>(x + head) + unit;
      cnt = walk(col, lanes / kGroupLanes, t0, t1, bus);
    } else {
      long long lane = unit - groups;
      if (lane >= head) lane += groups * kGroupLanes;
      cnt = walk(x + lane, lanes, t0, t1, bus);
    }
  }

  __shared__ unsigned part[kThreads / 32];
  cnt = __reduce_add_sync(kFull, cnt);
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
// elem_bytes-wide signed integers (4 or 8), aligned to its element; `out`
// is one int64 that receives the total (zeroed here, on the stream, before
// the launch). Returns the first CUDA error of the zeroing and the launch
// (cudaErrorInvalidValue for arguments it cannot take). Does not
// synchronise.
extern "C" int stream_toggles(const void* x, void* out, long long t_len, long long lanes,
                              int elem_bytes, unsigned long long mask, void* stream) {
  if (t_len < 2 || lanes < 1 || (elem_bytes != 4 && elem_bytes != 8)) return cudaErrorInvalidValue;
  const auto addr = reinterpret_cast<uintptr_t>(x);
  if (addr % elem_bytes != 0) return cudaErrorInvalidValue;
  const long long group_lanes = 16 / elem_bytes;
  long long head = lanes;  // every lane scalar, unless the rows are aligned alike
  long long groups = 0;
  if (lanes * elem_bytes % 16 == 0) {
    head = static_cast<long long>((16 - addr % 16) % 16) / elem_bytes;
    groups = (lanes - head) / group_lanes;
  }
  const long long units = lanes - groups * (group_lanes - 1);
  const long long steps = t_len - 1;
  const long long target = hopper::sm_count(hopper::current_device()) * kItemsPerSm;
  long long t_chunk = (steps * units + target - 1) / target;
  t_chunk = t_chunk < kMinChunk ? kMinChunk : (t_chunk > kMaxChunk ? kMaxChunk : t_chunk);
  if (t_chunk > steps) t_chunk = steps;
  const long long items = units * ((steps + t_chunk - 1) / t_chunk);
  const long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* total = static_cast<unsigned long long*>(out);
  const cudaError_t zeroed = cudaMemsetAsync(total, 0, sizeof(*total), s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  const Bus bus{mask, static_cast<unsigned>(mask),
                static_cast<unsigned>(__builtin_popcountll(mask >> 32))};
  if (elem_bytes == 4) {
    stream_toggles_kernel<int32_t><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const int32_t*>(x), total, t_len, lanes, head, groups, units, t_chunk, bus);
  } else {
    stream_toggles_kernel<long long><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const long long*>(x), total, t_len, lanes, head, groups, units, t_chunk, bus);
  }
  return static_cast<int>(cudaGetLastError());
}
