// Stream toggle counters for Hopper (sm_90a), bound with ctypes.
//
// K5 stream_toggles replaces toggle_count_pallas
//    (src/repro/kernels/toggle_count/kernel.py): the total number of bit
//    flips along the time axis of a (T, L) stream of int32 or int64 values,
//    sum over t < T - 1 and l < L of popcount((x[t, l] ^ x[t + 1, l]) & mask).
// K3 strip_toggles replaces stream_strips_toggles_pallas
//    (src/repro/kernels/activity_profile/kernel.py): the same count for each
//    of S stacked (T1, L) int32 strips, one total per strip. A strip is the
//    profiling pipeline's seeded window (kernels/activity_profile/batch.py):
//    row 0 is the value just before the window, so every strip counts on
//    its own and no transition crosses strips. It serves the
//    output-stationary stream buckets and the weight-stationary horizontal
//    pass.
//
// What bounds them on this card
//   Each value costs one logic op per 32-bit word and one or two popcounts,
//   far below the card's integer and popcount rates (64 and 16 a clock on
//   each SM) at 3.35 TB/s, so both are bound by bytes: a kernel has to read
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
//   * K3 runs the same column walk over every strip: its items are K5's
//     items of each strip (lane group or lane, time chunk), and a block
//     owns whole strips, several where a strip has fewer items than a
//     block has threads (a long strip is cut into chunks that each read
//     their seed row). So each strip's total is summed in the block (REDUX
//     per warp, a shared-memory add per warp and strip) and written once:
//     no atomic in device memory and no zeroing of the output (a memset is
//     one more runtime call on the host and one more operation on the
//     card, each as long as the kernel's own at these sizes). The time chunk is sized as for one stream of all the strips'
//     steps, at least kStripMinChunk steps, and long enough that a strip
//     has at most a block's worth of items where its lanes allow (a
//     thread walks its block's items in turn otherwise). Its index
//     arithmetic is 32-bit but for the strip's base address. (Before: one
//     block per strip, each value loaded twice as a scalar, once itself
//     and once as its successor's predecessor, and fewer blocks than one
//     wave on the Table-I buckets.)
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
constexpr long long kStripMinChunk = 4;    // K3's least steps per item (its strips are short)

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

// K3: block b owns strips [b * per_block, +per_block) and their items;
// item i of the block is (strip i / per_strip, unit j % units, chunk j /
// units) with j = i % per_strip. A warp walks items base + lane for base
// = its first thread, + kThreads, ... (one step unless a strip has more
// items than a block has threads).
__global__ void __launch_bounds__(kThreads)
strip_toggles_kernel(const int32_t* __restrict__ x, long long* __restrict__ out, int num_strips,
                     int t1, int lanes, int head, int groups, int units, int t_chunk, int per_strip,
                     int per_block, Bus bus) {
  using V = Group<int32_t>::type;
  constexpr int kGroupLanes = Group<int32_t>::lanes;
  __shared__ unsigned long long sums[kThreads];  // per_block <= kThreads strips
  const int first = blockIdx.x * per_block;
  const int strips = min(per_block, num_strips - first);
  const int items = strips * per_strip;
  if (static_cast<int>(threadIdx.x) < strips) sums[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x % 32;
  for (int base = threadIdx.x - lane; base < items; base += kThreads) {
    const int i = base + lane;
    const int s = min(i, items - 1) / per_strip;
    unsigned cnt = 0;
    if (i < items) {
      const int j = i - s * per_strip;
      const int unit = j % units;
      const int t0 = (j / units) * t_chunk + 1;
      const int t_end = min(t0 + t_chunk, t1);
      const int32_t* strip = x + static_cast<long long>(first + s) * t1 * lanes;
      if (unit < groups) {
        cnt = walk(reinterpret_cast<const V*>(strip + head) + unit, lanes / kGroupLanes, t0, t_end,
                   bus);
      } else {
        int lane_at = unit - groups;
        if (lane_at >= head) lane_at += groups * kGroupLanes;
        cnt = walk(strip + lane_at, lanes, t0, t_end, bus);
      }
    }
    // the strips of the warp's first and last items, alike in every lane
    const int s0 = base / per_strip;
    if (s0 == min(base + 31, items - 1) / per_strip) {
      cnt = __reduce_add_sync(kFull, cnt);
      if (lane == 0 && cnt) atomicAdd(&sums[s0], static_cast<unsigned long long>(cnt));
    } else if (cnt) {
      atomicAdd(&sums[s], static_cast<unsigned long long>(cnt));
    }
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < strips)
    out[first + threadIdx.x] = static_cast<long long>(sums[threadIdx.x]);
}

// The lanes of a (t, lanes) stream of elem_bytes-wide values at `addr`: the
// `head` lanes before the first 16-byte boundary, then `groups` 16-byte
// lane groups, then the rest; every lane is scalar (head = lanes) where the
// rows are not all aligned alike. `units` counts the groups and the scalar
// lanes.
struct Lanes {
  long long head, groups, units;
};

Lanes lane_units(uintptr_t addr, long long lanes, int elem_bytes) {
  const long long group_lanes = 16 / elem_bytes;
  Lanes l{lanes, 0, 0};
  if (lanes * elem_bytes % 16 == 0) {
    l.head = static_cast<long long>((16 - addr % 16) % 16) / elem_bytes;
    l.groups = (lanes - l.head) / group_lanes;
  }
  l.units = lanes - l.groups * (group_lanes - 1);
  return l;
}

// Time steps per item for `work` (unit, step) pairs over streams of `steps`
// steps: the grid holds about kItemsPerSm items for each SM, at least
// `least` and at most kMaxChunk (and steps) steps each.
long long time_chunk(long long work, long long steps, long long least) {
  const long long target = hopper::sm_count(hopper::current_device()) * kItemsPerSm;
  long long t_chunk = (work + target - 1) / target;
  t_chunk = t_chunk < least ? least : (t_chunk > kMaxChunk ? kMaxChunk : t_chunk);
  return t_chunk > steps ? steps : t_chunk;
}

Bus make_bus(unsigned long long mask) {
  return Bus{mask, static_cast<unsigned>(mask),
             static_cast<unsigned>(__builtin_popcountll(mask >> 32))};
}

}  // namespace

// C entry point of K5. `x` is a contiguous (t_len, lanes) device array of
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
  const Lanes l = lane_units(addr, lanes, elem_bytes);
  const long long head = l.head, groups = l.groups, units = l.units;
  const long long steps = t_len - 1;
  const long long t_chunk = time_chunk(steps * units, steps, kMinChunk);
  const long long items = units * ((steps + t_chunk - 1) / t_chunk);
  const long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* total = static_cast<unsigned long long*>(out);
  const cudaError_t zeroed = cudaMemsetAsync(total, 0, sizeof(*total), s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  const Bus bus = make_bus(mask);
  if (elem_bytes == 4) {
    stream_toggles_kernel<int32_t><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const int32_t*>(x), total, t_len, lanes, head, groups, units, t_chunk, bus);
  } else {
    stream_toggles_kernel<long long><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const long long*>(x), total, t_len, lanes, head, groups, units, t_chunk, bus);
  }
  return static_cast<int>(cudaGetLastError());
}

// C entry point of K3. `strips` is a contiguous (num_strips, t1, lanes)
// device array of int32 aligned to its element; `out` receives one int64
// per strip, every one written: the toggles on the low `bits` bits of the
// sign-extended values (0 where t1 = 1, written by a memset). Returns the
// first CUDA error of the launch (cudaErrorInvalidValue for arguments it
// cannot take). Does not synchronise.
extern "C" int strip_toggles(const void* strips, void* out, int num_strips, int t1, int lanes,
                             int bits, void* stream) {
  if (num_strips < 1 || t1 < 1 || lanes < 1 || bits < 1 || bits > 64) return cudaErrorInvalidValue;
  const auto addr = reinterpret_cast<uintptr_t>(strips);
  if (addr % 4 != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t1 < 2)
    return static_cast<int>(cudaMemsetAsync(out, 0, sizeof(long long) * num_strips, s));
  // A strip's rows are lanes * 4 bytes apart, so where they are 16-byte
  // multiples every row of every strip is aligned as the first.
  const Lanes l = lane_units(addr, lanes, 4);
  const long long steps = t1 - 1;
  // at least kStripMinChunk steps, and enough that a strip's items fit a
  // block, but at most kMaxChunk, so that a warp's count fits 32 bits
  long long least = (steps * l.units + kThreads - 1) / kThreads;
  least = least < kStripMinChunk ? kStripMinChunk : (least > kMaxChunk ? kMaxChunk : least);
  const long long t_chunk = time_chunk(steps * l.units * num_strips, steps, least);
  const long long per_strip = l.units * ((steps + t_chunk - 1) / t_chunk);
  if (per_strip > INT_MAX - kThreads) return cudaErrorInvalidValue;
  const int per_block = per_strip >= kThreads ? 1 : kThreads / static_cast<int>(per_strip);
  const unsigned blocks = static_cast<unsigned>((num_strips + per_block - 1) / per_block);
  const unsigned long long mask = bits >= 64 ? ~0ull : (1ull << bits) - 1ull;
  strip_toggles_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const int32_t*>(strips), static_cast<long long*>(out), num_strips, t1, lanes,
      static_cast<int>(l.head), static_cast<int>(l.groups), static_cast<int>(l.units),
      static_cast<int>(t_chunk), static_cast<int>(per_strip), per_block, make_bus(mask));
  return static_cast<int>(cudaGetLastError());
}
