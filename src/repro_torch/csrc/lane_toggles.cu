// Per-bit-lane toggle counters for Hopper (sm_90a), bound with ctypes.
//
// Neither replaces a TPU kernel: the JAX package runs the lane-resolved
// profile as XLA programs (_h_lane_toggles_xla and _v_lane_toggles_xla in
// src/repro/kernels/activity_profile/ops.py), never a Pallas kernel. On the
// card the port ran them as PyTorch programs that launched one shift, mask
// and sum per bit lane and per block, thousands of launches a profile.
// These two kernels compute the same counts, lane by lane:
//
// L1 ws_lane_toggles: for every weight-stationary partial-sum bus of a @ w
//    on a `rows`-deep array, the toggles of each bit lane b < b_v of the
//    int64 partial sums, summed over every (t, r, c) transition; each k
//    strip of `rows` reduction rows streams on its own, its first
//    transition seeded at t = 0.
// L2 stream_lane_toggles: for a (T, L) int32 bundle of lane streams on a
//    `bits`-wide bus, the toggles of each of the min(bits, 32) value lanes,
//    plus, on a bus wider than 32 bits, one shared sign lane (the bits above
//    31 of a sign-extended int32 are all copies of bit 31).
//
// What bounds them on this card
//   L1 does K1's work (activity_profile.cu) with a count per lane in place
//   of one masked popcount: a multiply-add into an int64 per partial sum
//   and, per transition and 32-bit word of the bus, an XOR and its share of
//   the bit-sliced counting (a full adder, two logic ops, a word). At a few
//   MB of operands that is integer-op bound: 7 ops a partial sum at b_v =
//   37, 0.17 ms for the six Table-I layers at the H100's 16.7 T integer
//   ops/s. L2 reads each value once for an XOR and a full adder, so at the
//   main path's sizes its bytes bound it, and in practice its launch.
//
// The design
//   * L1 keeps K1's grid and staging: a block of kWarps warps owns one k
//     tile, a group of 32 * cw columns and rw = kWarps / cw runs of kSteps =
//     15 time transitions; it stages its runs' activation rows (transposed)
//     and the W tile in shared memory, kRowChunk reduction rows at a time. A
//     thread owns one column and one run: kVals = 16 int64 partial sums in
//     registers, its recomputed seed row first.
//   * Counting per lane by bit slicing (toggles.cuh). At each reduction row
//     a thread has 15 transitions, so 15 XOR words per 32-bit word of the
//     bus: a tree of 11 full adders turns them into 4 bit planes of per-lane
//     counts (0..15), which add into a 9-plane counter. A staged chunk adds
//     at most 32 * 15 = 480 to a lane, so 9 planes never overflow. The high
//     word is counted only where b_v > 32, and nothing is masked: lanes at
//     or above b_v are never read out.
//   * Flushed once per staged chunk: each lane's count is gathered from the
//     planes and summed over the warp with one REDUX (at most 32 * 480 a
//     lane, 32 bits); the thread of lane b keeps lane b's 64-bit total (and
//     lane b + 32's). The block sums its warps in shared memory and adds one
//     64-bit atomic per lane into the output, which the C entry zeroes on
//     the stream, as K1's does.
//   * L2 walks columns as K5 does (toggle_count.cu): a thread owns one lane
//     and a chunk of time steps from its seed row t0 - 1, so each value is
//     read from device memory once plus one seed row per chunk;
//     neighbouring threads own neighbouring lanes, so a warp reads 128
//     contiguous bytes a row. The chunk is a multiple of 15 steps, sized as
//     K5's from the stream and the SM count (about kItemsPerSm items an SM,
//     at most kMaxGroups groups), so that a narrow stream still fills the
//     card. Each group of 15 XOR words goes through the same tree into a
//     9-plane counter, flushed once per chunk as L1's. One lane a thread,
//     not K5's 16-byte groups: four lanes would need four counters of 9
//     planes, and the lane streams of the profiles are a few MB.
//   * Every loop is bounded by the true extents: rows past M repeat row
//     M - 1 (equal sums, no toggles), columns past N and items past the
//     grid walk nothing, and a short last group of L2 pads with zero words.
//
// What the reference's XLA programs did that this design drops: the int32
// lo/hi planes standing in for int64 sums (native int64 here), the padding
// of M, K and N to block multiples, and int32 partials per (tile, time
// block) summed on the host (64-bit atomics into int64 totals here).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "toggles.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 32;
constexpr int kSteps = 15;         // L1: transitions a thread counts (kernel.py WS_KERNEL_STEPS)
constexpr int kVals = kSteps + 1;  // L1: its time rows, the seed row first
constexpr int kWarps = 4;          // L1: warps per block
constexpr int kRowChunk = 32;      // L1: reduction rows staged at a time
constexpr int kPlanes = 9;         // counter planes: a flush's counts stay below 2^9
constexpr int kGroup = 15;         // L2: XOR words a count15 tree takes
constexpr int kStreamThreads = 256;
constexpr long long kMaxGroups = 32;     // L2: groups of kGroup steps an item walks, at most
constexpr long long kItemsPerSm = 4096;  // L2: (lane, chunk) items an SM, as K5
static_assert(kRowChunk * kSteps < (1 << kPlanes), "L1's chunk overflows its counter");
static_assert(kMaxGroups * kGroup < (1 << kPlanes), "L2's chunk overflows its counter");

// L1's launch: the GEMM, its grid and its bus.
struct LanePlan {
  int m, k, n, rows;
  int runs;        // ceil((m - 1) / kSteps) time runs
  int run_blocks;  // ceil(runs / rw)
  int col_blocks;  // column groups of 32 / cw
  int cw;          // column groups a block owns; rw = kWarps / cw runs
  int lanes_lo;    // min(b_v, 32): lanes of the low word
  int lanes_hi;    // b_v - 32 where positive: lanes of the high word
};

// Adds the chunk's counts of each lane b < lanes to `total` of the warp's
// thread b: one REDUX a lane.
__device__ __forceinline__ void flush(const unsigned (&acc)[kPlanes], int lanes, int lane,
                                      unsigned long long& total) {
  for (int b = 0; b < lanes; ++b) {
    const unsigned sum = __reduce_add_sync(kFull, toggles::lane_count(acc, b));
    if (lane == b) total += sum;
  }
}

// One block per (k tile, column block, run block), as K1; warp w owns
// column group w % cw of the block and run w / cw of it. kHi: b_v > 32.
template <bool kHi>
__global__ void __launch_bounds__(kLanes * kWarps)
ws_lane_toggles_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ w,
                       unsigned long long* __restrict__ out, LanePlan p) {
  // at[r][g][j]: run g's time row j (its seed first) at reduction row r
  __shared__ __align__(16) int32_t at[kRowChunk * kWarps * kVals];
  // ws[r][cc]: column cc of the block at reduction row r
  __shared__ int32_t ws[kRowChunk * kLanes * kWarps];
  // part[w][b]: warp w's total of lane b (b < 32) and of lane b (b >= 32)
  __shared__ unsigned long long part[kWarps][2 * kLanes];

  const int cw = p.cw;
  const int rw = kWarps / cw;
  const int ncols = kLanes * cw;
  long long bid = blockIdx.x;
  const int rb = static_cast<int>(bid % p.run_blocks);
  bid /= p.run_blocks;
  const int cb = static_cast<int>(bid % p.col_blocks);
  const int kt = static_cast<int>(bid / p.col_blocks);
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int g = warp / cw;
  const int cc = (warp % cw) * kLanes + lane;
  const int c = cb * ncols + cc;
  const int run = rb * rw + g;
  const int t_base = rb * rw * kSteps;  // the block's first seed row
  const int k0 = kt * p.rows;
  const int valid_r = min(p.rows, p.k - k0);
  const bool walks = run < p.runs && c < p.n;

  long long s[kVals];
#pragma unroll
  for (int j = 0; j < kVals; ++j) s[j] = 0;
  unsigned long long lo_total = 0, hi_total = 0;  // lanes `lane` and `lane` + 32
  for (int rc = 0; rc < valid_r; rc += kRowChunk) {
    const int nr = min(kRowChunk, valid_r - rc);
    __syncthreads();  // the previous chunk's reads are done
    for (int e = threadIdx.x; e < nr * rw * kVals; e += blockDim.x) {
      const int j = e % kVals;
      const int gg = (e / kVals) % rw;
      const int r = e / (kVals * rw);
      const int t = min(t_base + gg * kSteps + j, p.m - 1);
      at[e] = a[static_cast<long long>(t) * p.k + k0 + rc + r];
    }
    for (int e = threadIdx.x; e < nr * ncols; e += blockDim.x) {
      const int col = cb * ncols + e % ncols;
      ws[e] = col < p.n ? w[static_cast<long long>(k0 + rc + e / ncols) * p.n + col] : 0;
    }
    __syncthreads();

    unsigned acc_lo[kPlanes] = {}, acc_hi[kPlanes] = {};
    if (walks) {
      for (int r = 0; r < nr; ++r) {
        const int32_t wv = ws[r * ncols + cc];
        const int4* ar = reinterpret_cast<const int4*>(at + (r * rw + g) * kVals);
        int32_t av[kVals];
#pragma unroll
        for (int q = 0; q < kVals / 4; ++q) {
          const int4 four = ar[q];
          av[4 * q] = four.x;
          av[4 * q + 1] = four.y;
          av[4 * q + 2] = four.z;
          av[4 * q + 3] = four.w;
        }
#pragma unroll
        for (int j = 0; j < kVals; ++j) s[j] += static_cast<long long>(av[j]) * static_cast<long long>(wv);
        unsigned d[kSteps], cnt[4];
#pragma unroll
        for (int j = 1; j < kVals; ++j)
          d[j - 1] = static_cast<unsigned>(s[j]) ^ static_cast<unsigned>(s[j - 1]);
        toggles::count15(d, cnt);
        toggles::add_planes(acc_lo, cnt);
        if constexpr (kHi) {
#pragma unroll
          for (int j = 1; j < kVals; ++j)
            d[j - 1] = static_cast<unsigned>(s[j] >> 32) ^ static_cast<unsigned>(s[j - 1] >> 32);
          toggles::count15(d, cnt);
          toggles::add_planes(acc_hi, cnt);
        }
      }
    }
    flush(acc_lo, p.lanes_lo, lane, lo_total);
    if constexpr (kHi) flush(acc_hi, p.lanes_hi, lane, hi_total);
  }

  part[warp][lane] = lo_total;
  part[warp][kLanes + lane] = hi_total;
  __syncthreads();
  const int b = threadIdx.x;  // lane b of the bus: the low word's, then the high word's
  if (b < p.lanes_lo || (b >= kLanes && b < kLanes + p.lanes_hi)) {
    unsigned long long total = 0;
    for (int i = 0; i < kWarps; ++i) total += part[i][b];
    if (total) atomicAdd(out + b, total);
  }
}

// L2: item i is (lane i % lanes, chunk i / lanes); the chunk walks steps
// [t0, t0 + t_chunk) from its seed row t0 - 1.
__global__ void __launch_bounds__(kStreamThreads)
stream_lane_toggles_kernel(const int32_t* __restrict__ x, unsigned long long* __restrict__ out,
                           long long t_len, long long lanes, long long items, long long t_chunk,
                           int value_lanes, bool sign_lane) {
  __shared__ unsigned long long part[kStreamThreads / kLanes][kLanes];
  const long long item = static_cast<long long>(blockIdx.x) * kStreamThreads + threadIdx.x;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  unsigned acc[kPlanes] = {};
  if (item < items) {
    const int32_t* col = x + item % lanes;
    const long long t0 = (item / lanes) * t_chunk + 1;
    const long long t1 = min(t0 + t_chunk, t_len);
    int32_t prev = __ldg(col + (t0 - 1) * lanes);
    for (long long t = t0; t < t1; t += kGroup) {
      unsigned d[kGroup], cnt[4];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        d[u] = 0;
        if (t + u < t1) {
          const int32_t v = __ldg(col + (t + u) * lanes);
          d[u] = static_cast<unsigned>(prev ^ v);
          prev = v;
        }
      }
      toggles::count15(d, cnt);
      toggles::add_planes(acc, cnt);
    }
  }
  unsigned long long total = 0;
  flush(acc, value_lanes, lane, total);
  part[warp][lane] = total;
  __syncthreads();
  const int b = threadIdx.x;
  if (b < value_lanes) {
    unsigned long long sum = 0;
    for (int i = 0; i < kStreamThreads / kLanes; ++i) sum += part[i][b];
    if (sum) {
      atomicAdd(out + b, sum);
      if (sign_lane && b == kLanes - 1) atomicAdd(out + kLanes, sum);
    }
  }
}

}  // namespace

// C entry point of L1. Pointers are device pointers to contiguous int32
// (m, k) and (k, n) operands with int16-range values; `out` receives b_v
// int64 lane totals (lane 0 the least significant bit) and is zeroed here,
// on the stream, before the launch. Returns the first CUDA error of the
// zeroing and the launch (cudaErrorInvalidValue for arguments it cannot
// take). Does not synchronise.
extern "C" int ws_lane_toggles(const void* a, const void* w, void* out, int m, int k, int n,
                               int rows, int b_v, void* stream) {
  if (m < 2 || k < 1 || n < 1 || rows < 1 || b_v < 1 || b_v > 64) return cudaErrorInvalidValue;
  LanePlan p{};
  p.m = m;
  p.k = k;
  p.n = n;
  p.rows = rows;
  p.runs = (m - 2) / kSteps + 1;  // ceil((m - 1) / kSteps)
  const int col_groups = (n + kLanes - 1) / kLanes;
  p.cw = col_groups % 4 == 0 ? 4 : (col_groups % 2 == 0 ? 2 : 1);
  p.col_blocks = col_groups / p.cw;
  const int rw = kWarps / p.cw;
  p.run_blocks = (p.runs + rw - 1) / rw;
  p.lanes_lo = b_v < kLanes ? b_v : kLanes;
  p.lanes_hi = b_v > kLanes ? b_v - kLanes : 0;
  const long long k_tiles = (k + rows - 1) / rows;
  const long long blocks = k_tiles * p.col_blocks * p.run_blocks;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t zeroed = cudaMemsetAsync(out, 0, b_v * sizeof(unsigned long long), s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  const auto launch = [&](auto kernel) {
    kernel<<<static_cast<unsigned>(blocks), kLanes * kWarps, 0, s>>>(
        static_cast<const int32_t*>(a), static_cast<const int32_t*>(w),
        static_cast<unsigned long long*>(out), p);
  };
  if (p.lanes_hi > 0) {
    launch(ws_lane_toggles_kernel<true>);
  } else {
    launch(ws_lane_toggles_kernel<false>);
  }
  return static_cast<int>(cudaGetLastError());
}

// C entry point of L2. `x` is a contiguous (t_len, lanes) device array of
// int32; `out` receives min(bits, 32) value-lane totals and, where bits >
// 32, the sign lane's after them, int64, zeroed here on the stream before
// the launch. Returns the first CUDA error of the zeroing and the launch.
// Does not synchronise.
extern "C" int stream_lane_toggles(const void* x, void* out, long long t_len, long long lanes,
                                   int bits, void* stream) {
  if (t_len < 2 || lanes < 1 || bits < 1 || bits > 64) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % sizeof(int32_t) != 0) return cudaErrorInvalidValue;
  const int value_lanes = bits < kLanes ? bits : kLanes;
  const bool sign_lane = bits > kLanes;
  const long long steps = t_len - 1;
  // groups of kGroup steps an item: enough items for kItemsPerSm an SM
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms < 1)
    sms = 132;  // an H100 SXM; a launch on a bad device fails on its own
  const long long target = static_cast<long long>(sms) * kItemsPerSm * kGroup;
  long long groups = (steps * lanes + target - 1) / target;
  groups = groups < 1 ? 1 : (groups > kMaxGroups ? kMaxGroups : groups);
  const long long t_chunk = groups * kGroup;
  const long long items = lanes * ((steps + t_chunk - 1) / t_chunk);
  const long long blocks = (items + kStreamThreads - 1) / kStreamThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t out_bytes = (value_lanes + (sign_lane ? 1 : 0)) * sizeof(unsigned long long);
  const cudaError_t zeroed = cudaMemsetAsync(out, 0, out_bytes, s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  stream_lane_toggles_kernel<<<static_cast<unsigned>(blocks), kStreamThreads, 0, s>>>(
      static_cast<const int32_t*>(x), static_cast<unsigned long long*>(out), t_len, lanes, items,
      t_chunk, value_lanes, sign_lane);
  return static_cast<int>(cudaGetLastError());
}
