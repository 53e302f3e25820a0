// Switching-activity toggle counters for Hopper (sm_90a), bound with ctypes.
//
// K1 ws_activity_toggles replaces activity_profile_pallas
//    (src/repro/kernels/activity_profile/kernel.py): exact input-bus (h) and
//    partial-sum-bus (v) toggle totals of a whole weight-stationary GEMM.
// K4 operand_stream_toggles replaces operand_stream_toggles_pallas (same
//    file): exact toggle total of a (T, L) bundle of independent operand
//    lane streams, the whole per-GEMM work of the output-stationary dataflow.
//
// What bounds them on this card
//   K1 is bound by integer operations: every (t, r, c) partial sum costs an
//   int64 multiply-add, an XOR, a mask and a popcount, and the operands it
//   reads are a few MB. So it keeps every partial sum in a register and
//   never writes one to memory: a warp holds 32 consecutive time steps of
//   one array column, each lane runs the running sum down the reduction
//   rows, and the predecessor in time is one __shfl_up_sync away.
//   K4 reads each stream element once and does three operations on it, so
//   it is bound by bytes: one thread per lane reads a column of a time
//   chunk, neighbouring threads on neighbouring addresses.
//
// What the TPU kernels did that this design drops
//   * The Pallas grid runs in order and carries the previous time block's
//     last row in VMEM scratch. CUDA blocks run in any order, so every warp
//     (K1) or block (K4) recomputes its seed row t0 - 1 itself: lane 0 of a
//     K1 warp is the seed and counts nothing. The first chunk seeds with
//     t = 0, so its first transition counts zero.
//   * The lo/hi int32 planes stood in for 64-bit integers, which the TPU's
//     vector unit lacks. Here the sums are native int64, and a toggle count
//     is __popcll((s ^ prev) & mask), the same bits as the numpy oracle's
//     two's-complement bus representation. Operand values are sign-extended
//     to int64 before the XOR, so on a bus wider than 32 bits the bits above
//     31 flip with the sign, as on the reference.
//   * Per-cell int32 partials become one 64-bit atomicAdd per block into an
//     int64 total, so no partial has an overflow bound.
//   * Edges: the kernels read the unpadded operands and bound every loop by
//     the true extents (r < valid rows of the k tile, c < N, t < M), where
//     the TPU kernel padded and masked.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 32;            // time steps a K1 warp holds; lane 0 seeds
constexpr int kSteps = kLanes - 1;    // transitions a K1 warp counts
constexpr int kWarps = 8;             // K1: array columns per block, one per warp
constexpr int kStreamThreads = 256;   // K4: stream lanes per block
constexpr int kStreamSteps = 64;      // K4: transitions per block

__device__ __forceinline__ unsigned long long bus_mask(int bits) {
  // 1ull << 64 is undefined, so the full bus is its own case.
  return bits >= 64 ? ~0ull : ((1ull << bits) - 1ull);
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long x) {
  for (int off = kLanes / 2; off > 0; off >>= 1) x += __shfl_down_sync(kFull, x, off);
  return x;
}

// One block per (time chunk, group of kWarps columns, k tile); warp w of the
// block owns column c = group * kWarps + w, lane l owns time step
// t = chunk * kSteps + l. The h bus of a k strip is the same stream for
// every n tile, so blocks of column group 0 count it once and scale it by
// n_tiles.
__global__ void __launch_bounds__(kLanes * kWarps)
ws_activity_toggles_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ w,
                           unsigned long long* __restrict__ out, int m, int k, int n,
                           int rows, int b_h, int b_v, int t_chunks, int col_groups,
                           unsigned long long n_tiles) {
  const long long bid = blockIdx.x;
  const int chunk = static_cast<int>(bid % t_chunks);
  const long long rest = bid / t_chunks;
  const int group = static_cast<int>(rest % col_groups);
  const int kt = static_cast<int>(rest / col_groups);
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;

  const int k0 = kt * rows;
  const int valid_r = min(rows, k - k0);
  const int t_raw = chunk * kSteps + lane;
  const bool counts = lane > 0 && t_raw < m;  // lane 0 is the seed row t0 - 1
  const int t = min(t_raw, m - 1);            // lanes past the end read a valid row
  const int32_t* a_row = a + static_cast<long long>(t) * k + k0;

  unsigned long long v_cnt = 0;
  unsigned long long h_cnt = 0;
  const int c = group * kWarps + warp;
  if (c < n) {  // uniform across the warp, so the shuffles below see every lane
    const unsigned long long mask = bus_mask(b_v);
    const int32_t* w_col = w + static_cast<long long>(k0) * n + c;
    long long s = 0;
    for (int r = 0; r < valid_r; ++r) {
      s += static_cast<long long>(a_row[r]) * static_cast<long long>(w_col[static_cast<long long>(r) * n]);
      const long long prev = __shfl_up_sync(kFull, s, 1);
      if (counts) v_cnt += __popcll(static_cast<unsigned long long>(s ^ prev) & mask);
    }
  }
  if (group == 0) {
    const unsigned long long mask = bus_mask(b_h);
    for (int r = warp; r < valid_r; r += kWarps) {
      const long long x = a_row[r];
      const long long prev = __shfl_up_sync(kFull, x, 1);
      if (counts) h_cnt += __popcll(static_cast<unsigned long long>(x ^ prev) & mask);
    }
  }

  __shared__ unsigned long long part[2][kWarps];
  h_cnt = warp_sum(h_cnt);
  v_cnt = warp_sum(v_cnt);
  if (lane == 0) {
    part[0][warp] = h_cnt;
    part[1][warp] = v_cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long h = 0, v = 0;
    for (int i = 0; i < kWarps; ++i) {
      h += part[0][i];
      v += part[1][i];
    }
    if (h) atomicAdd(out, h * n_tiles);
    if (v) atomicAdd(out + 1, v);
  }
}

// One block per (time chunk, group of kStreamThreads lanes); each thread
// walks one lane from its seed row t0 - 1 to the end of the chunk.
__global__ void __launch_bounds__(kStreamThreads)
operand_stream_toggles_kernel(const int32_t* __restrict__ x, unsigned long long* __restrict__ out,
                              int t_len, int lanes, int bits, int lane_groups) {
  const long long bid = blockIdx.x;
  const int group = static_cast<int>(bid % lane_groups);
  const int chunk = static_cast<int>(bid / lane_groups);
  const int l = group * kStreamThreads + threadIdx.x;

  unsigned long long cnt = 0;
  if (l < lanes) {
    const unsigned long long mask = bus_mask(bits);
    const int t0 = chunk * kStreamSteps + 1;
    const int t1 = min(t0 + kStreamSteps, t_len);
    long long prev = x[static_cast<long long>(t0 - 1) * lanes + l];
    for (int t = t0; t < t1; ++t) {
      const long long cur = x[static_cast<long long>(t) * lanes + l];
      cnt += __popcll(static_cast<unsigned long long>(cur ^ prev) & mask);
      prev = cur;
    }
  }

  __shared__ unsigned long long part[kStreamThreads / kLanes];
  cnt = warp_sum(cnt);
  if (threadIdx.x % kLanes == 0) part[threadIdx.x / kLanes] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int i = 0; i < kStreamThreads / kLanes; ++i) total += part[i];
    if (total) atomicAdd(out, total);
  }
}

}  // namespace

// C entry points. Pointers are device pointers; `out` is zeroed by the
// caller and receives int64 totals. Each returns cudaGetLastError() after
// its launch (cudaErrorInvalidValue for a grid it cannot launch), so a
// refused launch is reported to the caller. Neither synchronises.

extern "C" int ws_activity_toggles(const void* a, const void* w, void* out, int m, int k,
                                   int n, int rows, int cols, int b_h, int b_v,
                                   void* stream) {
  if (m < 2 || k < 1 || n < 1 || rows < 1 || cols < 1) return cudaErrorInvalidValue;
  const int k_tiles = (k + rows - 1) / rows;
  const int col_groups = (n + kWarps - 1) / kWarps;
  const int t_chunks = (m - 2) / kSteps + 1;  // ceil((m - 1) / kSteps)
  const long long blocks = static_cast<long long>(t_chunks) * col_groups * k_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const unsigned long long n_tiles = static_cast<unsigned long long>((n + cols - 1) / cols);
  ws_activity_toggles_kernel<<<static_cast<unsigned>(blocks), kLanes * kWarps, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(w),
      static_cast<unsigned long long*>(out), m, k, n, rows, b_h, b_v, t_chunks, col_groups,
      n_tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int operand_stream_toggles(const void* x, void* out, int t_len, int lanes, int bits,
                                      void* stream) {
  if (t_len < 2 || lanes < 1) return cudaErrorInvalidValue;
  const int lane_groups = (lanes + kStreamThreads - 1) / kStreamThreads;
  const int t_chunks = (t_len - 2) / kStreamSteps + 1;  // ceil((t_len - 1) / kStreamSteps)
  const long long blocks = static_cast<long long>(t_chunks) * lane_groups;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  operand_stream_toggles_kernel<<<static_cast<unsigned>(blocks), kStreamThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<unsigned long long*>(out), t_len, lanes, bits,
      lane_groups);
  return static_cast<int>(cudaGetLastError());
}
