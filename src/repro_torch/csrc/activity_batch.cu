// Batched toggle counters of the profiling pipeline for Hopper (sm_90a),
// bound with ctypes.
//
// The pipeline (repro_torch/core/pipeline.py) flattens many GEMMs into
// stacked, fixed-shape work (repro_torch/kernels/activity_profile/batch.py):
//   strips   (S, T1, L) int32: seeded time windows, T1 = t_seg + 1. Row 0 of
//            a window is the stream value just before it (the window's own
//            first row for a stream's first window), so every window counts
//            on its own and no carry crosses windows.
//   w_tiles  (W, R, C) int32: the distinct weight tiles.
//   tasks    (P,) int32 strip_ids / w_ids / valid_r: task p runs strip
//            strip_ids[p] (L = R) through tile w_ids[p]; rows r >= valid_r
//            are K padding and count nothing.
//
// K2 ws_task_toggles replaces activity_profile_pallas_tasks
//    (src/repro/kernels/activity_profile/kernel.py): per task, the toggles of
//    every vertical (partial-sum) bus, S[t, r, c] = sum_{r' <= r} a[t, r'] *
//    w[r', c] against S[t - 1, r, c], on a b_v-wide bus.
// K3 strip_toggles replaces stream_strips_toggles_pallas (same file): per
//    strip, the toggles of every lane between consecutive rows on a
//    bits-wide bus. It serves the output-stationary stream buckets and the
//    weight-stationary horizontal pass, which the reference ran as an XLA
//    side pass (_h_strips_xla in batch.py).
//
// What bounds them on this card
//   K2 is bound by integer operations: each partial sum is an int64
//   multiply-add, an XOR, a mask and a popcount, against 4 bytes of operand
//   read per (t, r) and per (r, c). So it keeps every partial sum in a
//   register and never stores one: a warp holds 32 consecutive time rows of
//   one array column (lane 0 is the seed row and counts nothing), each lane
//   runs the sum down the reduction rows, and the predecessor in time is one
//   __shfl_up_sync away. The operands are staged in shared memory 32
//   reduction rows at a time: the activation block is loaded row-contiguous
//   (coalesced) and read with a padded stride (no bank conflicts), and the
//   weight row is read by the whole warp at one address (a broadcast).
//   K3 reads each strip element once from device memory and does three
//   operations on it, so it is bound by bytes: neighbouring threads take
//   neighbouring lanes of a row, and a row's predecessor comes from cache.
//
// What the TPU kernels did that this design drops
//   * Scalar prefetch of the task metadata becomes three index loads per
//     block; one block owns a whole task (K2) or strip (K3) and writes its
//     own int64 total, so there are no atomics and the totals are exact and
//     deterministic.
//   * The lo/hi int32 planes stood in for 64-bit integers, which the TPU's
//     vector unit lacks, and the b_v <= 32 lo-plane fast path skipped the hi
//     plane. Here the sums are native int64 and a count is
//     __popcll((s ^ prev) & mask(bits)): exact for every bus width in
//     [1, 64], and it covers the fast path's case with the same bits.
//     Operand values are sign-extended to int64 before the XOR, so on a bus
//     wider than 32 bits the bits above 31 flip with the sign, as the
//     reference's value32_toggles counts them.
//   * K-padding rows are not masked but skipped: the reduction loop stops at
//     valid_r, which is what the reference's (r < valid_r) gate on the row's
//     count amounts to. valid_r == 0 turns a task off.
//   * Indices out of range are not read: the task's total becomes -1, a
//     count no real task can have.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 32;          // time rows a K2 warp holds; lane 0 seeds
constexpr int kSteps = kLanes - 1;  // transitions a K2 warp counts
constexpr int kRowBlock = 32;       // K2: reduction rows staged at once
constexpr int kMaxColWarps = 32;    // K2: array columns per pass, one per warp
constexpr int kStripThreads = 256;  // K3: threads per strip

__device__ __forceinline__ unsigned long long bus_mask(int bits) {
  // 1ull << 64 is undefined, so the full bus is its own case.
  return bits >= 64 ? ~0ull : ((1ull << bits) - 1ull);
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long x) {
  for (int off = kLanes / 2; off > 0; off >>= 1) x += __shfl_down_sync(kFull, x, off);
  return x;
}

// Sum of one value per thread over the block; the result is valid in thread 0.
__device__ unsigned long long block_sum(unsigned long long x) {
  __shared__ unsigned long long part[kMaxColWarps];
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  x = warp_sum(x);
  if (lane == 0) part[warp] = x;
  __syncthreads();
  unsigned long long total = 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < static_cast<int>(blockDim.x / kLanes); ++i) total += part[i];
  }
  return total;
}

// One block per task, blockDim.x = 32 * col_warps. The block walks the
// task's (time chunk, column group) items; in each, warp w owns column
// c = group * col_warps + w and lane l owns time row t = chunk * kSteps + l.
// Each item stages the chunk's 32 activation rows and the group's weight
// columns kRowBlock reduction rows at a time.
__global__ void __launch_bounds__(kLanes * kMaxColWarps)
ws_task_toggles_kernel(const int32_t* __restrict__ strips, const int32_t* __restrict__ w_tiles,
                       const int32_t* __restrict__ strip_ids, const int32_t* __restrict__ w_ids,
                       const int32_t* __restrict__ valid_r, long long* __restrict__ out,
                       int num_strips, int num_tiles, int t1, int rows, int cols, int b_v,
                       int col_warps) {
  __shared__ int32_t a_sh[kLanes][kRowBlock + 1];  // +1: lanes read a column conflict-free
  __shared__ int32_t w_sh[kRowBlock][kMaxColWarps];

  const int p = blockIdx.x;
  const int sid = strip_ids[p];
  const int wid = w_ids[p];
  const int vr = min(max(valid_r[p], 0), rows);
  if (sid < 0 || sid >= num_strips || wid < 0 || wid >= num_tiles) {
    if (threadIdx.x == 0) out[p] = -1;
    return;  // uniform across the block: no barrier is skipped by part of it
  }
  const int32_t* strip = strips + static_cast<long long>(sid) * t1 * rows;
  const int32_t* tile = w_tiles + static_cast<long long>(wid) * rows * cols;

  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const unsigned long long mask = bus_mask(b_v);
  const int chunks = (t1 - 2) / kSteps + 1;  // ceil((t1 - 1) / kSteps), t1 >= 2
  const int groups = (cols + col_warps - 1) / col_warps;

  unsigned long long cnt = 0;
  for (int item = 0; item < chunks * groups; ++item) {
    const int chunk = item % chunks;
    const int group = item / chunks;
    const int t0 = chunk * kSteps;
    const int c = group * col_warps + warp;
    const bool counts = lane > 0 && t0 + lane < t1;
    long long s = 0;
    for (int r0 = 0; r0 < vr; r0 += kRowBlock) {
      const int nr = min(kRowBlock, vr - r0);
      __syncthreads();  // the previous block's reads are done
      for (int i = threadIdx.x; i < kLanes * kRowBlock; i += blockDim.x) {
        const int tl = i / kRowBlock;
        const int rl = i % kRowBlock;
        const int t = min(t0 + tl, t1 - 1);  // rows past the end repeat the last
        a_sh[tl][rl] = rl < nr ? strip[static_cast<long long>(t) * rows + r0 + rl] : 0;
      }
      for (int i = threadIdx.x; i < kRowBlock * col_warps; i += blockDim.x) {
        const int rl = i / col_warps;
        const int cl = i % col_warps;
        const int cc = group * col_warps + cl;
        w_sh[rl][cl] = (rl < nr && cc < cols) ? tile[static_cast<long long>(r0 + rl) * cols + cc] : 0;
      }
      __syncthreads();
      if (c < cols) {  // uniform across the warp, so the shuffles see every lane
        for (int rl = 0; rl < nr; ++rl) {
          s += static_cast<long long>(a_sh[lane][rl]) * static_cast<long long>(w_sh[rl][warp]);
          const long long prev = __shfl_up_sync(kFull, s, 1);
          if (counts) cnt += __popcll(static_cast<unsigned long long>(s ^ prev) & mask);
        }
      }
    }
  }
  const unsigned long long total = block_sum(cnt);
  if (threadIdx.x == 0) out[p] = static_cast<long long>(total);
}

// One block per strip; the block's threads stride over the strip's
// (t1 - 1) x lanes transitions in row-major order.
__global__ void __launch_bounds__(kStripThreads)
strip_toggles_kernel(const int32_t* __restrict__ strips, long long* __restrict__ out, int t1,
                     int lanes, int bits) {
  const int32_t* strip = strips + static_cast<long long>(blockIdx.x) * t1 * lanes;
  const unsigned long long mask = bus_mask(bits);
  const long long n = static_cast<long long>(t1 - 1) * lanes;
  unsigned long long cnt = 0;
  for (long long e = threadIdx.x; e < n; e += blockDim.x) {
    const long long cur = strip[e + lanes];  // row t = 1 + e / lanes
    const long long prev = strip[e];         // row t - 1, same lane
    cnt += __popcll(static_cast<unsigned long long>(cur ^ prev) & mask);
  }
  const unsigned long long total = block_sum(cnt);
  if (threadIdx.x == 0) out[blockIdx.x] = static_cast<long long>(total);
}

}  // namespace

// C entry points. Pointers are device pointers; `out` receives one int64 per
// task (K2) or strip (K3) and needs no zeroing. Each returns
// cudaGetLastError() after its launch (cudaErrorInvalidValue for shapes it
// cannot launch), so a refused launch is reported to the caller. Neither
// synchronises.

extern "C" int ws_task_toggles(const void* strips, const void* w_tiles, const void* strip_ids,
                               const void* w_ids, const void* valid_r, void* out,
                               int num_tasks, int num_strips, int num_tiles, int t1, int rows,
                               int cols, int b_v, void* stream) {
  if (num_tasks < 1 || t1 < 2 || rows < 1 || cols < 1 || b_v < 1 || b_v > 64) {
    return cudaErrorInvalidValue;
  }
  const int col_warps = cols < kMaxColWarps ? cols : kMaxColWarps;
  ws_task_toggles_kernel<<<num_tasks, kLanes * col_warps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(strips), static_cast<const int32_t*>(w_tiles),
      static_cast<const int32_t*>(strip_ids), static_cast<const int32_t*>(w_ids),
      static_cast<const int32_t*>(valid_r), static_cast<long long*>(out), num_strips, num_tiles,
      t1, rows, cols, b_v, col_warps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int strip_toggles(const void* strips, void* out, int num_strips, int t1, int lanes,
                             int bits, void* stream) {
  if (num_strips < 1 || t1 < 1 || lanes < 1 || bits < 1 || bits > 64) {
    return cudaErrorInvalidValue;
  }
  strip_toggles_kernel<<<num_strips, kStripThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(strips), static_cast<long long*>(out), t1, lanes, bits);
  return static_cast<int>(cudaGetLastError());
}
