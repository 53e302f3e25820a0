// Batched toggle counter of the profiling pipeline for Hopper (sm_90a),
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
//    The pipeline's other batched pass, K3 strip_toggles over the strips
//    alone, runs on K5's column walk (toggle_count.cu).
//
// What bounds it on this card
//   K2 computes K1's function (activity_profile.cu) over stacked tasks:
//   each partial sum costs an int64 multiply-add, a logic op per 32-bit
//   word of the b_v bus and b_v / 32 popcounts, against 4 bytes of operand
//   read per (t, r) and per (r, c). Hopper pops 16 counts a clock on an SM
//   against 64 integer ops, so the popcount rate bounds it (0.14 ms for the
//   Table-I bucket at b_v = 37), then the logic ops.
//
// The K2 design (K1's, over tasks)
//   * Work items. An item is (task, group of 32 array columns, run of
//     kSteps time transitions); a warp owns one item, a block of kTaskWarps
//     warps four consecutive ones, runs fastest. At t_seg = 128 on a 32x32
//     array a task is 8 runs of 16, so a block holds 4 runs of one task (the
//     Table-I bucket: 3776 tasks, 7552 blocks, about 7 waves of 1056). At
//     t_seg = 8 a task is one run, and a block spans four tasks, so no warp
//     idles. Each warp stages its own operands (its run's activation rows,
//     transposed so the run's values at one reduction row are contiguous,
//     and its columns of the weight tile) in its own slice of shared
//     memory, kRowChunk reduction rows at a time, with cp.async copies that
//     hold no register (the partial sums hold most of them), and syncs with
//     __syncwarp only: one layout serves every t_seg, where blocks sharing
//     one staged W tile would need a second layout for short segments.
//     Copying the W tile per warp costs one copy a thread per reduction row,
//     against some 100 instructions of the row's walk.
//   * Registers blocked in time. A thread owns one column and one run:
//     kSteps + 1 int64 partial sums, its seed row's first. Walking the
//     reduction rows r < valid_r it reads w[r][c] once (its own slot, no
//     bank conflict) and its run's a[t][r] as 16-byte broadcast loads, adds
//     the products and counts the transitions between neighbouring sums in
//     registers: no shuffles. Row 0 of a strip is its seed, so every
//     transition of a task counts and the first run is like the others.
//   * Run length: 16 transitions (19 popcounts at b_v = 37 with the packed
//     high words of toggles.cuh), or 8 where t_seg % 16 is 1 to 8 and runs
//     of 16 would pad more steps (t_seg = 8, 24, ...). The pipeline's t_seg
//     is a multiple of 8 up to 128, so the runs divide it; for any other
//     t1 >= 2, rows past t1 - 1 repeat the last row: equal sums, no toggles.
//   * Registers. The launch bound holds a thread to 64 (8 blocks of 128
//     threads an SM). A run of 16 keeps 17 int64 sums (34 registers), so
//     the walk keeps nothing else it can do without: the operands' addresses,
//     the task and its total wait in shared memory, a run's 17 values come
//     as four 16-byte loads and one single one, and the staging copies
//     (cp.async) hold no register. Buses of 38-40 bits pack their high
//     words as 41-48 do (S = 16, two more popcounts a run): with four
//     packed words (S = 8) the walk spilled.
//   * Columns past `cols` skip the walk but take part in every warp-wide
//     reduction.
//   * Totals. Each warp sums its 32-bit counts with one REDUX per staged
//     chunk (at most 2^20 a warp there) into a 64-bit total; the block adds
//     the totals of its warps, task by task, into out[task] with one 64-bit
//     atomic each. The C entry zeroes `out` on the stream first, so the
//     caller allocates it uninitialised. Integer atomics keep the totals
//     exact and deterministic.
//
// What the TPU kernel did that this design drops
//   * Scalar prefetch of the task metadata becomes three index loads per
//     warp.
//   * The lo/hi int32 planes stood in for 64-bit integers, which the TPU's
//     vector unit lacks, and the b_v <= 32 lo-plane fast path skipped the hi
//     plane. Here the sums are native int64: exact for every bus width in
//     [1, 64], and a bus of 32 bits or fewer (S = 0) takes no high word.
//     Operand values are sign-extended to int64 before the XOR, so on a bus
//     wider than 32 bits the bits above 31 flip with the sign, as the
//     reference's value32_toggles counts them.
//   * K-padding rows are not masked but skipped: the reduction loop stops at
//     valid_r, which is what the reference's (r < valid_r) gate on the row's
//     count amounts to. valid_r == 0 turns a task off.
//   * Indices out of range are not read: the task's total becomes -1, a
//     count no real task can have, written by the warp of its first item
//     alone, and no warp adds to it.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "toggles.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 32;          // array columns a K2 warp walks
constexpr int kTaskWarps = 4;       // K2: warps (items) per block
constexpr int kRowChunk = 32;       // K2: reduction rows staged at a time
constexpr int kLongRun = 16;        // K2: transitions a thread counts
constexpr int kShortRun = 8;        // ... where t_seg % 16 is 1 to 8

// A 4-byte copy from device to shared memory that bypasses the registers
// (cp.async); cp_async_wait waits for all of the thread's copies.
__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// K2's launch: the bucket, its grid and its bus.
struct TaskPlan {
  long long items;  // num_tasks * col_groups * runs
  int num_strips, num_tiles, t1, rows, cols;
  int runs;        // time runs of a task: ceil((t1 - 1) / kSteps)
  int col_groups;  // ceil(cols / 32)
  unsigned v_lo, v_hi;  // the b_v mask's low and high words
};

// One warp per item (task, column group, run), kTaskWarps consecutive items
// a block; see the note at the top.
template <int S, int kSteps>
__global__ void __launch_bounds__(kLanes * kTaskWarps, 8)
ws_task_toggles_kernel(const int32_t* __restrict__ strips, const int32_t* __restrict__ w_tiles,
                       const int32_t* __restrict__ strip_ids, const int32_t* __restrict__ w_ids,
                       const int32_t* __restrict__ valid_r, long long* __restrict__ out,
                       TaskPlan p) {
  constexpr int kVals = kSteps + 1;          // a run's time rows, the seed row first
  constexpr int kPad = (kVals + 3) / 4 * 4;  // ... padded to a 16-byte row
  // at[w][r][j]: warp w's time row j at reduction row r of the chunk
  __shared__ __align__(16) int32_t at[kTaskWarps][kRowChunk * kPad];
  // ws[w][r][l]: warp w's column of lane l at reduction row r of the chunk
  __shared__ int32_t ws[kTaskWarps][kRowChunk * kLanes];
  // the warp's operands in device memory: its strip at the run's seed row,
  // and its tile at its first column
  __shared__ const int32_t* a_src[kTaskWarps];
  __shared__ const int32_t* w_src[kTaskWarps];
  __shared__ long long part_task[kTaskWarps];
  __shared__ unsigned long long part_v[kTaskWarps];

  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const long long item = static_cast<long long>(blockIdx.x) * kTaskWarps + warp;
  // The warp's item; an idle warp, or one whose task has a bad id, walks no
  // row (vr = 0) and adds nothing (task -1).
  long long task = -1;
  int run = 0, cg = 0, vr = 0;
  if (item < p.items) {
    run = static_cast<int>(item % p.runs);
    cg = static_cast<int>(item / p.runs % p.col_groups);
    task = item / p.runs / p.col_groups;
    const int sid = strip_ids[task];
    const int wid = w_ids[task];
    if (sid < 0 || sid >= p.num_strips || wid < 0 || wid >= p.num_tiles) {
      if (run == 0 && cg == 0 && lane == 0) out[task] = -1;
      task = -1;
    } else {
      vr = min(max(valid_r[task], 0), p.rows);
      if (lane == 0) {
        a_src[warp] = strips + (static_cast<long long>(sid) * p.t1 + run * kSteps) * p.rows;
        w_src[warp] = w_tiles + static_cast<long long>(wid) * p.rows * p.cols + cg * kLanes;
      }
    }
  }
  // What the walk does not need is kept in shared memory, not in registers:
  // the partial sums take all but a few of the 64.
  if (lane == 0) {
    part_task[warp] = task;
    part_v[warp] = 0;
  }
  __syncwarp();

  const bool walks = cg * kLanes + lane < p.cols;
  const int steps_left = p.t1 - 1 - run * kSteps;  // time rows after the seed row
  int32_t* a_sh = at[warp];
  int32_t* w_sh = ws[warp] + lane;
  long long s[kVals];
#pragma unroll
  for (int j = 0; j < kVals; ++j) s[j] = 0;
  for (int rc = 0; rc < vr; rc += kRowChunk) {
    const int nr = min(kRowChunk, vr - rc);
    __syncwarp();  // the previous chunk's reads are done
    if (lane < nr) {  // lane r stages reduction row rc + r of every time row
      const int32_t* src = a_src[warp] + rc + lane;
#pragma unroll
      for (int j = 0; j < kVals; ++j) {
        cp_async4(a_sh + lane * kPad + j, src);
        if (j < steps_left) src += p.rows;  // rows past the end repeat the last
      }
    }
    if (walks) {
      const int32_t* src = w_src[warp] + static_cast<long long>(rc) * p.cols + lane;
      for (int r = 0; r < nr; ++r, src += p.cols) cp_async4(w_sh + r * kLanes, src);
    }
    cp_async_wait();
    __syncwarp();
    unsigned v = 0;
    if (walks) {
      for (int r = 0; r < nr; ++r) {
        const int32_t wv = w_sh[r * kLanes];
        const int32_t* ar = a_sh + r * kPad;
        int32_t av[kVals];  // 16-byte loads, and single ones for the rest
#pragma unroll
        for (int q = 0; q < kVals / 4; ++q) {
          const int4 four = reinterpret_cast<const int4*>(ar)[q];
          av[4 * q] = four.x;
          av[4 * q + 1] = four.y;
          av[4 * q + 2] = four.z;
          av[4 * q + 3] = four.w;
        }
#pragma unroll
        for (int j = kVals / 4 * 4; j < kVals; ++j) av[j] = ar[j];
#pragma unroll
        for (int j = 0; j < kVals; ++j) {
          s[j] += static_cast<long long>(av[j]) * static_cast<long long>(wv);
        }
        v += toggles::transitions<S>(s, p.v_lo, p.v_hi);
      }
    }
    // a chunk's counts are at most kRowChunk * kSteps * 64 a thread (2^20 a
    // warp), so the 32-bit sums cannot overflow
    v = __reduce_add_sync(kFull, v);
    if (lane == 0) part_v[warp] += v;
  }

  __syncthreads();
  if (threadIdx.x == 0) {  // a task's warps are neighbours: one atomic per task
    long long cur = -1;
    unsigned long long sum = 0;
    for (int i = 0; i <= kTaskWarps; ++i) {
      if (i == kTaskWarps || part_task[i] != cur) {
        if (cur >= 0 && sum) atomicAdd(reinterpret_cast<unsigned long long*>(out + cur), sum);
        if (i == kTaskWarps) break;
        cur = part_task[i];
        sum = 0;
      }
      sum += part_v[i];
    }
  }
}

}  // namespace

// C entry point. Pointers are device pointers; `out` receives one int64 per
// task, zeroed here on the stream before the launch. Returns the first CUDA
// error of the zeroing and the launch (cudaErrorInvalidValue for shapes it
// cannot launch), so a refused launch is reported to the caller. Does not
// synchronise.

extern "C" int ws_task_toggles(const void* strips, const void* w_tiles, const void* strip_ids,
                               const void* w_ids, const void* valid_r, void* out,
                               int num_tasks, int num_strips, int num_tiles, int t1, int rows,
                               int cols, int b_v, void* stream) {
  if (num_tasks < 1 || t1 < 2 || rows < 1 || cols < 1 || b_v < 1 || b_v > 64) {
    return cudaErrorInvalidValue;
  }
  const int steps = t1 - 1;
  const bool short_runs = steps % kLongRun != 0 && steps % kLongRun <= kShortRun;
  const int run_t = short_runs ? kShortRun : kLongRun;
  TaskPlan p{};
  p.num_strips = num_strips;
  p.num_tiles = num_tiles;
  p.t1 = t1;
  p.rows = rows;
  p.cols = cols;
  p.runs = (steps + run_t - 1) / run_t;
  p.col_groups = (cols + kLanes - 1) / kLanes;
  p.items = static_cast<long long>(num_tasks) * p.col_groups * p.runs;
  const long long blocks = (p.items + kTaskWarps - 1) / kTaskWarps;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const unsigned long long v_mask = b_v >= 64 ? ~0ull : (1ull << b_v) - 1;
  p.v_lo = static_cast<unsigned>(v_mask);
  p.v_hi = static_cast<unsigned>(v_mask >> 32);

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t zeroed =
      cudaMemsetAsync(out, 0, static_cast<size_t>(num_tasks) * sizeof(long long), s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  const auto launch = [&](auto kernel) {
    kernel<<<static_cast<unsigned>(blocks), kLanes * kTaskWarps, 0, s>>>(
        static_cast<const int32_t*>(strips), static_cast<const int32_t*>(w_tiles),
        static_cast<const int32_t*>(strip_ids), static_cast<const int32_t*>(w_ids),
        static_cast<const int32_t*>(valid_r), static_cast<long long*>(out), p);
  };
  const auto launch_runs = [&](auto long_kernel, auto short_kernel) {
    if (short_runs) {
      launch(short_kernel);
    } else {
      launch(long_kernel);
    }
  };
  const int hb = b_v - 32;  // the bus's bits above the low word
  if (hb <= 0) {
    launch_runs(ws_task_toggles_kernel<0, kLongRun>, ws_task_toggles_kernel<0, kShortRun>);
  } else if (hb <= 5) {
    launch_runs(ws_task_toggles_kernel<5, kLongRun>, ws_task_toggles_kernel<5, kShortRun>);
  } else if (hb <= 16) {  // S = 8 too: see the note at the top
    launch_runs(ws_task_toggles_kernel<16, kLongRun>, ws_task_toggles_kernel<16, kShortRun>);
  } else {
    launch_runs(ws_task_toggles_kernel<32, kLongRun>, ws_task_toggles_kernel<32, kShortRun>);
  }
  return static_cast<int>(cudaGetLastError());
}
