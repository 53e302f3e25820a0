// The per-GEMM weight-stationary toggle counter for Hopper (sm_90a), bound
// with ctypes.
//
// K1 ws_activity_toggles replaces activity_profile_pallas
//    (src/repro/kernels/activity_profile/kernel.py): exact input-bus (h) and
//    partial-sum-bus (v) toggle totals of a whole weight-stationary GEMM.
// K4, the per-GEMM output-stationary counter (operand_stream_toggles_pallas
//    in the same file), computes K5's function on an int32 (T, L) stream, so
//    its wrapper launches toggle_count.cu's stream_toggles.
//
// What bounds K1 on this card
//   Every (t, r, c) partial sum S[t, r, c] = sum_{r' <= r} a[t, r'] w[r', c]
//   costs a multiply-add into an int64, a logic op per 32-bit word of the
//   b_v bus and b_v / 32 popcounts, against a few MB of operands. Hopper
//   pops 16 counts a clock on an SM against 64 integer ops, so the popcount
//   rate bounds it (0.11 ms for the six Table-I layers at b_v = 37), then
//   the logic ops. The multiply-add is a minor share, so the tensor cores,
//   whose products never leave their accumulators, are of no use here.
//
// The K1 design
//   * Tiles staged in shared memory. A block of kWarps warps owns one k tile
//     (`rows` reduction rows), a group of 32 * cw columns and rw = kWarps / cw
//     runs of kSteps time transitions (cw = 4, 2 or 1, whichever divides the
//     column groups). It stages its runs' activation rows (each run's seed row
//     and kSteps rows, transposed so a run's kVals values of one reduction
//     row are contiguous) and the W tile, kRowChunk reduction rows at a time,
//     with loads where neighbouring threads take neighbouring addresses.
//   * Registers blocked in time. A thread owns one column and one run: kVals
//     int64 partial sums, its seed row's first. Walking r down the tile it
//     reads w[r][c] once (a conflict-free 32-bit load) and its run's a[t][r]
//     as four 16-byte broadcast loads, adds kVals products and counts the
//     kSteps transitions between neighbouring sums in registers: no shuffles,
//     and the recomputed seed costs one multiply-add in kVals, where the
//     warp-per-32-steps design spent a whole lane in 32 and a shuffle per sum.
//   * Masked popcounts (toggles.cuh, shared with K2). The low word of a
//     transition takes one popcount. On a bus wider than 32 bits, the high
//     word's hb = b_v - 32 bits are masked and packed 32 / S to a word
//     (field width S = 5, 8, 16 or 32, the smallest that holds hb) before
//     one popcount: at b_v = 37, 15 transitions take 15 + 3 popcounts
//     instead of 30.
//   * The h bus is counted once per (k tile, time run), from the staged rows,
//     by the block of column group 0, and scaled by the n tiles.
//   * Every loop is bounded by the true M, K and N: rows past M repeat row
//     M - 1 (equal sums, no toggles), columns past N skip the walk.
//   * Each warp sums its counts with one REDUX per staged chunk (32-bit
//     counts that cannot overflow there) into a 64-bit total; the block adds
//     its totals into the output with two 64-bit atomics. The C entry zeroes
//     the output on the stream, so the caller allocates it uninitialised.
//
// What the TPU kernel did that this design drops
//   * The Pallas grid runs in order and carries the previous time block's
//     last row in VMEM scratch. CUDA blocks run in any order, so every K1
//     run recomputes its seed row t0 - 1 itself. The first run seeds with
//     t = 0, so its first transition counts zero.
//   * The lo/hi int32 planes stood in for 64-bit integers, which the TPU's
//     vector unit lacks. Here the sums are native int64, and a toggle count
//     takes the same bits as the numpy oracle's two's-complement bus
//     representation. Operand values are sign-extended to int64 before the
//     XOR, so on a bus wider than 32 bits the bits above 31 flip with the
//     sign, as on the reference.
//   * Per-cell int32 partials become 64-bit atomics into int64 totals, so
//     no partial has an overflow bound.
//   * Edges: the kernel reads the unpadded operands and bounds every loop by
//     the true extents, where the TPU kernel padded and masked.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "toggles.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 32;
constexpr int kSteps = 15;            // K1: transitions a thread counts (kernel.py WS_KERNEL_STEPS)
constexpr int kVals = kSteps + 1;     // K1: its time rows, the seed row first
constexpr int kWarps = 4;             // K1: warps per block
constexpr int kRowChunk = 32;         // K1: reduction rows staged at a time

// K1's launch: the GEMM, its grid and its buses.
struct WsPlan {
  int m, k, n, rows;
  int runs;        // ceil((m - 1) / kSteps) time runs
  int run_blocks;  // ceil(runs / rw)
  int col_blocks;  // column groups of 32 / cw
  int cw;          // column groups a block owns; rw = kWarps / cw runs
  unsigned v_lo, v_hi;        // the b_v mask's low and high words
  unsigned h_lo, h_hi_bits;   // the b_h mask's low word and its bits above 31
  unsigned long long n_tiles;
};

// One block per (k tile, column block, run block); see the note at the top.
// Warp w owns column group w % cw of the block and run w / cw of it.
template <int S>
__global__ void __launch_bounds__(kLanes * kWarps)
ws_activity_toggles_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ w,
                           unsigned long long* __restrict__ out, WsPlan p) {
  // at[r][g][j]: run g's time row j (its seed first) at reduction row r
  __shared__ __align__(16) int32_t at[kRowChunk * kWarps * kVals];
  // ws[r][cc]: column cc of the block at reduction row r
  __shared__ int32_t ws[kRowChunk * kLanes * kWarps];
  __shared__ unsigned long long part[2][kWarps];

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
  const bool counts_h = cb == 0 && warp % cw == 0 && run < p.runs;

  long long s[kVals];
#pragma unroll
  for (int j = 0; j < kVals; ++j) s[j] = 0;
  unsigned long long v_warp = 0, h_warp = 0;  // valid in lane 0
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

    unsigned h = 0;
    if (counts_h) {  // lanes take (r, j) pairs of run g, j fastest
      for (int e = lane; e < nr * kVals; e += kLanes) {
        const int j = e % kVals;
        const int32_t* row = at + ((e / kVals) * rw + g) * kVals;
        if (j > 0) h += toggles::bus32(row[j] ^ row[j - 1], p.h_lo, p.h_hi_bits);
      }
    }
    unsigned v = 0;
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
        v += toggles::transitions<S>(s, p.v_lo, p.v_hi);
      }
    }
    // a chunk's counts are at most kRowChunk * kSteps * 64 a thread (2^20 a
    // warp), so the 32-bit sums cannot overflow
    v = __reduce_add_sync(kFull, v);
    h = __reduce_add_sync(kFull, h);
    v_warp += v;
    h_warp += h;
  }

  if (lane == 0) {
    part[0][warp] = h_warp;
    part[1][warp] = v_warp;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long h_tot = 0, v_tot = 0;
    for (int i = 0; i < kWarps; ++i) {
      h_tot += part[0][i];
      v_tot += part[1][i];
    }
    if (h_tot) atomicAdd(out, h_tot * p.n_tiles);
    if (v_tot) atomicAdd(out + 1, v_tot);
  }
}

}  // namespace

// C entry point. Pointers are device pointers; `out` receives the two
// int64 totals (h, v) and is zeroed here, on the stream, before the launch.
// Returns the first CUDA error of the zeroing and the launch
// (cudaErrorInvalidValue for a grid it cannot launch), so a refused launch
// is reported to the caller. Does not synchronise.
extern "C" int ws_activity_toggles(const void* a, const void* w, void* out, int m, int k,
                                   int n, int rows, int cols, int b_h, int b_v,
                                   void* stream) {
  if (m < 2 || k < 1 || n < 1 || rows < 1 || cols < 1 || b_h < 1 || b_h > 64 || b_v < 1 ||
      b_v > 64) {
    return cudaErrorInvalidValue;
  }
  WsPlan p{};
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
  const long long k_tiles = (k + rows - 1) / rows;
  const long long blocks = k_tiles * p.col_blocks * p.run_blocks;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const unsigned long long v_mask = b_v >= 64 ? ~0ull : (1ull << b_v) - 1;
  const unsigned long long h_mask = b_h >= 64 ? ~0ull : (1ull << b_h) - 1;
  p.v_lo = static_cast<unsigned>(v_mask);
  p.v_hi = static_cast<unsigned>(v_mask >> 32);
  p.h_lo = static_cast<unsigned>(h_mask);
  p.h_hi_bits = b_h > 32 ? b_h - 32 : 0;
  p.n_tiles = static_cast<unsigned long long>((n + cols - 1) / cols);

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t zeroed = cudaMemsetAsync(out, 0, 2 * sizeof(unsigned long long), s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  const int hb = b_v - 32;  // the bus's bits above the low word
  const auto launch = [&](auto kernel) {
    kernel<<<static_cast<unsigned>(blocks), kLanes * kWarps, 0, s>>>(
        static_cast<const int32_t*>(a), static_cast<const int32_t*>(w),
        static_cast<unsigned long long*>(out), p);
  };
  if (hb <= 0) {
    launch(ws_activity_toggles_kernel<0>);
  } else if (hb <= 5) {
    launch(ws_activity_toggles_kernel<5>);
  } else if (hb <= 8) {
    launch(ws_activity_toggles_kernel<8>);
  } else if (hb <= 16) {
    launch(ws_activity_toggles_kernel<16>);
  } else {
    launch(ws_activity_toggles_kernel<32>);
  }
  return static_cast<int>(cudaGetLastError());
}
