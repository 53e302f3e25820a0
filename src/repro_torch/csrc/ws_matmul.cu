// Weight-stationary GEMM for Hopper (sm_90a), bound with ctypes.
//
// K6 replaces ws_matmul_pallas (src/repro/kernels/ws_matmul/kernel.py):
//    out = a @ w for a (M, K) and w (K, N), with K innermost and a wide
//    accumulator: int8/int16 operands accumulate in 32 bits and wrap mod
//    2^32, as the TPU's int32 accumulator does; bf16/f32 operands
//    accumulate in f32. Every type runs on the tensor cores, in one kernel
//    of three modes, two of them fed by a prep kernel; the wrapper names
//    the route by type and shape (kernels/ws_matmul/kernel.py, gemm_route):
//
// ws_gemm_tc: the tensor-core kernel
//   At the shapes it serves it is bound by operations, which only wgmma
//   runs at the card's tensor-core rate. A block owns a 128-row output tile
//   (256 columns for bf16 and tf32, 128 for the integer planes). Its first
//   warpgroup is the producer: one thread keeps a ring of shared-memory
//   stages filled by TMA, each stage one 128-byte-wide K slice of A (128
//   rows, K-major) and of B. The two other warpgroups each own 64 rows and
//   run wgmma on every stage that has arrived, with the sums in
//   registers. The modes:
//   * bf16 with K % 8 == 0 and N % 8 == 0 (the "tc" route): a and w as
//     they are, 4 stages of 64-element K slices, m64n256k16 f32; B (K, N)
//     row-major is read MN-major with the transpose bit.
//   * int8 and int16 (the "tc" route), from the operand planes below: 4
//     stages of 128-element K slices, m64n128k32 s32, whose B must be
//     K-major, so w is transposed by the prep kernel.
//     int16 has no tensor-core type. Its operands are split into planes,
//     x = hi * 2^8 + lo with hi = x >> 8 (s8) and lo = x & 0xFF (u8), and
//     a.w = hh * 2^16 + (hl + lh) * 2^8 + ll (mod 2^32), four int8
//     products (s8.s8, s8.u8, u8.s8, u8.u8) that wgmma takes as they are.
//     One accumulator is kept and updated by Horner's rule over four
//     passes of the block's K range: D = (hh * 2^8 + hl + lh) * 2^8 + ll.
//     It needs the registers of one int8 tile, not three; the later reads
//     of the planes come from L2. The shifts wrap exactly: multiplication
//     by 2^k and addition commute with reduction mod 2^32.
//     Integer sums are wgmma's s32 sums without .satfinite, which wrap.
//     Where the output tiles do not fill the card (the Table-I GEMMs give
//     4-28 tiles for 132 SMs), K is split across blocks and each adds its
//     partial sums into the zeroed output with red.global.add: int32
//     addition wraps mod 2^32, so the total is exact in any order.
//   * tf32 (the "tf32" route: f32, and bf16 with K or N not a multiple of
//     8), from f32 operand planes: 2 stages of 32-element K slices,
//     m64n256k8 f32 over tf32, both operands K-major (tf32 has no
//     transpose bit). One TF32 product keeps 11 significant bits of each
//     operand, which the f32 tolerance (1e-5 * |a| @ |w|) does not admit;
//     three products do. Each f32 value is split as x = big + small + r:
//     big is x rounded to TF32, small is x - big (exact in f32) rounded to
//     TF32, so |r| <= 2^-22 |x|, and a.w = a_s.w_b + a_b.w_s + a_b.w_b up
//     to the dropped a_s.w_s and the r terms, about 3 * 2^-22 |a|.|w| in
//     all. A stage holds both planes of its K slice of A and of W (96 KB),
//     so each plane byte is read once per tile (no pass-by-pass re-read as
//     for int16), and each consumer runs the three products on it into its
//     one accumulator, the small ones first. bf16 is exact in TF32, so
//     unaligned bf16 takes one plane (its values) and one product.
//   bf16 and tf32 take no split of K: their shapes fill the card, and an
//   f32 sum in a varying order would not be deterministic.
//
// gemm_operand_planes: the prep kernel of the integer and tf32 modes
//   Copies a into planes (P, M, Kp) and w, transposed, into (P, N, Kp), K
//   zero-padded to Kp (a multiple of 32), so that every shape has
//   TMA-legal strides and a 128-byte row holds 32 TF32 values. int8: one
//   int8 plane (the values); int16: two (hi, lo); bf16: one f32 plane (the
//   values); f32: two f32 planes (big, small). Bound by bytes; a row of a
//   per block, and w through a 32 x 32 shared-memory tile, so that reads
//   and writes are coalesced.
//   Non-finite f32 values go whole into small, and big keeps their sign
//   as +-1: the three products then give inf * w = +-inf, inf * 0 = NaN
//   and inf * inf = inf as the f32 product does, where small = 0 would give
//   inf * 0 = NaN in a_b.w_s for every w that TF32 holds exactly. A finite
//   value that would round to inf (near f32's maximum) is truncated
//   instead. The split's one limit is at the other end: below 2^-115 small
//   is subnormal and keeps fewer bits (a step of 2^-136), so values below
//   about 2^-120, within 2^6 of f32's smallest normal, lose more than 1e-5
//   of themselves, and a dot product made of such values misses the f32
//   tolerance. The route is fixed by type and shape; serving that band on
//   the CUDA cores would need the data's magnitudes on the host first.
//
// What the TPU kernel did that these designs drop
//   * The grid's K axis ran in order and carried the sum in VMEM scratch;
//     here each block loops over its K range itself, so the sum stays in
//     registers (and split-K blocks meet only in the wrapping atomics).
//   * The wrapper zero-padded every dimension to a block multiple; here TMA
//     fills zeros past the ends (the planes pad K only), and the stores
//     skip rows and columns past the end.

#include <algorithm>
#include <atomic>
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kConsumers = 2;                     // consumer warpgroups, 64 rows each
constexpr int kTcRows = 64 * kConsumers;          // output rows per block
constexpr int kTcThreads = 128 * (kConsumers + 1);
constexpr int kRowBytes = 128;                    // a stage's K slice: 128 bytes of every row
constexpr int kPlaneK = 32;                       // the planes' K padding

// The kernel's modes, and each one's output columns, K slice (elements),
// stages and the planes a stage holds of each operand.
enum Mode : int { kBf16 = 0, kInt = 1, kTf32 = 2 };
template <int M> struct Tc;
template <> struct Tc<kBf16> { static constexpr int kCols = 256, kSliceK = 64, kStages = 4, kPlanes = 1; };
template <> struct Tc<kInt> { static constexpr int kCols = 128, kSliceK = 128, kStages = 4, kPlanes = 1; };
template <> struct Tc<kTf32> { static constexpr int kCols = 256, kSliceK = 32, kStages = 2, kPlanes = 2; };

template <int M>
__host__ __device__ constexpr int tc_stage_bytes() {
  return Tc<M>::kPlanes * (kTcRows + Tc<M>::kCols) * kRowBytes;
}
template <int M>
__host__ __device__ constexpr int tc_smem_bytes() {
  return Tc<M>::kStages * tc_stage_bytes<M>() + 1024 /* alignment */ + 2 * Tc<M>::kStages * 8;
}

// One block: output tile (tile % tiles_m, tile / tiles_m), K stages
// [split * per_split, +per_split) of k_stages. `planes` is the number of
// planes of each operand: kInt 1 (int8: one pass) or 2 (int16: four passes
// of the block's K range, hh, hl, lh, ll); kTf32 1 (bf16: one product a
// stage) or 2 (f32: three); kBf16 1.
template <int M>
__global__ void __launch_bounds__(kTcThreads, 1)
ws_gemm_tc_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                  void* __restrict__ out, int m, int n, int tiles_m, int k_stages, int per_split,
                  int planes) {
  using namespace hopper;
  constexpr bool Int = M == kInt;
  constexpr int kCols = Tc<M>::kCols;
  constexpr int kSliceK = Tc<M>::kSliceK;
  constexpr int kStages = Tc<M>::kStages;
  constexpr int kStageBytes = tc_stage_bytes<M>();
  constexpr int kABytes = kTcRows * kRowBytes;  // one plane of A's slice
  constexpr int kBBytes = kCols * kRowBytes;    // one plane of B's slice
  constexpr int kAcc = kCols / 2;  // accumulator registers a thread
  using AccT = typename std::conditional<Int, uint32_t, float>::type;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int wg = threadIdx.x / 128;
  const int m0 = (blockIdx.x % tiles_m) * kTcRows;
  const int n0 = (blockIdx.x / tiles_m) * kCols;
  const int k_begin = blockIdx.y * per_split;
  const int ks = min(per_split, k_stages - k_begin);
  const int passes = Int ? planes * planes : 1;
  const int steps = passes * ks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // A stage: the planes of A's slice, then those of B's.
  if (wg == 0) {
    // Producer: one thread issues every load.
    regs_dec<24>();
    if (threadIdx.x == 0) {
      for (int s = 0; s < steps; ++s) {
        const int st = s % kStages;
        const int kt = k_begin + s % ks;
        uint8_t* a_tile = smem + st * kStageBytes;
        uint8_t* b_tile = a_tile + Tc<M>::kPlanes * kABytes;
        mbar_wait(&empty[st], ((s / kStages) & 1) ^ 1);
        if constexpr (M == kInt) {
          // passes: hh (0, 0), hl (0, 1), lh (1, 0), ll (1, 1)
          const int pass = s / ks;
          mbar_expect_tx(&full[st], kABytes + kBBytes);
          tma_load_3d(a_tile, &map_a, &full[st], kt * kSliceK, m0, pass >> 1);
          tma_load_3d(b_tile, &map_b, &full[st], kt * kSliceK, n0, pass & 1);
        } else if constexpr (M == kTf32) {
          mbar_expect_tx(&full[st], planes * (kABytes + kBBytes));
          for (int p = 0; p < planes; ++p) {
            tma_load_3d(a_tile + p * kABytes, &map_a, &full[st], kt * kSliceK, m0, p);
            tma_load_3d(b_tile + p * kBBytes, &map_b, &full[st], kt * kSliceK, n0, p);
          }
        } else {
          mbar_expect_tx(&full[st], kABytes + kBBytes);
          tma_load_2d(a_tile, &map_a, &full[st], kt * kSliceK, m0);
#pragma unroll
          for (int c = 0; c < kCols / 64; ++c)
            tma_load_2d(b_tile + c * kSliceK * kRowBytes, &map_b, &full[st], n0 + 64 * c,
                        kt * kSliceK);
        }
      }
    }
  } else {
    // Consumers: warpgroup wg - 1 owns rows [64 (wg - 1), +64) of the tile.
    regs_inc<240>();
    const int c = wg - 1;
    AccT acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = AccT(0);
    for (int s = 0; s < steps; ++s) {
      const int st = s % kStages;
      if constexpr (Int) {
        if (passes == 4 && (s == ks || s == 3 * ks)) {  // Horner: D = D * 2^8 before hl and ll
#pragma unroll
          for (int i = 0; i < kAcc; ++i) acc[i] <<= 8;
        }
      }
      const uint8_t* a_tile = smem + st * kStageBytes + c * 64 * kRowBytes;
      const uint8_t* b_tile = smem + st * kStageBytes + Tc<M>::kPlanes * kABytes;
      mbar_wait(&full[st], (s / kStages) & 1);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // four 32-byte k slices of the 128-byte rows
        const uint64_t da = smem_desc(a_tile + 32 * kk, 16, 8 * kRowBytes, kRowBytes);
        if constexpr (M == kInt) {
          const uint64_t db = smem_desc(b_tile + 32 * kk, 16, 8 * kRowBytes, kRowBytes);
          switch (s / ks) {
            case 0: wgmma_s8s8(acc, da, db, 1); break;
            case 1: wgmma_s8u8(acc, da, db, 1); break;
            case 2: wgmma_u8s8(acc, da, db, 1); break;
            default: wgmma_u8u8(acc, da, db, 1); break;
          }
        } else if constexpr (M == kTf32) {
          const uint64_t db = smem_desc(b_tile + 32 * kk, 16, 8 * kRowBytes, kRowBytes);
          if (planes == 2) {  // the small products first: a_s.w_b, then a_b.w_s
            wgmma_tf32_ss(acc, smem_desc(a_tile + kABytes + 32 * kk, 16, 8 * kRowBytes, kRowBytes),
                          db, 1);
            wgmma_tf32_ss(acc, da, smem_desc(b_tile + kBBytes + 32 * kk, 16, 8 * kRowBytes, kRowBytes),
                          1);
          }
          wgmma_tf32_ss(acc, da, db, 1);  // a_b.w_b
        } else {
          // B MN-major: 16 K rows of 128 bytes a slice, 64-column chunks
          // kSliceK rows apart (LBO), 8-row atoms (SBO).
          const uint64_t db = smem_desc(b_tile + 16 * kRowBytes * kk, kSliceK * kRowBytes,
                                        8 * kRowBytes, kRowBytes);
          wgmma_bf16_ss<1>(acc, da, db, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[st]);
    }

    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x / 32) % 4;
    const int r0 = m0 + c * 64 + 16 * warp + lane / 4;
#pragma unroll
    for (int i = 0; i < kAcc; i += 2) {
      const int r = r0 + ((i & 2) ? 8 : 0);
      const int col = n0 + 8 * (i / 4) + 2 * (lane % 4);
      if (r >= m || col >= n) continue;
      const long long at = static_cast<long long>(r) * n + col;
      if constexpr (Int) {
        uint32_t* o = static_cast<uint32_t*>(out) + at;
        atomicAdd(o, acc[i]);
        if (col + 1 < n) atomicAdd(o + 1, acc[i + 1]);
      } else {
        float* o = static_cast<float*>(out) + at;
        if (M == kBf16 || n % 2 == 0) {
          // col is even, so the pair lies in the row and is 8-byte aligned
          *reinterpret_cast<float2*>(o) = make_float2(acc[i], acc[i + 1]);
        } else {
          o[0] = acc[i];
          if (col + 1 < n) o[1] = acc[i + 1];
        }
      }
    }
  }
}

// The planes of each operand type: their element type, and the type a value
// is staged in on its way.
template <typename T> struct Plane;
template <> struct Plane<int8_t> { using type = int8_t; using stage = int; };
template <> struct Plane<int16_t> { using type = int8_t; using stage = int; };
template <> struct Plane<__nv_bfloat16> { using type = float; using stage = float; };
template <> struct Plane<float> { using type = float; using stage = float; };

__device__ __forceinline__ int to_stage(int8_t x) { return x; }
__device__ __forceinline__ int to_stage(int16_t x) { return x; }
__device__ __forceinline__ float to_stage(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_stage(float x) { return x; }

// Writes the value x of an operand into each of its planes, at `at` in a
// plane of `size` elements: int8 its value; int16 hi = x >> 8 (s8) and lo =
// x & 0xFF (its bits as s8, read as u8); bf16 its f32 value (exact in TF32);
// f32 big and small (hopper::split_tf32; see the note at the top).
template <typename T>
__device__ __forceinline__ void put_planes(typename Plane<T>::type* planes, long long size,
                                           long long at, typename Plane<T>::stage x) {
  if constexpr (std::is_same<T, int8_t>::value) {
    planes[at] = static_cast<int8_t>(x);
  } else if constexpr (std::is_same<T, int16_t>::value) {
    planes[at] = static_cast<int8_t>(x >> 8);
    planes[size + at] = static_cast<int8_t>(static_cast<uint8_t>(x & 0xFF));
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    planes[at] = x;
  } else {
    float big, small;
    hopper::split_tf32(x, big, small);
    planes[at] = big;
    planes[size + at] = small;
  }
}

// Blocks [0, a_blocks) copy rows of a (grid-stride over rows, the block's
// threads along the row); the others each transpose one 32 x 32 tile of w
// (tile t: K rows 32 (t % k_tiles), N columns 32 (t / k_tiles)).
template <typename T>
__global__ void __launch_bounds__(256)
gemm_operand_planes_kernel(const T* __restrict__ a, const T* __restrict__ w,
                           typename Plane<T>::type* __restrict__ ap,
                           typename Plane<T>::type* __restrict__ wp, int m, int k, int n, int kp,
                           int a_blocks, int k_tiles) {
  using S = typename Plane<T>::stage;
  __shared__ S tile[32][33];
  if (static_cast<int>(blockIdx.x) < a_blocks) {
    const long long size = static_cast<long long>(m) * kp;
    for (int r = blockIdx.x; r < m; r += a_blocks) {
      const T* row = a + static_cast<long long>(r) * k;
      const long long at = static_cast<long long>(r) * kp;
      for (int col = threadIdx.x; col < kp; col += 256)
        put_planes<T>(ap, size, at + col, col < k ? to_stage(row[col]) : S(0));
    }
    return;
  }
  const int t = blockIdx.x - a_blocks;
  const int k0 = (t % k_tiles) * 32, n0 = (t / k_tiles) * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += 8) {
    const int kk = k0 + i, nn = n0 + tx;
    tile[i][tx] = (kk < k && nn < n) ? to_stage(w[static_cast<long long>(kk) * n + nn]) : S(0);
  }
  __syncthreads();
  const long long size = static_cast<long long>(n) * kp;
  for (int i = ty; i < 32; i += 8) {
    const int nn = n0 + i, kk = k0 + tx;
    if (nn < n && kk < kp) put_planes<T>(wp, size, static_cast<long long>(nn) * kp + kk, tile[tx][i]);
  }
}

template <int M>
int launch_tc(const CUtensorMap& map_a, const CUtensorMap& map_b, void* out, int m, int n,
              int k_stages, int planes, cudaStream_t s) {
  constexpr int bytes = tc_smem_bytes<M>();
  static std::atomic<unsigned long long> smem_set{0};
  const int dev = hopper::current_device();
  const cudaError_t err = hopper::allow_smem(ws_gemm_tc_kernel<M>, bytes, dev, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_m = (m + kTcRows - 1) / kTcRows;
  const int tiles = tiles_m * ((n + Tc<M>::kCols - 1) / Tc<M>::kCols);
  // Integers: split K until the blocks fill the card once (one block an SM).
  int splits = M == kInt ? std::max(1, std::min(k_stages, hopper::sm_count(dev) / tiles)) : 1;
  const int per_split = (k_stages + splits - 1) / splits;
  splits = (k_stages + per_split - 1) / per_split;
  const dim3 grid(tiles, splits);
  ws_gemm_tc_kernel<M><<<grid, kTcThreads, bytes, s>>>(map_a, map_b, out, m, n, tiles_m, k_stages,
                                                       per_split, planes);
  return static_cast<int>(cudaGetLastError());
}

int launch_planes(const void* a, const void* w, void* ap, void* wp, int m, int k, int n, int kp,
                  int dtype, cudaStream_t s) {
  if (m < 0 || k < 1 || n < 0 || kp < k || kp % kPlaneK) return cudaErrorInvalidValue;
  const int a_blocks = std::min(4096, m);
  const int k_tiles = (kp + 31) / 32;
  const long long w_tiles = static_cast<long long>(k_tiles) * ((n + 31) / 32);
  if (a_blocks + w_tiles > INT_MAX) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(a_blocks + w_tiles);
  if (grid == 0) return cudaSuccess;  // m = n = 0: nothing to write
  const auto go = [&](auto value) {
    using T = decltype(value);
    using P = typename Plane<T>::type;
    gemm_operand_planes_kernel<T><<<grid, 256, 0, s>>>(
        static_cast<const T*>(a), static_cast<const T*>(w), static_cast<P*>(ap), static_cast<P*>(wp),
        m, k, n, kp, a_blocks, k_tiles);
  };
  switch (dtype) {
    case 0: go(int8_t{}); break;
    case 1: go(int16_t{}); break;
    case 2: go(__nv_bfloat16{}); break;
    case 3: go(float{}); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point of the prep kernel. `a` (m, k) and `w` (k, n) are
// contiguous device arrays of `dtype` 0 int8, 1 int16, 2 bf16 or 3 f32;
// `a_planes` (P, m, kp) and `w_planes` (P, n, kp) are device arrays of int8
// (dtype 0, 1) or f32 (dtype 2, 3): int8 P = 1 (the values), int16 P = 2
// (hi = x >> 8, lo = x & 0xFF read as u8), bf16 P = 1 (the values), f32
// P = 2 (big, small: see the note at the top); kp is k rounded up to a
// multiple of 32; m or n may be 0. Every element of the planes is written.
extern "C" int gemm_operand_planes(const void* a, const void* w, void* a_planes, void* w_planes,
                                   int m, int k, int n, int kp, int dtype, void* stream) {
  return launch_planes(a, w, a_planes, w_planes, m, k, n, kp, dtype,
                       static_cast<cudaStream_t>(stream));
}

// C entry point of the tensor-core kernel: `a` (m, k) and `w` (k, n) are
// contiguous device arrays of one type `dtype`, 0 int8, 1 int16, 2 bf16 or
// 3 f32; `out` (m, n) is int32 (integers) or f32, and every element is
// written. bf16 with k % 8 == 0 and n % 8 == 0 is read as it is and needs
// 16-byte aligned operands. The other cases launch the prep kernel first,
// into `planes`, scratch of P * (m + n) * kp elements (kp = k rounded up to
// 32), int8 for the integers and f32 for bf16 and f32 (P as for
// gemm_operand_planes); the integers zero `out` and add their wrapped
// partial sums into it. Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for arguments it cannot take, or a tensor map
// cuTensorMapEncodeTiled refuses). Does not synchronise.
extern "C" int ws_gemm_tc(const void* a, const void* w, void* planes, void* out, int m, int k, int n,
                          int dtype, void* stream) {
  if (m < 1 || k < 1 || n < 1 || dtype < 0 || dtype > 3) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap map_a, map_b;
  if (dtype == 2 && k % 8 == 0 && n % 8 == 0) {
    if (reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
      return cudaErrorInvalidValue;
    const uint64_t dims_a[2] = {static_cast<uint64_t>(k), static_cast<uint64_t>(m)};
    const uint64_t strides_a[1] = {static_cast<uint64_t>(k) * 2};
    const uint32_t box_a[2] = {Tc<kBf16>::kSliceK, kTcRows};
    const uint64_t dims_b[2] = {static_cast<uint64_t>(n), static_cast<uint64_t>(k)};
    const uint64_t strides_b[1] = {static_cast<uint64_t>(n) * 2};
    const uint32_t box_b[2] = {64, Tc<kBf16>::kSliceK};
    if (!hopper::make_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, dims_a, strides_a, box_a, kRowBytes) ||
        !hopper::make_map(&map_b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, dims_b, strides_b, box_b, kRowBytes))
      return cudaErrorInvalidValue;
    const int k_stages = (k + Tc<kBf16>::kSliceK - 1) / Tc<kBf16>::kSliceK;
    return launch_tc<kBf16>(map_a, map_b, out, m, n, k_stages, 1, s);
  }
  const bool ints = dtype < 2;
  const int kp = (k + kPlaneK - 1) / kPlaneK * kPlaneK;
  const uint64_t p = dtype == 1 || dtype == 3 ? 2 : 1;
  const uint64_t elem = ints ? 1 : 4;
  uint8_t* ap = static_cast<uint8_t*>(planes);
  uint8_t* wp = ap + p * m * kp * elem;
  const int err = launch_planes(a, w, ap, wp, m, k, n, kp, dtype, s);
  if (err != cudaSuccess) return err;
  const uint64_t dims_a[3] = {static_cast<uint64_t>(kp), static_cast<uint64_t>(m), p};
  const uint64_t strides_a[2] = {kp * elem, kp * elem * m};
  const uint64_t dims_b[3] = {static_cast<uint64_t>(kp), static_cast<uint64_t>(n), p};
  const uint64_t strides_b[2] = {kp * elem, kp * elem * n};
  if (!ints) {
    const uint32_t box_a[3] = {Tc<kTf32>::kSliceK, kTcRows, 1};
    const uint32_t box_b[3] = {Tc<kTf32>::kSliceK, Tc<kTf32>::kCols, 1};
    if (!hopper::make_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, ap, dims_a, strides_a, box_a, kRowBytes) ||
        !hopper::make_map(&map_b, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, wp, dims_b, strides_b, box_b, kRowBytes))
      return cudaErrorInvalidValue;
    return launch_tc<kTf32>(map_a, map_b, out, m, n, kp / Tc<kTf32>::kSliceK, static_cast<int>(p), s);
  }
  const cudaError_t zeroed = cudaMemsetAsync(out, 0, static_cast<size_t>(m) * n * 4, s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  const uint32_t box_a[3] = {Tc<kInt>::kSliceK, kTcRows, 1};
  const uint32_t box_b[3] = {Tc<kInt>::kSliceK, Tc<kInt>::kCols, 1};
  if (!hopper::make_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, ap, dims_a, strides_a, box_a, kRowBytes) ||
      !hopper::make_map(&map_b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, wp, dims_b, strides_b, box_b, kRowBytes))
    return cudaErrorInvalidValue;
  const int k_stages = (kp + Tc<kInt>::kSliceK - 1) / Tc<kInt>::kSliceK;
  return launch_tc<kInt>(map_a, map_b, out, m, n, k_stages, static_cast<int>(p), s);
}
