// Weight-stationary GEMM for Hopper (sm_90a), bound with ctypes.
//
// K6 replaces ws_matmul_pallas (src/repro/kernels/ws_matmul/kernel.py):
//    out = a @ w for a (M, K) and w (K, N), with K innermost and a wide
//    accumulator: int8/int16 operands accumulate in 32 bits and wrap mod
//    2^32, as the TPU's int32 accumulator does; bf16/f32 operands
//    accumulate in f32. Three kernels serve it; the wrapper picks one by
//    type and shape (kernels/ws_matmul/kernel.py, gemm_route):
//
// ws_gemm_tc: the tensor-core route (bf16 with K % 8 == 0 and N % 8 == 0;
//   int8 and int16 always, through the operand planes below)
//   At the shapes it serves it is bound by operations, which only wgmma
//   runs at the card's tensor-core rate. A block owns a 128-row output tile
//   (256 columns for bf16, 128 for the integer planes). Its first
//   warpgroup is the producer: one thread keeps a ring of 4 shared-memory
//   stages filled by TMA, each stage one 128-byte-wide K slice of A (128 x
//   64 bf16 or 128 x 128 int8, K-major) and of B. The two other warpgroups
//   each own 64 rows and issue wgmma on every stage that has arrived, with
//   the sums in registers (m64n256k16 f32 for bf16, read B (K, N)
//   row-major as MN-major with the transpose bit; m64n128k32 s32 for int8,
//   whose B must be K-major, so w is transposed by the prep kernel).
//   * int16 has no tensor-core type. Its operands are split into planes,
//     x = hi * 2^8 + lo with hi = x >> 8 (s8) and lo = x & 0xFF (u8), and
//     a.w = hh * 2^16 + (hl + lh) * 2^8 + ll (mod 2^32), four int8
//     products (s8.s8, s8.u8, u8.s8, u8.u8) that wgmma takes as they are.
//     One accumulator is kept and updated by Horner's rule over three
//     passes of the block's K range: D = (hh * 2^8 + hl + lh) * 2^8 + ll.
//     It needs the registers of one int8 tile, not three; the second and
//     third read of the planes comes from L2. The shifts wrap exactly:
//     multiplication by 2^k and addition commute with reduction mod 2^32.
//   * Integer sums are wgmma's s32 sums without .satfinite, which wrap.
//     Where the output tiles do not fill the card (the Table-I GEMMs give
//     4-28 tiles for 132 SMs), K is split across blocks and each adds its
//     partial sums into the zeroed output with red.global.add: int32
//     addition wraps mod 2^32, so the total is exact in any order. bf16
//     takes no split: its shapes fill the card, and an f32 sum in a
//     varying order would not be deterministic.
//
// gemm_operand_planes: the prep kernel of the integer route
//   Copies a into planes (P, M, Kp) and w, transposed, into (P, N, Kp), K
//   zero-padded to Kp (a multiple of 32), so that every integer shape has
//   TMA-legal strides; P = 1 for int8 (the values) and 2 for int16 (hi,
//   lo). Bound by bytes; w goes through a 32 x 32 shared-memory tile so
//   that both its reads and its writes are coalesced.
//
// ws_matmul: the CUDA-core route (f32, and bf16 whose rows are not
//   16-byte multiples)
//   A tensor-core f32 route would be TF32, whose rounding the f32
//   tolerance does not admit. A block owns a 128 x 128 output tile and
//   walks K in steps of 8: it stages the (128, 8) slice of a, transposed,
//   and the (8, 128) slice of w in shared memory as f32, and each of its
//   256 threads keeps an 8 x 8 register tile of f32 sums, so every 16
//   shared-memory loads feed 64 fused multiply-adds. A thread's rows and
//   columns are 16 apart, so a warp's loads are conflict-free (w) or
//   broadcasts (a). It bound-checks the true extents (zeros outside).
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

constexpr int kTile = 128;          // output rows and columns per block
constexpr int kStep = 8;            // reduction rows per shared-memory stage
constexpr int kThreads = 256;       // 16 x 16 threads, each an 8 x 8 register tile
constexpr int kMicro = 8;
constexpr int kSide = 16;
constexpr int kPad = 4;             // keeps the transposed a stores conflict-free

__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(float x) { return x; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
ws_matmul_kernel(const T* __restrict__ a, const T* __restrict__ w, float* __restrict__ out, int m,
                 int k, int n) {
  __shared__ float as[kStep][kTile + kPad];  // a slice, transposed: as[kk][row]
  __shared__ float ws[kStep][kTile];

  const int tid = threadIdx.x;
  const int ty = tid / kSide;
  const int tx = tid % kSide;
  const long long m0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long n0 = static_cast<long long>(blockIdx.y) * kTile;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += kStep) {
    // Each thread stages 4 values of a (128 x 8) and 4 of w (8 x 128).
#pragma unroll
    for (int s = 0; s < kTile * kStep / kThreads; ++s) {
      const int idx = tid + s * kThreads;
      const int ar = idx / kStep, ac = idx % kStep;
      const long long gr = m0 + ar;
      const int gk = k0 + ac;
      as[ac][ar] = (gr < m && gk < k) ? widen(a[gr * k + gk]) : 0.0f;
      const int wr = idx / kTile, wc = idx % kTile;
      const int gk2 = k0 + wr;
      const long long gc = n0 + wc;
      ws[wr][wc] = (gk2 < k && gc < n) ? widen(w[static_cast<long long>(gk2) * n + gc]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kStep; ++kk) {
      float av[kMicro], wv[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) av[i] = as[kk][ty + kSide * i];
#pragma unroll
      for (int j = 0; j < kMicro; ++j) wv[j] = ws[kk][tx + kSide * j];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
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
      if (c < n) out[r * n + c] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* a, const void* w, void* out, int m, int k, int n, cudaStream_t s) {
  const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  ws_matmul_kernel<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(a), static_cast<const T*>(w),
                                                static_cast<float*>(out), m, k, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point of the CUDA-core route. `a` (m, k) and `w` (k, n) are
// contiguous device arrays of one operand type, `dtype`: 2 bf16 or 3 f32
// (the codes of ws_gemm_tc; the integer types take the tensor cores). `out`
// (m, n) is f32; every element is written. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments it cannot take). Does not
// synchronise.
extern "C" int ws_matmul(const void* a, const void* w, void* out, int m, int k, int n,
                         int dtype, void* stream) {
  if (m < 1 || k < 1 || n < 1) return cudaErrorInvalidValue;
  if ((n + kTile - 1) / kTile > 65535) return cudaErrorInvalidValue;  // grid.y limit
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 2: return launch<__nv_bfloat16>(a, w, out, m, k, n, s);
    case 3: return launch<float>(a, w, out, m, k, n, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The tensor-core route and its prep kernel
// ---------------------------------------------------------------------------

namespace {

constexpr int kConsumers = 2;                     // consumer warpgroups, 64 rows each
constexpr int kTcRows = 64 * kConsumers;          // output rows per block
constexpr int kTcThreads = 128 * (kConsumers + 1);
constexpr int kTcStages = 4;
constexpr int kRowBytes = 128;                    // a stage's K slice: 128 bytes of every row
constexpr int kPlaneK = 32;                       // the planes' K padding

// bf16: 256 output columns, 64-element K slices, B read MN-major in four
// 64-column chunks. Integer planes: 128 columns, 128-element K slices.
template <bool Int> struct Tc;
template <> struct Tc<false> { static constexpr int kCols = 256, kSliceK = 64; };
template <> struct Tc<true> { static constexpr int kCols = 128, kSliceK = 128; };

template <bool Int>
__host__ __device__ constexpr int tc_stage_bytes() { return (kTcRows + Tc<Int>::kCols) * kRowBytes; }
template <bool Int>
__host__ __device__ constexpr int tc_smem_bytes() {
  return kTcStages * tc_stage_bytes<Int>() + 1024 /* alignment */ + 2 * kTcStages * 8;
}

// One block: output tile (tile % tiles_m, tile / tiles_m), K stages
// [split * per_split, +per_split) of k_stages, `products` passes (1, or 4
// for the int16 planes: hh, hl, lh, ll).
template <bool Int>
__global__ void __launch_bounds__(kTcThreads, 1)
ws_gemm_tc_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                  void* __restrict__ out, int m, int n, int tiles_m, int k_stages, int per_split,
                  int products) {
  using namespace hopper;
  constexpr int kCols = Tc<Int>::kCols;
  constexpr int kSliceK = Tc<Int>::kSliceK;
  constexpr int kStageBytes = tc_stage_bytes<Int>();
  constexpr int kABytes = kTcRows * kRowBytes;
  constexpr int kAcc = kCols / 2;  // accumulator registers a thread
  using AccT = typename std::conditional<Int, uint32_t, float>::type;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kTcStages * kStageBytes);
  uint64_t* empty = full + kTcStages;

  const int wg = threadIdx.x / 128;
  const int m0 = (blockIdx.x % tiles_m) * kTcRows;
  const int n0 = (blockIdx.x / tiles_m) * kCols;
  const int k_begin = blockIdx.y * per_split;
  const int ks = min(per_split, k_stages - k_begin);
  const int steps = products * ks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread issues every load.
    regs_dec<24>();
    if (threadIdx.x == 0) {
      for (int s = 0; s < steps; ++s) {
        const int st = s % kTcStages;
        const int kt = k_begin + s % ks;
        const int prod = s / ks;
        uint8_t* a_tile = smem + st * kStageBytes;
        uint8_t* b_tile = a_tile + kABytes;
        mbar_wait(&empty[st], ((s / kTcStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], kStageBytes);
        if constexpr (Int) {
          // planes: hh (0, 0), hl (0, 1), lh (1, 0), ll (1, 1)
          tma_load_3d(a_tile, &map_a, &full[st], kt * kSliceK, m0, prod >> 1);
          tma_load_3d(b_tile, &map_b, &full[st], kt * kSliceK, n0, prod & 1);
        } else {
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
      const int st = s % kTcStages;
      if constexpr (Int) {
        if (products == 4 && (s == ks || s == 3 * ks)) {  // Horner: D = D * 2^8 before hl and ll
#pragma unroll
          for (int i = 0; i < kAcc; ++i) acc[i] <<= 8;
        }
      }
      const uint8_t* a_tile = smem + st * kStageBytes + c * 64 * kRowBytes;
      const uint8_t* b_tile = smem + st * kStageBytes + kABytes;
      mbar_wait(&full[st], (s / kTcStages) & 1);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // four 32-byte k slices of the 128-byte rows
        const uint64_t da = smem_desc(a_tile + 32 * kk, 16, 8 * kRowBytes, kRowBytes);
        if constexpr (Int) {
          const uint64_t db = smem_desc(b_tile + 32 * kk, 16, 8 * kRowBytes, kRowBytes);
          switch (s / ks) {
            case 0: wgmma_s8s8(acc, da, db, 1); break;
            case 1: wgmma_s8u8(acc, da, db, 1); break;
            case 2: wgmma_u8s8(acc, da, db, 1); break;
            default: wgmma_u8u8(acc, da, db, 1); break;
          }
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
        // this route has n % 8 == 0, so col + 1 < n and the pair is 8-byte aligned
        *reinterpret_cast<float2*>(static_cast<float*>(out) + at) = make_float2(acc[i], acc[i + 1]);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void put_planes(int8_t* planes, long long plane_size, long long at, T x) {
  if constexpr (sizeof(T) == 1) {
    planes[at] = static_cast<int8_t>(x);
  } else {
    planes[at] = static_cast<int8_t>(x >> 8);                                 // hi, s8
    planes[plane_size + at] = static_cast<int8_t>(static_cast<uint8_t>(x & 0xFF));  // lo, u8
  }
}

// Blocks [0, a_blocks) copy a (grid-stride); the others each transpose one
// 32 x 32 tile of w (tile t: K rows 32 (t % k_tiles), N columns 32 (t / k_tiles)).
template <typename T>
__global__ void __launch_bounds__(256)
gemm_operand_planes_kernel(const T* __restrict__ a, const T* __restrict__ w, int8_t* __restrict__ ap,
                           int8_t* __restrict__ wp, int m, int k, int n, int kp, int a_blocks,
                           int k_tiles) {
  __shared__ int tile[32][33];
  if (static_cast<int>(blockIdx.x) < a_blocks) {
    const long long size = static_cast<long long>(m) * kp;
    for (long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x; i < size;
         i += static_cast<long long>(a_blocks) * 256) {
      const long long r = i / kp;
      const int col = static_cast<int>(i % kp);
      put_planes<T>(ap, size, i, col < k ? a[r * k + col] : T(0));
    }
    return;
  }
  const int t = blockIdx.x - a_blocks;
  const int k0 = (t % k_tiles) * 32, n0 = (t / k_tiles) * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += 8) {
    const int kk = k0 + i, nn = n0 + tx;
    tile[i][tx] = (kk < k && nn < n) ? static_cast<int>(w[static_cast<long long>(kk) * n + nn]) : 0;
  }
  __syncthreads();
  const long long size = static_cast<long long>(n) * kp;
  for (int i = ty; i < 32; i += 8) {
    const int nn = n0 + i, kk = k0 + tx;
    if (nn < n && kk < kp) put_planes<T>(wp, size, static_cast<long long>(nn) * kp + kk, static_cast<T>(tile[tx][i]));
  }
}

template <bool Int>
int launch_tc(const CUtensorMap& map_a, const CUtensorMap& map_b, void* out, int m, int n,
              int k_stages, int products, cudaStream_t s) {
  constexpr int bytes = tc_smem_bytes<Int>();
  static std::atomic<unsigned long long> smem_set{0};
  const int dev = hopper::current_device();
  const cudaError_t err = hopper::allow_smem(ws_gemm_tc_kernel<Int>, bytes, dev, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_m = (m + kTcRows - 1) / kTcRows;
  const int tiles = tiles_m * ((n + Tc<Int>::kCols - 1) / Tc<Int>::kCols);
  // Integers: split K until the blocks fill the card once (one block an SM).
  int splits = Int ? std::max(1, std::min(k_stages, hopper::sm_count(dev) / tiles)) : 1;
  const int per_split = (k_stages + splits - 1) / splits;
  splits = (k_stages + per_split - 1) / per_split;
  const dim3 grid(tiles, splits);
  ws_gemm_tc_kernel<Int><<<grid, kTcThreads, bytes, s>>>(map_a, map_b, out, m, n, tiles_m,
                                                         k_stages, per_split, products);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace {

int launch_planes(const void* a, const void* w, int8_t* ap, int8_t* wp, int m, int k, int n, int kp,
                  int dtype, cudaStream_t s) {
  if (m < 0 || k < 1 || n < 0 || kp < k || kp % kPlaneK) return cudaErrorInvalidValue;
  const long long a_size = static_cast<long long>(m) * kp;
  const int a_blocks = static_cast<int>(std::min(4096LL, (a_size + 255) / 256));
  const int k_tiles = (kp + 31) / 32;
  const long long w_tiles = static_cast<long long>(k_tiles) * ((n + 31) / 32);
  if (a_blocks + w_tiles > INT_MAX) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(a_blocks + w_tiles);
  if (grid == 0) return cudaSuccess;  // m = n = 0: nothing to write
  switch (dtype) {
    case 0:
      gemm_operand_planes_kernel<int8_t><<<grid, 256, 0, s>>>(
          static_cast<const int8_t*>(a), static_cast<const int8_t*>(w), ap, wp, m, k, n, kp,
          a_blocks, k_tiles);
      break;
    case 1:
      gemm_operand_planes_kernel<int16_t><<<grid, 256, 0, s>>>(
          static_cast<const int16_t*>(a), static_cast<const int16_t*>(w), ap, wp, m, k, n, kp,
          a_blocks, k_tiles);
      break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point of the prep kernel. `a` (m, k) and `w` (k, n) are
// contiguous device arrays of `dtype` 0 int8 or 1 int16; `a_planes` (P, m,
// kp) and `w_planes` (P, n, kp) are int8 device arrays, P = 1 for int8 and
// 2 for int16 (plane 0 hi = x >> 8, plane 1 lo = x & 0xFF read as u8); kp
// is k rounded up to a multiple of 32; m or n may be 0. Every byte of the
// planes is written.
extern "C" int gemm_operand_planes(const void* a, const void* w, void* a_planes, void* w_planes,
                                   int m, int k, int n, int kp, int dtype, void* stream) {
  return launch_planes(a, w, static_cast<int8_t*>(a_planes), static_cast<int8_t*>(w_planes), m, k,
                       n, kp, dtype, static_cast<cudaStream_t>(stream));
}

// C entry point of the tensor-core route: `a` (m, k) and `w` (k, n) are
// contiguous device arrays of one type `dtype`, 0 int8, 1 int16 or 2 bf16;
// `out` (m, n) is int32 or f32, and every element is written.
// bf16 needs k % 8 == 0, n % 8 == 0 and 16-byte aligned operands.
// int8/int16 launch the prep kernel first, into `planes`, int8 scratch of
// P * (m + n) * kp bytes (kp = k rounded up to 32, P = 1 or 2; unused for
// bf16), zero `out` and add the wrapped partial sums into it.
// Returns cudaGetLastError() after the launches (cudaErrorInvalidValue for
// arguments it cannot take, or a tensor map cuTensorMapEncodeTiled refuses). Does not
// synchronise.
extern "C" int ws_gemm_tc(const void* a, const void* w, void* planes, void* out, int m, int k, int n,
                          int dtype, void* stream) {
  if (m < 1 || k < 1 || n < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap map_a, map_b;
  if (dtype == 2) {
    if (k % 8 || n % 8 || reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
      return cudaErrorInvalidValue;
    const uint64_t dims_a[2] = {static_cast<uint64_t>(k), static_cast<uint64_t>(m)};
    const uint64_t strides_a[1] = {static_cast<uint64_t>(k) * 2};
    const uint32_t box_a[2] = {Tc<false>::kSliceK, kTcRows};
    const uint64_t dims_b[2] = {static_cast<uint64_t>(n), static_cast<uint64_t>(k)};
    const uint64_t strides_b[1] = {static_cast<uint64_t>(n) * 2};
    const uint32_t box_b[2] = {64, Tc<false>::kSliceK};
    if (!hopper::make_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, dims_a, strides_a, box_a, kRowBytes) ||
        !hopper::make_map(&map_b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, dims_b, strides_b, box_b, kRowBytes))
      return cudaErrorInvalidValue;
    const int k_stages = (k + Tc<false>::kSliceK - 1) / Tc<false>::kSliceK;
    return launch_tc<false>(map_a, map_b, out, m, n, k_stages, 1, s);
  }
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const int kp = (k + kPlaneK - 1) / kPlaneK * kPlaneK;
  const uint64_t p = dtype == 1 ? 2 : 1;
  int8_t* ap = static_cast<int8_t*>(planes);
  int8_t* wp = ap + p * m * kp;
  const int err = launch_planes(a, w, ap, wp, m, k, n, kp, dtype, s);
  if (err != cudaSuccess) return err;
  const cudaError_t zeroed = cudaMemsetAsync(out, 0, static_cast<size_t>(m) * n * 4, s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  const uint64_t dims_a[3] = {static_cast<uint64_t>(kp), static_cast<uint64_t>(m), p};
  const uint64_t strides_a[2] = {static_cast<uint64_t>(kp), static_cast<uint64_t>(kp) * m};
  const uint32_t box_a[3] = {Tc<true>::kSliceK, kTcRows, 1};
  const uint64_t dims_b[3] = {static_cast<uint64_t>(kp), static_cast<uint64_t>(n), p};
  const uint64_t strides_b[2] = {static_cast<uint64_t>(kp), static_cast<uint64_t>(kp) * n};
  const uint32_t box_b[3] = {Tc<true>::kSliceK, Tc<true>::kCols, 1};
  if (!hopper::make_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, ap, dims_a, strides_a, box_a, kRowBytes) ||
      !hopper::make_map(&map_b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, wp, dims_b, strides_b, box_b, kRowBytes))
    return cudaErrorInvalidValue;
  const int k_stages = (kp + Tc<true>::kSliceK - 1) / Tc<true>::kSliceK;
  return launch_tc<true>(map_a, map_b, out, m, n, k_stages, p == 2 ? 4 : 1, s);
}
