// Hopper (sm_90a) building blocks of the port's tensor-core kernels, as raw
// PTX and runtime calls: TMA tensor maps and loads, mbarriers, wgmma
// shared-memory descriptors, fences, the TF32 split of an f32 value and the
// few wgmma shapes that K6 (ws_matmul.cu) and K7 (flash_attention.cu) use. No CUTLASS or CuTe
// header is included, so a source that includes this one still builds in
// seconds.
//
// Shared-memory tiles are written by TMA with a 128-byte (or, for rows of
// 64 bytes, 64-byte) swizzle and read by wgmma through a descriptor of the
// same swizzle. A tile is a stack of rows of `row_bytes` (64 or 128) bytes
// whose base is 1024-byte aligned. Read K-major (the reduction dimension
// along the row), 8 rows form one swizzle atom and the descriptor's stride
// byte offset (SBO) is 8 * row_bytes; each k slice of one wgmma (32 bytes:
// 16 bf16, 8 tf32 or 32 int8 values) moves the start address 32 bytes along the
// row. Read MN-major (the output dimension along the row, 16-bit types
// only), 8 rows of the reduction dimension form one atom (SBO = 8 *
// row_bytes), a k slice of 16 rows moves the start address 16 rows, and the
// leading byte offset (LBO) is the distance between two stacks of
// row_bytes-wide column chunks (CUTLASS's canonical GMMA layouts).
#pragma once

#include <atomic>
#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

namespace hopper {

// ---------------------------------------------------------------------------
// Host: TMA tensor maps. cuTensorMapEncodeTiled lives in libcuda; it is
// looked up through the runtime, so the library does not link libcuda.
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map over a row-major array of `rank` dimensions (`dims`
// innermost first, `strides` in bytes for dimensions 1..rank-1) that loads
// boxes of `box` elements, swizzled by the box's row of `row_bytes` (64 or
// 128). Loads past the array's end fill zeros. Returns false if refused.
inline bool make_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                     const uint64_t* dims, const uint64_t* strides, const uint32_t* box,
                     int row_bytes) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  const CUtensorMapSwizzle swizzle =
      row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  return encode(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(base), d, s, b, e,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// Host: launch set-up that belongs to a device, done once for each device
// (devices 0-63; others redo it at every launch)
// ---------------------------------------------------------------------------

inline int current_device() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev;
}

// The number of SMs of device `dev`.
inline int sm_count(int dev) {
  static std::atomic<int> cached[64];
  int n = dev >= 0 && dev < 64 ? cached[dev].load(std::memory_order_relaxed) : 0;
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
      return 132;  // an H100 SXM; a launch on a bad device fails on its own
    if (dev >= 0 && dev < 64) cached[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

// Lets `kernel` take `bytes` of dynamic shared memory on device `dev` (the
// attribute is per device). `done` belongs to the kernel and holds a bit
// for each device where this has been set.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel* kernel, int bytes, int dev,
                              std::atomic<unsigned long long>& done) {
  const unsigned long long bit = dev >= 0 && dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

// ---------------------------------------------------------------------------
// Device: mbarriers and TMA loads
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async (TMA) proxy.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Arrives once and adds `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed. A fresh barrier
// is in phase 0, so a wait on parity 1 passes at once.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---------------------------------------------------------------------------
// Device: wgmma descriptors, fences and register budgets
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor: start address, LBO and SBO in 16-byte
// units, swizzle mode 1 (128 B) or 2 (64 B) in bits 62-63.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo,
                                              int row_bytes) {
  uint64_t d = (smem_addr(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16;
  d |= static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32;
  d |= static_cast<uint64_t>(row_bytes == 128 ? 1 : 2) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma fence or wait (the asm statements above name no register).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Moves registers from the producer warpgroup to the consumers.
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Makes this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma and TMA read shared memory through it).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` (1-15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Two f32 values as one register of two bf16 (the first in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// ---------------------------------------------------------------------------
// TF32 planes: an f32 value x as big + small, each a TF32 value (an f32 whose
// low 13 mantissa bits are zero), so that three TF32 products a_s.b_b +
// a_b.b_s + a_b.b_b stand for one f32 product (ws_matmul.cu's note says
// within what).
// ---------------------------------------------------------------------------

// x rounded to the nearest TF32 value, ties away from zero (what
// cvt.rna.tf32.f32 gives, written on the bits so that the plain versions
// match it bit for bit), except that a finite x that would round to inf
// is truncated. For finite x only.
__device__ __forceinline__ float round_tf32(float x) {
  const uint32_t u = __float_as_uint(x);
  uint32_t r = (u + 0x1000u) & 0xFFFFE000u;
  if ((r & 0x7FFFFFFFu) == 0x7F800000u) r = u & 0xFFFFE000u;
  return __uint_as_float(r);
}

// big = x rounded to TF32, small = (x - big) rounded to TF32 (the
// difference is exact). A non-finite x goes whole into small and big keeps
// its sign as +-1, so that the three products give inf and NaN as the f32
// product does (small = 0 would give inf * 0 = NaN in a_b.b_s).
__device__ __forceinline__ void split_tf32(float x, float& big, float& small) {
  big = copysignf(1.0f, x);
  small = x;
  if (isfinite(x)) {
    big = round_tf32(x);
    small = round_tf32(x - big);
  }
}

// A value in [0, 1] (a softmax weight) as the bits of its TF32 rounding,
// ties away from zero, as round_tf32 gives it.
__device__ __forceinline__ uint32_t cvt_rna_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// ---------------------------------------------------------------------------
// wgmma shapes. An m64nN accumulator holds N / 2 values a thread: value i
// lies in row 16 * warp + lane / 4 (+ 8 if bit 1 of i is set) and column
// 8 * (i / 4) + 2 * (lane % 4) + (i & 1) of the warpgroup's 64 x N tile.
//   wgmma_bf16_ss<TransB>: D (64 x N, f32) += A (64 x 16, smem, K-major)
//     * B (16 x N, smem; TransB 0 K-major, 1 MN-major), N 128 or 256.
//   wgmma_bf16_rs: D (64 x N, f32) += A (64 x 16, registers) * B (16 x N,
//     smem, MN-major), N 32, 64 or 128.
//   wgmma_<a><b>: D (64 x 128, s32, wrapping) += A (64 x 32) * B (32 x 128),
//     both smem K-major, a and b each s8 or u8.
//   wgmma_tf32_ss: D (64 x N, f32) += A (64 x 8) * B (8 x N), both smem
//     K-major (tf32 has no transpose bit), N 32, 64 or 256.
//   wgmma_tf32_rs: D (64 x N, f32) += A (64 x 8, registers) * B (8 x N,
//     smem K-major), N 32, 64 or 128. Register a[j] of a thread holds row
//     16 * warp + lane / 4 (+ 8 if bit 0 of j is set) and column lane % 4
//     (+ 4 if bit 1 of j is set) of the 64 x 8 slice of A.
// Each is one asm statement written once below, as a macro of its shape:
// the accumulators d[0..R-1] are operands %0..%(R-1) (HOPPER_LIST<R> and
// HOPPER_ACC<R>), and the operands after them are numbered from R on.
// ---------------------------------------------------------------------------

#define HOPPER_P0 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define HOPPER_P1 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define HOPPER_P2 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define HOPPER_P3 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define HOPPER_P4 "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
#define HOPPER_P5 "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define HOPPER_P6 "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
#define HOPPER_P7 "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define HOPPER_LIST16 "{" HOPPER_P0 "}"
#define HOPPER_LIST32 "{" HOPPER_P0 ", " HOPPER_P1 "}"
#define HOPPER_LIST64 "{" HOPPER_P0 ", " HOPPER_P1 ", " HOPPER_P2 ", " HOPPER_P3 "}"
#define HOPPER_LIST128                                                                        \
  "{" HOPPER_P0 ", " HOPPER_P1 ", " HOPPER_P2 ", " HOPPER_P3 ", " HOPPER_P4 ", " HOPPER_P5 \
  ", " HOPPER_P6 ", " HOPPER_P7 "}"
#define HOPPER_D8(c, i) \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]), c(d[i + 6]), c(d[i + 7])
#define HOPPER_D16(c, i) HOPPER_D8(c, i), HOPPER_D8(c, i + 8)
#define HOPPER_D32(c, i) HOPPER_D16(c, i), HOPPER_D16(c, i + 16)
#define HOPPER_D64(c, i) HOPPER_D32(c, i), HOPPER_D32(c, i + 32)
#define HOPPER_ACC16(c) HOPPER_D16(c, 0)
#define HOPPER_ACC32(c) HOPPER_D32(c, 0)
#define HOPPER_ACC64(c) HOPPER_D64(c, 0)
#define HOPPER_ACC128(c) HOPPER_D64(c, 0), HOPPER_D64(c, 64)

// bf16, both operands in shared memory: R = N / 2 accumulators, then the
// descriptors (%A, %B), scale-d (%P) and the transpose bit of B (%T).
#define HOPPER_WGMMA_BF16_SS(N, R, A, B, P, T)                                                 \
  template <int TransB>                                                                      \
  __device__ __forceinline__ void wgmma_bf16_ss(float(&d)[R], uint64_t desc_a, uint64_t desc_b, \
                                                int scale_d) {                               \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                              \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " HOPPER_LIST##R     \
                 ", %" #A ", %" #B ", p, 1, 1, 0, %" #T ";\n}\n"                               \
                 : HOPPER_ACC##R("+f")                                                         \
                 : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TransB));                       \
  }
HOPPER_WGMMA_BF16_SS(128, 64, 64, 65, 66, 67)
HOPPER_WGMMA_BF16_SS(256, 128, 128, 129, 130, 131)

// bf16, A in four registers a thread (%A0..%A3), B from shared memory read
// MN-major (%B); scale-d is 1 (%P).
#define HOPPER_WGMMA_BF16_RS(N, R, A0, A1, A2, A3, B, P)                                        \
  __device__ __forceinline__ void wgmma_bf16_rs(float(&d)[R], const uint32_t(&a)[4],            \
                                                uint64_t desc_b) {                              \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                               \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " HOPPER_LIST##R      \
                 ", {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #B ", p, 1, 1, 1;\n}\n"         \
                 : HOPPER_ACC##R("+f")                                                          \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));            \
  }
HOPPER_WGMMA_BF16_RS(32, 16, 16, 17, 18, 19, 20, 21)
HOPPER_WGMMA_BF16_RS(64, 32, 32, 33, 34, 35, 36, 37)
HOPPER_WGMMA_BF16_RS(128, 64, 64, 65, 66, 67, 68, 69)

// 8-bit integers of the types `ab` ("s8.u8": A s8, B u8), both from shared
// memory K-major; no .satfinite, so the s32 sums wrap.
#define HOPPER_WGMMA_I8(name, ab)                                                             \
  __device__ __forceinline__ void name(uint32_t(&d)[64], uint64_t desc_a, uint64_t desc_b,     \
                                       int scale_d) {                                         \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                  \
                 "wgmma.mma_async.sync.aligned.m64n128k32.s32." ab " " HOPPER_LIST64             \
                 ", %64, %65, p;\n}\n"                                                         \
                 : HOPPER_ACC64("+r")                                                          \
                 : "l"(desc_a), "l"(desc_b), "r"(scale_d));                                    \
  }
HOPPER_WGMMA_I8(wgmma_s8s8, "s8.s8")
HOPPER_WGMMA_I8(wgmma_s8u8, "s8.u8")
HOPPER_WGMMA_I8(wgmma_u8s8, "u8.s8")
HOPPER_WGMMA_I8(wgmma_u8u8, "u8.u8")

// tf32, both operands in shared memory K-major: R = N / 2 accumulators,
// then the descriptors (%A, %B) and scale-d (%P). The operands are f32 bit
// patterns whose low 13 mantissa bits the tensor cores do not read.
#define HOPPER_WGMMA_TF32_SS(N, R, A, B, P)                                                   \
  __device__ __forceinline__ void wgmma_tf32_ss(float(&d)[R], uint64_t desc_a, uint64_t desc_b, \
                                                int scale_d) {                               \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                              \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 " HOPPER_LIST##R      \
                 ", %" #A ", %" #B ", p, 1, 1;\n}\n"                                            \
                 : HOPPER_ACC##R("+f")                                                         \
                 : "l"(desc_a), "l"(desc_b), "r"(scale_d));                                    \
  }
HOPPER_WGMMA_TF32_SS(32, 16, 16, 17, 18)
HOPPER_WGMMA_TF32_SS(64, 32, 32, 33, 34)
HOPPER_WGMMA_TF32_SS(256, 128, 128, 129, 130)

// tf32, A in four registers a thread (%A0..%A3, the bits of TF32 values),
// B from shared memory K-major (%B), scale-d (%P).
#define HOPPER_WGMMA_TF32_RS(N, R, A0, A1, A2, A3, B, P)                                        \
  __device__ __forceinline__ void wgmma_tf32_rs(float(&d)[R], const uint32_t(&a)[4],            \
                                                uint64_t desc_b, int scale_d) {                 \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                               \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 " HOPPER_LIST##R       \
                 ", {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #B ", p, 1, 1;\n}\n"            \
                 : HOPPER_ACC##R("+f")                                                          \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));      \
  }
HOPPER_WGMMA_TF32_RS(32, 16, 16, 17, 18, 19, 20, 21)
HOPPER_WGMMA_TF32_RS(64, 32, 32, 33, 34, 35, 36, 37)
HOPPER_WGMMA_TF32_RS(128, 64, 64, 65, 66, 67, 68, 69)

#undef HOPPER_WGMMA_TF32_RS
#undef HOPPER_WGMMA_TF32_SS
#undef HOPPER_WGMMA_I8
#undef HOPPER_WGMMA_BF16_RS
#undef HOPPER_WGMMA_BF16_SS
#undef HOPPER_ACC128
#undef HOPPER_ACC64
#undef HOPPER_ACC32
#undef HOPPER_ACC16
#undef HOPPER_D64
#undef HOPPER_D32
#undef HOPPER_D16
#undef HOPPER_D8
#undef HOPPER_LIST128
#undef HOPPER_LIST64
#undef HOPPER_LIST32
#undef HOPPER_LIST16
#undef HOPPER_P0
#undef HOPPER_P1
#undef HOPPER_P2
#undef HOPPER_P3
#undef HOPPER_P4
#undef HOPPER_P5
#undef HOPPER_P6
#undef HOPPER_P7

}  // namespace hopper
