// Device helpers of the port's tensor-core kernels (flash_attention.cu,
// paged_attention.cu): cp.async copies, Hopper's warpgroup MMA (wgmma)
// with 128-byte-swizzled shared-memory descriptors, the register layout
// of its accumulator and the 16-bit A fragments made from it. The
// products and fragments are templates on the element type T:
// __nv_bfloat16 (the default) or __half, both with float32 accumulators.
//
// Included by each source; _build.py hashes the headers of csrc/ with
// each source, so an edit here rebuilds every library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace {

// A shared [rows][D] tile of 16-bit elements is D / 64 panels of [rows][64], panel p
// holding columns 64p .. 64p + 63 at p * rows * 128 bytes. A panel row is
// 128 bytes, stored with the 128-byte swizzle from a 1024-byte aligned
// base: row r's 16-byte chunk c sits at r * 128 + ((c ^ (r & 7)) << 4).
// wgmma reads such a tile K-major (the 16-column k-chunk kk in panel
// kk / 4 at +32 * (kk % 4), 8-row groups 1024 bytes apart) or MN-major
// (the 16-row k-chunk kk at +2048 * kk in every panel, the panels the
// descriptor's leading offset apart), so one copy serves S = Q.K^T and
// dQ = dS.K alike, and a product whose N is D = 128 spans both panels.
//
// The accumulator of an m64nNk16 product: thread t of the warpgroup holds,
// for each 8-column block j, d[4j + 2h + e] at row 16 (t / 32) + (t % 32) / 4
// + 8h and column 8j + 2 (t % 4) + e. The A operand from registers of
// k-chunk kk wants the same rows and columns 16kk .. 16kk + 15 in that
// order, so d[8kk .. 8kk + 7] packed in pairs is the fragment.

constexpr int kTcThreads = 128;  // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// bytes of a [rows][D] tile of 16-bit elements
template <int D>
__host__ __device__ constexpr uint32_t tc_tile(int rows) {
  return static_cast<uint32_t>(rows) * D * 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes from global to shared memory, asynchronously; zeros when !ok
// (nothing is read then).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// cp.async writes through the generic proxy and wgmma reads through the
// async proxy: each thread fences its own copies before the barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Orders the compiler's reads and writes of an accumulator against the
// asynchronous products (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
// K-major k-chunk kk of a [rows][D] tile: 8-row groups 1024 bytes apart
// (the leading offset is unused).
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int kk) {
  return sw128_desc(tile + (kk >> 2) * rows * 128 + 32 * (kk & 3), 16, 1024);
}
// MN-major k-chunk kk of a [rows][D] tile: 8-row groups along K 1024 bytes
// apart; the leading offset is the stride between the 64-column panels.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int kk) {
  return sw128_desc(tile + 2048 * kk, rows * 128, 1024);
}

// Whether T is float16 (else bfloat16): picks the products' input type.
template <typename T>
__host__ __device__ constexpr bool is_f16() {
  return std::is_same<T, __half>::value;
}

#define WGMMA_ACC16                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define WGMMA_ACC32                                                        \
  WGMMA_ACC16, "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),        \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
      "+f"(d[30]), "+f"(d[31])
#define WGMMA_ACC64                                                        \
  WGMMA_ACC32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),        \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),    \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),    \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),    \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),    \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),    \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define WGMMA_REGS16                                                       \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define WGMMA_REGS32                                                       \
  WGMMA_REGS16 ", %16, %17, %18, %19, %20, %21, %22, %23, "               \
               "%24, %25, %26, %27, %28, %29, %30, %31"
#define WGMMA_REGS64                                                       \
  WGMMA_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, "               \
               "%40, %41, %42, %43, %44, %45, %46, %47, "                 \
               "%48, %49, %50, %51, %52, %53, %54, %55, "                 \
               "%56, %57, %58, %59, %60, %61, %62, %63"
// d (+)= A.B with A and B from shared memory (K-major both): N columns,
// input type TY, the accumulate predicate operand P, descriptors A, B.
#define WGMMA_SS(N, TY, REGS, P, A, B)                                     \
  "{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                          \
  "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY " {" REGS     \
  "}, " A ", " B ", p, 1, 1, 0, 0;\n}\n"
// d += A.B with A from registers, B MN-major from shared memory.
#define WGMMA_RS(N, TY, REGS, P, A, B)                                     \
  "{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                          \
  "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY " {" REGS     \
  "}, " A ", " B ", p, 1, 1, 1;\n}\n"

// d (+)= A.B, A [64 x 16] and B [16 x N] both K-major in shared memory;
// accumulate = 0 overwrites d. N = 32 and 64.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b, int accumulate) {
  if constexpr (is_f16<T>())
    asm volatile(WGMMA_SS("32", "f16", WGMMA_REGS16, "%18", "%16", "%17")
                 : WGMMA_ACC16 : "l"(a), "l"(b), "r"(accumulate));
  else
    asm volatile(WGMMA_SS("32", "bf16", WGMMA_REGS16, "%18", "%16", "%17")
                 : WGMMA_ACC16 : "l"(a), "l"(b), "r"(accumulate));
}
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  if constexpr (is_f16<T>())
    asm volatile(WGMMA_SS("64", "f16", WGMMA_REGS32, "%34", "%32", "%33")
                 : WGMMA_ACC32 : "l"(a), "l"(b), "r"(accumulate));
  else
    asm volatile(WGMMA_SS("64", "bf16", WGMMA_REGS32, "%34", "%32", "%33")
                 : WGMMA_ACC32 : "l"(a), "l"(b), "r"(accumulate));
}

// d += A.B, A [64 x 16] from registers (4 pairs of T a thread), B
// [16 x N] MN-major in shared memory. N = 64 and 128.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (is_f16<T>())
    asm volatile(WGMMA_RS("64", "f16", WGMMA_REGS32, "%37",
                          "{%32, %33, %34, %35}", "%36")
                 : WGMMA_ACC32
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                   "r"(1));
  else
    asm volatile(WGMMA_RS("64", "bf16", WGMMA_REGS32, "%37",
                          "{%32, %33, %34, %35}", "%36")
                 : WGMMA_ACC32
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                   "r"(1));
}
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (is_f16<T>())
    asm volatile(WGMMA_RS("128", "f16", WGMMA_REGS64, "%69",
                          "{%64, %65, %66, %67}", "%68")
                 : WGMMA_ACC64
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                   "r"(1));
  else
    asm volatile(WGMMA_RS("128", "bf16", WGMMA_REGS64, "%69",
                          "{%64, %65, %66, %67}", "%68")
                 : WGMMA_ACC64
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                   "r"(1));
}

// 2^x by the SFU, denormals flushed (the probabilities' exp).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// lo and hi rounded to T (nearest even), packed lo first.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (is_f16<T>()) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// The A fragments (in T) of the N / 8 k-chunks of a [64 x N / 2]
// accumulator.
template <typename T = __nv_bfloat16, int N>
__device__ __forceinline__ void to_a(const float (&d)[N],
                                     uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack2<T>(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// Byte offset of row r's 16-byte chunk c in a swizzled [n][D] tile.
__device__ __forceinline__ uint32_t sw128_at(int r, int c, int n) {
  return (c >> 3) * n * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// Rows [r0, r0 + n) of one (batch, head) slice of a [B, T, H, D]
// tensor of 16-bit elements E (row stride st) into the swizzled [n][D]
// tile at dst, by cp.async, over the block's threads; rows at or past T
// are zeros. Eight threads cover a panel row's 128 bytes.
template <int D, typename E>
__device__ __forceinline__ void load_tile(uint32_t dst, const E* base,
                                          long long st, int r0, int n,
                                          int T) {
  static_assert(sizeof(E) == 2, "tiles hold 16-bit elements");
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < n * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r0 + r < T;
    cp_async16(dst + sw128_at(r, c, n),
               base + (ok ? (long long)(r0 + r) * st + c * 8 : 0), ok);
  }
}

}  // namespace
