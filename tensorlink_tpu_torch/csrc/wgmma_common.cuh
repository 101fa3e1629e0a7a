// Hopper (sm_90a) helpers for the port's warp-specialized kernels: TMA
// tensor copies completing on mbarriers, the full/empty mbarrier
// handshake of a producer warp and consumer warpgroups, setmaxnreg, and
// wgmma (warpgroup matrix multiply) on shared-memory descriptors of
// 128-byte-swizzled tiles, written as PTX by hand (no CUTLASS/CuTe).
//
// Tile layout. A 16-bit (bf16 or f16) tile of R rows x 64 columns (128
// bytes a row) is what one TMA box with CU_TENSOR_MAP_SWIZZLE_128B
// writes: rows of 128 bytes in groups of 8 (1024 bytes), the 16-byte
// chunks of row r XORed with r % 8. A tile 128 columns wide is two such
// regions, one after the other. Regions start 1024-byte aligned, so the
// swizzle that TMA applies and the one wgmma reads agree.
// - K-major operand (rows are M or N, the reduction dimension K runs
//   along the row: Q and K in S = Q K^T): SBO = 1024 (8 rows), LBO unused
//   (1); k-step kk of 16 columns starts kk % 4 * 32 bytes into region
//   kk / 4.
// - MN-major operand (rows are K, N runs along the row: V in O += P V,
//   read with the transpose bit): SBO = 1024 (8 K-rows), LBO = the region
//   stride (the next 64 N-columns); k-step j of 16 rows starts 2048 j
//   bytes in.
// Accumulator layout of m64nNk16 (f32): warp w of the warpgroup holds rows
// 16 w .. 16 w + 15; d[4 i + e] is row 16 w + lane / 4 + 8 (e / 2),
// column 8 i + 2 (lane % 4) + e % 2, the mma.sync m16n8 C layout repeated
// over N. The register A operand of m64nNk16 is, per warp, the mma.sync
// m16n8k16 A fragment, so a score accumulator packs straight into it.

#pragma once

#include <cuda.h>

#include "mma_common.cuh"

namespace tlk {

// ------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the initialized barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// one arrival, and `bytes` more of transactions (TMA) before the phase ends
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of the given parity has completed (a fresh barrier
// counts its phase "1" as completed, so a producer's first wait on an
// empty barrier passes)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// ------------------------------------------------------------------ TMA
// a box of a 4-d tensor map (coordinates innermost first) into shared
// memory, completing `bytes` of the barrier's transactions; out-of-bounds
// elements arrive as zeros
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// ----------------------------------------------------- register shares
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------- wgmma
// shared-memory matrix descriptor of a 128-byte-swizzled operand
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr,
                                               uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32) | (1ull << 62);
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

// Registers an in-flight wgmma reads or writes must not be touched by
// other code until wgmma_wait: after the wait, this "redefines" them, so
// the compiler neither reads an accumulator early nor reuses an A
// register before the hardware is done with it.
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

// The wgmma forms below take their operand type T (bf16 or f16) as a
// template argument; only the instruction's type string differs, so each
// asm statement is written once, as a macro of that string.
#define TLK_ACC32                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),      \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
      "+f"(d[30]), "+f"(d[31])
#define TLK_ACC64                                                      \
  TLK_ACC32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),       \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define TLK_REGS32                                   \
  "%0, %1, %2, %3, %4, %5, %6, %7,"                  \
  "%8, %9, %10, %11, %12, %13, %14, %15,"            \
  "%16, %17, %18, %19, %20, %21, %22, %23,"          \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define TLK_REGS64                                   \
  TLK_REGS32 ","                                     \
  "%32, %33, %34, %35, %36, %37, %38, %39,"          \
  "%40, %41, %42, %43, %44, %45, %46, %47,"          \
  "%48, %49, %50, %51, %52, %53, %54, %55,"          \
  "%56, %57, %58, %59, %60, %61, %62, %63"

#define TLK_WGMMA_SS_64(TY)                                             \
  asm volatile(                                                         \
      "{\n.reg .pred p;\n"                                              \
      "setp.ne.b32 p, %34, 0;\n"                                        \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"      \
      TLK_REGS32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                     \
      : TLK_ACC32                                                       \
      : "l"(da), "l"(db), "r"(scale_d))
#define TLK_WGMMA_RS_64(TY)                                             \
  asm volatile(                                                         \
      "{\n.reg .pred p;\n"                                              \
      "setp.ne.b32 p, %37, 0;\n"                                        \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"      \
      TLK_REGS32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"       \
      : TLK_ACC32                                                       \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),            \
        "r"(scale_d))
#define TLK_WGMMA_RS_128(TY)                                            \
  asm volatile(                                                         \
      "{\n.reg .pred p;\n"                                              \
      "setp.ne.b32 p, %69, 0;\n"                                        \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"     \
      TLK_REGS64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"       \
      : TLK_ACC64                                                       \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),            \
        "r"(scale_d))

// d[32] (+)= A[64, 16] B[16, 64], A and B K-major in shared memory
template <typename T>
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da,
                                                   uint64_t db, int scale_d) {
  if constexpr (kIsF16<T>)
    TLK_WGMMA_SS_64("f16");
  else
    TLK_WGMMA_SS_64("bf16");
}

// d[32] += A[64, 16] B[16, 64], A from registers (the mma.sync A fragment
// of each warp's 16 rows), B MN-major in shared memory (transposed)
template <typename T>
__device__ __forceinline__ void wgmma_rs_m64n64k16_tb(float (&d)[32],
                                                      const uint32_t (&a)[4],
                                                      uint64_t db,
                                                      int scale_d) {
  if constexpr (kIsF16<T>)
    TLK_WGMMA_RS_64("f16");
  else
    TLK_WGMMA_RS_64("bf16");
}

// d[64] += A[64, 16] B[16, 128], A from registers (the mma.sync A fragment
// of each warp's 16 rows), B MN-major in shared memory (transposed)
template <typename T>
__device__ __forceinline__ void wgmma_rs_m64n128k16_tb(float (&d)[64],
                                                       const uint32_t (&a)[4],
                                                       uint64_t db,
                                                       int scale_d) {
  if constexpr (kIsF16<T>)
    TLK_WGMMA_RS_128("f16");
  else
    TLK_WGMMA_RS_128("bf16");
}

#undef TLK_WGMMA_SS_64
#undef TLK_WGMMA_RS_64
#undef TLK_WGMMA_RS_128
#undef TLK_REGS32
#undef TLK_REGS64
#undef TLK_ACC32
#undef TLK_ACC64

}  // namespace tlk
