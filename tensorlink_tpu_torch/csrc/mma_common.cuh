// Tensor-core and async-copy helpers shared by the port's attention
// kernels (flash_attention.cu, flash_attention_f32.cu, paged_decode.cu),
// for sm_90a.
//
// mma.sync m16n8k16 (bf16 or f16 in, f32 accumulate) with operand
// fragments read from row-major shared tiles by ldmatrix, mma.sync m16n8k8
// in tf32, and
// 16- or 4-byte cp.async copies from device memory into shared memory (a
// source size of 0 fills the destination with zeros, which is how ragged
// edges and unmapped pages are padded without a branch around the copy).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tlk {

using bf16 = __nv_bfloat16;
using f16 = __half;

// the 16-bit storage types of the tensor-core kernels: bf16 (the default
// of every template below, which paged_decode.cu uses) and f16. ldmatrix,
// cp.async and the tile layouts do not depend on which; the mma's type
// string and the packing of f32 values do.
template <typename T>
constexpr bool kIsF16 = std::is_same<T, f16>::value;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane l supplies the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c[16x8] += a[16x16] * b[16x8]; T (bf16 or f16) inputs, f32 accumulators
template <typename T = bf16>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if constexpr (kIsF16<T>)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[16x8] += a[16x8] * b[8x8]; tf32 inputs (the mma reads the upper 19
// bits of each register: sign, exponent and 10 mantissa bits), f32
// accumulators. Fragments: a0 (row g, col t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); b0 (row t, col g), b1 (t + 4, g); c as for mma above
// (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two f32 values rounded to nearest T, low half first
template <typename T = bf16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsF16<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    return pack_bf16(lo, hi);
  }
}

// the two T values of a packed register as f32, low half first
template <typename T = bf16>
__device__ __forceinline__ float2 unpack2(uint32_t x) {
  if constexpr (kIsF16<T>)
    return __half22float2(*reinterpret_cast<const __half2*>(&x));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// Fragment addresses inside a row-major shared tile with leading dim LD.
// A operand (16 rows from r0, 16 columns from c0), and the B operand of
// two n-tiles read transposed (16 k-rows from r0, 16 n-columns from c0):
// both use the same per-lane row addresses.
template <int LD, typename T>
__device__ __forceinline__ const T* frag_a(const T* s, int r0, int c0,
                                           int lane) {
  return s + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8;
}

// B operand of two n-tiles (n rows n0..n0+15 of a [n][k] tile, k from c0)
template <int LD, typename T>
__device__ __forceinline__ const T* frag_b(const T* s, int n0, int c0,
                                           int lane) {
  return s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + c0 +
         ((lane >> 3) & 1) * 8;
}

// A (score) fragment of k-step j from the f32 accumulators of n-tiles
// 2j and 2j + 1 (the C layout of one mma is the A layout of the next),
// rounded to T
template <typename T = bf16>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack2<T>(c0[0], c0[1]);
  a[1] = pack2<T>(c0[2], c0[3]);
  a[2] = pack2<T>(c1[0], c1[1]);
  a[3] = pack2<T>(c1[2], c1[3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// f16's operand scale. f16 keeps 11 significant bits down to 2^-14, fewer
// below, none below 2^-24, so an f32 operand that is about to be rounded
// to f16 and may be small (flash_attention.cu's dS-like operands,
// paged_decode.cu's P v_scale over int8 V) is first multiplied, row by
// row, by a power of two: the one that takes the row's largest magnitude
// m into [2^14, 2^15). kNoScale (2^126, also the bound of any scale) when
// m is 0, below f32's normal range or not finite, so that a row's first
// live tile sets it.
constexpr float kNoScale = 0x1p126f;
__device__ __forceinline__ float f16_scale(float m) {
  const int e = (__float_as_int(m) >> 23) & 0xff;
  if (e == 0 || e == 255) return kNoScale;
  return __int_as_float(min(max(268 - e, 1), 253) << 23);
}

// f16: scales the rows of an operand tile x (the C layout of NT n-tiles:
// rows e / 2 of each 4) in place by the rows' factors f. A factor only
// shrinks: where the tile's largest value in a row would reach 2^15, the
// row's factor is set from it and the row of the f32 accumulator acc is
// scaled by the ratio. That test is one vote for the warp (every lane
// must call); the quad's maximum (the row is spread over a quad) is taken
// only when it fires. The caller divides acc's rows by f at the end.
template <int NT, int DT>
__device__ __forceinline__ void f16_scale_rows(float (&x)[NT][4],
                                               float (&f)[2],
                                               float (&acc)[DT][4]) {
  float mx[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mx[e >> 1] = fmaxf(mx[e >> 1], fabsf(x[j][e]));
  if (__any_sync(0xffffffffu,
                 !(mx[0] * f[0] < 0x1p15f && mx[1] * f[1] < 0x1p15f))) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float nf = f16_scale(quad_max(mx[r]));
      if (nf < f[r]) {
        const float ratio = nf / f[r];
#pragma unroll
        for (int i = 0; i < DT; ++i) {
          acc[i][2 * r] *= ratio;
          acc[i][2 * r + 1] *= ratio;
        }
        f[r] = nf;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] *= f[e >> 1];
}

// 16 bytes device -> shared; src_bytes 0 writes 16 zero bytes (src is
// then not read but must still be a valid address expression)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two int8 values (low byte first) -> the T-typed (bf16 or f16) x2
// register of an mma operand; |x| <= 128 is exact in both
template <typename T = bf16>
__device__ __forceinline__ uint32_t i8x2_to(int8_t lo, int8_t hi) {
  return pack2<T>(static_cast<float>(lo), static_cast<float>(hi));
}

// The flash kernels' plan by head dim (flash_attention.cu in bf16 and f16,
// flash_attention_f32.cu in f32): the blocks an SM each kernel is built
// for, two at D <= 128 and one at D 256, and the warps that share a 16-row
// strip in the backward, each summing the outputs of D / bwd_halves
// columns, two at D 256 so that the [16, D] accumulators fit.
template <int D>
__host__ __device__ constexpr int blocks_per_sm() {
  return D == 256 ? 1 : 2;
}
template <int D>
__host__ __device__ constexpr int bwd_halves() {
  return D == 256 ? 2 : 1;
}

}  // namespace tlk
