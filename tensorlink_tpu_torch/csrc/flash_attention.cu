// Flash attention forward (B1) and backward (B2) on tensor cores (sm_90a).
//
// Replaces the TPU kernels of tensorlink_tpu/ops/pallas/flash_attention.py:
// flash_attention_fwd_lse (kernel _flash_fwd_kernel) and flash_attention_bwd
// (kernels _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel), and computes
// what the plain versions in tensorlink_tpu_torch/ops/flash_attention.py
// compute. Operands are [B, heads, T, D] views read through their strides
// (D contiguous), so the public [B, T, H, D] layout needs no transpose copy.
// GQA reads the unrepeated K/V: query head h uses kv head h / (H / Hkv).
// A key is attended iff kv_mask[b, k] != 0 (when a mask is given), k < Tk,
// and the positional band holds: k <= q under causal, and k > q - window
// (plus k < q + window when not causal) under a window. A query row with no
// attended key gives o = 0 and lse = 1e30, which makes the backward's
// p = exp(s - lse) exactly 0 there.
//
// Design (first version, simple and right). Every product runs on the
// tensor cores through mma.sync m16n8k16 (bf16 in, f32 accumulate), with
// operand fragments read from padded shared-memory tiles by ldmatrix; the
// softmax state and every accumulator stay in registers in f32.
// - Forward: one block of 4 warps per (query tile of 64, head, batch row);
//   each warp owns 16 query rows. The block stages its Q tile once, then
//   walks only the key tiles its causal / window band can reach (the loop
//   bounds replace the TPU grid's block skipping), staging K and V tiles of
//   64 keys, and folds each into the online softmax (running max, row sums,
//   output accumulator). P goes from the score accumulators straight into
//   the A operand of P.V.
// - Backward: a dq kernel (one block per query tile) walks its key tiles
//   twice, recomputing S and dP on the tensor cores and p = exp(s - lse):
//   the first pass sums delta = rowsum(p * dp), the second forms
//   ds = p (dp - delta) scale and accumulates dQ += dS K. Then a dkv
//   kernel (one block per (key tile of 64, kv head, batch row),
//   walking the query tiles of 32 that its band reaches, for every query
//   head of its GQA group: S^T = K Q^T, dP^T = V dO^T, dV += P^T dO,
//   dK += dS^T Q). dK and dV of a GQA group are summed inside the block,
//   so no per-query-head buffer exists. delta equals rowsum(dO * O), the
//   TPU kernels' form, in exact arithmetic; taken from the bf16-rounded O
//   it is off by ~2^-9 |dO||O|, which swamps ds wherever attention is near
//   uniform (dp close to delta) and wrecked the q/k gradients of BERT's
//   upper layers. From the kernel's own p and dp, the ds of a row sums to
//   zero as it must, for the price of one more S/dP pass in the dq kernel.
// Ragged edges (T not a multiple of a tile) are zero-filled in shared
// memory and masked; D is 64 or 128; the type is bf16.
//
// What bounds it on this card: 4 D flops per attended (query, key) pair
// forward and at least 10 D backward, against reading q, k, v (and do)
// and writing o (or dq, dk, dv) once. At BERT-base's training shape (T 512,
// D 64, a padding mask) the forward's least time is set by those bytes and
// the backward's by the tensor cores; at a long causal sequence (T 2048,
// D 128) by the tensor cores both ways. This first design sits well above
// both (PERF.md): it leaves for later cp.async or TMA staging of the next
// K/V tile while the current one is used (loads here are synchronous
// 16-byte loads), wgmma, warp specialisation, and a cheaper exact delta.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps
constexpr int kBQ = 64;        // forward / dq: query rows per block
constexpr int kBK = 64;        // key rows per tile (dkv: per block)
constexpr int kBQd = 32;       // dkv: query rows per inner tile
constexpr float kNegInf = -1e30f;
constexpr float kLseMasked = 1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct View {  // a [B, heads, T, D] operand; strides in elements, D contiguous
  const bf16* p;
  long long sb, sh, st;
};

struct OutView {
  bf16* p;
  long long sb, sh, st;
};

struct Shape {
  int B, H, Hkv, Tq, Tk, causal, window;  // window <= 0: none
  float scale;
  const uint8_t* kv_mask;  // [B, Tk], nonzero = attend; null = all keys
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane l supplies the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c[16x8] += a[16x16] * b[16x8]; bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment addresses inside a row-major shared tile with leading dim LD.
// A operand (16 rows from r0, 16 columns from c0), and the B operand of
// two n-tiles read transposed (16 k-rows from r0, 16 n-columns from c0):
// both use the same per-lane row addresses.
template <int LD>
__device__ __forceinline__ const bf16* frag_a(const bf16* s, int r0, int c0,
                                              int lane) {
  return s + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8;
}

// B operand of two n-tiles (n rows n0..n0+15 of a [n][k] tile, k from c0)
template <int LD>
__device__ __forceinline__ const bf16* frag_b(const bf16* s, int n0, int c0,
                                              int lane) {
  return s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + c0 +
         ((lane >> 3) & 1) * 8;
}

// rows r0..r0+ROWS-1 of a [T, D] slab (row stride st) into a padded tile;
// rows at or past T are zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long st, int r0, int T) {
  constexpr int LD = D + 8, CH = D / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < T)
      val = __ldg(reinterpret_cast<const uint4*>(
          src + static_cast<long long>(r0 + r) * st + c));
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

__device__ __forceinline__ bool band_keep(int q, int k, int causal,
                                          int window) {
  if (causal && k > q) return false;
  if (window > 0 && (k <= q - window || (!causal && k >= q + window)))
    return false;
  return true;
}

// keys [lo, hi) that some query of [q0, q1] can attend
__device__ __forceinline__ void key_range(int q0, int q1, int Tk, int causal,
                                          int window, int& lo, int& hi) {
  lo = 0;
  hi = Tk;
  if (causal) hi = min(hi, q1 + 1);
  if (window > 0) {
    lo = max(0, q0 - window + 1);
    if (!causal) hi = min(hi, q1 + window);
  }
}

// queries [lo, hi) that can attend some key of [k0, k1]
__device__ __forceinline__ void query_range(int k0, int k1, int Tq,
                                            int causal, int window, int& lo,
                                            int& hi) {
  lo = 0;
  hi = Tq;
  if (causal) lo = k0;
  if (window > 0) {
    hi = min(hi, k1 + window);
    if (!causal) lo = max(lo, k0 - window + 1);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// --------------------------------------------------------------- forward
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(View q, View k, View v, OutView o,
                     float* __restrict__ lse, Shape s) {
  constexpr int LD = D + 8, KS = D / 16, NT = kBK / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kBQ * LD;
  bf16* vs = ks + kBK * LD;
  uint8_t* keep_s = reinterpret_cast<uint8_t*>(vs + kBK * LD);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int hk = h / (s.H / s.Hkv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const bf16* kb = k.p + b * k.sb + hk * k.sh;
  const bf16* vb = v.p + b * v.sb + hk * v.sh;
  const uint8_t* km =
      s.kv_mask ? s.kv_mask + static_cast<long long>(b) * s.Tk : nullptr;
  const int qr[2] = {q0 + warp * 16 + gid, q0 + warp * 16 + gid + 8};
  const float sl2 = s.scale * kLog2e;  // scores in the log2 domain

  load_tile<D, kBQ>(qs, q.p + b * q.sb + h * q.sh, q.st, q0, s.Tq);

  int klo, khi;
  key_range(q0, q0 + kBQ - 1, s.Tk, s.causal, s.window, klo, khi);

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int k0 = (klo / kBK) * kBK; k0 < khi; k0 += kBK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, kBK>(ks, kb, k.st, k0, s.Tk);
    load_tile<D, kBK>(vs, vb, v.st, k0, s.Tk);
    if (threadIdx.x < kBK) {
      const int kk = k0 + threadIdx.x;
      keep_s[threadIdx.x] = kk < s.Tk && (km == nullptr || km[kk] != 0);
    }
    __syncthreads();

    float sc[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, frag_a<LD>(qs, warp * 16, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bb[4];
        ldsm_x4(bb, frag_b<LD>(ks, np * 16, kk * 16, lane));
        mma(sc[2 * np], a, bb[0], bb[1]);
        mma(sc[2 * np + 1], a, bb[2], bb[3]);
      }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, kl = i * 8 + 2 * tig + (e & 1);
        const bool keep =
            keep_s[kl] && band_keep(qr[r], k0 + kl, s.causal, s.window);
        const float x = keep ? sc[i][e] * sl2 : kNegInf;
        sc[i][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];  // per-thread partial row sums; summed at the end
    }
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = sc[i][e] == kNegInf ? 0.f : exp2f(sc[i][e] - m[r]);
        sc[i][e] = p;
        l[r] += p;
      }
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }
    // O += P V: the score accumulators of n-tiles 2j, 2j+1 are the A
    // operand of k-step j
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      const uint32_t a[4] = {
          pack_bf16(sc[2 * j][0], sc[2 * j][1]),
          pack_bf16(sc[2 * j][2], sc[2 * j][3]),
          pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]),
          pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bb[4];
        ldsm_x4_t(bb, frag_a<LD>(vs, j * 16, dp * 16, lane));
        mma(acc[2 * dp], a, bb[0], bb[1]);
        mma(acc[2 * dp + 1], a, bb[2], bb[3]);
      }
    }
  }

  bf16* ob = o.p + b * o.sb + h * o.sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    if (qr[r] >= s.Tq) continue;
    const float inv = lr > 0.f ? 1.f / lr : 0.f;
    bf16* row = ob + static_cast<long long>(qr[r]) * o.st;
#pragma unroll
    for (int i = 0; i < DT; ++i)
      *reinterpret_cast<__nv_bfloat162*>(row + i * 8 + 2 * tig) =
          __floats2bfloat162_rn(acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
    if (tig == 0)
      lse[(static_cast<long long>(b) * s.H + h) * s.Tq + qr[r]] =
          lr > 0.f ? (m[r] + log2f(lr)) * kLn2 : kLseMasked;
  }
}

// -------------------------------------------------------------- backward
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(View q, View k, View v, View dout,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, OutView dq, Shape s) {
  constexpr int LD = D + 8, KS = D / 16, NT = kBK / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kBQ * LD;
  bf16* ks = dos + kBQ * LD;
  bf16* vs = ks + kBK * LD;
  uint8_t* keep_s = reinterpret_cast<uint8_t*>(vs + kBK * LD);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int hk = h / (s.H / s.Hkv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const bf16* kb = k.p + b * k.sb + hk * k.sh;
  const bf16* vb = v.p + b * v.sb + hk * v.sh;
  const uint8_t* km =
      s.kv_mask ? s.kv_mask + static_cast<long long>(b) * s.Tk : nullptr;
  const int qr[2] = {q0 + warp * 16 + gid, q0 + warp * 16 + gid + 8};
  const float sl2 = s.scale * kLog2e;
  const long long rowbase = (static_cast<long long>(b) * s.H + h) * s.Tq;
  float lse2[2], dl[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r)
    lse2[r] = qr[r] < s.Tq ? lse[rowbase + qr[r]] * kLog2e : kLseMasked;

  load_tile<D, kBQ>(qs, q.p + b * q.sb + h * q.sh, q.st, q0, s.Tq);
  load_tile<D, kBQ>(dos, dout.p + b * dout.sb + h * dout.sh, dout.st, q0,
                    s.Tq);

  int klo, khi;
  key_range(q0, q0 + kBQ - 1, s.Tk, s.causal, s.window, klo, khi);

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  // pass 0 sums delta = rowsum(p * dp) over the row's visible keys (and
  // writes it for the dkv kernel); pass 1 forms ds = p (dp - delta) and
  // accumulates dQ
  for (int pass = 0; pass < 2; ++pass) {
  for (int k0 = (klo / kBK) * kBK; k0 < khi; k0 += kBK) {
    __syncthreads();
    load_tile<D, kBK>(ks, kb, k.st, k0, s.Tk);
    load_tile<D, kBK>(vs, vb, v.st, k0, s.Tk);
    if (threadIdx.x < kBK) {
      const int kk = k0 + threadIdx.x;
      keep_s[threadIdx.x] = kk < s.Tk && (km == nullptr || km[kk] != 0);
    }
    __syncthreads();

    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4], ad[4];
      ldsm_x4(a, frag_a<LD>(qs, warp * 16, kk * 16, lane));
      ldsm_x4(ad, frag_a<LD>(dos, warp * 16, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bb[4];
        ldsm_x4(bb, frag_b<LD>(ks, np * 16, kk * 16, lane));
        mma(sc[2 * np], a, bb[0], bb[1]);
        mma(sc[2 * np + 1], a, bb[2], bb[3]);
        ldsm_x4(bb, frag_b<LD>(vs, np * 16, kk * 16, lane));
        mma(dp[2 * np], ad, bb[0], bb[1]);
        mma(dp[2 * np + 1], ad, bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, kl = i * 8 + 2 * tig + (e & 1);
        const bool keep =
            keep_s[kl] && band_keep(qr[r], k0 + kl, s.causal, s.window);
        const float p = keep ? exp2f(sc[i][e] * sl2 - lse2[r]) : 0.f;
        if (pass == 0)
          dl[r] += p * dp[i][e];
        else
          sc[i][e] = p * (dp[i][e] - dl[r]) * s.scale;  // ds
      }
    if (pass == 0) continue;
    // dQ += dS K (K read transposed: k-rows are keys)
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      const uint32_t a[4] = {
          pack_bf16(sc[2 * j][0], sc[2 * j][1]),
          pack_bf16(sc[2 * j][2], sc[2 * j][3]),
          pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]),
          pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3])};
#pragma unroll
      for (int dd = 0; dd < DT / 2; ++dd) {
        uint32_t bb[4];
        ldsm_x4_t(bb, frag_a<LD>(ks, j * 16, dd * 16, lane));
        mma(acc[2 * dd], a, bb[0], bb[1]);
        mma(acc[2 * dd + 1], a, bb[2], bb[3]);
      }
    }
  }
  if (pass == 0) {  // finish delta and publish it for the dkv kernel
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dl[r] = quad_sum(dl[r]);
      if (tig == 0 && qr[r] < s.Tq) delta[rowbase + qr[r]] = dl[r];
    }
  }
  }

  bf16* out = dq.p + b * dq.sb + h * dq.sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qr[r] >= s.Tq) continue;
    bf16* row = out + static_cast<long long>(qr[r]) * dq.st;
#pragma unroll
    for (int i = 0; i < DT; ++i)
      *reinterpret_cast<__nv_bfloat162*>(row + i * 8 + 2 * tig) =
          __floats2bfloat162_rn(acc[i][2 * r], acc[i][2 * r + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(View q, View k, View v, View dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, OutView dk,
                         OutView dv, Shape s) {
  constexpr int LD = D + 8, KS = D / 16, NQ = kBQd / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kBK * LD;
  bf16* qs = vs + kBK * LD;
  bf16* dos = qs + kBQd * LD;
  float* lse_s = reinterpret_cast<float*>(dos + kBQd * LD);
  float* dl_s = lse_s + kBQd;

  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * kBK;
  const int group = s.H / s.Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int kr[2] = {k0 + warp * 16 + gid, k0 + warp * 16 + gid + 8};
  bool kkeep[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    kkeep[r] = kr[r] < s.Tk &&
               (s.kv_mask == nullptr ||
                s.kv_mask[static_cast<long long>(b) * s.Tk + kr[r]] != 0);
  const float sl2 = s.scale * kLog2e;

  load_tile<D, kBK>(ks, k.p + b * k.sb + hk * k.sh, k.st, k0, s.Tk);
  load_tile<D, kBK>(vs, v.p + b * v.sb + hk * v.sh, v.st, k0, s.Tk);

  int qlo, qhi;
  query_range(k0, k0 + kBK - 1, s.Tq, s.causal, s.window, qlo, qhi);

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const bf16* qb = q.p + b * q.sb + h * q.sh;
    const bf16* gb = dout.p + b * dout.sb + h * dout.sh;
    const long long rowbase = (static_cast<long long>(b) * s.H + h) * s.Tq;
    for (int q0 = (qlo / kBQd) * kBQd; q0 < qhi; q0 += kBQd) {
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_tile<D, kBQd>(qs, qb, q.st, q0, s.Tq);
      load_tile<D, kBQd>(dos, gb, dout.st, q0, s.Tq);
      if (threadIdx.x < kBQd) {
        const int qq = q0 + threadIdx.x;
        const bool in = qq < s.Tq;
        lse_s[threadIdx.x] = in ? lse[rowbase + qq] * kLog2e : kLseMasked;
        dl_s[threadIdx.x] = in ? delta[rowbase + qq] : 0.f;
      }
      __syncthreads();

      float sc[NQ][4], dp[NQ][4];
#pragma unroll
      for (int i = 0; i < NQ; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[i][e] = dp[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4], av[4];
        ldsm_x4(a, frag_a<LD>(ks, warp * 16, kk * 16, lane));
        ldsm_x4(av, frag_a<LD>(vs, warp * 16, kk * 16, lane));
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t bb[4];
          ldsm_x4(bb, frag_b<LD>(qs, np * 16, kk * 16, lane));
          mma(sc[2 * np], a, bb[0], bb[1]);
          mma(sc[2 * np + 1], a, bb[2], bb[3]);
          ldsm_x4(bb, frag_b<LD>(dos, np * 16, kk * 16, lane));
          mma(dp[2 * np], av, bb[0], bb[1]);
          mma(dp[2 * np + 1], av, bb[2], bb[3]);
        }
      }
      // rows are keys, columns are queries: p^T and ds^T
#pragma unroll
      for (int i = 0; i < NQ; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, ql = i * 8 + 2 * tig + (e & 1);
          const int qq = q0 + ql;
          const bool keep = kkeep[r] && qq < s.Tq &&
                            band_keep(qq, kr[r], s.causal, s.window);
          const float p = keep ? exp2f(sc[i][e] * sl2 - lse_s[ql]) : 0.f;
          sc[i][e] = p;
          dp[i][e] = p * (dp[i][e] - dl_s[ql]) * s.scale;
        }
      // dV += P^T dO, dK += dS^T Q (dO and Q read transposed)
#pragma unroll
      for (int j = 0; j < kBQd / 16; ++j) {
        const uint32_t ap[4] = {
            pack_bf16(sc[2 * j][0], sc[2 * j][1]),
            pack_bf16(sc[2 * j][2], sc[2 * j][3]),
            pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]),
            pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3])};
        const uint32_t ad[4] = {
            pack_bf16(dp[2 * j][0], dp[2 * j][1]),
            pack_bf16(dp[2 * j][2], dp[2 * j][3]),
            pack_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1]),
            pack_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3])};
#pragma unroll
        for (int dd = 0; dd < DT / 2; ++dd) {
          uint32_t bb[4];
          ldsm_x4_t(bb, frag_a<LD>(dos, j * 16, dd * 16, lane));
          mma(dva[2 * dd], ap, bb[0], bb[1]);
          mma(dva[2 * dd + 1], ap, bb[2], bb[3]);
          ldsm_x4_t(bb, frag_a<LD>(qs, j * 16, dd * 16, lane));
          mma(dka[2 * dd], ad, bb[0], bb[1]);
          mma(dka[2 * dd + 1], ad, bb[2], bb[3]);
        }
      }
    }
  }

  bf16* kout = dk.p + b * dk.sb + hk * dk.sh;
  bf16* vout = dv.p + b * dv.sb + hk * dv.sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kr[r] >= s.Tk) continue;
    bf16* krow = kout + static_cast<long long>(kr[r]) * dk.st;
    bf16* vrow = vout + static_cast<long long>(kr[r]) * dv.st;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(krow + i * 8 + 2 * tig) =
          __floats2bfloat162_rn(dka[i][2 * r], dka[i][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vrow + i * 8 + 2 * tig) =
          __floats2bfloat162_rn(dva[i][2 * r], dva[i][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------- launching
template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D>
int launch_fwd(View q, View k, View v, OutView o, float* lse, Shape s,
               cudaStream_t stream) {
  constexpr int LD = D + 8;
  const size_t smem = sizeof(bf16) * (kBQ + 2 * kBK) * LD + kBK;
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s.Tq + kBQ - 1) / kBQ, s.H, s.B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(q, k, v, o, lse, s);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(View q, View k, View v, View dout, const float* lse,
               float* delta, OutView dq, OutView dk, OutView dv, Shape s,
               cudaStream_t stream) {
  constexpr int LD = D + 8;
  cudaError_t err = cudaSuccess;
  if (s.Tq > 0) {  // dq first: it writes the delta the dkv kernel reads
    const size_t smem = sizeof(bf16) * (2 * kBQ + 2 * kBK) * LD + kBK;
    err = allow_smem(flash_bwd_dq_kernel<D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((s.Tq + kBQ - 1) / kBQ, s.H, s.B);
    flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
        q, k, v, dout, lse, delta, dq, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (s.Tk > 0) {
    const size_t smem =
        sizeof(bf16) * (2 * kBK + 2 * kBQd) * LD + sizeof(float) * 2 * kBQd;
    err = allow_smem(flash_bwd_dkv_kernel<D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((s.Tk + kBK - 1) / kBK, s.Hkv, s.B);
    flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, s);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// strides of n views: each a multiple of 8 elements (16-byte rows)
bool strides_ok(const long long* st, int n) {
  for (int i = 0; i < 3 * n; ++i)
    if (st[i] % 8 != 0) return false;
  return true;
}

View view(const void* p, const long long* st) {
  return View{static_cast<const bf16*>(p), st[0], st[1], st[2]};
}

OutView out_view(void* p, const long long* st) {
  return OutView{static_cast<bf16*>(p), st[0], st[1], st[2]};
}

bool shape_ok(const int* dims) {
  const int B = dims[0], H = dims[1], Hkv = dims[2], Tq = dims[3],
            Tk = dims[4], D = dims[5];
  return B >= 0 && Tq >= 0 && Tk >= 0 && H > 0 && Hkv > 0 && H % Hkv == 0 &&
         H <= 65535 && B <= 65535 && (D == 64 || D == 128);
}

Shape make_shape(const int* dims, float scale, const void* kv_mask) {
  return Shape{dims[0], dims[1], dims[2], dims[3], dims[4],
               dims[6], dims[7], scale,
               static_cast<const uint8_t*>(kv_mask)};
}

}  // namespace

extern "C" {

// Forward. ptrs = {q, k, v, kv_mask (or null), o, lse}; strides = (b, h, t)
// element strides of the [B, heads, T, D] views q, k, v, o (12 values);
// dims = {B, H, Hkv, Tq, Tk, D, causal, window (<= 0: none)}. bf16 q/k/v/o,
// f32 lse [B, H, Tq] contiguous, uint8 kv_mask [B, Tk] contiguous. Returns a
// cudaError_t (0 = launched).
int tl_flash_fwd(const void* const* ptrs, const long long* strides,
                 const int* dims, float scale, void* stream) {
  if (!shape_ok(dims) || !strides_ok(strides, 4)) return cudaErrorInvalidValue;
  const int dense[] = {0, 1, 2, 4};
  for (int i : dense)
    if (!aligned(ptrs[i])) return cudaErrorMisalignedAddress;
  const Shape s = make_shape(dims, scale, ptrs[3]);
  if (s.B == 0 || s.Tq == 0) return 0;
  const View q = view(ptrs[0], strides), k = view(ptrs[1], strides + 3),
             v = view(ptrs[2], strides + 6);
  const OutView o = out_view(const_cast<void*>(ptrs[4]), strides + 9);
  float* lse = static_cast<float*>(const_cast<void*>(ptrs[5]));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dims[5] == 64 ? launch_fwd<64>(q, k, v, o, lse, s, st)
                       : launch_fwd<128>(q, k, v, o, lse, s, st);
}

// Backward. ptrs = {q, k, v, do, lse, kv_mask (or null), delta (f32
// [B, H, Tq] workspace), dq, dk, dv}; strides of the views q, k, v, do, dq,
// dk, dv (21 values); dims as for the forward.
int tl_flash_bwd(const void* const* ptrs, const long long* strides,
                 const int* dims, float scale, void* stream) {
  if (!shape_ok(dims) || !strides_ok(strides, 7)) return cudaErrorInvalidValue;
  const int dense[] = {0, 1, 2, 3, 7, 8, 9};
  for (int i : dense)
    if (!aligned(ptrs[i])) return cudaErrorMisalignedAddress;
  const Shape s = make_shape(dims, scale, ptrs[5]);
  if (s.B == 0) return 0;
  const View q = view(ptrs[0], strides), k = view(ptrs[1], strides + 3),
             v = view(ptrs[2], strides + 6), dout = view(ptrs[3], strides + 9);
  const OutView dq = out_view(const_cast<void*>(ptrs[7]), strides + 12),
                dk = out_view(const_cast<void*>(ptrs[8]), strides + 15),
                dv = out_view(const_cast<void*>(ptrs[9]), strides + 18);
  const float* lse = static_cast<const float*>(ptrs[4]);
  float* delta = static_cast<float*>(const_cast<void*>(ptrs[6]));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dims[5] == 64
             ? launch_bwd<64>(q, k, v, dout, lse, delta, dq, dk, dv, s, st)
             : launch_bwd<128>(q, k, v, dout, lse, delta, dq, dk, dv, s, st);
}

const char* tl_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
