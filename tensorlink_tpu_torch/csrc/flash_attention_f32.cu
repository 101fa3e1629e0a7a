// Flash attention forward (B1) and backward (B2) for f32 operands, on the
// tensor cores in TF32 with a three-product split (3xTF32), for sm_90a.
//
// Replaces, for f32 inputs, the TPU kernels of
// tensorlink_tpu/ops/pallas/flash_attention.py: flash_attention_fwd_lse and
// flash_attention_bwd, which compute in f32 whatever their inputs (the bf16
// and f16 forms are in flash_attention.cu). f32 q, k, v and do give f32 o,
// dq, dk, dv and lse; every sum is f32. Operands are
// [B, heads, T, D] views read through their strides (D contiguous); GQA
// reads the unrepeated K/V (query head h uses kv head h / (H / Hkv)). A key
// is attended iff kv_mask[b, k] != 0 (when a mask is given), k < Tk, and
// the positional band holds (k <= q under causal; k > q - window, and
// k < q + window when not causal, under a window). A query row with no
// attended key gives o = 0 and lse = 1e30, so the backward's p is 0 there.
//
// What bounds it: the operations. At the training shapes (BERT-base
// 8 x 12 x 512 x 64 with padding, Llama-3-8B 32/8 heads x 2048 x 128
// causal) an attended (query, key) pair costs 4 D flops forward and 8 D
// backward (S, dP, dQ, dK, dV; 10 D with the recomputed S in dkv) against
// a few bytes of q, k, v a pair. f32 on the CUDA cores tops out at
// 67 TFLOP/s. A TF32 mma runs at 495 TFLOP/s but keeps 11 significant
// bits, ~5e-4 relative a product: one TF32 pass would put an f32 model's
// attention outside the port's f32 gates (1e-4 of max |o|). So each f32
// operand splits as it is read, x = hi + lo with hi = rna_tf32(x) and
// lo = x - hi (see split), and a b ~= a_hi b_hi + a_hi b_lo + a_lo b_hi in
// the f32 accumulators: within ~2^-21 of the f32 product (the dropped
// a_lo b_lo is below 2^-22 |a b|), at three products, 165 TFLOP/s.
//
// Design: blocks of 4 warps; warp w owns a 16-row strip of the block's 64
// rows (queries; keys in the dkv kernel) and keeps its S and dP strips
// (16 x 64, or 16 x 32 at D 128 in the backward) and its output rows in
// f32 registers. Products are mma.sync m16n8k8 tf32 (csrc/mma_common.cuh).
// Operand fragments are read from f32 tiles in shared memory, rows padded
// by 16 bytes: with that pitch the row reads of an A or
// K^T-like operand (lanes at row g, column t) and the column reads of a
// V-like operand (rows 2t, 2t + 1, column g) fall on distinct banks. A
// score accumulator becomes the A operand of the next product with its k
// order permuted (a thread's C columns 2t, 2t + 1 are A columns t, t + 4;
// the B operand reads rows 2t, 2t + 1 to match), so P and dS never pass
// through shared memory. Tiles arrive by 16-byte cp.async, one buffer per
// operand, each copy in its own commit group and issued as soon as the
// operand's last reader is done, so it lands under the other operand's
// product: forward, V(i) under S = Q K(i)^T and K(i + 1) under O += P V(i).
// - Forward: one block per (head, 64-query tile, batch row); online
//   softmax in f32 on the accumulators, in the log2 domain (exp2f of scores
//   pre-scaled by log2 e).
// - Backward, dq kernel (one block per query tile, one pass over the key
//   tiles, 32 keys a tile at D 128 for the register file): with
//   p = exp(s - lse), dp = dO V^T and the row's delta = sum_k p dp (the
//   port's delta convention, taken from the kernel's own p and dp), it
//   centres dp on d~ = rowsum(dO o) and sums A = sum_k p (dp - d~) k,
//   C = sum_k p k and delta, then dQ = scale (A - (delta - d~) C): exact for
//   any d~ (flash_attention.cu's dq does the same). delta - d~ is dO times
//   the forward's rounding of o, so C takes one TF32 product (P_hi K_hi):
//   its 2^-11 error lands that far below a term that is itself at o's
//   rounding. delta is published for the dkv kernel. With a caller's delta
//   (delta_in, the ring's backward) d~ is that delta, C is not formed, and
//   nothing is published.
// - Backward, dkv kernel (one block per (kv head, 64-key tile, batch row)):
//   walks the (query head of its GQA group, query tile) units its band
//   reaches (32 queries a unit at D 128), forming S^T and dP^T, and sums dK
//   and dV of the whole group in registers.
// Key tiles whose keys are all masked, and a warp's strips that the band
// leaves empty, are skipped. Every kernel takes 2 blocks an SM (f32 at
// D 128: 99 KB of tiles each). At D 256 every kernel takes the SM alone
// (195 KB of tiles): the forward keeps its 4 warps (O is 128 f32
// registers a thread); in the backward a warp's two [16, D] sums would be
// 256 registers, so its blocks take 8 warps, two to each 16-row strip,
// which both form the strip's whole S and dP and each sum the outputs
// (A and C, or dK and dV) of one half of D's columns. wgmma is not used: its tf32 form reads only
// K-major operands from shared memory, and V, dO and the transposed
// products of B2 are not K-major; it would also need hi and lo copies of
// every tile (192 KB for Q, K and V^T at D 128).

#include "mma_common.cuh"

namespace {

using namespace tlk;

constexpr int kThreads = 128;  // 4 warps, a 16-row strip each
constexpr int kRows = 64;      // rows a block (queries; keys in dkv)
constexpr float kLseMasked = 1e30f;

__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

struct View {  // a [B, heads, T, D] operand; strides in elements
  const float* p;
  long long sb, sh, st;
};

struct OutView {
  float* p;
  long long sb, sh, st;
};

struct Shape {
  int B, H, Hkv, Tq, Tk, causal, window;  // window <= 0: none
  int delta_in;  // backward: delta [B, H, Tq] given by the caller
  float scale;
  const uint8_t* kv_mask;  // [B, Tk], nonzero = attend; null = all keys
};

__device__ __forceinline__ bool band_keep(int q, int k, int causal,
                                          int window) {
  if (causal && k > q) return false;
  if (window > 0 && (k <= q - window || (!causal && k >= q + window)))
    return false;
  return true;
}

// no (query, key) pair of [qa, qb] x [ka, kb] is inside the band
__device__ __forceinline__ bool band_empty(int qa, int qb, int ka, int kb,
                                           int causal, int window) {
  return (causal && ka > qb) ||
         (window > 0 && (kb <= qa - window || (!causal && ka >= qb + window)));
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

__device__ __forceinline__ bool key_kept(const Shape& s, int b, int k) {
  return k < s.Tk &&
         (s.kv_mask == nullptr || s.kv_mask[(long long)b * s.Tk + k] != 0);
}

// the kept keys of [k0, k0 + KT) as bits (KT 32 or 64), from every lane
template <int KT>
__device__ __forceinline__ void key_bits(uint32_t (&bits)[2], const Shape& s,
                                         int b, int k0, int lane) {
  bits[0] = __ballot_sync(0xffffffffu, key_kept(s, b, k0 + lane));
  bits[1] = KT > 32
                ? __ballot_sync(0xffffffffu, key_kept(s, b, k0 + 32 + lane))
                : 0u;
}

// rows [r0, r0 + ROWS) of a [T, D] slab into a tile of pitch LD with
// 16-byte cp.async copies by the block's NTH threads; rows at or past n
// are zero-filled
template <int D, int ROWS, int LD, int NTH = kThreads>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long st, int r0, int n) {
  constexpr int EPC = 4, CH = D / EPC;
  for (int i = threadIdx.x; i < ROWS * CH; i += NTH) {
    const int r = i / CH, c = (i % CH) * EPC;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * LD + c, ok ? src + (long long)(r0 + r) * st + c : src,
               ok ? 16 : 0);
  }
}

// ------------------------------------------------- 3xTF32 fragments
template <int N>
struct Frag {  // an operand fragment: tf32 hi and lo
  uint32_t hi[N], lo[N];
};

// x = hi + lo: hi = x rounded to tf32 (to nearest, ties away from zero:
// the bits of cvt.rna.tf32.f32, here an integer add and mask, which
// measured 1.3-1.5x faster on the kernels); lo = x - hi (exact), whose
// low 13 bits the mma drops (|error| <= 2^-21 |x|)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b: a_lo b_hi + a_hi b_lo + a_hi b_hi, the small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const Frag<4>& a,
                                     const Frag<2>& b) {
  mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(c, a.hi, b.hi[0], b.hi[1]);
}

// A operand from a row-major tile: rows r0 + (g, g + 8), columns
// c0 + (t, t + 4)
template <int LD>
__device__ __forceinline__ void frag_a(Frag<4>& f, const float* s, int r0,
                                       int c0, int g, int t) {
  const float* p = s + (r0 + g) * LD + c0 + t;
  split(*p, f.hi[0], f.lo[0]);
  split(p[8 * LD], f.hi[1], f.lo[1]);
  split(p[4], f.hi[2], f.lo[2]);
  split(p[8 * LD + 4], f.hi[3], f.lo[3]);
}

// B operand X^T of a row-major [n][k] tile X (K in Q K^T): row n0 + g,
// columns c0 + (t, t + 4)
template <int LD>
__device__ __forceinline__ void frag_bt(Frag<2>& f, const float* s, int n0,
                                        int c0, int g, int t) {
  const float* p = s + (n0 + g) * LD + c0 + t;
  split(*p, f.hi[0], f.lo[0]);
  split(p[4], f.hi[1], f.lo[1]);
}

// B operand X of a row-major [k][n] tile X (V in P V), k in the permuted
// order of frag_c: rows k0 + 2t, k0 + 2t + 1, column n0 + g
template <int LD>
__device__ __forceinline__ void frag_bn(Frag<2>& f, const float* s, int k0,
                                        int n0, int g, int t) {
  const float* p = s + (k0 + 2 * t) * LD + n0 + g;
  split(*p, f.hi[0], f.lo[0]);
  split(p[LD], f.hi[1], f.lo[1]);
}

// A operand from the f32 accumulators of one n-tile (P or dS), k permuted:
// C (g, 2t) -> A (g, t), C (g, 2t + 1) -> A (g, t + 4)
__device__ __forceinline__ void frag_c(Frag<4>& f, const float (&c)[4]) {
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
}

// a tile row, padded by 16 bytes
template <int D>
__host__ __device__ constexpr int pitch() {
  return D + 4;
}

// ---------------------------------------------------------------- forward
template <int D, bool BAND>
__global__ void __launch_bounds__(kThreads, blocks_per_sm<D>())
    flash_fwd_tc_kernel(View q, View k, View v, OutView o,
                        float* __restrict__ lse, Shape s) {
  constexpr int LD = pitch<D>(), KS = D / 8, NT = kRows / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + kRows * LD;
  float* vs = ks + kRows * LD;

  // causal: the last query tiles see the most keys, so they launch first
  const int tile = s.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int h = blockIdx.x, q0 = tile * kRows, b = blockIdx.z;
  const int hk = h / (s.H / s.Hkv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const int qr[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  const float sl2 = s.scale * kLog2e;  // scores in the log2 domain
  const float* kb = k.p + b * k.sb + hk * k.sh;
  const float* vb = v.p + b * v.sb + hk * v.sh;

  int lo, hi;
  key_range(q0, min(q0 + kRows, s.Tq) - 1, s.Tk, s.causal, s.window, lo, hi);
  const int kt0 = lo - lo % kRows;
  const int n = hi > kt0 ? (hi - kt0 + kRows - 1) / kRows : 0;

  load_tile<D, kRows, LD>(qs, q.p + b * q.sb + h * q.sh, q.st, q0, s.Tq);
  if (n > 0) load_tile<D, kRows, LD>(ks, kb, k.st, kt0, s.Tk);
  cp_async_commit();

  float acc[D / 8][4];  // O: this warp's 16 rows x D
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int i = 0; i < n; ++i) {
    const int k0 = kt0 + i * kRows;
    cp_async_wait<0>();
    __syncthreads();  // K(i) has landed; every warp is done with V(i - 1)
    load_tile<D, kRows, LD>(vs, vb, v.st, k0, s.Tk);
    cp_async_commit();
    uint32_t kbits[2];
    key_bits<kRows>(kbits, s, b, k0, lane);
    const bool live =
        (kbits[0] | kbits[1]) &&
        !(BAND && band_empty(q0 + r0, q0 + r0 + 15, k0, k0 + kRows - 1,
                             s.causal, s.window));
    float sc[NT][4];  // S, then P: this warp's 16 rows x 64 keys
    if (live) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        Frag<4> a;
        frag_a<LD>(a, qs, r0, 8 * kk, g, t);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          Frag<2> bb;
          frag_bt<LD>(bb, ks, 8 * j, 8 * kk, g, t);
          mma3(sc[j], a, bb);
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, kl = 8 * j + 2 * t + (e & 1);
          bool keep = (kbits[kl >> 5] >> (kl & 31)) & 1u;
          if (BAND)
            keep = keep && band_keep(qr[r], k0 + kl, s.causal, s.window);
          sc[j][e] = keep ? sc[j][e] * sl2 : kNegInf;
          mx[r] = fmaxf(mx[r], sc[j][e]);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        alpha[r] = exp2f(m[r] - mx[r]);  // both -1e30: 1, on zero sums
        l[r] *= alpha[r];
        m[r] = mx[r];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = sc[j][e] == kNegInf ? 0.f : exp2f(sc[j][e] - m[r]);
          sc[j][e] = p;
          l[r] += p;
        }
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] *= alpha[e >> 1];
    }
    cp_async_wait<0>();
    __syncthreads();  // V(i) has landed; every warp is done with K(i)
    if (i + 1 < n)
      load_tile<D, kRows, LD>(ks, kb, k.st, k0 + kRows, s.Tk);
    cp_async_commit();
    if (live) {  // O += P V
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        Frag<4> a;
        frag_c(a, sc[j]);
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          Frag<2> bb;
          frag_bn<LD>(bb, vs, 8 * j, 8 * dn, g, t);
          mma3(acc[dn], a, bb);
        }
      }
    }
  }
  cp_async_wait<0>();

  float* ob = o.p + b * o.sb + h * o.sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    if (qr[r] >= s.Tq) continue;
    const float inv = lr > 0.f ? 1.f / lr : 0.f;
    float* row = ob + (long long)qr[r] * o.st;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      put2(row + 8 * dn + 2 * t, acc[dn][2 * r] * inv,
                     acc[dn][2 * r + 1] * inv);
    if (t == 0)
      lse[((long long)b * s.H + h) * s.Tq + qr[r]] =
          lr > 0.f ? (m[r] + log2f(lr)) * kLn2 : kLseMasked;
  }
}

// ------------------------------------------------------- backward: dq
// keys a tile: the [16, D] A and C sums fill the register file at D 128
// (and half of D's columns at D 256)
template <int D>
__host__ __device__ constexpr int dq_keys() {
  return D == 64 ? 64 : 32;
}

template <int D, bool BAND>
__global__ void __launch_bounds__(kThreads * bwd_halves<D>(),
                                  blocks_per_sm<D>())
    flash_bwd_dq_tc_kernel(View q, View k, View v, View o,
                           View dout, const float* __restrict__ lse,
                           float* __restrict__ delta, OutView dq,
                           Shape s) {
  constexpr int KT = dq_keys<D>(), LD = pitch<D>(), KS = D / 8,
                NT = KT / 8;
  constexpr int NTH = kThreads * bwd_halves<D>();
  constexpr int DN = D / bwd_halves<D>() / 8;  // n-tiles of a warp's outputs
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + kRows * LD;
  float* ks = dos + kRows * LD;
  float* vs = ks + KT * LD;

  const int tile = s.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int h = blockIdx.x, q0 = tile * kRows, b = blockIdx.z;
  const int hk = h / (s.H / s.Hkv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = (warp & 3) * 16;
  const int half = warp >> 2, dc0 = half * DN * 8;  // this warp's columns
  const int qr[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  const float sl2 = s.scale * kLog2e;
  const bool own = !s.delta_in;
  const float* kb = k.p + b * k.sb + hk * k.sh;
  const float* vb = v.p + b * v.sb + hk * v.sh;
  const long long rowbase = ((long long)b * s.H + h) * s.Tq;

  int lo, hi;
  key_range(q0, min(q0 + kRows, s.Tq) - 1, s.Tk, s.causal, s.window, lo, hi);
  const int kt0 = lo - lo % KT;
  const int n = hi > kt0 ? (hi - kt0 + KT - 1) / KT : 0;

  load_tile<D, kRows, LD, NTH>(qs, q.p + b * q.sb + h * q.sh, q.st, q0,
                               s.Tq);
  load_tile<D, kRows, LD, NTH>(dos, dout.p + b * dout.sb + h * dout.sh,
                               dout.st, q0, s.Tq);
  if (n > 0) load_tile<D, KT, LD, NTH>(vs, vb, v.st, kt0, s.Tk);
  cp_async_commit();
  if (n > 0) load_tile<D, KT, LD, NTH>(ks, kb, k.st, kt0, s.Tk);
  cp_async_commit();

  // d~ of this thread's two rows (each lane of the quad dots a quarter),
  // or the caller's delta; and lse in the log2 domain
  float dt[2], lse2[2], dl[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = qr[r] < s.Tq;
    lse2[r] = in ? lse[rowbase + qr[r]] * kLog2e : kLseMasked;
    if (!own) {
      dt[r] = in ? delta[rowbase + qr[r]] : 0.f;
      continue;
    }
    float acc = 0.f;
    if (in) {
      const float* orow = o.p + b * o.sb + h * o.sh + (long long)qr[r] * o.st;
      const float* grow =
          dout.p + b * dout.sb + h * dout.sh + (long long)qr[r] * dout.st;
#pragma unroll 8
      for (int c = t * (D / 4); c < (t + 1) * (D / 4); ++c)
        acc = fmaf(orow[c], grow[c], acc);
    }
    dt[r] = quad_sum(acc);
  }

  float acc_a[DN][4], acc_c[DN][4];
#pragma unroll
  for (int i = 0; i < DN; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_a[i][e] = acc_c[i][e] = 0.f;

  for (int i = 0; i < n; ++i) {
    const int k0 = kt0 + i * KT;
    cp_async_wait<1>();
    __syncthreads();  // V(i) (and Q, dO) has landed
    uint32_t kbits[2];
    key_bits<KT>(kbits, s, b, k0, lane);
    const bool live =
        (kbits[0] | kbits[1]) &&
        !(BAND && band_empty(q0 + r0, q0 + r0 + 15, k0, k0 + KT - 1,
                             s.causal, s.window));
    float sc[NT][4], dp[NT][4];
    if (live) {  // dP = dO V^T
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        Frag<4> a;
        frag_a<LD>(a, dos, r0, 8 * kk, g, t);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          Frag<2> bb;
          frag_bt<LD>(bb, vs, 8 * j, 8 * kk, g, t);
          mma3(dp[j], a, bb);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // K(i) has landed; every warp is done with V(i)
    if (i + 1 < n) load_tile<D, KT, LD, NTH>(vs, vb, v.st, k0 + KT, s.Tk);
    cp_async_commit();
    if (live) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {  // S = Q K^T
        Frag<4> a;
        frag_a<LD>(a, qs, r0, 8 * kk, g, t);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          Frag<2> bb;
          frag_bt<LD>(bb, ks, 8 * j, 8 * kk, g, t);
          mma3(sc[j], a, bb);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, kl = 8 * j + 2 * t + (e & 1);
          bool keep = (kbits[kl >> 5] >> (kl & 31)) & 1u;
          if (BAND)
            keep = keep && band_keep(qr[r], k0 + kl, s.causal, s.window);
          const float p = keep ? exp2f(sc[j][e] * sl2 - lse2[r]) : 0.f;
          dl[r] += p * dp[j][e];
          sc[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dt[r]);
        }
      // A += (P o (dP - d~)) K, C += P K (K read down its rows: keys are k)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        Frag<4> ad, ap;
        frag_c(ad, dp[j]);
        frag_c(ap, sc[j]);
#pragma unroll
        for (int dn = 0; dn < DN; ++dn) {
          Frag<2> bb;
          frag_bn<LD>(bb, ks, 8 * j, dc0 + 8 * dn, g, t);
          mma3(acc_a[dn], ad, bb);
          if (own) mma_tf32(acc_c[dn], ap.hi, bb.hi[0], bb.hi[1]);
        }
      }
    }
    __syncthreads();  // every warp is done with K(i)
    if (i + 1 < n) load_tile<D, KT, LD, NTH>(ks, kb, k.st, k0 + KT, s.Tk);
    cp_async_commit();
  }
  cp_async_wait<0>();

  float* out = dq.p + b * dq.sb + h * dq.sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dl[r] = quad_sum(dl[r]);
    if (qr[r] >= s.Tq) continue;
    if (!own)
      dl[r] = dt[r];  // the whole row's delta, whatever keys this call saw
    else if (t == 0 && half == 0)
      delta[rowbase + qr[r]] = dl[r];
    const float c = dl[r] - dt[r];
    float* row = out + (long long)qr[r] * dq.st + dc0;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
      put2(row + 8 * dn + 2 * t,
                     s.scale * (acc_a[dn][2 * r] - c * acc_c[dn][2 * r]),
                     s.scale * (acc_a[dn][2 * r + 1] - c * acc_c[dn][2 * r + 1]));
  }
}

// ------------------------------------------------------ backward: dk, dv
// queries a unit: the [16, D] dK and dV sums fill the register file at
// D 128 (and half of D's columns at D 256)
template <int D>
__host__ __device__ constexpr int dkv_queries() {
  return D == 64 ? 64 : 32;
}

template <int D, bool BAND>
__global__ void __launch_bounds__(kThreads * bwd_halves<D>(),
                                  blocks_per_sm<D>())
    flash_bwd_dkv_tc_kernel(View q, View k, View v, View dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta, OutView dk,
                            OutView dv, Shape s) {
  constexpr int QT = dkv_queries<D>(), LD = pitch<D>(), KS = D / 8,
                NQ = QT / 8;
  constexpr int NTH = kThreads * bwd_halves<D>();
  constexpr int DN = D / bwd_halves<D>() / 8;  // n-tiles of a warp's outputs
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kRows * LD;
  float* qs = vs + kRows * LD;
  float* dos = qs + QT * LD;
  float* lse_s = reinterpret_cast<float*>(dos + QT * LD);  // [QT]
  float* dl_s = lse_s + QT;                                // [QT]

  const int hk = blockIdx.x, k0 = blockIdx.y * kRows, b = blockIdx.z;
  const int G = s.H / s.Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = (warp & 3) * 16;
  const int dc0 = (warp >> 2) * DN * 8;  // this warp's output columns
  const int kr[2] = {k0 + r0 + g, k0 + r0 + g + 8};
  const bool kkeep[2] = {key_kept(s, b, kr[0]), key_kept(s, b, kr[1])};
  const float sl2 = s.scale * kLog2e;

  int lo, hi;
  query_range(k0, min(k0 + kRows, s.Tk) - 1, s.Tq, s.causal, s.window, lo,
              hi);
  const int qt0 = lo - lo % QT;
  const int nqt = hi > qt0 ? (hi - qt0 + QT - 1) / QT : 0;
  // a key tile whose keys are all masked (padding) has zero gradients
  const bool any_key = __syncthreads_or(kkeep[0] || kkeep[1]);
  const bool warp_keys = __any_sync(0xffffffffu, kkeep[0] || kkeep[1]);
  const int nu = any_key ? G * nqt : 0;  // (query head, query tile) units

  auto issue_q = [&](int u) {  // Q rows, lse and delta of unit u
    const int h = hk * G + u / nqt, q0 = qt0 + (u % nqt) * QT;
    load_tile<D, QT, LD, NTH>(qs, q.p + b * q.sb + h * q.sh, q.st, q0, s.Tq);
    if (threadIdx.x < QT) {
      const int qq = q0 + threadIdx.x;
      const bool in = qq < s.Tq;
      const long long at = ((long long)b * s.H + h) * s.Tq + (in ? qq : 0);
      cp_async4(lse_s + threadIdx.x, lse + at, in ? 4 : 0);
      cp_async4(dl_s + threadIdx.x, delta + at, in ? 4 : 0);
    }
  };
  auto issue_do = [&](int u) {
    const int h = hk * G + u / nqt, q0 = qt0 + (u % nqt) * QT;
    load_tile<D, QT, LD, NTH>(dos, dout.p + b * dout.sb + h * dout.sh,
                              dout.st, q0, s.Tq);
  };

  load_tile<D, kRows, LD, NTH>(ks, k.p + b * k.sb + hk * k.sh, k.st, k0,
                               s.Tk);
  load_tile<D, kRows, LD, NTH>(vs, v.p + b * v.sb + hk * v.sh, v.st, k0,
                               s.Tk);
  if (nu > 0) issue_q(0);
  cp_async_commit();
  if (nu > 0) issue_do(0);
  cp_async_commit();

  float dka[DN][4], dva[DN][4];
#pragma unroll
  for (int i = 0; i < DN; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  for (int u = 0; u < nu; ++u) {
    const int q0 = qt0 + (u % nqt) * QT;
    cp_async_wait<1>();
    __syncthreads();  // Q(u), lse and delta (and K, V) have landed
    const bool live =
        warp_keys && !(BAND && band_empty(q0, q0 + QT - 1, k0 + r0,
                                          k0 + r0 + 15, s.causal, s.window));
    // rows are keys, columns are queries: S^T then P^T, dP^T then dS^T
    float st[NQ][4], dpt[NQ][4];
    if (live) {
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {  // S^T = K Q^T
        Frag<4> a;
        frag_a<LD>(a, ks, r0, 8 * kk, g, t);
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          Frag<2> bb;
          frag_bt<LD>(bb, qs, 8 * j, 8 * kk, g, t);
          mma3(st[j], a, bb);
        }
      }
      // a query past Tq needs no test: its zero-filled q, dO, lse and
      // delta make its p finite and its dS and P^T dO zero
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, ql = 8 * j + 2 * t + (e & 1);
          bool keep = kkeep[r];
          if (BAND)
            keep = keep && band_keep(q0 + ql, kr[r], s.causal, s.window);
          st[j][e] = keep ? exp2f(st[j][e] * sl2 - lse_s[ql] * kLog2e) : 0.f;
        }
    }
    cp_async_wait<0>();
    __syncthreads();  // dO(u) has landed
    if (live) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {  // dP^T = V dO^T
        Frag<4> a;
        frag_a<LD>(a, vs, r0, 8 * kk, g, t);
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          Frag<2> bb;
          frag_bt<LD>(bb, dos, 8 * j, 8 * kk, g, t);
          mma3(dpt[j], a, bb);
        }
      }
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = 8 * j + 2 * t + (e & 1);
          dpt[j][e] = st[j][e] * (dpt[j][e] - dl_s[ql]) * s.scale;
        }
#pragma unroll
      for (int j = 0; j < NQ; ++j) {  // dK += dS^T Q
        Frag<4> a;
        frag_c(a, dpt[j]);
#pragma unroll
        for (int dn = 0; dn < DN; ++dn) {
          Frag<2> bb;
          frag_bn<LD>(bb, qs, 8 * j, dc0 + 8 * dn, g, t);
          mma3(dka[dn], a, bb);
        }
      }
    }
    __syncthreads();  // every warp is done with Q(u), lse and delta
    if (u + 1 < nu) issue_q(u + 1);
    cp_async_commit();
    if (live) {
#pragma unroll
      for (int j = 0; j < NQ; ++j) {  // dV += P^T dO
        Frag<4> a;
        frag_c(a, st[j]);
#pragma unroll
        for (int dn = 0; dn < DN; ++dn) {
          Frag<2> bb;
          frag_bn<LD>(bb, dos, 8 * j, dc0 + 8 * dn, g, t);
          mma3(dva[dn], a, bb);
        }
      }
    }
    __syncthreads();  // every warp is done with dO(u)
    if (u + 1 < nu) issue_do(u + 1);
    cp_async_commit();
  }
  cp_async_wait<0>();

  float* kout = dk.p + b * dk.sb + hk * dk.sh;
  float* vout = dv.p + b * dv.sb + hk * dv.sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kr[r] >= s.Tk) continue;
    float* krow = kout + (long long)kr[r] * dk.st + dc0;
    float* vrow = vout + (long long)kr[r] * dv.st + dc0;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      put2(krow + 8 * dn + 2 * t, dka[dn][2 * r], dka[dn][2 * r + 1]);
      put2(vrow + 8 * dn + 2 * t, dva[dn][2 * r], dva[dn][2 * r + 1]);
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
constexpr size_t tile_bytes(int rows) {
  return sizeof(float) * rows * pitch<D>();
}

template <int D, bool BAND>
int launch_fwd(View q, View k, View v, OutView o, float* lse,
               Shape s, cudaStream_t stream) {
  const size_t smem = 3 * tile_bytes<D>(kRows);
  cudaError_t err = allow_smem(flash_fwd_tc_kernel<D, BAND>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(s.H, (s.Tq + kRows - 1) / kRows, s.B);
  flash_fwd_tc_kernel<D, BAND><<<grid, kThreads, smem, stream>>>(q, k, v,
                                                                    o, lse, s);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool BAND>
int launch_bwd(View q, View k, View v, View o, View dout,
               const float* lse, float* delta, OutView dq, OutView dk,
               OutView dv, Shape s, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (s.Tq > 0) {  // dq first: it writes the delta the dkv kernel reads
    const size_t smem =
        2 * tile_bytes<D>(kRows) + 2 * tile_bytes<D>(dq_keys<D>());
    err = allow_smem(flash_bwd_dq_tc_kernel<D, BAND>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(s.H, (s.Tq + kRows - 1) / kRows, s.B);
    flash_bwd_dq_tc_kernel<D, BAND>
        <<<grid, kThreads * bwd_halves<D>(), smem, stream>>>(
            q, k, v, o, dout, lse, delta, dq, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (s.Tk > 0) {
    const size_t smem = 2 * tile_bytes<D>(kRows) +
                        2 * tile_bytes<D>(dkv_queries<D>()) +
                        2 * sizeof(float) * dkv_queries<D>();
    err = allow_smem(flash_bwd_dkv_tc_kernel<D, BAND>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(s.Hkv, (s.Tk + kRows - 1) / kRows, s.B);
    flash_bwd_dkv_tc_kernel<D, BAND>
        <<<grid, kThreads * bwd_halves<D>(), smem, stream>>>(
            q, k, v, dout, lse, delta, dk, dv, s);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// strides of n views: each a multiple of 16 bytes
bool strides_ok(const long long* st, int n) {
  for (int i = 0; i < 3 * n; ++i)
    if (st[i] * static_cast<long long>(sizeof(float)) % 16 != 0) return false;
  return true;
}

View view(const void* p, const long long* st) {
  return View{static_cast<const float*>(p), st[0], st[1], st[2]};
}

OutView out_view(const void* p, const long long* st) {
  return OutView{static_cast<float*>(const_cast<void*>(p)), st[0], st[1],
                 st[2]};
}

bool shape_ok(const int* dims) {
  const int B = dims[0], H = dims[1], Hkv = dims[2], Tq = dims[3],
            Tk = dims[4], D = dims[5];
  return B >= 0 && Tq >= 0 && Tk >= 0 && H > 0 && Hkv > 0 && H % Hkv == 0 &&
         H <= 65535 && B <= 65535 && (D == 64 || D == 128 || D == 256);
}

Shape make_shape(const int* dims, float scale, const void* kv_mask) {
  return Shape{dims[0], dims[1], dims[2], dims[3], dims[4],
               dims[6], dims[7], dims[8], scale,
               static_cast<const uint8_t*>(kv_mask)};
}

int fwd_entry(const void* const* ptrs, const long long* strides,
              const int* dims, float scale, void* stream) {
  if (!shape_ok(dims) || !strides_ok(strides, 4))
    return cudaErrorInvalidValue;
  const int dense[] = {0, 1, 2, 4};
  for (int i : dense)
    if (!aligned(ptrs[i])) return cudaErrorMisalignedAddress;
  const Shape s = make_shape(dims, scale, ptrs[3]);
  if (s.B == 0 || s.Tq == 0) return 0;
  const View q = view(ptrs[0], strides),
                k = view(ptrs[1], strides + 3),
                v = view(ptrs[2], strides + 6);
  const OutView o = out_view(ptrs[4], strides + 9);
  float* lse = static_cast<float*>(const_cast<void*>(ptrs[5]));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool band = s.causal || s.window > 0;
  switch (dims[5]) {
    case 64:
      return band ? launch_fwd<64, true>(q, k, v, o, lse, s, st)
                  : launch_fwd<64, false>(q, k, v, o, lse, s, st);
    case 128:
      return band ? launch_fwd<128, true>(q, k, v, o, lse, s, st)
                  : launch_fwd<128, false>(q, k, v, o, lse, s, st);
    default:
      return band ? launch_fwd<256, true>(q, k, v, o, lse, s, st)
                  : launch_fwd<256, false>(q, k, v, o, lse, s, st);
  }
}

int bwd_entry(const void* const* ptrs, const long long* strides,
              const int* dims, float scale, void* stream) {
  if (!shape_ok(dims) || !strides_ok(strides, 8))
    return cudaErrorInvalidValue;
  const int dense[] = {0, 1, 2, 3, 7, 8, 9, 10};
  for (int i : dense)
    if (!aligned(ptrs[i])) return cudaErrorMisalignedAddress;
  const Shape s = make_shape(dims, scale, ptrs[5]);
  if (s.B == 0) return 0;
  const View q = view(ptrs[0], strides),
                k = view(ptrs[1], strides + 3),
                v = view(ptrs[2], strides + 6),
                dout = view(ptrs[3], strides + 9),
                o = view(ptrs[10], strides + 21);
  const OutView dq = out_view(ptrs[7], strides + 12),
                   dk = out_view(ptrs[8], strides + 15),
                   dv = out_view(ptrs[9], strides + 18);
  const float* lse = static_cast<const float*>(ptrs[4]);
  float* delta = static_cast<float*>(const_cast<void*>(ptrs[6]));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool band = s.causal || s.window > 0;
  switch (dims[5]) {
    case 64:
      return band ? launch_bwd<64, true>(q, k, v, o, dout, lse, delta, dq,
                                         dk, dv, s, st)
                  : launch_bwd<64, false>(q, k, v, o, dout, lse, delta, dq,
                                          dk, dv, s, st);
    case 128:
      return band ? launch_bwd<128, true>(q, k, v, o, dout, lse, delta, dq,
                                          dk, dv, s, st)
                  : launch_bwd<128, false>(q, k, v, o, dout, lse, delta, dq,
                                           dk, dv, s, st);
    default:
      return band ? launch_bwd<256, true>(q, k, v, o, dout, lse, delta, dq,
                                          dk, dv, s, st)
                  : launch_bwd<256, false>(q, k, v, o, dout, lse, delta, dq,
                                           dk, dv, s, st);
  }
}

}  // namespace

extern "C" {

// Forward. The arguments are tl_flash_fwd's (flash_attention.cu): ptrs =
// {q, k, v, kv_mask (or null), o, lse}; strides = (b, h, t) element strides
// of the views q, k, v, o (12 values); dims = {B, H, Hkv, Tq, Tk, D, causal,
// window (<= 0: none), delta_in (0 here)}. f32 q/k/v/o and lse [B, H, Tq]
// contiguous, uint8 kv_mask [B, Tk] contiguous; 16-byte aligned base
// pointers and strides. Returns a cudaError_t (0 = launched).
int tl_flash_fwd_f32(const void* const* ptrs, const long long* strides,
                     const int* dims, float scale, void* stream) {
  return fwd_entry(ptrs, strides, dims, scale, stream);
}

// Backward. The arguments are tl_flash_bwd's: ptrs = {q, k, v, do, lse,
// kv_mask (or null), delta (f32 [B, H, Tq] contiguous), dq, dk, dv, o};
// strides of q, k, v, do, dq, dk, dv, o (24 values); dims as for the
// forward. delta_in 0: delta is a workspace the dq kernel fills with
// rowsum(p dp), and o centres its one-pass sums; 1: the caller's delta,
// read by both kernels (o is then not read).
int tl_flash_bwd_f32(const void* const* ptrs, const long long* strides,
                     const int* dims, float scale, void* stream) {
  return bwd_entry(ptrs, strides, dims, scale, stream);
}

const char* tl_flash_f32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
