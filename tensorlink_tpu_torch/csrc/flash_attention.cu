// Flash attention forward (B1) and backward (B2) on 16-bit tensor cores
// (sm_90a), for bf16 and f16 operands (one source, two instantiations).
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
// Design.
// - Forward (B1), on Hopper's warpgroup tensor cores: one block per (query
//   tile of 64 rows, head, batch row). A producer warp loads the Q tile
//   once and streams the K and V tiles of the block's band (the loop
//   bounds replace the TPU grid's block skipping) by TMA into a 2-3 stage
//   ring of 128-byte-swizzled shared memory, with full/empty mbarriers;
//   setmaxnreg hands its registers to the consumer warpgroup, which owns
//   the 64 query rows: S = Q K^T and O += P V run on wgmma (m64n64k16
//   from shared memory; P from registers, V read MN-major, n128 twice at
//   D 256), the online
//   softmax in registers between them. TMA zero-fills rows past T. Key tiles whose keys are all masked
//   are neither loaded nor multiplied, the positional test is compiled in
//   only under a band and run only on the tiles its edge crosses, and
//   causal grids launch their heaviest query tiles first. PTX by hand
//   (wgmma_common.cuh), no CUTLASS. At D 256 the consumer's O tile is
//   128 f32 registers a thread, so a block takes the SM alone (two
//   stages, 160 KB of tiles, up to 255 registers a thread, no
//   setmaxnreg hand-over).
// - The backward (B2) runs on mma.sync m16n8k16 (16-bit in, f32 accumulate),
//   with operand fragments read from padded shared-memory tiles by
//   ldmatrix (mma_common.cuh); the softmax state and every accumulator stay
//   in registers in f32.
// - Backward, dq kernel (one block per query tile of 64): ONE pass over the
//   key tiles, where the first design walked them twice (a pass just for
//   delta = rowsum(p * dp)). It recomputes S and dP = dO V^T on the tensor
//   cores and p = exp(s - lse), and accumulates the exact delta, C = P K and
//   A = (P o (dP - d~)) K, where d~ = rowsum(dO o O) from the forward's
//   16-bit O is only an estimate of delta; then
//   dQ = scale (A - (delta - d~) C), exact for any d~ (see the kernel's
//   note for why d~ is there). delta
//   must come from the kernel's own p and dp: the TPU kernels' rowsum(dO o
//   O) from the bf16-rounded O is off by ~2^-9 |dO||O|, which swamps ds
//   where attention is near uniform and wrecked BERT's upper-layer q/k
//   gradients. The dq kernel publishes delta for the dkv kernel. A caller
//   that sees only part of a row's keys (a ring's block) passes the row's
//   delta instead (delta_in): then it is d~ and the final delta, and
//   nothing is published.
// - Backward, dkv kernel (one block per (key tile of 64, kv head, batch
//   row)): walks the (query head of its GQA group, query tile of 64) units
//   its band reaches: S^T = K Q^T, dP^T = V dO^T, dV += P^T dO,
//   dK += dS^T Q. dK and dV of a GQA group are summed inside the block, so
//   no per-query-head buffer exists. Where a key tile has many units (a
//   long causal GQA band, 4 heads x 32 tiles at Llama's shape) two quads of
//   4 warps take alternate units and add their sums at the end, which
//   halves the longest block's walk; otherwise one quad walks them.
// - Both backward kernels stage the next tile while the current one is used:
//   cp.async 16-byte copies into a two-stage ring (K/V tiles in the dq
//   kernel; Q, dO, lse and delta tiles in the dkv kernel). Causal grids
//   launch their heaviest tiles first. A key tile whose keys are all masked
//   (padding) is skipped. Kernels without a causal or window band compile
//   the positional test out. ptxas caps registers for two blocks an SM at
//   D 128 and three at D 64 (scoring half a tile at a time where the
//   accumulators need the room); chip_smoke.py's [build] lines print the
//   register and spill report, and the forward's HGMMA count.
// - D 256 in the backward: a warp's two [16, D] accumulators would be 256
//   f32 registers a thread, beyond the 255 a thread can hold. So blocks
//   take 8 warps, two to each 16-row strip (queries in dq, keys in dkv):
//   both warps of a pair form the strip's whole S and dP (full-D dot
//   products, the same values in both), and each accumulates the outputs
//   (A and C, or dK and dV) of one half of D's columns. That repeats S and
//   dP (6 products a tile pair where D <= 128 does 4) for a register plan
//   that fits; one block an SM (about 200 KB of tiles). The dkv kernel
//   keeps one quad of units at D 256.
// Ragged edges (T not a multiple of a tile) are zero-filled in shared
// memory and masked; D is 64, 128 or 256 (the wrapper zero-pads any other
// D <= 256 to the next of them and passes the true D's scale).
//
// The storage type T is bf16 or f16 (tl_flash_* and tl_flash_*_f16). Both
// run at the card's 16-bit tensor rate; only the mma/wgmma type string,
// the TMA element type and the packing of f32 values differ (mma<T> and
// pack2<T> in mma_common.cuh, the wgmma forms in wgmma_common.cuh). Every
// sum is f32, as in the Pallas kernels, which keep p, dp and ds in f32.
// f16 has more precision than bf16 (11 significant bits against 8) but
// not its range: below 2^-14 it loses bits and below 2^-24 it is zero. P
// is in [0, 1] and is packed as bf16's is (about 2^-12 relative, under
// o's own rounding). The backward's packed dS-like operands (P o (dP -
// d~) in the dq kernel, dS in the dkv kernel) scale with dO and shrink
// where attention is near uniform, so in f16 they would fall below 2^-14
// and lose bits, or underflow: each row of such an operand (a query row
// in dq, a key row in dkv, the rows of the accumulator it feeds) is
// multiplied by a power of two before it is rounded, chosen from the
// tile's own values so that the row's largest lands in [2^14, 2^15), and
// the row's f32 accumulator is divided by it at the end. When a later
// tile's values are larger, the row's factor shrinks and its accumulator
// is scaled by the ratio first (exact: powers of two), as the online
// softmax rescales O. No host read and no pass before the kernel.
//
// What bounds it on this card: 4 D flops per attended (query, key) pair
// forward and at least 10 D backward (this backward does 16 D: S and dP are
// formed in both kernels), against reading q, k, v (and do) and writing o
// (or dq, dk, dv) once. At BERT-base's training shape (T 512, D 64, a
// padding mask) the forward's least time is set by those bytes and the
// backward's by the tensor cores; at a long causal sequence (T 2048, D 128)
// by the tensor cores both ways. Not used yet in the backward: wgmma, TMA
// and warp specialisation (its 8 products per tile pair are where wgmma
// would pay next).

#include "mma_common.cuh"
#include "wgmma_common.cuh"

namespace {

using namespace tlk;

constexpr int kThreads = 128;  // 4 warps
constexpr int kBQ = 64;        // dq: query rows per block
constexpr int kBK = 64;        // key rows per tile (dkv: per block)
constexpr int kBQd = 64;       // dkv: query rows per staged tile
constexpr float kLseMasked = 1e30f;

template <typename T>
struct View {  // a [B, heads, T, D] operand; strides in elements, D contiguous
  const T* p;
  long long sb, sh, st;
};

template <typename T>
struct OutView {
  T* p;
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

// --------------------------------------------------------------- forward
// Warp-specialized on wgmma and TMA. A block owns kFwdRows query rows of
// one (head, batch row): warpgroup 0 is the producer, whose first warp
// loads the Q tile once and then walks the key tiles (kFwdBK keys) of the
// block's band into a ring of FwdLayout::kStages stages by TMA, each stage
// a K tile and a V tile on one full barrier; warpgroup 1, the consumer,
// owns the rows. For every key tile the consumer forms S = Q K^T with
// wgmma (both operands K-major in shared memory), folds it into the
// online softmax in registers, and adds P V with wgmma, P packed from the
// score accumulators into wgmma's register A operand and V read MN-major
// (the transpose bit); then it releases the stage on its empty barrier.
// Two blocks share an SM, so one block's softmax runs under the other's
// products. A 128-row block (two consumer warpgroups sharing each K/V
// tile, one block an SM) read slower at every shape timed (PERF.md), so
// the forward's query tile is 64 rows, the same as KERNEL_BLOCK. The
// producer also turns the tile's kv_mask (and Tk) into 64 keep bits,
// published with the stage; a tile with no kept key is neither loaded nor
// multiplied, and the consumer skips the tiles its rows cannot reach. The softmax is branch-free per score: the band becomes a
// bit range per row and tile (BAND compiles it in), and exp2 is one MUFU
// op. Keeping P V in flight under the next tile's softmax (tried) read
// slower at every shape timed, so each tile's products complete in turn.
constexpr int kFwdRows = 64;  // query rows a block (one wgmma M)
constexpr int kFwdBK = 64;    // keys per stage

template <int D>
struct FwdLayout {
  static constexpr int kQBytes = kFwdRows * D * 2;    // Q tile
  static constexpr int kKVBytes = kFwdBK * D * 2;     // one K or V tile
  // two blocks an SM: three stages fit at D 64, two at D 128; at D 256
  // one block an SM with two stages (Q and the ring: 160 KB)
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kRing = kStages * 2 * kKVBytes;
  static constexpr int kBars = 1 + 2 * kStages;  // q_full, full[], empty[]
  // 1024 bytes of slack to align the tiles to the swizzle atom
  static constexpr size_t kSmem =
      1024 + kQBytes + kRing + 8 * kBars + 8 * kStages;
};

// 2^x in one MUFU op, subnormal results flushed to zero (x = -1e30 gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// keys k0 .. k0 + 63 that query q may attend under the band, as bits
// (bit i: key k0 + i); computed once a row a tile, so the per-score test
// below is one bit, not a branchy positional test
__device__ __forceinline__ uint64_t band_bits(int q, int k0, int causal,
                                              int window) {
  int lo = 0, hi = kFwdBK - 1;  // kept key offsets [lo, hi]
  if (causal) hi = min(hi, q - k0);
  if (window > 0) {
    lo = max(lo, q - window + 1 - k0);
    if (!causal) hi = min(hi, q + window - 1 - k0);
  }
  const uint64_t upto = hi >= 63 ? ~0ull : (2ull << max(hi, 0)) - 1;
  const uint64_t from = ~0ull << min(lo, 63);
  return hi < lo ? 0ull : (upto & from);
}

// One tile of the online softmax, in place: sc holds this thread's S
// scores (accumulator layout: rows qr[e / 2 % 2], keys 8 j + 2 tig +
// e % 2) and becomes P; m (log2 domain) and the partial row sums l are
// updated; alpha gets the factor the O accumulator must be scaled by.
// bits are the tile's kept keys; BAND adds the positional band. Branch-free
// per score.
template <bool BAND>
__device__ __forceinline__ void fwd_softmax(float (&sc)[32], uint64_t bits,
                                            const int (&qr)[2], int k0,
                                            int tig, float sl2,
                                            const Shape& s, float (&m)[2],
                                            float (&l)[2], float (&alpha)[2]) {
  uint64_t tb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    uint64_t rb = bits;
    if (BAND) rb &= band_bits(qr[r], k0, s.causal, s.window);
    tb[r] = rb >> (2 * tig);  // bit 8 j + e % 2: this thread's keys
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const bool keep = (tb[r] >> (8 * j + (e & 1))) & 1ull;
      const float x = keep ? sc[4 * j + e] * sl2 : kNegInf;
      sc[4 * j + e] = x;
      mx[r] = fmaxf(mx[r], x);
    }
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    alpha[r] = ex2(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= alpha[r];  // per-thread partial row sums; summed at the end
    // a row with no kept key yet keeps m = -1e30; its p must be 0, not
    // 2^(-1e30 + 1e30)
    mu[r] = mx[r] == kNegInf ? 0.f : mx[r];
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int r = (e >> 1) & 1;
    const float p = ex2(sc[e] - mu[r]);
    sc[e] = p;
    l[r] += p;
  }
}

template <typename T, int D, bool BAND>
__global__ void __launch_bounds__(256, blocks_per_sm<D>())
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, OutView<T> o,
                     float* __restrict__ lse, Shape s) {
  using L = FwdLayout<D>;
  constexpr int DR = D / 64;  // 128-byte column regions of a tile
  constexpr int ST = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = qs + L::kQBytes;  // stage i: K tile, then V tile
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + L::kRing);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;
  uint32_t* kbits = reinterpret_cast<uint32_t*>(empty + ST);  // [ST][2]

  // causal: the last query tiles see the most keys, so they launch first
  // (blockIdx.y is the slowest-moving index of the launch order)
  const int tile = s.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int b = blockIdx.z, h = blockIdx.x, q0 = tile * kFwdRows;
  int klo, khi;
  key_range(q0, min(q0 + kFwdRows, s.Tq) - 1, s.Tk, s.causal, s.window, klo,
            khi);
  const int kt0 = (klo / kFwdBK) * kFwdBK;
  const int n = khi > kt0 ? (khi - kt0 + kFwdBK - 1) / kFwdBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    // ------------------------------------------------------- producer
    // (at D 256 one block holds the SM: every thread keeps its share)
    if constexpr (blocks_per_sm<D>() == 2) setmaxnreg_dec<40>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    const int hk = h / (s.H / s.Hkv);
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int r = 0; r < DR; ++r)
        tma_load_4d(qs + r * kFwdRows * 128, &tq, q_full, 64 * r, q0, h, b);
    }
    const uint8_t* km =
        s.kv_mask ? s.kv_mask + static_cast<long long>(b) * s.Tk : nullptr;
    for (int i = 0; i < n; ++i) {
      const int st = i % ST;
      const int k0 = kt0 + i * kFwdBK;
      const int ka = k0 + lane, kb = k0 + 32 + lane;
      const uint32_t w0 = __ballot_sync(
          0xffffffffu, ka < s.Tk && (km == nullptr || km[ka] != 0));
      const uint32_t w1 = __ballot_sync(
          0xffffffffu, kb < s.Tk && (km == nullptr || km[kb] != 0));
      if (lane == 0) {
        mbar_wait(empty + st, ((i / ST) & 1) ^ 1);
        kbits[2 * st] = w0;
        kbits[2 * st + 1] = w1;
        if (w0 | w1) {
          unsigned char* ks = ring + st * 2 * L::kKVBytes;
          mbar_arrive_expect_tx(full + st, 2 * L::kKVBytes);
#pragma unroll
          for (int r = 0; r < DR; ++r) {
            tma_load_4d(ks + r * kFwdBK * 128, &tk, full + st, 64 * r, k0,
                        hk, b);
            tma_load_4d(ks + L::kKVBytes + r * kFwdBK * 128, &tv, full + st,
                        64 * r, k0, hk, b);
          }
        } else {
          mbar_arrive(full + st);  // all keys masked: nothing to load
        }
      }
      __syncwarp();
    }
    return;
  }

  // ----------------------------------------------------------- consumers
  // the producer's 128 - 40 registers a thread go to the consumer
  if constexpr (blocks_per_sm<D>() == 2) setmaxnreg_inc<216>();
  const int t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31, gid = lane >> 2, tig = lane & 3;
  const int qr[2] = {q0 + warp * 16 + gid, q0 + warp * 16 + gid + 8};
  const float sl2 = s.scale * kLog2e;  // scores in the log2 domain
  const uint32_t q_addr = smem_u32(qs);

  float acc[D / 2];  // O: [64, D] of the warpgroup, f32
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int i = 0; i < n; ++i) {
    const int st = i % ST;
    const int k0 = kt0 + i * kFwdBK;
    mbar_wait(full + st, (i / ST) & 1);
    const uint64_t bits = (static_cast<uint64_t>(kbits[2 * st + 1]) << 32) |
                          kbits[2 * st];
    // no pair of the block's rows [q0, q0 + 63] and the tile's keys inside
    // the band
    const bool dead =
        BAND && ((s.causal && k0 > q0 + 63) ||
                 (s.window > 0 && (k0 + kFwdBK - 1 <= q0 - s.window ||
                                   (!s.causal && k0 >= q0 + 63 + s.window))));
    if (bits != 0 && !dead) {
      const uint32_t k_addr = smem_u32(ring + st * 2 * L::kKVBytes);
      const uint32_t v_addr = k_addr + L::kKVBytes;
      float sc[32];  // S: [64, kFwdBK]
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_m64n64k16<T>(
            sc,
            desc_sw128(q_addr + (kk / 4) * kFwdRows * 128 + (kk % 4) * 32,
                       16, 1024),
            desc_sw128(k_addr + (kk / 4) * kFwdBK * 128 + (kk % 4) * 32, 16,
                       1024),
            kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      float alpha[2];
      fwd_softmax<BAND>(sc, bits, qr, k0, tig, sl2, s, m, l, alpha);
#pragma unroll
      for (int e = 0; e < D / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];
      // O += P V: score n-tiles 2j, 2j + 1 are the A operand of k-step j
      uint32_t pa[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pa[j][0] = pack2<T>(sc[8 * j + 0], sc[8 * j + 1]);
        pa[j][1] = pack2<T>(sc[8 * j + 2], sc[8 * j + 3]);
        pa[j][2] = pack2<T>(sc[8 * j + 4], sc[8 * j + 5]);
        pa[j][3] = pack2<T>(sc[8 * j + 6], sc[8 * j + 7]);
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint64_t dv = desc_sw128(v_addr + j * 2048, kFwdBK * 128, 1024);
        if constexpr (D == 64) {
          wgmma_rs_m64n64k16_tb<T>(acc, pa[j], dv, 1);
        } else if constexpr (D == 128) {
          wgmma_rs_m64n128k16_tb<T>(acc, pa[j], dv, 1);
        } else {  // D 256: columns 0-127 (regions 0, 1), then 128-255
          using Half = float[64];
          wgmma_rs_m64n128k16_tb<T>(*reinterpret_cast<Half*>(acc), pa[j],
                                    dv, 1);
          wgmma_rs_m64n128k16_tb<T>(
              *reinterpret_cast<Half*>(acc + 64), pa[j],
              desc_sw128(v_addr + 2 * kFwdBK * 128 + j * 2048, kFwdBK * 128,
                         1024),
              1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int j = 0; j < 4; ++j) fence_regs(pa[j]);
    }
    if (lane == 0) mbar_arrive(empty + st);  // the stage may be refilled
  }

  T* ob = o.p + b * o.sb + h * o.sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    if (qr[r] >= s.Tq) continue;
    const float inv = lr > 0.f ? 1.f / lr : 0.f;
    T* row = ob + static_cast<long long>(qr[r]) * o.st;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + j * 8 + 2 * tig) =
          pack2<T>(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    if (tig == 0)
      lse[(static_cast<long long>(b) * s.H + h) * s.Tq + qr[r]] =
          lr > 0.f ? (m[r] + log2f(lr)) * kLn2 : kLseMasked;
  }
}

// -------------------------------------------------------------- backward
// rows r0..r0+ROWS-1 of a [T, D] slab into a padded tile with cp.async;
// rows at or past T are zero-filled
template <int D, int ROWS, int NTH = kThreads, typename T>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src,
                                                long long st, int r0, int n) {
  constexpr int LD = D + 8, CH = D / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += NTH) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * LD + c,
               ok ? src + static_cast<long long>(r0 + r) * st + c : src,
               ok ? 16 : 0);
  }
}

// dq in one pass over the key tiles. With p = exp(s - lse), dp = dO V^T and
// the row's delta = sum_k p dp, dQ = scale * sum_k p (dp - delta) k. delta
// is only known after the last key tile, so the pass centres dp on an
// estimate d~ = rowsum(dO o O) taken from the forward's bf16 O before it
// starts, and accumulates A = sum_k p (dp - d~) k, C = sum_k p k and the
// exact delta = sum_k p dp, in f32 from the kernel's own p and dp; then
// dQ = scale * (A - (delta - d~) C), which is exact for any d~. The
// centring keeps A's bf16 operand as small as ds itself: with d~ = 0 the
// operand p dp carries a rounding error of 2^-9 |p dp| that does not
// cancel, and it made BERT's upper-layer q gradients 4.6x noisier than
// the plain path's. delta is published for the dkv kernel. BAND (causal or
// a window) compiles the positional test in; without it a key's keep is
// one bit of the tile's mask. In f16 each row's operand P o (dP - d~) is
// scaled by its factor fr (f16_scale_rows) and A divided by it at the end.
// At D 256 the two warps of a query strip each keep A and C for half of
// D's columns (bwd_halves); the first of them publishes delta.
template <typename T, int D, bool BAND>
__global__ void __launch_bounds__(kThreads * bwd_halves<D>(),
                                  D == 64 ? 3 : (D == 128 ? 2 : 1))
    flash_bwd_dq_kernel(View<T> q, View<T> k, View<T> v, View<T> o,
                        View<T> dout, const float* __restrict__ lse,
                        float* __restrict__ delta, OutView<T> dq, Shape s) {
  constexpr int LD = D + 8, KS = D / 16;
  constexpr int NTH = kThreads * bwd_halves<D>();
  constexpr int DH = D / bwd_halves<D>();  // output columns a warp holds
  constexpr int DT = DH / 8;
  // keys scored at a time: at D 128 (and 256) half a tile keeps the two
  // [16, DH] accumulators and the score fragments inside the register
  // file; at D 64 three blocks share an SM (ptxas caps registers at 168)
  constexpr int KSUB = D == 64 ? 64 : 32;
  constexpr int NT = KSUB / 8;
  constexpr int STAGE = 2 * kBK * LD;  // K and V tiles
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + kBQ * LD;
  T* ring = dos + kBQ * LD;  // [2][K tile, V tile]
  uint8_t* keep_ring = reinterpret_cast<uint8_t*>(ring + 2 * STAGE);

  // causal: the last query tiles see the most keys, so they launch first
  // (blockIdx.y is the slowest-moving index of the launch order)
  const int tile = s.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int b = blockIdx.z, h = blockIdx.x, q0 = tile * kBQ;
  const int hk = h / (s.H / s.Hkv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const T* kb = k.p + b * k.sb + hk * k.sh;
  const T* vb = v.p + b * v.sb + hk * v.sh;
  const uint8_t* km =
      s.kv_mask ? s.kv_mask + static_cast<long long>(b) * s.Tk : nullptr;
  // the warp's query strip, and the half of D's columns it accumulates
  const int rw = warp & 3, half = warp >> 2, dc0 = half * DH;
  const int qr[2] = {q0 + rw * 16 + gid, q0 + rw * 16 + gid + 8};
  const float sl2 = s.scale * kLog2e;
  const long long rowbase = (static_cast<long long>(b) * s.H + h) * s.Tq;
  float lse2[2], dl[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r)
    lse2[r] = qr[r] < s.Tq ? lse[rowbase + qr[r]] * kLog2e : kLseMasked;

  load_tile_async<D, kBQ, NTH>(qs, q.p + b * q.sb + h * q.sh, q.st, q0,
                               s.Tq);
  // d~ of this thread's two rows: each lane of the quad dots a quarter
  float dt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (s.delta_in) {  // the caller's delta is exact: it is the centre
      dt[r] = qr[r] < s.Tq ? delta[rowbase + qr[r]] : 0.f;
      continue;
    }
    float acc = 0.f;
    if (qr[r] < s.Tq) {
      const long long off = qr[r];
      const T* orow = o.p + b * o.sb + h * o.sh + off * o.st + tig * (D / 4);
      const T* grow =
          dout.p + b * dout.sb + h * dout.sh + off * dout.st + tig * (D / 4);
#pragma unroll
      for (int c = 0; c < D / 4; c += 8) {
        const uint4 ov = __ldg(reinterpret_cast<const uint4*>(orow + c));
        const uint4 gv = __ldg(reinterpret_cast<const uint4*>(grow + c));
        const uint32_t o4[4] = {ov.x, ov.y, ov.z, ov.w};
        const uint32_t g4[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 of = unpack2<T>(o4[i]);
          const float2 gf = unpack2<T>(g4[i]);
          acc = fmaf(of.x, gf.x, fmaf(of.y, gf.y, acc));
        }
      }
    }
    dt[r] = quad_sum(acc);
  }
  load_tile_async<D, kBQ, NTH>(dos, dout.p + b * dout.sb + h * dout.sh,
                               dout.st, q0, s.Tq);

  int klo, khi;
  key_range(q0, q0 + kBQ - 1, s.Tk, s.causal, s.window, klo, khi);
  const int kt0 = (klo / kBK) * kBK;
  const int n = khi > kt0 ? (khi - kt0 + kBK - 1) / kBK : 0;
  auto issue = [&](int i) {
    T* ks = ring + (i & 1) * STAGE;
    const int k0 = kt0 + i * kBK;
    load_tile_async<D, kBK, NTH>(ks, kb, k.st, k0, s.Tk);
    load_tile_async<D, kBK, NTH>(ks + kBK * LD, vb, v.st, k0, s.Tk);
    if (threadIdx.x < kBK) {
      const int kk = k0 + threadIdx.x;
      keep_ring[(i & 1) * kBK + threadIdx.x] =
          kk < s.Tk && (km == nullptr || km[kk] != 0);
    }
  };

  float acc_a[DT][4], acc_c[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_a[i][e] = acc_c[i][e] = 0.f;
  float fr[2] = {kNoScale, kNoScale};  // f16: the rows' operand factors

  if (n > 0) issue(0);
  cp_async_commit();  // with the Q and dO tiles
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile i (and Q, dO) has landed
    __syncthreads();
    const T* ks = ring + (i & 1) * STAGE;
    const T* vs = ks + kBK * LD;
    const uint8_t* keep_s = keep_ring + (i & 1) * kBK;
    const int k0 = kt0 + i * kBK;
    // the tile's key mask as bits; a tile whose keys are all masked
    // (padding) adds nothing
    const uint32_t kbits[2] = {__ballot_sync(0xffffffffu, keep_s[lane]),
                               __ballot_sync(0xffffffffu, keep_s[lane + 32])};
#pragma unroll 1
    for (int c0 = 0; (kbits[0] | kbits[1]) && c0 < kBK; c0 += KSUB) {
      float sc[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4], ad[4];
        ldsm_x4(a, frag_a<LD>(qs, rw * 16, kk * 16, lane));
        ldsm_x4(ad, frag_a<LD>(dos, rw * 16, kk * 16, lane));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bb[4];
          ldsm_x4(bb, frag_b<LD>(ks, c0 + np * 16, kk * 16, lane));
          mma<T>(sc[2 * np], a, bb[0], bb[1]);
          mma<T>(sc[2 * np + 1], a, bb[2], bb[3]);
          ldsm_x4(bb, frag_b<LD>(vs, c0 + np * 16, kk * 16, lane));
          mma<T>(dp[2 * np], ad, bb[0], bb[1]);
          mma<T>(dp[2 * np + 1], ad, bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, kl = c0 + j * 8 + 2 * tig + (e & 1);
          bool keep = (kbits[kl >> 5] >> (kl & 31)) & 1u;
          if (BAND) keep = keep && band_keep(qr[r], k0 + kl, s.causal, s.window);
          const float p = keep ? exp2f(sc[j][e] * sl2 - lse2[r]) : 0.f;
          dl[r] += p * dp[j][e];
          sc[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dt[r]);
        }
      if constexpr (kIsF16<T>) f16_scale_rows(dp, fr, acc_a);
      // C += P K, A += (P o (dP - d~)) K (K read transposed: k-rows are keys)
#pragma unroll
      for (int j = 0; j < KSUB / 16; ++j) {
        uint32_t pc[4], pd[4];
        pack_a<T>(pc, sc[2 * j], sc[2 * j + 1]);
        pack_a<T>(pd, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
        for (int dd = 0; dd < DT / 2; ++dd) {
          uint32_t bb[4];
          ldsm_x4_t(bb, frag_a<LD>(ks, c0 + j * 16, dc0 + dd * 16, lane));
          mma<T>(acc_c[2 * dd], pc, bb[0], bb[1]);
          mma<T>(acc_c[2 * dd + 1], pc, bb[2], bb[3]);
          mma<T>(acc_a[2 * dd], pd, bb[0], bb[1]);
          mma<T>(acc_a[2 * dd + 1], pd, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // tile i is consumed before it is refilled
  }
  cp_async_wait<0>();

  T* out = dq.p + b * dq.sb + h * dq.sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dl[r] = quad_sum(dl[r]);
    if (qr[r] >= s.Tq) continue;
    if (s.delta_in)
      dl[r] = dt[r];  // the whole row's delta, whatever keys this call saw
    else if (tig == 0 && half == 0)
      delta[rowbase + qr[r]] = dl[r];
    const float ia = kIsF16<T> ? 1.f / fr[r] : 1.f;  // a power of two: exact
    T* row = out + static_cast<long long>(qr[r]) * dq.st + dc0;
#pragma unroll
    for (int i = 0; i < DT; ++i)
      *reinterpret_cast<uint32_t*>(row + i * 8 + 2 * tig) = pack2<T>(
          s.scale * (acc_a[i][2 * r] * ia - (dl[r] - dt[r]) * acc_c[i][2 * r]),
          s.scale * (acc_a[i][2 * r + 1] * ia -
                     (dl[r] - dt[r]) * acc_c[i][2 * r + 1]));
  }
}

// dK and dV of one (key tile of 64, kv head, batch row), over the
// (query head of the GQA group, query tile) units its band reaches. With
// QUADS = 2 the units are dealt to two quads of 4 warps in turn, so a long
// causal GQA band runs two units at a time; each warp owns 16 key rows and
// the two quads' sums of the same rows are added through shared memory at
// the end. With QUADS = 1 (few units a block) one quad walks them all and
// two (D 128) or three (D 64) blocks share an SM. In f16 each key row of
// dS is scaled by its factor fk (f16_scale_rows) and dK divided by it at
// the end (each quad keeps its own factors). At D 256 (one quad) the two
// warps of a key strip each keep dK and dV for half of D's columns.
template <typename T, int D, int QUADS, bool BAND>
__global__ void __launch_bounds__(
    128 * QUADS * bwd_halves<D>(),
    QUADS == 2 ? 1 : (D == 64 ? 3 : (D == 128 ? 2 : 1)))
    flash_bwd_dkv_kernel(View<T> q, View<T> k, View<T> v, View<T> dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, OutView<T> dk,
                         OutView<T> dv, Shape s) {
  static_assert(QUADS == 1 || bwd_halves<D>() == 1,
                "two quads of units or two halves of D, not both");
  constexpr int LD = D + 8, KS = D / 16;
  constexpr int DH = D / bwd_halves<D>();  // output columns a warp holds
  constexpr int DT = DH / 8;
  // queries scored at a time: half a unit's tile, for the register file's
  // sake (dK and dV accumulators are [16, D] each)
  constexpr int QSUB = 32;
  constexpr int NQ = QSUB / 8;
  constexpr int TILE = 2 * kBQd * LD;  // Q and dO rows of one unit
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kBK * LD;
  constexpr int NTH = 128 * QUADS * bwd_halves<D>();
  T* ring = vs + kBK * LD;  // [2 stages][QUADS][Q tile, dO tile]
  float* lse_ring =
      reinterpret_cast<float*>(ring + 2 * QUADS * TILE);  // [2][QUADS][kBQd]
  float* dl_ring = lse_ring + 2 * QUADS * kBQd;         // [2][QUADS][kBQd]

  // causal: the first key tiles are seen by the most queries, and launch
  // first (blockIdx.y is the slowest-moving index of the launch order)
  const int b = blockIdx.z, hk = blockIdx.x, k0 = blockIdx.y * kBK;
  const int group = s.H / s.Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int quad = QUADS == 1 ? 0 : warp >> 2, qw = warp & 3;
  const int dc0 = bwd_halves<D>() == 1 ? 0 : (warp >> 2) * DH;
  const int gid = lane >> 2, tig = lane & 3;
  const int kr[2] = {k0 + qw * 16 + gid, k0 + qw * 16 + gid + 8};
  bool kkeep[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    kkeep[r] = kr[r] < s.Tk &&
               (s.kv_mask == nullptr ||
                s.kv_mask[static_cast<long long>(b) * s.Tk + kr[r]] != 0);
  const float sl2 = s.scale * kLog2e;

  load_tile_async<D, kBK, NTH>(ks, k.p + b * k.sb + hk * k.sh, k.st,
                                       k0, s.Tk);
  load_tile_async<D, kBK, NTH>(vs, v.p + b * v.sb + hk * v.sh, v.st,
                                       k0, s.Tk);

  int qlo, qhi;
  query_range(k0, k0 + kBK - 1, s.Tq, s.causal, s.window, qlo, qhi);
  const int qt0 = (qlo / kBQd) * kBQd;
  const int nqt = qhi > qt0 ? (qhi - qt0 + kBQd - 1) / kBQd : 0;
  // a key tile whose keys are all masked (padding) has zero gradients
  const bool any_key = __syncthreads_or(kkeep[0] || kkeep[1]);
  const int n = any_key ? group * nqt : 0;  // units
  const int npairs = (n + QUADS - 1) / QUADS;  // round p: unit QUADS p + quad
  auto issue = [&](int p) {
#pragma unroll
    for (int g = 0; g < QUADS; ++g) {
      const int u = QUADS * p + g;
      if (u >= n) break;
      const int h = hk * group + u / nqt, q0 = qt0 + (u % nqt) * kBQd;
      const int slot = (p & 1) * QUADS + g;
      T* qs = ring + slot * TILE;
      load_tile_async<D, kBQd, NTH>(
          qs, q.p + b * q.sb + h * q.sh, q.st, q0, s.Tq);
      load_tile_async<D, kBQd, NTH>(
          qs + kBQd * LD, dout.p + b * dout.sb + h * dout.sh, dout.st, q0,
          s.Tq);
      if (tid < kBQd) {
        const int qq = q0 + tid;
        const bool in = qq < s.Tq;
        const long long at =
            (static_cast<long long>(b) * s.H + h) * s.Tq + (in ? qq : 0);
        cp_async4(lse_ring + slot * kBQd + tid, lse + at, in ? 4 : 0);
        cp_async4(dl_ring + slot * kBQd + tid, delta + at, in ? 4 : 0);
      }
    }
  };

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;
  float fk[2] = {kNoScale, kNoScale};  // f16: the key rows' dS factors

  if (npairs > 0) issue(0);
  cp_async_commit();  // with the K and V tiles
  for (int p = 0; p < npairs; ++p) {
    if (p + 1 < npairs) issue(p + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int u = QUADS * p + quad;
    if (u < n) {  // quad-uniform
      const int slot = (p & 1) * QUADS + quad;
      const T* qs = ring + slot * TILE;
      const T* dos = qs + kBQd * LD;
      const float* lse_s = lse_ring + slot * kBQd;
      const float* dl_s = dl_ring + slot * kBQd;
      const int q0 = qt0 + (u % nqt) * kBQd;
#pragma unroll 1
      for (int c0 = 0; c0 < kBQd; c0 += QSUB) {
        float sc[NQ][4], dp[NQ][4];
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t a[4], av[4];
          ldsm_x4(a, frag_a<LD>(ks, qw * 16, kk * 16, lane));
          ldsm_x4(av, frag_a<LD>(vs, qw * 16, kk * 16, lane));
#pragma unroll
          for (int np = 0; np < NQ / 2; ++np) {
            uint32_t bb[4];
            ldsm_x4(bb, frag_b<LD>(qs, c0 + np * 16, kk * 16, lane));
            mma<T>(sc[2 * np], a, bb[0], bb[1]);
            mma<T>(sc[2 * np + 1], a, bb[2], bb[3]);
            ldsm_x4(bb, frag_b<LD>(dos, c0 + np * 16, kk * 16, lane));
            mma<T>(dp[2 * np], av, bb[0], bb[1]);
            mma<T>(dp[2 * np + 1], av, bb[2], bb[3]);
          }
        }
        // rows are keys, columns are queries: p^T and ds^T
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, ql = c0 + j * 8 + 2 * tig + (e & 1);
            // a query past Tq needs no test: its zero-filled q, dO and
            // delta make its p finite and its dP, ds and P^T dO zero
            bool keep = kkeep[r];
            if (BAND)
              keep = keep && band_keep(q0 + ql, kr[r], s.causal, s.window);
            const float pv =
                keep ? exp2f(sc[j][e] * sl2 - lse_s[ql] * kLog2e) : 0.f;
            sc[j][e] = pv;
            dp[j][e] = pv * (dp[j][e] - dl_s[ql]) * s.scale;
          }
        if constexpr (kIsF16<T>) f16_scale_rows(dp, fk, dka);
        // dV += P^T dO, dK += dS^T Q (dO and Q read transposed)
#pragma unroll
        for (int j = 0; j < QSUB / 16; ++j) {
          uint32_t ap[4], ad[4];
          pack_a<T>(ap, sc[2 * j], sc[2 * j + 1]);
          pack_a<T>(ad, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
          for (int dd = 0; dd < DT / 2; ++dd) {
            uint32_t bb[4];
            ldsm_x4_t(bb, frag_a<LD>(dos, c0 + j * 16, dc0 + dd * 16, lane));
            mma<T>(dva[2 * dd], ap, bb[0], bb[1]);
            mma<T>(dva[2 * dd + 1], ap, bb[2], bb[3]);
            ldsm_x4_t(bb, frag_a<LD>(qs, c0 + j * 16, dc0 + dd * 16, lane));
            mma<T>(dka[2 * dd], ad, bb[0], bb[1]);
            mma<T>(dka[2 * dd + 1], ad, bb[2], bb[3]);
          }
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // dK unscaled (f16: a power of two, exact)
  float ik[2] = {1.f, 1.f};
  if constexpr (kIsF16<T>)
    for (int r = 0; r < 2; ++r) ik[r] = 1.f / fk[r];
  // quad 1 hands its sums to quad 0 through the (now idle) ring
  float* red = reinterpret_cast<float*>(ring);  // [2][kBK][D]: dk, dv
  if (QUADS == 2 && quad == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qw * 16 + gid + 8 * r;
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        float* pk = red + row * D + i * 8 + 2 * tig;
        float* pv = pk + kBK * D;
        pk[0] = dka[i][2 * r] * ik[r];
        pk[1] = dka[i][2 * r + 1] * ik[r];
        pv[0] = dva[i][2 * r];
        pv[1] = dva[i][2 * r + 1];
      }
    }
  }
  __syncthreads();
  if (quad == 1) return;
  const bool add = QUADS == 2;
  T* kout = dk.p + b * dk.sb + hk * dk.sh;
  T* vout = dv.p + b * dv.sb + hk * dv.sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kr[r] >= s.Tk) continue;
    const int row = qw * 16 + gid + 8 * r;
    T* krow = kout + static_cast<long long>(kr[r]) * dk.st + dc0;
    T* vrow = vout + static_cast<long long>(kr[r]) * dv.st + dc0;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      const float* pk = red + row * D + i * 8 + 2 * tig;
      const float* pv = pk + kBK * D;
      *reinterpret_cast<uint32_t*>(krow + i * 8 + 2 * tig) =
          pack2<T>(dka[i][2 * r] * ik[r] + (add ? pk[0] : 0.f),
                   dka[i][2 * r + 1] * ik[r] + (add ? pk[1] : 0.f));
      *reinterpret_cast<uint32_t*>(vrow + i * 8 + 2 * tig) =
          pack2<T>(dva[i][2 * r] + (add ? pv[0] : 0.f),
                   dva[i][2 * r + 1] + (add ? pv[1] : 0.f));
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

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, taken from the driver the runtime has loaded, so
// the library needs no -lcuda at link time
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiledFn>(nullptr);
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// a [B, heads, T, D] view of T (element strides sb, sh, st; D contiguous)
// as the 4-d tensor map {D, T, heads, B}, read in boxes of 64 columns x
// `rows` rows, 128-byte swizzled; rows past T arrive as zeros
template <typename T>
bool make_map(CUtensorMap* map, const void* p, const long long* st3, int D,
              int T_, int heads, int B, int rows) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(T_),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st3[2]) * 2,
                                 static_cast<cuuint64_t>(st3[1]) * 2,
                                 static_cast<cuuint64_t>(st3[0]) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t es[4] = {1, 1, 1, 1};
  return enc(map,
             kIsF16<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             4, const_cast<void*>(p), dims, strides, box, es,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D, bool BAND>
int launch_fwd(const CUtensorMap& tq, const CUtensorMap& tk,
               const CUtensorMap& tv, OutView<T> o, float* lse, Shape s,
               cudaStream_t stream) {
  using L = FwdLayout<D>;
  cudaError_t err = allow_smem(flash_fwd_kernel<T, D, BAND>, L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(s.H, (s.Tq + kFwdRows - 1) / kFwdRows, s.B);
  flash_fwd_kernel<T, D, BAND><<<grid, 256, L::kSmem, stream>>>(tq, tk, tv,
                                                                o, lse, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_fwd_band(const CUtensorMap& tq, const CUtensorMap& tk,
                    const CUtensorMap& tv, OutView<T> o, float* lse, Shape s,
                    cudaStream_t stream) {
  return s.causal || s.window > 0
             ? launch_fwd<T, D, true>(tq, tk, tv, o, lse, s, stream)
             : launch_fwd<T, D, false>(tq, tk, tv, o, lse, s, stream);
}

constexpr int kDkvTwoQuadUnits = 16;

template <typename T, int D, int QUADS, bool BAND>
cudaError_t launch_dkv(View<T> q, View<T> k, View<T> v, View<T> dout,
                       const float* lse, const float* delta, OutView<T> dk,
                       OutView<T> dv, Shape s, cudaStream_t stream) {
  constexpr int LD = D + 8;
  const size_t smem = sizeof(T) * (2 * kBK + 4 * QUADS * kBQd) * LD +
                      sizeof(float) * 4 * QUADS * kBQd;
  cudaError_t err =
      allow_smem(flash_bwd_dkv_kernel<T, D, QUADS, BAND>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(s.Hkv, (s.Tk + kBK - 1) / kBK, s.B);
  flash_bwd_dkv_kernel<T, D, QUADS, BAND>
      <<<grid, 128 * QUADS * bwd_halves<D>(), smem, stream>>>(
          q, k, v, dout, lse, delta, dk, dv, s);
  return cudaGetLastError();
}

template <typename T, int D, bool BAND>
int launch_bwd(View<T> q, View<T> k, View<T> v, View<T> o, View<T> dout,
               const float* lse, float* delta, OutView<T> dq, OutView<T> dk,
               OutView<T> dv, Shape s, cudaStream_t stream) {
  constexpr int LD = D + 8;
  cudaError_t err = cudaSuccess;
  if (s.Tq > 0) {  // dq first: it writes the delta the dkv kernel reads
    const size_t smem = sizeof(T) * (2 * kBQ + 4 * kBK) * LD + 2 * kBK;
    err = allow_smem(flash_bwd_dq_kernel<T, D, BAND>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(s.H, (s.Tq + kBQ - 1) / kBQ, s.B);
    flash_bwd_dq_kernel<T, D, BAND>
        <<<grid, kThreads * bwd_halves<D>(), smem, stream>>>(
            q, k, v, o, dout, lse, delta, dq, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (s.Tk > 0) {
    // two quads per block when a key tile has many (query head, query
    // tile) units to walk: a long GQA band, where one quad's serial walk
    // would set the kernel's time (at D <= 128: D 256's block is already
    // two halves of 4 warps)
    const int units = (s.H / s.Hkv) * ((s.Tq + kBQd - 1) / kBQd);
    if constexpr (bwd_halves<D>() == 1)
      err = units >= kDkvTwoQuadUnits
                ? launch_dkv<T, D, 2, BAND>(q, k, v, dout, lse, delta, dk,
                                            dv, s, stream)
                : launch_dkv<T, D, 1, BAND>(q, k, v, dout, lse, delta, dk,
                                            dv, s, stream);
    else
      err = launch_dkv<T, D, 1, BAND>(q, k, v, dout, lse, delta, dk, dv, s,
                                      stream);
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

template <typename T>
View<T> view(const void* p, const long long* st) {
  return View<T>{static_cast<const T*>(p), st[0], st[1], st[2]};
}

template <typename T>
OutView<T> out_view(void* p, const long long* st) {
  return OutView<T>{static_cast<T*>(p), st[0], st[1], st[2]};
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

template <typename T>
int fwd_entry(const void* const* ptrs, const long long* strides,
              const int* dims, float scale, void* stream) {
  if (!shape_ok(dims) || !strides_ok(strides, 4)) return cudaErrorInvalidValue;
  const int dense[] = {0, 1, 2, 4};
  for (int i : dense)
    if (!aligned(ptrs[i])) return cudaErrorMisalignedAddress;
  const Shape s = make_shape(dims, scale, ptrs[3]);
  if (s.B == 0 || s.Tq == 0) return 0;
  const int D = dims[5];
  // with no keys (Tk 0) no K/V box is ever loaded; the maps only need to
  // be valid, so they are made over q
  const bool keys = s.Tk > 0;
  CUtensorMap tq, tk, tv;
  if (!make_map<T>(&tq, ptrs[0], strides, D, s.Tq, s.H, s.B, kFwdRows) ||
      !make_map<T>(&tk, keys ? ptrs[1] : ptrs[0],
                   keys ? strides + 3 : strides, D, keys ? s.Tk : s.Tq,
                   keys ? s.Hkv : s.H, s.B, kFwdBK) ||
      !make_map<T>(&tv, keys ? ptrs[2] : ptrs[0],
                   keys ? strides + 6 : strides, D, keys ? s.Tk : s.Tq,
                   keys ? s.Hkv : s.H, s.B, kFwdBK))
    return cudaErrorInvalidValue;
  const OutView<T> o = out_view<T>(const_cast<void*>(ptrs[4]), strides + 9);
  float* lse = static_cast<float*>(const_cast<void*>(ptrs[5]));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_fwd_band<T, 64>(tq, tk, tv, o, lse, s, st);
    case 128:
      return launch_fwd_band<T, 128>(tq, tk, tv, o, lse, s, st);
    default:
      return launch_fwd_band<T, 256>(tq, tk, tv, o, lse, s, st);
  }
}

template <typename T>
int bwd_entry(const void* const* ptrs, const long long* strides,
              const int* dims, float scale, void* stream) {
  if (!shape_ok(dims) || !strides_ok(strides, 8)) return cudaErrorInvalidValue;
  const int dense[] = {0, 1, 2, 3, 7, 8, 9, 10};
  for (int i : dense)
    if (!aligned(ptrs[i])) return cudaErrorMisalignedAddress;
  const Shape s = make_shape(dims, scale, ptrs[5]);
  if (s.B == 0) return 0;
  const View<T> q = view<T>(ptrs[0], strides),
                k = view<T>(ptrs[1], strides + 3),
                v = view<T>(ptrs[2], strides + 6),
                dout = view<T>(ptrs[3], strides + 9),
                o = view<T>(ptrs[10], strides + 21);
  const OutView<T> dq = out_view<T>(const_cast<void*>(ptrs[7]), strides + 12),
                   dk = out_view<T>(const_cast<void*>(ptrs[8]), strides + 15),
                   dv = out_view<T>(const_cast<void*>(ptrs[9]), strides + 18);
  const float* lse = static_cast<const float*>(ptrs[4]);
  float* delta = static_cast<float*>(const_cast<void*>(ptrs[6]));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool band = s.causal || s.window > 0;
  switch (dims[5]) {
    case 64:
      return band ? launch_bwd<T, 64, true>(q, k, v, o, dout, lse, delta, dq,
                                            dk, dv, s, st)
                  : launch_bwd<T, 64, false>(q, k, v, o, dout, lse, delta,
                                             dq, dk, dv, s, st);
    case 128:
      return band ? launch_bwd<T, 128, true>(q, k, v, o, dout, lse, delta,
                                             dq, dk, dv, s, st)
                  : launch_bwd<T, 128, false>(q, k, v, o, dout, lse, delta,
                                              dq, dk, dv, s, st);
    default:
      return band ? launch_bwd<T, 256, true>(q, k, v, o, dout, lse, delta,
                                             dq, dk, dv, s, st)
                  : launch_bwd<T, 256, false>(q, k, v, o, dout, lse, delta,
                                              dq, dk, dv, s, st);
  }
}

}  // namespace

extern "C" {

// Forward. ptrs = {q, k, v, kv_mask (or null), o, lse}; strides = (b, h, t)
// element strides of the [B, heads, T, D] views q, k, v, o (12 values);
// dims = {B, H, Hkv, Tq, Tk, D, causal, window (<= 0: none), delta_in (0
// here)}. q/k/v/o of the entry's type (bf16, or f16 for the _f16 entry),
// f32 lse [B, H, Tq] contiguous, uint8 kv_mask [B, Tk] contiguous. q, k
// and v are read by TMA: 16-byte aligned base pointers and strides.
// Returns a cudaError_t (0 = launched).
int tl_flash_fwd(const void* const* ptrs, const long long* strides,
                 const int* dims, float scale, void* stream) {
  return fwd_entry<bf16>(ptrs, strides, dims, scale, stream);
}

int tl_flash_fwd_f16(const void* const* ptrs, const long long* strides,
                     const int* dims, float scale, void* stream) {
  return fwd_entry<f16>(ptrs, strides, dims, scale, stream);
}

// Backward. ptrs = {q, k, v, do, lse, kv_mask (or null), delta (f32
// [B, H, Tq] contiguous), dq, dk, dv, o (the forward's output)}; strides
// of the views q, k, v, do, dq, dk, dv, o (24 values); dims as for the
// forward. delta_in 0:
// delta is a workspace the dq kernel fills with its own rowsum(p dp); 1:
// delta holds the caller's rowsum(dO o O) of the whole row (a ring's
// merged output, whose keys this call sees only in part), which both
// kernels read and neither writes.
int tl_flash_bwd(const void* const* ptrs, const long long* strides,
                 const int* dims, float scale, void* stream) {
  return bwd_entry<bf16>(ptrs, strides, dims, scale, stream);
}

int tl_flash_bwd_f16(const void* const* ptrs, const long long* strides,
                     const int* dims, float scale, void* stream) {
  return bwd_entry<f16>(ptrs, strides, dims, scale, stream);
}

const char* tl_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

const char* tl_flash_f16_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
