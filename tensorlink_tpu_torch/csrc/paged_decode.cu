// Paged attention read straight from the block table (sm_90a).
//
// Replaces the TPU kernel tensorlink_tpu/ops/pallas/paged_decode.py
// paged_decode_attention (kernel _paged_kernel) and computes what that
// file's paged_decode_reference computes: for query t of row b at logical
// position lengths[b] - T + t, softmax attention over the keys at logical
// positions kpos <= qpos (and kpos > qpos - window when a window is set,
// and mask[b, 0, t | 0, kpos] when a mask is given), with the keys and
// values of logical position p read from pool block block_table[b, p / bs]
// at offset p % bs. GQA reads the unrepeated pools: query head h uses kv
// head h / (H / Hkv). int8 pools are dequantized in-kernel with their
// per-(slot, kv head) f32 scales. A row with no attendable key gives
// exact zeros. Accumulation is f32 throughout; the output takes q's type.
// A block-table entry outside [0, NB) (the sentinel) is never read.
//
// Three variants; the wrapper (ops/paged_decode.py) picks one from the
// dtypes and shapes alone:
//
// decode (bf16 q over bf16 or int8 pools, or f16 q over f16 or int8 pools;
//   D 64 or 128; T * group <= 16 query rows per kv head). What bounds
//   it: the bytes of the live KV pages (2 * live keys * D * sizeof(kv)
//   per (row, kv head)); the flops are
//   ~8 per byte read. Design: one block of 4 warps per (kv head, row, key
//   partition of 256 keys, DECODE_PARTITION in ops/paged_decode.py).
//   Partitions are fixed slices of
//   the view, so the grid never depends on the lengths (no device-to-host
//   read); a block whose partition lies past its row's live range (or
//   below its window) exits at once, and the merge kernel reads only the
//   partitions a row reaches. The block reads its partition's block-table
//   entries into shared memory up front, then streams stages of 64 keys
//   (4 pages of 16) through a ring of 3 shared-memory stages with 16-byte
//   cp.async copies, so two stages are in flight while one is scored; K/V
//   stay in their working type in shared memory (bf16 or f16, or int8). The
//   GQA group's query rows (T * group, padded to 16) are one mma.sync
//   m16n8k16 A tile held in registers; warp w scores keys 16w..16w+15 of
//   each stage against all 16 rows on the tensor cores (S = Q K^T, then
//   O += P V with P straight from the score accumulators) and keeps its own
//   online-softmax state; the 4 warp states merge through shared memory at
//   the end. mma.sync rather than warp-split dot products: one m16n8k16
//   does 16 rows x 8 keys x 16 dims in one instruction where a dot-product
//   warp would spend ~32 FMAs and a shuffle tree per (row, key), and the
//   16-row tile costs nothing extra when the group fills 4 of its rows.
//   int8 pages are read as int8 and widened to q's 16-bit type in
//   registers while the fragments are built (|x| <= 127 is exact in bf16
//   and f16); K's scale multiplies the score of its key, V's scale
//   multiplies p before P is rounded to 16 bits, so dequantization costs
//   no extra pass over the page. In f16 that product can sink below f16's
//   normal range (v_scale is absmax / 127: V of absmax 1e-4 gives p v_scale
//   near 1e-6, where f16 keeps a few bits, and below 2^-24 nothing), so
//   each row of P v_scale is multiplied by a power of two that puts the
//   row's largest value in [2^14, 2^15) before it is rounded
//   (tlk::f16_scale_rows, flash_attention.cu's guard of dS): a later stage
//   with larger values shrinks the factor and scales the row's f32
//   accumulator by the ratio, and the accumulator is divided by the factor
//   at the end (powers of two: exact). The scores and O stay f32.
// prefill (the same types; T * group > 16, group <= 64): B1's tile loop
//   (flash_attention.cu) over the paged view. One block of 4 warps per
//   (64-row query tile of (t, head) pairs of one GQA group, kv head, row,
//   partition); each warp owns 16 rows, holds their Q fragments in
//   registers, and walks key stages of 64 keys built page by page through
//   the block table with cp.async, double-buffered. Causal and window
//   bounds are loop bounds per tile (and skip a warp whose rows cannot see
//   a stage). What bounds it: at the engine's 128-token chunk over a long
//   context, the tensor cores (4 D flops per attended (query, key) pair
//   against D * sizeof(kv) * 2 bytes per key shared by 128 * group rows).
//   Where tiles x kv heads x rows cannot fill the card, each tile's live
//   key range splits evenly (in whole stages) across up to as many blocks
//   as one wave of the card holds, and the same merge kernel combines
//   them; here the split follows the live range, read on the device, so
//   every block has work whatever the row's length.
// general (anything else: f32 q or pools, mixed 16-bit types (f16 q over
//   bf16 pools, bf16 q over f16 pools), other head dims, a mask whose
//   width is not a multiple of 16): the first, scalar design. One block of
//   8 warps per (query tile, kv head, row, split); K/V chunks of 32 keys
//   dequantized into shared memory as f32, lane j scores key j, splits of
//   the live range combined by the same merge kernel.
//
// wgmma is not used: at decode the tile has 16 rows where wgmma needs 64,
// and the bytes bound the kernel; at the prefill chunk wgmma (with TMA
// staging of whole pages) would lift the tensor-core rate above what
// mma.sync reaches, which is work for a later version.
//
// The decode and prefill variants are one template on q's 16-bit type QT
// (bf16 or f16; a pool is QT or int8): the type enters through
// tlk::mma<QT>, pack2<QT>, pack_a<QT> and the int8 widening i8x2_to<QT>.

#include <cuda_fp16.h>

#include "mma_common.cuh"

namespace {

using tlk::bf16;
using tlk::f16;
using tlk::kLog2e;
using tlk::kNegInf;

// ------------------------------------------------------ general variant
constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
constexpr int kKC = 32;                     // keys per chunk: one per lane
constexpr int kMaxRows = 32;                // query rows per block
constexpr int kRowsPerWarp = kMaxRows / kWarps;
constexpr int kMaxD = 256;
constexpr int kDPerLane = kMaxD / kWarp;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Merge the partial states of one (row, query, head), from either
// variant that splits: out = sum_p acc_p 2^(m_p - M) / sum_p l_p 2^(m_p - M),
// M = max_p m_p, with every m in the log2 domain; exact zeros when no key
// is attended. With ``fixed`` (decode) the partitions are fixed kp-key
// slices of the view and only those the row reaches are read (from its
// own length and window; the blocks of the others exited without
// writing); otherwise (prefill, general) every split wrote its state.
template <typename QT>
__global__ void paged_merge_kernel(const float* __restrict__ part,
                                   const int* __restrict__ lengths,
                                   QT* __restrict__ out, int T, int H, int D,
                                   int Lv, int window, int kp, int nsplit,
                                   bool fixed) {
  const size_t id = blockIdx.x;
  int p0 = 0, p1 = nsplit - 1;
  if (fixed) {
    const int b = static_cast<int>(id / (static_cast<size_t>(T) * H));
    const int t = static_cast<int>((id / H) % T);
    const int qpos = lengths[b] - T + t;
    const int kmax = min(qpos, Lv - 1);
    const int kmin = window > 0 ? max(qpos - window + 1, 0) : 0;
    p0 = kmin / kp;
    p1 = kmax < kmin ? p0 - 1 : kmax / kp;
  }
  const float* pp = part + id * nsplit * (D + 2);
  float M = kNegInf;
  for (int p = p0; p <= p1; ++p) M = fmaxf(M, pp[p * (D + 2)]);
  float L = 0.f;
  for (int p = p0; p <= p1; ++p)
    L += pp[p * (D + 2) + 1] * exp2f(pp[p * (D + 2)] - M);
  const float inv = L > 0.f ? 1.f / L : 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float O = 0.f;
    for (int p = p0; p <= p1; ++p)
      O += pp[p * (D + 2) + 2 + d] * exp2f(pp[p * (D + 2)] - M);
    out[id * D + d] = from_f<QT>(O * inv);
  }
}

template <typename QT>
int launch_merge(const float* part, const int* lengths, void* out, int B,
                 int T, int H, int D, int Lv, int window, int kp, int nsplit,
                 bool fixed, cudaStream_t stream) {
  paged_merge_kernel<QT><<<B * T * H, D < 128 ? D : 128, 0, stream>>>(
      part, lengths, static_cast<QT*>(out), T, H, D, Lv, window, kp, nsplit,
      fixed);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads) paged_general_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k,
    const KT* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ block_table,
    const int* __restrict__ lengths, const uint8_t* __restrict__ mask,
    QT* __restrict__ out, float* __restrict__ part, int T, int H, int Hkv,
    int D, int NB, int bs, int MB, int mask_T, int window, int TQ,
    int nsplit, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int group = H / Hkv;
  const int b = blockIdx.z / nsplit;
  const int split = blockIdx.z % nsplit;
  const int hkv = blockIdx.y;
  const int t0 = blockIdx.x * TQ;
  const int tq = min(TQ, T - t0);
  const int nr = tq * group;  // rows of this block: r -> (t0 + r / group,
                              //                          hkv * group + r % group)
  const int Dp = D + 1;       // padded K row: lane j reads row j conflict-free
  const int Lv = MB * bs;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;

  float* qs = smem;                  // [nr][D], pre-scaled
  float* ks = qs + TQ * group * D;   // [kKC][D + 1]
  float* vs = ks + kKC * Dp;         // [kKC][D]
  float* ps = vs + kKC * D;          // [kWarps][kKC] probabilities
  int* kphys = reinterpret_cast<int*>(ps + kWarps * kKC);  // [kKC]

  for (int e = tid; e < nr * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int t = t0 + r / group, h = hkv * group + r % group;
    qs[e] = to_f(q[((static_cast<size_t>(b) * T + t) * H + h) * D + d]) *
            scale;
  }

  const int live = lengths[b];
  const int qpos_lo = live - T + t0;
  const int qpos_hi = qpos_lo + tq - 1;
  const int kmax = min(qpos_hi, Lv - 1);
  const int kmin = window > 0 ? max(qpos_lo - window + 1, 0) : 0;
  // this block's share of the tile's live chunks: the range splits
  // evenly per row, so a short row leaves its later splits empty
  const int j_lo = kmin / kKC, j_hi = kmax >= 0 ? kmax / kKC : -1;
  const int per_split = (j_hi - j_lo + nsplit) / nsplit;
  const int c_begin = (j_lo + split * per_split) * kKC;
  const int c_end = min((j_lo + (split + 1) * per_split) * kKC - 1, kmax);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDPerLane];
#pragma unroll
  for (int ri = 0; ri < kRowsPerWarp; ++ri) {
    m[ri] = kNegInf;
    l[ri] = 0.f;
#pragma unroll
    for (int i = 0; i < kDPerLane; ++i) acc[ri][i] = 0.f;
  }

  for (int c0 = c_begin; c0 <= c_end; c0 += kKC) {
    __syncthreads();  // the previous chunk is consumed (and q is staged)
    if (tid < kKC) {
      const int p = c0 + tid;
      int phys = -1;
      if (p >= kmin && p <= kmax) {
        phys = block_table[static_cast<size_t>(b) * MB + p / bs];
        if (phys < 0 || phys >= NB) phys = -1;  // sentinel: never read
      }
      kphys[tid] = phys;
    }
    __syncthreads();
    for (int e = tid; e < kKC * D; e += kThreads) {
      const int j = e / D, d = e % D;
      const int phys = kphys[j];
      float kv = 0.f, vv = 0.f;
      if (phys >= 0) {
        const size_t slot =
            (static_cast<size_t>(phys) * bs + (c0 + j) % bs) * Hkv + hkv;
        kv = to_f(k[slot * D + d]);
        vv = to_f(v[slot * D + d]);
        if (k_scale != nullptr) {
          kv *= k_scale[slot];
          vv *= v_scale[slot];
        }
      }
      ks[j * Dp + d] = kv;
      vs[j * D + d] = vv;
    }
    __syncthreads();

#pragma unroll
    for (int ri = 0; ri < kRowsPerWarp; ++ri) {
      const int r = warp + ri * kWarps;
      if (r >= nr) continue;  // warp-uniform
      const int t = t0 + r / group;
      const int qpos = live - T + t;
      if (c0 > qpos) continue;  // chunk wholly after this query
      if (window > 0 && c0 + kKC - 1 <= qpos - window) continue;  // below band
      const int p = c0 + lane;
      bool keep = kphys[lane] >= 0 && p <= qpos &&
                  (window <= 0 || p > qpos - window);
      if (keep && mask != nullptr) {
        const int tm = mask_T == 1 ? 0 : t;
        keep = mask[(static_cast<size_t>(b) * mask_T + tm) * Lv + p] != 0;
      }
      float s = kNegInf;
      if (keep) {
        const float* qr = qs + r * D;
        const float* kr = ks + lane * Dp;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot;
      }
      const float m_new = fmaxf(m[ri], warp_max(s));
      const float pj = keep ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[ri] - m_new);
      l[ri] = alpha * l[ri] + warp_sum(pj);
      m[ri] = m_new;
      ps[warp * kKC + lane] = pj;
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kDPerLane; ++i) {
        const int d = lane + i * kWarp;
        if (d < D) {
          float a = acc[ri][i] * alpha;
          for (int j = 0; j < kKC; ++j)
            a = fmaf(ps[warp * kKC + j], vs[j * D + d], a);
          acc[ri][i] = a;
        }
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int ri = 0; ri < kRowsPerWarp; ++ri) {
    const int r = warp + ri * kWarps;
    if (r >= nr) continue;
    const int t = t0 + r / group, h = hkv * group + r % group;
    const size_t row = (static_cast<size_t>(b) * T + t) * H + h;
    if (nsplit == 1) {
      const float inv = l[ri] > 0.f ? 1.f / l[ri] : 0.f;  // no key: exact 0
      QT* o = out + row * D;
#pragma unroll
      for (int i = 0; i < kDPerLane; ++i) {
        const int d = lane + i * kWarp;
        if (d < D) o[d] = from_f<QT>(acc[ri][i] * inv);
      }
    } else {
      // partial state (m, l, unnormalized acc) for the merge kernel
      float* pp = part + (row * nsplit + split) * (D + 2);
      if (lane == 0) {
        pp[0] = m[ri] * kLog2e;  // the merge works in the log2 domain
        pp[1] = l[ri];
      }
#pragma unroll
      for (int i = 0; i < kDPerLane; ++i) {
        const int d = lane + i * kWarp;
        if (d < D) pp[2 + d] = acc[ri][i];
      }
    }
  }
}

template <typename QT, typename KT>
int launch_general(const void* q, const void* k, const void* v,
                   const float* ks, const float* vsc, const int* bt,
                   const int* lengths, const uint8_t* mask, void* out,
                   float* part, int nsplit, int B, int T, int H, int Hkv,
                   int D, int NB, int bs, int MB, int mask_T, int window,
                   float scale, cudaStream_t stream) {
  const int group = H / Hkv;
  const int TQ = min(kMaxRows / group, T);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(TQ) * group * D + kKC * (D + 1) +
                       kKC * D + kWarps * kKC) +
      sizeof(int) * kKC;
  auto kern = paged_general_kernel<QT, KT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + TQ - 1) / TQ, Hkv, B * nsplit);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), ks, vsc, bt, lengths, mask,
      static_cast<QT*>(out), part, T, H, Hkv, D, NB, bs, MB, mask_T, window,
      TQ, nsplit, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  return launch_merge<QT>(part, lengths, out, B, T, H, D, MB * bs, window, 0,
                          nsplit, false, stream);
}

template <typename QT>
int launch_general_kv(int kv_dtype, const void* q, const void* k,
                      const void* v, const float* ks, const float* vsc,
                      const int* bt, const int* lengths, const uint8_t* mask,
                      void* out, float* part, int nsplit, int B, int T, int H,
                      int Hkv, int D, int NB, int bs, int MB, int mask_T,
                      int window, float scale, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch_general<QT, float>(q, k, v, ks, vsc, bt, lengths, mask,
                                        out, part, nsplit, B, T, H, Hkv, D,
                                        NB, bs, MB, mask_T, window, scale,
                                        stream);
    case 1:
      return launch_general<QT, bf16>(q, k, v, ks, vsc, bt, lengths, mask,
                                       out, part, nsplit, B, T, H, Hkv, D,
                                       NB, bs, MB, mask_T, window, scale,
                                       stream);
    case 2:
      return launch_general<QT, int8_t>(q, k, v, ks, vsc, bt, lengths, mask,
                                         out, part, nsplit, B, T, H, Hkv, D,
                                         NB, bs, MB, mask_T, window, scale,
                                         stream);
    case 3:
      return launch_general<QT, __half>(q, k, v, ks, vsc, bt, lengths, mask,
                                         out, part, nsplit, B, T, H, Hkv, D,
                                         NB, bs, MB, mask_T, window, scale,
                                         stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ------------------------------------------ decode and prefill variants
constexpr int kMThreads = 128;  // 4 warps
constexpr int kStageKeys = 64;  // keys per pipeline stage (4 pages of 16)
constexpr int kDecodeRows = 16;
constexpr int kPrefillRows = 64;

template <typename QT>
struct PagedArgs {
  const QT* q;
  const void* k;  // QT, or int8
  const void* v;
  const float* k_scale;  // int8 pools only
  const float* v_scale;
  const int* block_table;
  const int* lengths;
  const uint8_t* mask;  // null: none
  QT* out;
  float* part;  // [B * T * H, nsplit, D + 2] when nsplit > 1
  int T, H, Hkv, NB, bs, MB, mask_T, window, kp, nsplit;
  float scale;
};

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// bytes of one key row of a K or V stage in shared memory (16-bit rows
// padded by 16 bytes so ldmatrix's 8 row addresses hit distinct banks)
template <int D, bool INT8>
__host__ __device__ constexpr int kv_row_bytes() {
  return INT8 ? D + 16 : (D + 8) * 2;
}

// one stage: K tile, V tile, (int8: k and v scales), per-key "mapped"
// flags, mask rows
template <int D, bool INT8>
__host__ __device__ constexpr size_t stage_bytes(int mrows) {
  return 2 * kStageKeys * kv_row_bytes<D, INT8>() +
         (INT8 ? 2 * kStageKeys * 4 : 0) + kStageKeys +
         static_cast<size_t>(mrows) * kStageKeys;
}

template <int D, bool DECODE>
__host__ __device__ constexpr size_t head_bytes(int kp, int bs) {
  return align16(static_cast<size_t>(DECODE ? kDecodeRows : kPrefillRows) *
                     (D + 8) * 2 +
                 static_cast<size_t>((kp - 1) / bs + 2) * 4);
}

// c += a * (the K^T fragment of one n-tile of an int8 [key][d] tile,
// widened to QT); kr points at K[n][k0 + 2 tig] of this lane's key n
template <typename QT>
__device__ __forceinline__ void mma_i8(float (&c)[4], const uint32_t (&a)[4],
                                       const int8_t* kr) {
  tlk::mma<QT>(c, a, tlk::i8x2_to<QT>(kr[0], kr[1]),
              tlk::i8x2_to<QT>(kr[8], kr[9]));
}

template <typename QT, int D, bool INT8, bool DECODE>
__global__ void __launch_bounds__(kMThreads)
    paged_mma_kernel(const PagedArgs<QT> a) {
  constexpr int ROWS = DECODE ? kDecodeRows : kPrefillRows;
  constexpr int NST = DECODE ? 3 : 2;    // ring stages
  constexpr int NK = DECODE ? 16 : 64;   // keys a warp scores per stage
  constexpr int NT = NK / 8, KS = D / 16, DT = D / 8, LDQ = D + 8;
  constexpr int KROW = kv_row_bytes<D, INT8>();
  constexpr int CPR = (INT8 ? D : 2 * D) / 16;  // 16-byte copies per key row
  constexpr int ELT = INT8 ? 1 : 2;
  extern __shared__ __align__(16) unsigned char smem[];

  const int group = a.H / a.Hkv;
  const int TQ = DECODE ? a.T : kPrefillRows / group;
  const int b = blockIdx.z / a.nsplit, split = blockIdx.z % a.nsplit;
  const int hkv = blockIdx.y, t0 = blockIdx.x * TQ;
  const int tq = min(TQ, a.T - t0), nrows = tq * group;
  const int Lv = a.MB * a.bs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int mrows = a.mask == nullptr ? 0 : (a.mask_T == 1 ? 1 : TQ);
  const size_t sbytes = stage_bytes<D, INT8>(mrows);

  QT* qs = reinterpret_cast<QT*>(smem);  // [ROWS][LDQ]
  int* bt_s = reinterpret_cast<int*>(qs + ROWS * LDQ);
  unsigned char* ring = smem + head_bytes<D, DECODE>(a.kp, a.bs);

  // the tile's key range (union over its queries) within this partition
  const int live = a.lengths[b];
  const int qlo = live - a.T + t0;
  const int kmin_t = a.window > 0 ? max(qlo - a.window + 1, 0) : 0;
  const int kmax_t = min(qlo + tq - 1, Lv - 1);
  int c_begin, c_end;
  if (DECODE) {  // fixed partitions of the view
    c_begin = max(kmin_t, split * a.kp);
    c_end = min(kmax_t, (split + 1) * a.kp - 1);
  } else {  // an even share of the tile's live stages (at most kp keys)
    const int s_lo = kmin_t / kStageKeys;
    const int n_st = kmax_t >= kmin_t ? kmax_t / kStageKeys - s_lo + 1 : 0;
    const int per = (n_st + a.nsplit - 1) / a.nsplit;
    c_begin = max(kmin_t, (s_lo + split * per) * kStageKeys);
    c_end = min(kmax_t, (s_lo + (split + 1) * per) * kStageKeys - 1);
  }
  const bool empty = c_begin > c_end;
  // decode: the merge never reads a partition past the row's range;
  // prefill: every split writes its (possibly empty) state
  if (DECODE && empty && a.nsplit > 1) return;
  const int k_first = empty ? 0 : (c_begin / kStageKeys) * kStageKeys;
  const int nstages = empty ? 0 : (c_end - k_first) / kStageKeys + 1;
  const int pg0 = empty ? 0 : c_begin / a.bs;

  if (!empty)
    for (int i = tid; i <= c_end / a.bs - pg0; i += kMThreads)
      bt_s[i] = a.block_table[static_cast<size_t>(b) * a.MB + pg0 + i];
  // Q tile: row r -> (t0 + r / group, hkv * group + r % group); padding
  // rows are zeros
  for (int c = tid; c < ROWS * (D / 8); c += kMThreads) {
    const int r = c / (D / 8), part = c % (D / 8);
    const bool ok = r < nrows;
    const int t = t0 + r / group, h = hkv * group + r % group;
    const QT* src =
        a.q + (ok ? ((static_cast<size_t>(b) * a.T + t) * a.H + h) * D +
                        part * 8
                  : 0);
    tlk::cp_async16(qs + r * LDQ + part * 8, src, ok ? 16 : 0);
  }
  __syncthreads();  // bt_s is read by every thread's stage copies

  // stage s holds keys k_first + 64 s ...; unmapped, out-of-range and
  // out-of-partition keys are zero-filled and flagged
  auto issue = [&](int s) {
    unsigned char* st = ring + (s % NST) * sbytes;
    float* ksc = reinterpret_cast<float*>(st + 2 * kStageKeys * KROW);
    uint8_t* kval = st + 2 * kStageKeys * KROW + (INT8 ? 2 * kStageKeys * 4 : 0);
    uint8_t* msk = kval + kStageKeys;
    const int kb = k_first + s * kStageKeys;
    for (int c = tid; c < kStageKeys * CPR; c += kMThreads) {
      const int j = c / CPR, part = c % CPR, key = kb + j;
      int phys = -1;
      if (key >= c_begin && key <= c_end) {
        phys = bt_s[key / a.bs - pg0];
        if (phys < 0 || phys >= a.NB) phys = -1;
      }
      const size_t slot =
          phys < 0 ? 0
                   : (static_cast<size_t>(phys) * a.bs + key % a.bs) * a.Hkv +
                         hkv;
      const size_t off = slot * D * ELT + part * 16;
      const int n = phys < 0 ? 0 : 16;
      tlk::cp_async16(st + j * KROW + part * 16,
                      static_cast<const char*>(a.k) + off, n);
      tlk::cp_async16(st + (kStageKeys + j) * KROW + part * 16,
                      static_cast<const char*>(a.v) + off, n);
      if (part == 0) {
        kval[j] = phys >= 0;
        if (INT8) {
          tlk::cp_async4(ksc + j, a.k_scale + slot, phys < 0 ? 0 : 4);
          tlk::cp_async4(ksc + kStageKeys + j, a.v_scale + slot,
                         phys < 0 ? 0 : 4);
        }
      }
    }
    for (int c = tid; c < mrows * (kStageKeys / 16); c += kMThreads) {
      const int r = c / (kStageKeys / 16), key0 = kb + (c % 4) * 16;
      const int tm = a.mask_T == 1 ? 0 : t0 + r;
      const bool ok = key0 < Lv && tm < a.T;
      const uint8_t* src =
          a.mask +
          (ok ? (static_cast<size_t>(b) * a.mask_T + tm) * Lv + key0 : 0);
      tlk::cp_async16(msk + r * kStageKeys + (c % 4) * 16, src, ok ? 16 : 0);
    }
  };

  // this thread's two rows (gid, gid + 8 of the warp's m-tile); their
  // key bounds, clipped to the block's range
  const int rw = DECODE ? 0 : 16 * warp;
  const int kw = DECODE ? 16 * warp : 0;
  int qpos[2], kmin[2], mrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rw + gid + 8 * r;
    const int t = t0 + row / group;
    const int qp = live - a.T + t;
    kmin[r] = max(c_begin, a.window > 0 ? qp - a.window + 1 : 0);
    qpos[r] = row < nrows ? min(qp, c_end) : -1;
    mrow[r] = a.mask_T == 1 ? 0 : row / group;
  }
  // the warp's union of row ranges, to skip stages none of its rows sees
  int w_hi = max(qpos[0], qpos[1]), w_lo = min(kmin[0], kmin[1]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    w_hi = max(w_hi, __shfl_xor_sync(0xffffffffu, w_hi, o));
    w_lo = min(w_lo, __shfl_xor_sync(0xffffffffu, w_lo, o));
  }

  uint32_t qa[KS][4];
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float sl2 = a.scale * kLog2e;  // scores in the log2 domain
  // f16 over int8: the rows' factors on P v_scale (tlk::f16_scale_rows)
  constexpr bool kScaleP = tlk::kIsF16<QT> && INT8;
  float fp[2] = {tlk::kNoScale, tlk::kNoScale};

#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (i < nstages) issue(i);
    tlk::cp_async_commit();  // the first group also holds the Q tile
  }
  for (int s = 0; s < nstages; ++s) {
    if (s + NST - 1 < nstages) issue(s + NST - 1);
    tlk::cp_async_commit();
    tlk::cp_async_wait<NST - 1>();  // stage s (and Q) has landed
    __syncthreads();
    if (s == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        tlk::ldsm_x4(qa[kk], tlk::frag_a<LDQ>(qs, rw, kk * 16, lane));
    }
    const int kb = k_first + s * kStageKeys;
    if (kb + kw <= w_hi && kb + kw + NK - 1 >= w_lo) {  // warp-uniform
      const unsigned char* st = ring + (s % NST) * sbytes;
      const unsigned char* vst = st + kStageKeys * KROW;
      const float* ksc = reinterpret_cast<const float*>(st + 2 * kStageKeys * KROW);
      const float* vsc = ksc + kStageKeys;
      const uint8_t* kval =
          st + 2 * kStageKeys * KROW + (INT8 ? 2 * kStageKeys * 4 : 0);
      const uint8_t* msk = kval + kStageKeys;

      float sc[NT][4];
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          if constexpr (INT8) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int8_t* kr = reinterpret_cast<const int8_t*>(st) +
                                 (kw + np * 16 + hf * 8 + gid) * KROW +
                                 kk * 16 + 2 * tig;
              mma_i8<QT>(sc[2 * np + hf], qa[kk], kr);
            }
          } else {
            uint32_t bb[4];
            tlk::ldsm_x4(bb, tlk::frag_b<D + 8>(reinterpret_cast<const QT*>(st),
                                               kw + np * 16, kk * 16, lane));
            tlk::mma<QT>(sc[2 * np], qa[kk], bb[0], bb[1]);
            tlk::mma<QT>(sc[2 * np + 1], qa[kk], bb[2], bb[3]);
          }
        }
      }

      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, kl = kw + i * 8 + 2 * tig + (e & 1);
          const int kp = kb + kl;
          bool keep = kval[kl] && kp >= kmin[r] && kp <= qpos[r];
          if (mrows > 0) keep = keep && msk[mrow[r] * kStageKeys + kl] != 0;
          float x = sc[i][e] * sl2;
          if (INT8) x *= ksc[kl];
          x = keep ? x : kNegInf;
          sc[i][e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = tlk::quad_max(mx[r]);
        alpha[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];  // per-thread partial row sums
      }
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, kl = kw + i * 8 + 2 * tig + (e & 1);
          const float p = sc[i][e] == kNegInf ? 0.f : exp2f(sc[i][e] - m[r]);
          l[r] += p;
          sc[i][e] = INT8 ? p * vsc[kl] : p;  // V's scale folds into p
        }
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        acc[i][0] *= alpha[0];
        acc[i][1] *= alpha[0];
        acc[i][2] *= alpha[1];
        acc[i][3] *= alpha[1];
      }
      if constexpr (kScaleP) tlk::f16_scale_rows(sc, fp, acc);
      // O += P V
#pragma unroll
      for (int j = 0; j < NK / 16; ++j) {
        uint32_t pa[4];
        tlk::pack_a<QT>(pa, sc[2 * j], sc[2 * j + 1]);
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          if constexpr (INT8) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int8_t* vc = reinterpret_cast<const int8_t*>(vst) +
                                 (kw + j * 16 + 2 * tig) * KROW + dp * 16 +
                                 hf * 8 + gid;
              tlk::mma<QT>(acc[2 * dp + hf], pa,
                          tlk::i8x2_to<QT>(vc[0], vc[KROW]),
                          tlk::i8x2_to<QT>(vc[8 * KROW], vc[9 * KROW]));
            }
          } else {
            uint32_t bb[4];
            tlk::ldsm_x4_t(bb, tlk::frag_a<D + 8>(
                                   reinterpret_cast<const QT*>(vst),
                                   kw + j * 16, dp * 16, lane));
            tlk::mma<QT>(acc[2 * dp], pa, bb[0], bb[1]);
            tlk::mma<QT>(acc[2 * dp + 1], pa, bb[2], bb[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with stage s before it refills
  }
  tlk::cp_async_wait<0>();
  __syncthreads();

  if constexpr (kScaleP) {  // the rows' P factors out of O (exact)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.f / fp[r];
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        acc[i][2 * r] *= inv;
        acc[i][2 * r + 1] *= inv;
      }
    }
  }
  const float lsum[2] = {tlk::quad_sum(l[0]), tlk::quad_sum(l[1])};
  // (row of the tile, d) -> output or partial state; mx in the log2 domain
  auto row_id = [&](int row) {
    const int t = t0 + row / group, h = hkv * group + row % group;
    return (static_cast<size_t>(b) * a.T + t) * a.H + h;
  };
  if constexpr (DECODE) {
    // merge the 4 warps' states of the same 16 rows through shared memory
    float* red = reinterpret_cast<float*>(ring);  // [4][16][D + 2]
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* rp = red + (warp * 16 + gid + 8 * r) * (D + 2);
      if (tig == 0) {
        rp[0] = m[r];
        rp[1] = lsum[r];
      }
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        rp[2 + i * 8 + 2 * tig] = acc[i][2 * r];
        rp[3 + i * 8 + 2 * tig] = acc[i][2 * r + 1];
      }
    }
    __syncthreads();
    for (int e = tid; e < nrows * D; e += kMThreads) {
      const int row = e / D, d = e % D;
      float M = kNegInf;
#pragma unroll
      for (int w = 0; w < 4; ++w) M = fmaxf(M, red[(w * 16 + row) * (D + 2)]);
      float L = 0.f, O = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float* rp = red + (w * 16 + row) * (D + 2);
        const float f = exp2f(rp[0] - M);
        L += rp[1] * f;
        O += rp[2 + d] * f;
      }
      const size_t id = row_id(row);
      if (a.nsplit == 1) {
        a.out[id * D + d] = from_f<QT>(L > 0.f ? O / L : 0.f);
      } else {
        float* pp = a.part + (id * a.nsplit + split) * (D + 2);
        if (d == 0) {
          pp[0] = M;
          pp[1] = L;
        }
        pp[2 + d] = O;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rw + gid + 8 * r;
      if (row >= nrows) continue;
      const size_t id = row_id(row);
      if (a.nsplit == 1) {
        const float inv = lsum[r] > 0.f ? 1.f / lsum[r] : 0.f;
        QT* o = a.out + id * D;
#pragma unroll
        for (int i = 0; i < DT; ++i)
          *reinterpret_cast<uint32_t*>(o + i * 8 + 2 * tig) = tlk::pack2<QT>(
              acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
      } else {
        float* pp = a.part + (id * a.nsplit + split) * (D + 2);
        if (tig == 0) {
          pp[0] = m[r];
          pp[1] = lsum[r];
        }
#pragma unroll
        for (int i = 0; i < DT; ++i) {
          pp[2 + i * 8 + 2 * tig] = acc[i][2 * r];
          pp[3 + i * 8 + 2 * tig] = acc[i][2 * r + 1];
        }
      }
    }
  }
}

template <typename QT, int D, bool INT8, bool DECODE>
int launch_mma(const PagedArgs<QT>& a, int B, cudaStream_t stream) {
  constexpr int NST = DECODE ? 3 : 2;
  const int group = a.H / a.Hkv;
  const int TQ = DECODE ? a.T : kPrefillRows / group;
  const int mrows = a.mask == nullptr ? 0 : (a.mask_T == 1 ? 1 : TQ);
  size_t ring = NST * stage_bytes<D, INT8>(mrows);
  if (DECODE) {
    const size_t red = 4 * kDecodeRows * (D + 2) * sizeof(float);
    ring = ring > red ? ring : red;
  }
  const size_t smem = head_bytes<D, DECODE>(a.kp, a.bs) + ring;
  auto kern = paged_mma_kernel<QT, D, INT8, DECODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.T + TQ - 1) / TQ, a.Hkv, B * a.nsplit);
  kern<<<grid, kMThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return static_cast<int>(err);
  return launch_merge<QT>(a.part, a.lengths, a.out, B, a.T, a.H, D,
                         a.MB * a.bs, a.window, a.kp, a.nsplit, DECODE,
                         stream);
}

template <typename QT, int D, bool DECODE>
int launch_mma_kv(const PagedArgs<QT>& a, int kv_dtype, int B,
                  cudaStream_t stream) {
  return kv_dtype == 2 ? launch_mma<QT, D, true, DECODE>(a, B, stream)
                       : launch_mma<QT, D, false, DECODE>(a, B, stream);
}

template <typename QT>
int launch_fast(const void* q, const void* k, const void* v,
                const float* k_scale, const float* v_scale,
                const int* block_table, const int* lengths,
                const uint8_t* mask, void* out, float* part, bool decode,
                int kp, int nsplit, int B, int T_, int H, int Hkv, int D,
                int NB, int bs, int MB, int mask_T, int window, float scale,
                int kv_dtype, cudaStream_t s) {
  const PagedArgs<QT> a{static_cast<const QT*>(q), k, v, k_scale, v_scale,
                       block_table, lengths, mask, static_cast<QT*>(out),
                       part, T_, H, Hkv, NB, bs, MB, mask_T, window, kp,
                       nsplit, scale};
  if (D == 64)
    return decode ? launch_mma_kv<QT, 64, true>(a, kv_dtype, B, s)
                  : launch_mma_kv<QT, 64, false>(a, kv_dtype, B, s);
  return decode ? launch_mma_kv<QT, 128, true>(a, kv_dtype, B, s)
                : launch_mma_kv<QT, 128, false>(a, kv_dtype, B, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// variant: 0 = general, 1 = decode, 2 = prefill (ops/paged_decode.py
// picks it). dtype codes: q 0 = float32, 1 = bfloat16, 2 = float16; kv
// 0 = float32, 1 = bfloat16, 2 = int8 (then k_scale/v_scale must be
// given), 3 = float16. The decode and prefill variants take bfloat16 q
// over bfloat16 or int8 pools and float16 q over float16 or int8 pools;
// the general variant any pair. Pointers
// are device pointers to contiguous arrays; mask may be null, else
// [B, 1, mask_T, MB*bs] bytes; window <= 0 means none. nsplit > 1 needs
// part, a float32 workspace of B * T * H * nsplit * (D + 2) elements. The
// decode and prefill variants cut each row's view into nsplit partitions
// of kp keys (kp a multiple of 64, nsplit = ceil(MB * bs / kp)); the
// general variant splits each row's live range evenly (kp unused).
// Returns a cudaError_t (0 = launched).
int tl_paged_decode(const void* q, const void* k, const void* v,
                    const float* k_scale, const float* v_scale,
                    const int* block_table, const int* lengths,
                    const uint8_t* mask, void* out, float* part, int variant,
                    int kp, int nsplit, int B, int T, int H, int Hkv, int D,
                    int NB, int bs, int MB, int mask_T, int window,
                    float scale, int q_dtype, int kv_dtype, void* stream) {
  if (B == 0 || T == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || D < 1 || bs < 1 || MB < 1 || NB < 1 ||
      nsplit < 1 || (nsplit > 1 && part == nullptr) ||
      (kv_dtype == 2 && (k_scale == nullptr || v_scale == nullptr)) ||
      (mask != nullptr && mask_T != 1 && mask_T != T))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = H / Hkv, Lv = MB * bs;
  if (variant == 0) {
    if (group > kMaxRows || D > kMaxD)
      return static_cast<int>(cudaErrorInvalidValue);
    switch (q_dtype) {
      case 0:
        return launch_general_kv<float>(kv_dtype, q, k, v, k_scale, v_scale,
                                        block_table, lengths, mask, out, part,
                                        nsplit, B, T, H, Hkv, D, NB, bs, MB,
                                        mask_T, window, scale, s);
      case 1:
        return launch_general_kv<bf16>(kv_dtype, q, k, v, k_scale, v_scale,
                                       block_table, lengths, mask, out, part,
                                       nsplit, B, T, H, Hkv, D, NB, bs, MB,
                                       mask_T, window, scale, s);
      case 2:
        return launch_general_kv<__half>(kv_dtype, q, k, v, k_scale, v_scale,
                                         block_table, lengths, mask, out,
                                         part, nsplit, B, T, H, Hkv, D, NB,
                                         bs, MB, mask_T, window, scale, s);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const bool decode = variant == 1;
  // q's own 16-bit pool code: bf16 (1) over bf16 (1), f16 (2) over f16 (3)
  const int own_kv = q_dtype == 1 ? 1 : 3;
  if ((variant != 1 && variant != 2) || (q_dtype != 1 && q_dtype != 2) ||
      (kv_dtype != own_kv && kv_dtype != 2) || (D != 64 && D != 128) ||
      kp < kStageKeys || kp % kStageKeys != 0 ||
      nsplit != (Lv + kp - 1) / kp ||
      (decode ? T * group > kDecodeRows : group > kPrefillRows) ||
      (mask != nullptr && (Lv % 16 != 0 || !aligned16(mask))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  return q_dtype == 1
             ? launch_fast<bf16>(q, k, v, k_scale, v_scale, block_table,
                                 lengths, mask, out, part, decode, kp, nsplit,
                                 B, T, H, Hkv, D, NB, bs, MB, mask_T, window,
                                 scale, kv_dtype, s)
             : launch_fast<f16>(q, k, v, k_scale, v_scale, block_table,
                                lengths, mask, out, part, decode, kp, nsplit,
                                B, T, H, Hkv, D, NB, bs, MB, mask_T, window,
                                scale, kv_dtype, s);
}

const char* tl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
