// Paged-decode attention read straight from the block table (sm_90a).
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
//
// Design (first, simple version). One thread block per (query tile, kv
// head, row, split): the tile holds up to kMaxRows query rows, the GQA
// group's query heads times TQ query positions, so the block shares each
// K/V load among every query head that reads that kv head. When the
// (tile, kv head, row) blocks alone cannot fill the card (decode: B * Hkv
// blocks), each row's live key range splits evenly across nsplit blocks
// that write partial softmax states (m, l, unnormalized acc) to a
// workspace, and a merge kernel combines them (flash-decoding). A block
// walks its key range in chunks of kKC = 32 logical positions: it looks
// up each position's block id itself, never builds the [B, MB*bs, Hkv, D]
// logical view, never dereferences a sentinel (>= NB) entry, and skips
// chunks wholly outside the causal range or wholly below the window band.
// Each chunk is dequantized into shared memory as f32; one warp owns a
// query row at a time, lane j scores key j of the chunk, and the online
// softmax (running max m, normalizer l, accumulator in registers) folds
// the chunk in.
//
// What bounds it on the card: the bytes of the live KV pages it reads
// (decode is memory-bound: 2 * live_keys * Hkv * D * sizeof(kv) per row).
// What the simple design leaves for later: cp.async/TMA staging of the
// next chunk while the current one is scored (the loads here are plain
// and synchronous), 16-byte vector loads, tensor-core (mma) scoring for
// long prefill tiles, idle warps when a tile has fewer rows than warps
// (decode: the GQA group of 4), and a split count that follows the rows'
// live lengths rather than the view width.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
constexpr int kKC = 32;                     // keys per chunk: one per lane
constexpr int kMaxRows = 32;                // query rows per block
constexpr int kRowsPerWarp = kMaxRows / kWarps;
constexpr int kMaxD = 256;
constexpr int kDPerLane = kMaxD / kWarp;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k,
    const KT* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ block_table,
    const int* __restrict__ lengths, const uint8_t* __restrict__ mask,
    QT* __restrict__ out, float* __restrict__ part, int T, int H, int Hkv,
    int D, int NB, int bs, int MB, int mask_T, int window, int TQ,
    int nsplit, float scale) {
  extern __shared__ float smem[];
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
        pp[0] = m[ri];
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

// Merge the nsplit partial softmax states of one (row, query, head):
// out = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M), M = max_s m_s;
// exact zeros when no split saw a key.
template <typename QT>
__global__ void paged_decode_merge_kernel(const float* __restrict__ part,
                                          QT* __restrict__ out, int D,
                                          int nsplit) {
  const size_t row = blockIdx.x;
  const float* pp = part + row * nsplit * (D + 2);
  float mx = kNegInf;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, pp[s * (D + 2)]);
  float lsum = 0.f;
  for (int s = 0; s < nsplit; ++s)
    lsum += pp[s * (D + 2) + 1] * expf(pp[s * (D + 2)] - mx);
  const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float o = 0.f;
    for (int s = 0; s < nsplit; ++s)
      o += pp[s * (D + 2) + 2 + d] * expf(pp[s * (D + 2)] - mx);
    out[row * D + d] = from_f<QT>(o * inv);
  }
}

// Thread blocks to aim for: enough to keep every SM busy with two
// resident blocks twice over.
constexpr int kTargetBlocks = 4 * 132;

int tile_rows(int T, int group) {
  int TQ = kMaxRows / group;
  return TQ > T ? T : TQ;
}

int split_count(int B, int T, int H, int Hkv, int bs, int MB) {
  const int group = H / Hkv;
  const int TQ = tile_rows(T, group);
  const int base = ((T + TQ - 1) / TQ) * Hkv * B;
  const int chunks = (MB * bs + kKC - 1) / kKC;  // of the widest row
  int n = (kTargetBlocks + base - 1) / base;
  if (n > chunks / 2) n = chunks / 2;
  return n < 1 ? 1 : n;
}

template <typename QT, typename KT>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vsc, const int* bt, const int* lengths,
           const uint8_t* mask, void* out, float* part, int nsplit, int B,
           int T, int H, int Hkv, int D, int NB, int bs, int MB, int mask_T,
           int window, float scale, cudaStream_t stream) {
  const int group = H / Hkv;
  const int TQ = tile_rows(T, group);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(TQ) * group * D + kKC * (D + 1) +
                       kKC * D + kWarps * kKC) +
      sizeof(int) * kKC;
  auto kern = paged_decode_kernel<QT, KT>;
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
  paged_decode_merge_kernel<QT><<<B * T * H, 128, 0, stream>>>(
      part, static_cast<QT*>(out), D, nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int launch_kv(int kv_dtype, const void* q, const void* k, const void* v,
              const float* ks, const float* vsc, const int* bt,
              const int* lengths, const uint8_t* mask, void* out,
              float* part, int nsplit, int B, int T, int H, int Hkv, int D,
              int NB, int bs, int MB, int mask_T, int window, float scale,
              cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch<QT, float>(q, k, v, ks, vsc, bt, lengths, mask, out,
                               part, nsplit, B, T, H, Hkv, D, NB, bs, MB,
                               mask_T, window, scale, stream);
    case 1:
      return launch<QT, __nv_bfloat16>(q, k, v, ks, vsc, bt, lengths, mask,
                                       out, part, nsplit, B, T, H, Hkv, D,
                                       NB, bs, MB, mask_T, window, scale,
                                       stream);
    case 2:
      return launch<QT, int8_t>(q, k, v, ks, vsc, bt, lengths, mask, out,
                                part, nsplit, B, T, H, Hkv, D, NB, bs, MB,
                                mask_T, window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// How many thread blocks split each row's key range (1 = no split, the
// kernel writes the output itself). With more than one, the caller passes
// a float32 workspace of B * T * H * nsplit * (D + 2) elements.
int tl_paged_decode_splits(int B, int T, int H, int Hkv, int bs, int MB) {
  if (B < 1 || T < 1 || Hkv < 1 || H % Hkv != 0) return 1;
  return split_count(B, T, H, Hkv, bs, MB);
}

// dtype codes: q 0 = float32, 1 = bfloat16; kv 0 = float32, 1 = bfloat16,
// 2 = int8 (then k_scale/v_scale must be given). Pointers are device
// pointers to contiguous arrays; mask may be null, else [B, 1, mask_T, MB*bs]
// bytes; window <= 0 means none; part is the split workspace (see
// tl_paged_decode_splits). Returns a cudaError_t (0 = launched).
int tl_paged_decode(const void* q, const void* k, const void* v,
                    const float* k_scale, const float* v_scale,
                    const int* block_table, const int* lengths,
                    const uint8_t* mask, void* out, float* part, int nsplit,
                    int B, int T, int H, int Hkv, int D, int NB, int bs,
                    int MB, int mask_T, int window, float scale, int q_dtype,
                    int kv_dtype, void* stream) {
  if (B == 0 || T == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxRows || D < 1 ||
      D > kMaxD || bs < 1 || MB < 1 || NB < 1 || nsplit < 1 ||
      (nsplit > 1 && part == nullptr) ||
      (kv_dtype == 2 && (k_scale == nullptr || v_scale == nullptr)) ||
      (mask != nullptr && mask_T != 1 && mask_T != T))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0:
      return launch_kv<float>(kv_dtype, q, k, v, k_scale, v_scale,
                              block_table, lengths, mask, out, part, nsplit,
                              B, T, H, Hkv, D, NB, bs, MB, mask_T, window,
                              scale, s);
    case 1:
      return launch_kv<__nv_bfloat16>(kv_dtype, q, k, v, k_scale, v_scale,
                                      block_table, lengths, mask, out, part,
                                      nsplit, B, T, H, Hkv, D, NB, bs, MB,
                                      mask_T, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* tl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
