// Flash attention forward (B1) and backward (B2) in float32, on the CUDA
// cores (FFMA), for sm_90a.
//
// The f32 forms of the kernels in flash_attention.cu: the same function
// (tensorlink_tpu/ops/pallas/flash_attention.py's flash_attention_fwd_lse
// and flash_attention_bwd, which compute in f32 whatever their inputs) on
// f32 q, k, v and do, with f32 o, lse, dq, dk and dv. Nothing is rounded to
// bf16 and no TF32 tensor core is used: either would drift from an f32
// model's plain attention by more than the port's f32 tolerance. Operands
// are [B, heads, T, D] views read through their strides (D contiguous);
// GQA reads the unrepeated K/V (query head h uses kv head h / (H / Hkv)).
// A key is attended iff kv_mask[b, k] != 0 (when a mask is given), k < Tk,
// and the positional band holds (k <= q under causal; k > q - window, and
// k < q + window when not causal, under a window). A query row with no
// attended key gives o = 0 and lse = 1e30, so the backward's p is 0 there.
//
// Design: one block of 256 threads per 64-row tile, four threads a row.
// Tiles live in shared memory as [64][D + 1] f32 rows (the odd pitch keeps
// the row-parallel reads on distinct banks). Every product is one of two
// forms: a tile of 64 x 64 row dot products (S = Q K^T, dP = dO V^T; a
// thread owns 16 columns of its row), or a [64 x 64] x [64 x D] product
// into D / 4 accumulators a thread (O += P V, dQ += dS K, dV += P^T dO,
// dK += dS^T Q).
// - Forward: one block per (head, 64-query tile, batch row); online
//   softmax over the key tiles of the block's band, exp in f32.
// - Backward, dq kernel (one block per query tile): a first pass over the
//   key tiles forms delta = rowsum(p dp) from the kernel's own p and dp
//   (the port's delta convention, as in flash_attention.cu) and publishes
//   it for the dkv kernel; a second pass forms dS = p (dp - delta) scale
//   and dQ. A caller's delta (delta_in, the ring's backward) replaces the
//   first pass, and nothing is published.
// - Backward, dkv kernel (one block per (kv head, 64-key tile, batch row)):
//   walks the (query head of its GQA group, query tile) units its band
//   reaches, forming S^T and dP^T, and sums dK and dV of the whole group in
//   registers.
// Key tiles whose keys are all masked are skipped. This is the simple
// first design; it is not tuned (PERF.md has its times against its bound
// at the card's f32 vector peak).

#include "mma_common.cuh"

namespace {

using namespace tlk;

constexpr int kThreads = 256;   // four threads a row of a 64-row tile
constexpr int kRows = 64;       // rows a block (queries; keys in dkv)
constexpr int kCols = 64;       // columns a tile (keys; queries in dkv)
constexpr int kLdS = kCols + 1; // pitch of a 64 x 64 score tile
constexpr float kLseMasked = 1e30f;

struct View {  // a [B, heads, T, D] f32 operand; strides in elements
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

// rows [t0, t0 + 64) of (batch b, head h) into a [64][D + 1] tile; rows
// past T are zeros
template <int D>
__device__ __forceinline__ void load_tile(float* tile, const View& x, int b,
                                          int h, int t0, int T) {
  const float* base = x.p + b * x.sb + h * x.sh;
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D, t = t0 + r;
    tile[r * (D + 1) + d] = t < T ? base[(long long)t * x.st + d] : 0.f;
  }
}

// acc[i] = A[r] . B[sub + 4 i] over D: 16 columns of row r of A B^T
template <int D>
__device__ __forceinline__ void row_dots(float (&acc)[16], const float* A,
                                         const float* Bm, int r, int sub) {
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  const float* a = A + r * (D + 1);
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float x = a[d];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      acc[i] = fmaf(x, Bm[(sub + 4 * i) * (D + 1) + d], acc[i]);
  }
}

// acc[i] += sum_j P[r][j] M[j][sub + 4 i]: this thread's D / 4 columns of
// row r of P M
template <int D>
__device__ __forceinline__ void row_accum(float (&acc)[D / 4], const float* P,
                                          const float* M, int r, int sub) {
  const float* p = P + r * kLdS;
#pragma unroll 2
  for (int j = 0; j < kCols; ++j) {
    const float x = p[j];
    const float* m = M + j * (D + 1) + sub;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) acc[i] = fmaf(x, m[4 * i], acc[i]);
  }
}

template <int D>
constexpr size_t tile_bytes() {
  return sizeof(float) * kRows * (D + 1);
}
constexpr size_t kScoreBytes = sizeof(float) * kRows * kLdS;

// ---------------------------------------------------------------- forward
template <int D, bool BAND>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel_f32(View q, View k, View v, OutView o,
                         float* __restrict__ lse, Shape s) {
  extern __shared__ float sm[];
  float* sq = sm;
  float* sk = sq + kRows * (D + 1);
  float* sv = sk + kCols * (D + 1);
  float* sp = sv + kCols * (D + 1);
  __shared__ uint8_t kept[kCols];
  const int h = blockIdx.x, q0 = blockIdx.y * kRows, b = blockIdx.z;
  const int hk = h / (s.H / s.Hkv);
  const int tid = threadIdx.x, r = tid >> 2, sub = tid & 3, qi = q0 + r;
  load_tile<D>(sq, q, b, h, q0, s.Tq);
  int lo, hi;
  key_range(q0, min(q0 + kRows, s.Tq) - 1, s.Tk, s.causal, s.window, lo, hi);
  float m = kNegInf, l = 0.f, acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;
  for (int k0 = lo - lo % kCols; k0 < hi; k0 += kCols) {
    __syncthreads();  // the last tile's readers are done
    int any = 0;
    if (tid < kCols) any = kept[tid] = key_kept(s, b, k0 + tid);
    if (!__syncthreads_or(any)) continue;
    load_tile<D>(sk, k, b, hk, k0, s.Tk);
    load_tile<D>(sv, v, b, hk, k0, s.Tk);
    __syncthreads();
    float sc[16];
    row_dots<D>(sc, sq, sk, r, sub);
    float mx = m;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = sub + 4 * i;
      const bool keep =
          kept[c] && (!BAND || band_keep(qi, k0 + c, s.causal, s.window));
      sc[i] = keep ? sc[i] * s.scale : kNegInf;
      mx = fmaxf(mx, sc[i]);
    }
    mx = quad_max(mx);
    const float alpha = expf(m - mx);  // both -1e30: 1, on zero sums
    l *= alpha;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) acc[i] *= alpha;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float p = sc[i] == kNegInf ? 0.f : expf(sc[i] - mx);
      sp[r * kLdS + sub + 4 * i] = p;
      l += p;
    }
    m = mx;
    __syncthreads();
    row_accum<D>(acc, sp, sv, r, sub);
  }
  l = quad_sum(l);
  if (qi < s.Tq) {
    const float l_safe = l == 0.f ? 1.f : l;
    float* out = o.p + b * o.sb + h * o.sh + (long long)qi * o.st + sub;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) out[4 * i] = acc[i] / l_safe;
    if (sub == 0)
      lse[((long long)b * s.H + h) * s.Tq + qi] =
          l > 0.f ? m + logf(l) : kLseMasked;
  }
}

// ------------------------------------------------------- backward: dq
template <int D, bool BAND>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_f32_kernel(View q, View k, View v, View dout,
                            const float* __restrict__ lse,
                            float* __restrict__ delta, OutView dq, Shape s) {
  extern __shared__ float sm[];
  float* sq = sm;
  float* sdo = sq + kRows * (D + 1);
  float* sk = sdo + kRows * (D + 1);
  float* sv = sk + kCols * (D + 1);
  float* sds = sv + kCols * (D + 1);
  __shared__ uint8_t kept[kCols];
  const int h = blockIdx.x, q0 = blockIdx.y * kRows, b = blockIdx.z;
  const int hk = h / (s.H / s.Hkv);
  const int tid = threadIdx.x, r = tid >> 2, sub = tid & 3, qi = q0 + r;
  const long long row = ((long long)b * s.H + h) * s.Tq + qi;
  load_tile<D>(sq, q, b, h, q0, s.Tq);
  load_tile<D>(sdo, dout, b, h, q0, s.Tq);
  const float lse_r = qi < s.Tq ? lse[row] : kLseMasked;
  int lo, hi;
  key_range(q0, min(q0 + kRows, s.Tq) - 1, s.Tk, s.causal, s.window, lo, hi);
  const int first = lo - lo % kCols;
  float dl = 0.f;
  if (s.delta_in) {
    if (qi < s.Tq) dl = delta[row];
  }
  // pass 0 (own delta only): delta = rowsum(p dp); pass 1: dS and dQ
  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;
  for (int pass = s.delta_in ? 1 : 0; pass < 2; ++pass) {
    for (int k0 = first; k0 < hi; k0 += kCols) {
      __syncthreads();
      int any = 0;
      if (tid < kCols) any = kept[tid] = key_kept(s, b, k0 + tid);
      if (!__syncthreads_or(any)) continue;
      load_tile<D>(sk, k, b, hk, k0, s.Tk);
      load_tile<D>(sv, v, b, hk, k0, s.Tk);
      __syncthreads();
      float sc[16], dp[16];
      row_dots<D>(sc, sq, sk, r, sub);
      row_dots<D>(dp, sdo, sv, r, sub);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c = sub + 4 * i;
        const bool keep =
            kept[c] && (!BAND || band_keep(qi, k0 + c, s.causal, s.window));
        const float p = keep ? expf(sc[i] * s.scale - lse_r) : 0.f;
        if (pass == 0)
          dl += p * dp[i];
        else
          sds[r * kLdS + c] = p * (dp[i] - dl) * s.scale;
      }
      if (pass == 1) {
        __syncthreads();
        row_accum<D>(acc, sds, sk, r, sub);
      }
    }
    if (pass == 0) {
      dl = quad_sum(dl);
      if (qi < s.Tq && sub == 0) delta[row] = dl;
    }
  }
  if (qi < s.Tq) {
    float* out = dq.p + b * dq.sb + h * dq.sh + (long long)qi * dq.st + sub;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) out[4 * i] = acc[i];
  }
}

// ------------------------------------------------------ backward: dk, dv
template <int D, bool BAND>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_f32_kernel(View q, View k, View v, View dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta, OutView dk,
                             OutView dv, Shape s) {
  extern __shared__ float sm[];
  float* sk = sm;
  float* sv = sk + kRows * (D + 1);
  float* sq = sv + kRows * (D + 1);
  float* sdo = sq + kCols * (D + 1);
  float* spt = sdo + kCols * (D + 1);
  float* sdst = spt + kRows * kLdS;
  __shared__ float slse[kCols], sdelta[kCols];
  const int hk = blockIdx.x, k0 = blockIdx.y * kRows, b = blockIdx.z;
  const int G = s.H / s.Hkv;
  const int tid = threadIdx.x, r = tid >> 2, sub = tid & 3, kj = k0 + r;
  const bool kkeep = key_kept(s, b, kj);
  float ak[D / 4], av[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) ak[i] = av[i] = 0.f;
  if (__syncthreads_or(kkeep)) {
    load_tile<D>(sk, k, b, hk, k0, s.Tk);
    load_tile<D>(sv, v, b, hk, k0, s.Tk);
    int lo, hi;
    query_range(k0, min(k0 + kRows, s.Tk) - 1, s.Tq, s.causal, s.window, lo,
                hi);
    for (int g = 0; g < G; ++g) {
      const int h = hk * G + g;
      for (int q0 = lo - lo % kCols; q0 < hi; q0 += kCols) {
        __syncthreads();
        load_tile<D>(sq, q, b, h, q0, s.Tq);
        load_tile<D>(sdo, dout, b, h, q0, s.Tq);
        if (tid < kCols) {
          const int qi = q0 + tid;
          const long long row = ((long long)b * s.H + h) * s.Tq + qi;
          slse[tid] = qi < s.Tq ? lse[row] : kLseMasked;
          sdelta[tid] = qi < s.Tq ? delta[row] : 0.f;
        }
        __syncthreads();
        float st[16], dpt[16];
        row_dots<D>(st, sk, sq, r, sub);
        row_dots<D>(dpt, sv, sdo, r, sub);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int c = sub + 4 * i, qi = q0 + c;
          const bool keep = kkeep && qi < s.Tq &&
                            (!BAND || band_keep(qi, kj, s.causal, s.window));
          const float p = keep ? expf(st[i] * s.scale - slse[c]) : 0.f;
          spt[r * kLdS + c] = p;
          sdst[r * kLdS + c] = p * (dpt[i] - sdelta[c]) * s.scale;
        }
        __syncthreads();
        row_accum<D>(av, spt, sdo, r, sub);
        row_accum<D>(ak, sdst, sq, r, sub);
      }
    }
  }
  if (kj < s.Tk) {
    const long long t = (long long)kj;
    float* ok = dk.p + b * dk.sb + hk * dk.sh + t * dk.st + sub;
    float* ov = dv.p + b * dv.sb + hk * dv.sh + t * dv.st + sub;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      ok[4 * i] = ak[i];
      ov[4 * i] = av[i];
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

template <int D, bool BAND>
int launch_fwd(View q, View k, View v, OutView o, float* lse, Shape s,
               cudaStream_t stream) {
  const size_t smem = 3 * tile_bytes<D>() + kScoreBytes;
  cudaError_t err = allow_smem(flash_fwd_kernel_f32<D, BAND>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(s.H, (s.Tq + kRows - 1) / kRows, s.B);
  flash_fwd_kernel_f32<D, BAND><<<grid, kThreads, smem, stream>>>(q, k, v, o,
                                                                  lse, s);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool BAND>
int launch_bwd(View q, View k, View v, View dout, const float* lse,
               float* delta, OutView dq, OutView dk, OutView dv, Shape s,
               cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (s.Tq > 0) {  // dq first: it writes the delta the dkv kernel reads
    const size_t smem = 4 * tile_bytes<D>() + kScoreBytes;
    err = allow_smem(flash_bwd_dq_f32_kernel<D, BAND>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(s.H, (s.Tq + kRows - 1) / kRows, s.B);
    flash_bwd_dq_f32_kernel<D, BAND><<<grid, kThreads, smem, stream>>>(
        q, k, v, dout, lse, delta, dq, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (s.Tk > 0) {
    const size_t smem = 4 * tile_bytes<D>() + 2 * kScoreBytes;
    err = allow_smem(flash_bwd_dkv_f32_kernel<D, BAND>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(s.Hkv, (s.Tk + kRows - 1) / kRows, s.B);
    flash_bwd_dkv_f32_kernel<D, BAND><<<grid, kThreads, smem, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, s);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// strides of n views: each a multiple of 4 elements (16-byte rows)
bool strides_ok(const long long* st, int n) {
  for (int i = 0; i < 3 * n; ++i)
    if (st[i] % 4 != 0) return false;
  return true;
}

View view(const void* p, const long long* st) {
  return View{static_cast<const float*>(p), st[0], st[1], st[2]};
}

OutView out_view(void* p, const long long* st) {
  return OutView{static_cast<float*>(p), st[0], st[1], st[2]};
}

bool shape_ok(const int* dims) {
  const int B = dims[0], H = dims[1], Hkv = dims[2], Tq = dims[3],
            Tk = dims[4], D = dims[5];
  return B >= 0 && Tq >= 0 && Tk >= 0 && H > 0 && Hkv > 0 && H % Hkv == 0 &&
         H <= 65535 && B <= 65535 && (D == 64 || D == 128);
}

Shape make_shape(const int* dims, float scale, const void* kv_mask) {
  return Shape{dims[0], dims[1], dims[2], dims[3], dims[4],
               dims[6], dims[7], dims[8], scale,
               static_cast<const uint8_t*>(kv_mask)};
}

}  // namespace

extern "C" {

// Forward, f32. The arguments are tl_flash_fwd's (flash_attention.cu):
// ptrs = {q, k, v, kv_mask (or null), o, lse}; strides = (b, h, t) element
// strides of the views q, k, v, o (12 values); dims = {B, H, Hkv, Tq, Tk, D,
// causal, window (<= 0: none), delta_in (0 here)}. f32 q/k/v/o, f32 lse
// [B, H, Tq] contiguous, uint8 kv_mask [B, Tk] contiguous; 16-byte aligned
// base pointers and strides. Returns a cudaError_t (0 = launched).
int tl_flash_fwd_f32(const void* const* ptrs, const long long* strides,
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
  const bool band = s.causal || s.window > 0;
  if (dims[5] == 64)
    return band ? launch_fwd<64, true>(q, k, v, o, lse, s, st)
                : launch_fwd<64, false>(q, k, v, o, lse, s, st);
  return band ? launch_fwd<128, true>(q, k, v, o, lse, s, st)
              : launch_fwd<128, false>(q, k, v, o, lse, s, st);
}

// Backward, f32. The arguments are tl_flash_bwd's: ptrs = {q, k, v, do,
// lse, kv_mask (or null), delta (f32 [B, H, Tq] contiguous), dq, dk, dv, o};
// strides of q, k, v, do, dq, dk, dv, o (24 values); dims as for the
// forward. delta_in 0: delta is a workspace the dq kernel fills with
// rowsum(p dp); 1: the caller's delta, read by both kernels. o is not read.
int tl_flash_bwd_f32(const void* const* ptrs, const long long* strides,
                     const int* dims, float scale, void* stream) {
  if (!shape_ok(dims) || !strides_ok(strides, 8)) return cudaErrorInvalidValue;
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
  const bool band = s.causal || s.window > 0;
  if (dims[5] == 64)
    return band ? launch_bwd<64, true>(q, k, v, dout, lse, delta, dq, dk, dv,
                                       s, st)
                : launch_bwd<64, false>(q, k, v, dout, lse, delta, dq, dk, dv,
                                        s, st);
  return band ? launch_bwd<128, true>(q, k, v, dout, lse, delta, dq, dk, dv,
                                      s, st)
              : launch_bwd<128, false>(q, k, v, dout, lse, delta, dq, dk, dv,
                                       s, st);
}

const char* tl_flash_f32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
