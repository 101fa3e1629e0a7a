// Fused residual add + norm (B4) as a thread-block-cluster kernel (sm_90a).
//
// Replaces tensorlink_tpu/ops/pallas/decode_glue.py::fused_residual_norm
// (kernels _kernel_bias / _kernel_nobias) and computes what the plain
// version in tensorlink_tpu_torch/ops/decode_glue.py computes: per row of
// D features, r = x + res in f32 (stored in x's type) and
// y = norm(r) * scale (+ bias), where norm is LayerNorm ((r - mean) /
// sqrt(var + eps)) or RMSNorm (r / sqrt(mean(r^2) + eps)), in f32.
//
// What bounds it on this card: bytes. It reads x, res, scale (and bias)
// once and writes r and y once; at the decode step's 8 rows x 4096 that
// is ~0.26 MB, ~0.08 us of HBM time, so a launch's fixed cost and the
// latency of its dependent steps set the time, not the bandwidth.
//
// Design, against that latency:
// - A row is split over a cluster of C blocks (C in 1, 2, 4, 8, chosen on
//   the host: ops/decode_glue.py::launch_geometry), each with a slice
//   short enough that one thread holds at most 8 elements of it. The host
//   takes the fewest blocks that hold the row (one up to D 8192): timed on
//   the H100 at the decode step's 8 x 4096, a cluster of 2-8 blocks read
//   slower than one block, its barrier costing more than the split saves.
// - Every load is issued before the first reduction: x, res, scale and
//   bias as vectors of up to 16 bytes (the widest that divides D and the
//   pointers' alignment, so every row stays aligned; odd D is scalar).
//   One dependent trip to device memory.
// - One reduction pass. Each thread takes (n, mean, M2) of its elements
//   two-pass from registers; warps and then the block merge them with
//   Chan's formula in a fixed order; the block publishes its partial in
//   shared memory; after a cluster barrier C lanes of every block read
//   the C partials through distributed shared memory at once and merge
//   them as a tree in rank order, so all blocks of a row hold the same
//   statistics. Every merge is a shuffle tree (lanes, then warps, then
//   ranks), so its chain is a few steps long. The barrier that keeps a block alive until the others have
//   read it is split: its arrive follows the reads, its wait comes after
//   the last store, so the stores overlap it. RMSNorm needs
//   only the sum of squares. A one-pass sum / sum of squares is not used:
//   it cancels catastrophically when the row's mean is large against its
//   spread, where the merged (mean, M2) is as exact as the plain version's
//   two passes.
// - The slice held in registers is normalized and stored; nothing is read
//   twice. r is stored before the reduction, so its writes overlap it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
// elements a thread holds (nv vectors of VEC): with 1024 threads and
// C <= 8 blocks a row, D up to 65536 fits, and the registers stay within
// the 64 a thread has at 1024 threads
constexpr int kElems = 8;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// VEC values of T, loaded and stored as one access of up to 16 bytes
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC < 16 ? sizeof(T) * VEC : 16) Vec {
  T v[VEC];
};

struct Moments {
  float n, mean, m2;  // count, mean, sum of squared deviations
};

// Chan's merge of b into a (exact for empty sides, so padding lanes hold
// n = 0); for RMSNorm (every
// mean 0) the plain sum of the counts and of m2. The weight b.n / n takes
// the fast division (as does each thread's mean): counts are integers below
// 2^17, so it is within 2 ulp, and it keeps the slow path of an IEEE
// division off the chain of dependent steps.
__device__ __forceinline__ Moments merge(Moments a, Moments b, bool rms) {
  if (rms) return Moments{a.n + b.n, 0.f, a.m2 + b.m2};
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float d = b.mean - a.mean;
  const float f = __fdividef(b.n, n);
  return Moments{n, a.mean + d * f, a.m2 + b.m2 + d * d * a.n * f};
}

// the two halves of a cluster barrier (cluster.sync() is both): arrive
// releases this block's earlier accesses, wait acquires the others'
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// lane 0 ends with the merge of lanes [0, width) (width a power of two,
// warp-uniform), taken as a tree in lane order; RMSNorm moves only m2
__device__ __forceinline__ Moments warp_merge(Moments m, bool rms,
                                              int width) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    if (o >= width) break;
    Moments b{0.f, 0.f, 0.f};
    b.m2 = __shfl_down_sync(0xffffffffu, m.m2, o);
    if (!rms) {
      b.n = __shfl_down_sync(0xffffffffu, m.n, o);
      b.mean = __shfl_down_sync(0xffffffffu, m.mean, o);
    }
    if ((threadIdx.x & 31) % (2 * o) == 0) m = merge(m, b, rms);
  }
  return m;
}

// One row per cluster of C blocks (C = the launch's cluster size); block
// rank c owns vectors [c * per_block, (c + 1) * per_block) of the row's
// D / VEC, thread t vector c * per_block + j * blockDim.x + t for j < nv.
// rms: RMSNorm (only m2 = sum of squares is kept), else LayerNorm.
template <typename T, typename S, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    fused_norm_kernel(const T* __restrict__ x, const T* __restrict__ res,
                      const S* __restrict__ scale,
                      const S* __restrict__ bias, T* __restrict__ r_out,
                      T* __restrict__ y_out, int D, int per_block, int nv,
                      float eps, int rms) {
  using VT = Vec<T, VEC>;
  using VS = Vec<S, VEC>;
  constexpr int kMaxNV = kElems / VEC;
  __shared__ Moments warp_part[kMaxThreads / 32];
  __shared__ Moments block_part;  // read by the cluster's other blocks
  __shared__ Moments row_stats;    // the row's, merged from every rank

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int c = static_cast<int>(cluster.block_rank());
  const long long row = blockIdx.x / C;
  const int v0 = c * per_block;
  const int vn = min(D / VEC - v0, per_block);  // this block's vectors
  const long long base = row * D;
  const int tid = threadIdx.x;

  VT xv[kMaxNV], rv[kMaxNV];
  VS sv[kMaxNV], bv[kMaxNV];
#pragma unroll
  for (int j = 0; j < kMaxNV; ++j) {
    const int i = j * blockDim.x + tid;
    if (j < nv && i < vn) {
      const long long e = static_cast<long long>(v0 + i) * VEC;
      xv[j] = *reinterpret_cast<const VT*>(x + base + e);
      rv[j] = *reinterpret_cast<const VT*>(res + base + e);
      sv[j] = *reinterpret_cast<const VS*>(scale + e);
      if (bias != nullptr) bv[j] = *reinterpret_cast<const VS*>(bias + e);
    }
  }

  float f[kMaxNV][VEC];
  float cnt = 0.f, sum = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxNV; ++j) {
    const int i = j * blockDim.x + tid;
    if (j < nv && i < vn) {
      VT out;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        f[j][e] = to_f(xv[j].v[e]) + to_f(rv[j].v[e]);
        out.v[e] = from_f<T>(f[j][e]);
        sum += f[j][e];
      }
      cnt += VEC;
      *reinterpret_cast<VT*>(r_out + base +
                             static_cast<long long>(v0 + i) * VEC) = out;
    }
  }
  Moments m{cnt, cnt > 0.f ? __fdividef(sum, cnt) : 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kMaxNV; ++j) {
    const int i = j * blockDim.x + tid;
    if (j < nv && i < vn) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = rms ? f[j][e] : f[j][e] - m.mean;
        m.m2 = fmaf(d, d, m.m2);
      }
    }
  }
  if (rms) m.mean = 0.f;

  // merge: lanes, then warps, then the cluster's blocks; all in a fixed
  // order, so every block of the row ends with the same statistics
  m = warp_merge(m, rms, 32);
  const int warp = tid >> 5, lane = tid & 31;
  const int nwarps = (blockDim.x + 31) >> 5;
  if (lane == 0) warp_part[warp] = m;
  __syncthreads();
  if (warp == 0) {  // the block's warps, merged by warp 0 as a tree
    Moments b = lane < nwarps ? warp_part[lane] : Moments{0.f, 0.f, 0.f};
    b = warp_merge(b, rms, 1 << (32 - __clz(nwarps - 1)));
    if (lane == 0) block_part = b;
  }
  if (C > 1) {
    cluster.sync();  // every block has started and published its partial
    // lane k of warp 0 fetches rank k's partial (the C reads at once) and
    // the warp merges them as a tree in rank order; then this block
    // signals that it is done reading the others' memory
    if (warp == 0) {
      Moments r = lane < C ? *cluster.map_shared_rank(&block_part, lane)
                           : Moments{0.f, 0.f, 0.f};
      r = warp_merge(r, rms, C);
      if (lane == 0) row_stats = r;
    }
    cluster_arrive();
  }
  __syncthreads();
  const Moments t = C > 1 ? row_stats : block_part;
  const float mean = t.mean, rstd = rsqrtf(t.m2 / D + eps);

#pragma unroll
  for (int j = 0; j < kMaxNV; ++j) {
    const int i = j * blockDim.x + tid;
    if (j < nv && i < vn) {
      VT out;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float y = (f[j][e] - mean) * rstd * to_f(sv[j].v[e]);
        if (bias != nullptr) y += to_f(bv[j].v[e]);
        out.v[e] = from_f<T>(y);
      }
      *reinterpret_cast<VT*>(y_out + base +
                             static_cast<long long>(v0 + i) * VEC) = out;
    }
  }
  // no block leaves while another may still read its partial
  if (C > 1) cluster_wait();
}

struct Args {
  const void *x, *res, *scale, *bias;
  void *r, *y;
  int rows, D, cluster, threads, vec, nv, rms;
  float eps;
};

template <typename T, typename S, int VEC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int per_block = (a.D / VEC + a.cluster - 1) / a.cluster;
  if (a.nv < 1 || a.nv * VEC > kElems ||
      static_cast<long long>(a.nv) * a.threads < per_block)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.cluster * a.rows));
  cfg.blockDim = dim3(static_cast<unsigned>(a.threads));
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(a.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.cluster > 1 ? 1 : 0;  // one block a row: a plain launch
  return cudaLaunchKernelEx(
      &cfg, fused_norm_kernel<T, S, VEC>, static_cast<const T*>(a.x),
      static_cast<const T*>(a.res), static_cast<const S*>(a.scale),
      static_cast<const S*>(a.bias), static_cast<T*>(a.r),
      static_cast<T*>(a.y), a.D, per_block, a.nv, a.eps, a.rms);
}

template <typename T, typename S>
cudaError_t by_vec(const Args& a, cudaStream_t stream) {
  constexpr int kWidest = 16 / static_cast<int>(sizeof(T));
  switch (a.vec) {
    case 1:
      return launch<T, S, 1>(a, stream);
    case 2:
      return launch<T, S, 2>(a, stream);
    case 4:
      return launch<T, S, 4>(a, stream);
    case 8:
      if (kWidest >= 8) return launch<T, S, (kWidest >= 8 ? 8 : 1)>(a, stream);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// ptrs = {x, res, scale, bias (or null), r_out, y_out}: x, res, r_out and
// y_out [rows, D] contiguous in one type, scale and bias [D] in f32 or in
// x's type. dims = {rows, D, type (0 f32, 1 bf16, 2 f16), scale type (0
// f32, else x's), cluster C, threads, vec, nv, rms}; the geometry comes
// from ops/decode_glue.py::launch_geometry. Returns a cudaError_t (0 =
// launched).
int tl_fused_norm(const void* const* ptrs, const int* dims, float eps,
                  void* stream) {
  Args a{ptrs[0], ptrs[1], ptrs[2], ptrs[3], const_cast<void*>(ptrs[4]),
         const_cast<void*>(ptrs[5]), dims[0], dims[1], dims[4], dims[5],
         dims[6], dims[7], dims[8], eps};
  const int type = dims[2], scale_f32 = dims[3] == 0;
  if (a.rows < 0 || a.D < 1 || a.vec < 1 || a.D % a.vec != 0 ||
      (a.cluster != 1 && a.cluster != 2 && a.cluster != 4 &&
       a.cluster != 8) ||
      a.threads < 32 || a.threads > kMaxThreads || a.threads % 32 != 0 ||
      static_cast<long long>(a.rows) * a.cluster > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (a.rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (type) {
    case 0:
      return by_vec<float, float>(a, st);
    case 1:
      return scale_f32 ? by_vec<__nv_bfloat16, float>(a, st)
                       : by_vec<__nv_bfloat16, __nv_bfloat16>(a, st);
    case 2:
      return scale_f32 ? by_vec<__half, float>(a, st)
                       : by_vec<__half, __half>(a, st);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* tl_fused_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
