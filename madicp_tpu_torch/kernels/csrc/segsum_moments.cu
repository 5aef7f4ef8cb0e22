// Per-level moment segment-sum of the MAD-tree build, for Hopper (sm_90a).
//
// Computes, for one tree level with `sz` nodes,
//     out[j, :] = sum over points p with idx[p] == j of
//                 [d, outer6(d), 1](p)          (10 columns)
// where d (n, 3) are the points shifted by their parent node's mean and
// ids outside [0, sz) drop. It replaces the TPU kernel
// madicp_tpu/ops/tree.py:279 `_segsum_moments_pallas` (a one-hot MXU
// contraction with a 3 x bf16 split) and the XLA scatter-add it stands
// in for (tree.py:451-455). The bf16 split was a workaround for the
// TPU's matrix unit and has no counterpart here.
//
// Bound on an H100 (3.35 TB/s): the function reads n x 16 B (d in f32
// plus a 4-byte id) = 2.1 MB at the flagship n = 131072 and writes at
// most 65536 x 10 x 4 B = 2.6 MB, so the least time is ~1.4 us per
// level; its ~19 flops per point are negligible. In practice it is
// bound by launch latency and by atomic contention: at level 0 every
// point adds into the same 10 addresses.
//
// What the design does about that:
//   * one thread per point forms its 10 moment columns in registers —
//     the (n, 10) moment table never exists in device memory;
//   * levels whose table fits shared memory (the wrapper picks this path
//     for sz <= 512: 40 KB of doubles) accumulate into a per-block shared
//     table in double, and the tiniest levels (sz <= WARP_AGG_MAX_NODES)
//     first reduce within the
//     warp, once per distinct id present, so 131072 points do not all
//     hit one shared address. Each block then writes its table to a
//     scratch slab and a second, tiny kernel sums the slabs in a fixed
//     order — no inter-block atomics, and the level-0 sums, which add
//     131072 terms, keep double accuracy;
//   * larger levels, with ~n/sz <= 256 points per node on average, use
//     global atomicAdd straight away, into double accumulators that a
//     last tiny kernel casts to the output.
// Every path accumulates in double, so float32 results carry only the
// final rounding: a float32 sum of 131072 terms in atomic order would
// drift past 1e-5 relative. The sum order of the atomics changes from
// run to run; results match the plain version to reassociation only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int NCOL = 10;
constexpr int WARP_AGG_MAX_NODES = 32;

template <typename T>
__device__ __forceinline__ void point_moments(const T* __restrict__ d, int p,
                                              double m[NCOL]) {
  const double x = static_cast<double>(d[3 * p + 0]);
  const double y = static_cast<double>(d[3 * p + 1]);
  const double z = static_cast<double>(d[3 * p + 2]);
  m[0] = x;
  m[1] = y;
  m[2] = z;
  m[3] = x * x;
  m[4] = x * y;
  m[5] = x * z;
  m[6] = y * y;
  m[7] = y * z;
  m[8] = z * z;
  m[9] = 1.0;
}

// Shared-table path. blockDim.x is a multiple of 32 and the block-stride
// loop bound is uniform across the block, so every warp runs each
// iteration with all 32 lanes present (full-mask shuffles are legal).
template <typename T, bool WARP_AGG>
__global__ void segsum_shared_kernel(const T* __restrict__ d,
                                     const int32_t* __restrict__ idx, int n,
                                     int sz, double* __restrict__ slabs) {
  extern __shared__ double tab[];
  const int tab_n = sz * NCOL;
  for (int i = threadIdx.x; i < tab_n; i += blockDim.x) tab[i] = 0.0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * blockDim.x;
  for (int base = blockIdx.x * blockDim.x; base < n; base += stride) {
    const int p = base + threadIdx.x;
    int id = -1;
    if (p < n) id = idx[p];
    const bool in = (p < n) && id >= 0 && id < sz;
    double m[NCOL];
    if (in) {
      point_moments(d, p, m);
    } else {
#pragma unroll
      for (int c = 0; c < NCOL; ++c) m[c] = 0.0;
    }
    if (WARP_AGG) {
      // one warp reduction per distinct node id present in the warp
      unsigned todo = __ballot_sync(FULL_MASK, in);
      while (todo) {
        const int src = __ffs(todo) - 1;
        const int j = __shfl_sync(FULL_MASK, id, src);
        const bool mine = in && id == j;
        todo &= ~__ballot_sync(FULL_MASK, mine);
#pragma unroll
        for (int c = 0; c < NCOL; ++c) {
          double v = mine ? m[c] : 0.0;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
          if (lane == src) atomicAdd(&tab[j * NCOL + c], v);
        }
      }
    } else if (in) {
#pragma unroll
      for (int c = 0; c < NCOL; ++c) atomicAdd(&tab[id * NCOL + c], m[c]);
    }
  }
  __syncthreads();
  double* slab = slabs + static_cast<size_t>(blockIdx.x) * tab_n;
  for (int i = threadIdx.x; i < tab_n; i += blockDim.x) slab[i] = tab[i];
}

// Sums the per-block slabs in block order (deterministic) and casts.
template <typename T>
__global__ void segsum_slab_reduce_kernel(const double* __restrict__ slabs,
                                          int n_slabs, int tab_n,
                                          T* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= tab_n) return;
  double acc = 0.0;
  for (int s = 0; s < n_slabs; ++s) acc += slabs[static_cast<size_t>(s) * tab_n + i];
  out[i] = static_cast<T>(acc);
}

// Global-atomic path for large levels: double accumulators (zeroed by
// the caller), one thread per point.
template <typename T>
__global__ void segsum_global_kernel(const T* __restrict__ d,
                                     const int32_t* __restrict__ idx, int n,
                                     int sz, double* __restrict__ acc) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int id = idx[p];
  if (id < 0 || id >= sz) return;
  double m[NCOL];
  point_moments(d, p, m);
  double* row = acc + static_cast<size_t>(id) * NCOL;
#pragma unroll
  for (int c = 0; c < NCOL; ++c) atomicAdd(row + c, m[c]);
}

template <typename T>
__global__ void segsum_cast_kernel(const double* __restrict__ acc, int tab_n,
                                   T* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < tab_n) out[i] = static_cast<T>(acc[i]);
}

constexpr int THREADS = 256;

template <typename T>
int launch(const T* d, const int32_t* idx, int n, int sz, int shared_blocks,
           double* scratch, T* out, cudaStream_t stream) {
  if (n <= 0 || sz <= 0) return static_cast<int>(cudaGetLastError());
  const int tab_n = sz * NCOL;
  const int tab_blocks = (tab_n + THREADS - 1) / THREADS;
  if (shared_blocks > 0) {
    const size_t smem = static_cast<size_t>(sz) * NCOL * sizeof(double);
    if (sz <= WARP_AGG_MAX_NODES) {
      segsum_shared_kernel<T, true><<<shared_blocks, THREADS, smem, stream>>>(
          d, idx, n, sz, scratch);
    } else {
      segsum_shared_kernel<T, false><<<shared_blocks, THREADS, smem, stream>>>(
          d, idx, n, sz, scratch);
    }
    segsum_slab_reduce_kernel<T><<<tab_blocks, THREADS, 0, stream>>>(
        scratch, shared_blocks, tab_n, out);
  } else {
    segsum_global_kernel<T><<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        d, idx, n, sz, scratch);
    segsum_cast_kernel<T><<<tab_blocks, THREADS, 0, stream>>>(scratch, tab_n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain C interface for ctypes. `shared_blocks` > 0 selects the
// shared-table path with that many blocks and a `scratch` of
// shared_blocks * sz * 10 doubles (need not be zeroed); 0 selects the
// global-atomic path, whose `scratch` of sz * 10 doubles must be zeroed.
// Every entry of `out` (sz * 10) is written. Returns the
// cudaGetLastError() code after the launches (0 = success).
int segsum_moments_f32(const float* d, const int32_t* idx, int n, int sz,
                       int shared_blocks, double* scratch, float* out,
                       void* stream) {
  return launch<float>(d, idx, n, sz, shared_blocks, scratch, out,
                       static_cast<cudaStream_t>(stream));
}

int segsum_moments_f64(const double* d, const int32_t* idx, int n, int sz,
                       int shared_blocks, double* scratch, double* out,
                       void* stream) {
  return launch<double>(d, idx, n, sz, shared_blocks, scratch, out,
                        static_cast<cudaStream_t>(stream));
}

const char* madicp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
