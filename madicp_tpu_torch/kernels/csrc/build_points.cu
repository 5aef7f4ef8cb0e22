// Per-point pass of one MAD-tree build level and the leaf pick (K8), for
// Hopper (sm_90a).
//
// advance_kernel, for each point i of a level with segment id g = idx[i]
// (live when 0 <= g < nseg) and node pack pack[g] = [mean (3), E row-major
// (9), parent leaf]:
//   d2 = p - mean, v_c = (E[0][c] d2x + E[1][c] d2y) + E[2][c] d2z
//   ext[g] = min(ext[g], keys of [v, -v])   (every live point)
//   the parent was a leaf:   leaf_of = node >> 1, frz_dist = |d|, retired
//   else, below the cap:     idx_next = 2 g + (v_z >= 0), d_next = d2
//   else, at the cap:        leaf_of = node, frz_dist = |d2|, frozen
// where node = sz + (g mod sz) is the point's node in its cloud's heap;
// every other point gets idx_next = -1, and its row of d_next is left
// unwritten: no later call reads it (the segment-sum drops the id, and
// the point never turns live again). pick_min_kernel:
// dmin[b M + leaf_of[i]] = min(key(frz_dist[i])) over valid points;
// pick_near_kernel: pos[a] = min over valid points with frz_dist <=
// dmin[a] (1 + tie_tol) of b n_total + offset + n. Keys are order-
// preserving integers of the floats (the bits, with the others flipped
// where the sign bit is set): int32 for float32, int64 for float64.
//
// It is the counterpart of madicp_tpu_torch/kernels/build_points.py
// `build_points_plain`, `pick_dmin_plain` and `pick_near_plain`, which
// port the JAX package's madicp_tpu/ops/tree.py:492-541, 561-592
// (per-point pass) and :594-618 (leaf pick); XLA lowered those, so no
// Pallas kernel stands behind them.
//
// Bound on an H100: bytes, counted from each call's data (chip_smoke.py
// `build_call_cost`): every point's id read and next id written (8 B);
// a live point's position read; d read only by the points that retire,
// d_next written only by the points that advance; a live node's pack (13
// values) and its 6 extents keys once; leaf_of and frz_dist written by
// the points that retire or freeze. The pick reads each valid point's
// leaf and distance once a kernel.
//
// Design:
//   * one thread a point; a warp first merges the points that share a
//     node (__match_any_sync, then __reduce_min_sync on the keys, in two
//     32-bit halves for int64 keys), and its leader issues one atomicMin a
//     column. Integer minima are exact and order-free, so the result is
//     the plain scatter's bit for bit, and a graph replay's too.
//   * contended levels (n >= 128 nseg, nseg <= 256: the levels near the
//     root, where all 131072 points share 1..256 nodes) reduce into a
//     block's shared table first (a few points a thread, grid-stride),
//     and the block adds only the entries it touched to the global table.
//   * every value is an _rn intrinsic in the plain version's order: nvcc
//     would contract a*b + c into an FMA, and one FMA sends a point on a
//     split plane to the other child.
// The kernels allocate nothing (the wrapper fills each table per call),
// read nothing back to the host and launch on the caller's stream, so
// they can be captured in a CUDA graph.

#include <cuda_runtime.h>
#include <stdint.h>

#include "arith.cuh"

namespace {

using madicp::Arith;

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int PACK = 13;
constexpr int EXT = 6;
constexpr int SMEM_MAX_NODES = 256;

// the least key over the lanes of `peers` (every lane of it calls)
__device__ __forceinline__ int warp_min(unsigned peers, int k) {
  return __reduce_min_sync(peers, k);
}

__device__ __forceinline__ long long warp_min(unsigned peers, long long k) {
  const int hi = static_cast<int>(k >> 32);
  const unsigned lo = static_cast<unsigned>(k & 0xffffffffll);
  const int hi_min = __reduce_min_sync(peers, hi);
  const unsigned lo_min = __reduce_min_sync(peers, hi == hi_min ? lo : 0xffffffffu);
  return static_cast<long long>((static_cast<unsigned long long>(static_cast<unsigned>(hi_min))
                                 << 32) | lo_min);
}

// sqrt((x x + y y) + z z)
template <typename T>
__device__ __forceinline__ T norm3(T x, T y, T z) {
  using A = Arith<T>;
  return A::sqrt(A::add(A::add(A::mul(x, x), A::mul(y, y)), A::mul(z, z)));
}

template <typename T, bool SMEM>
__global__ void __launch_bounds__(THREADS)
advance_kernel(const T* __restrict__ points, const T* __restrict__ d,
               const int* __restrict__ idx, const T* __restrict__ pack,
               typename Arith<T>::Key* __restrict__ ext, long long* __restrict__ leaf_of,
               T* __restrict__ frz_dist, T* __restrict__ d_next, int* __restrict__ idx_next,
               int n, int nseg, int sz, int last) {
  using A = Arith<T>;
  using Key = typename A::Key;
  __shared__ Key tab[SMEM ? SMEM_MAX_NODES * EXT : 1];
  const int lane = threadIdx.x & 31;
  if (SMEM) {
    for (int e = threadIdx.x; e < nseg * EXT; e += blockDim.x) tab[e] = A::big_key();
    __syncthreads();
  }
  const int stride = gridDim.x * blockDim.x;
  // base is the same for every lane: whole warps run each step together
  for (int base = blockIdx.x * blockDim.x; base < n; base += stride) {
    const int i = base + threadIdx.x;
    const bool in = i < n;
    const int g = in ? idx[i] : -1;
    const bool live = in && g >= 0 && g < nseg;
    T d2[3] = {T(0), T(0), T(0)}, v[3] = {T(0), T(0), T(0)};
    bool dead = false;
    if (live) {
      const T* pk = pack + static_cast<long long>(g) * PACK;
      const T* p = points + 3ll * i;
#pragma unroll
      for (int c = 0; c < 3; ++c) d2[c] = A::sub(__ldg(p + c), __ldg(pk + c));
#pragma unroll
      for (int c = 0; c < 3; ++c)
        v[c] = A::add(A::add(A::mul(__ldg(pk + 3 + c), d2[0]), A::mul(__ldg(pk + 6 + c), d2[1])),
                      A::mul(__ldg(pk + 9 + c), d2[2]));
      dead = __ldg(pk + 12) > T(0);
    }
    const unsigned live_mask = __ballot_sync(FULL_MASK, live);
    if (live) {
      const unsigned peers = __match_any_sync(live_mask, g);
      const bool leader = lane == __ffs(peers) - 1;
      Key* row = SMEM ? tab + g * EXT : ext + static_cast<long long>(g) * EXT;
#pragma unroll
      for (int c = 0; c < EXT; ++c) {
        const Key least = warp_min(peers, A::key(c < 3 ? v[c] : -v[c - 3]));
        if (leader) atomicMin(row + c, least);
      }
    }
    if (in) {
      if (live && !dead && !last) {
        T* dn = d_next + 3ll * i;
#pragma unroll
        for (int c = 0; c < 3; ++c) dn[c] = d2[c];
        idx_next[i] = 2 * g + (v[2] >= T(0) ? 1 : 0);
      } else {
        idx_next[i] = -1;
        if (live) {
          const long long node = sz + (g & (sz - 1));
          if (dead) {  // the one read of d: the shift from the leaf's mean
            const T* di = d + 3ll * i;
            leaf_of[i] = node >> 1;
            frz_dist[i] = norm3(di[0], di[1], di[2]);
          } else {  // at the depth cap
            leaf_of[i] = node;
            frz_dist[i] = norm3(d2[0], d2[1], d2[2]);
          }
        }
      }
    }
  }
  if (SMEM) {
    __syncthreads();
    for (int e = threadIdx.x; e < nseg * EXT; e += blockDim.x) {
      const Key k = tab[e];
      if (k != A::big_key()) atomicMin(ext + e, k);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
pick_min_kernel(const uint8_t* __restrict__ valid, const long long* __restrict__ leaf_of,
                const T* __restrict__ frz_dist, typename Arith<T>::Key* __restrict__ dmin,
                int n, int N, int M) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !valid[i]) return;
  const long long a = leaf_of[i] + static_cast<long long>(i / N) * M;
  atomicMin(dmin + a, Arith<T>::key(frz_dist[i]));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
pick_near_kernel(const uint8_t* __restrict__ valid, const long long* __restrict__ leaf_of,
                 const T* __restrict__ frz_dist,
                 const typename Arith<T>::Key* __restrict__ dmin, long long* __restrict__ pos,
                 int n, int N, int M, T factor, long long n_total, long long offset) {
  using A = Arith<T>;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !valid[i]) return;
  const int b = i / N;
  const long long a = leaf_of[i] + static_cast<long long>(b) * M;
  if (frz_dist[i] <= A::mul(A::from_key(dmin[a]), factor))
    atomicMin(pos + a, static_cast<long long>(b) * n_total + offset + (i - b * N));
}

template <typename T>
int launch_advance(const T* points, const T* d, const int* idx, const T* pack,
                   typename Arith<T>::Key* ext, long long* leaf_of, T* frz_dist, T* d_next,
                   int* idx_next, int n, int nseg, int sz, int last, int smem, int blocks,
                   cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (smem) {
    if (nseg > SMEM_MAX_NODES) return static_cast<int>(cudaErrorInvalidValue);
    advance_kernel<T, true><<<blocks, THREADS, 0, stream>>>(
        points, d, idx, pack, ext, leaf_of, frz_dist, d_next, idx_next, n, nseg, sz, last);
  } else {
    advance_kernel<T, false><<<blocks, THREADS, 0, stream>>>(
        points, d, idx, pack, ext, leaf_of, frz_dist, d_next, idx_next, n, nseg, sz, last);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_pick_min(const uint8_t* valid, const long long* leaf_of, const T* frz_dist,
                    typename Arith<T>::Key* dmin, int n, int N, int M, cudaStream_t stream) {
  if (n > 0) {
    pick_min_kernel<T><<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        valid, leaf_of, frz_dist, dmin, n, N, M);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_pick_near(const uint8_t* valid, const long long* leaf_of, const T* frz_dist,
                     const typename Arith<T>::Key* dmin, long long* pos, int n, int N, int M,
                     double factor, long long n_total, long long offset, cudaStream_t stream) {
  if (n > 0) {
    pick_near_kernel<T><<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        valid, leaf_of, frz_dist, dmin, pos, n, N, M, static_cast<T>(factor), n_total,
        offset);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain C interface for ctypes. Keys are int32 (float32) or int64
// (float64); every array is contiguous; each returns the
// cudaGetLastError() code after the launch (0 = success).
//
// advance: (points (n, 3), d (n, 3), idx (n,) int32, pack (nseg, 13), ext
// (nseg, 6) keys, leaf_of (n,) int64, frz_dist (n,), d_next (n, 3),
// idx_next (n,) int32, n, nseg, sz = 2^level, last (1 at the depth cap),
// smem (1: the shared-table path, nseg <= 256), blocks, stream)
int advance_f32(const float* points, const float* d, const int* idx, const float* pack,
                int* ext, long long* leaf_of, float* frz_dist, float* d_next, int* idx_next,
                int n, int nseg, int sz, int last, int smem, int blocks, void* stream) {
  return launch_advance<float>(points, d, idx, pack, ext, leaf_of, frz_dist, d_next, idx_next,
                               n, nseg, sz, last, smem, blocks,
                               static_cast<cudaStream_t>(stream));
}

int advance_f64(const double* points, const double* d, const int* idx, const double* pack,
                long long* ext, long long* leaf_of, double* frz_dist, double* d_next,
                int* idx_next, int n, int nseg, int sz, int last, int smem, int blocks,
                void* stream) {
  return launch_advance<double>(points, d, idx, pack, ext, leaf_of, frz_dist, d_next,
                                idx_next, n, nseg, sz, last, smem, blocks,
                                static_cast<cudaStream_t>(stream));
}

// pick_min: (valid (B N,) bool, leaf_of (B N,) int64, frz_dist (B N,),
// dmin (B M,) keys filled with the largest value's key, B N, N, M, stream)
int pick_min_f32(const uint8_t* valid, const long long* leaf_of, const float* frz_dist,
                 int* dmin, int n, int N, int M, void* stream) {
  return launch_pick_min<float>(valid, leaf_of, frz_dist, dmin, n, N, M,
                                static_cast<cudaStream_t>(stream));
}

int pick_min_f64(const uint8_t* valid, const long long* leaf_of, const double* frz_dist,
                 long long* dmin, int n, int N, int M, void* stream) {
  return launch_pick_min<double>(valid, leaf_of, frz_dist, dmin, n, N, M,
                                 static_cast<cudaStream_t>(stream));
}

// pick_near: (valid, leaf_of, frz_dist as pick_min, dmin (B M,) keys, pos
// (B M,) int64 filled with 2^31 - 1, B N, N, M, 1 + tie_tol, n_total,
// offset, stream)
int pick_near_f32(const uint8_t* valid, const long long* leaf_of, const float* frz_dist,
                  const int* dmin, long long* pos, int n, int N, int M, double factor,
                  long long n_total, long long offset, void* stream) {
  return launch_pick_near<float>(valid, leaf_of, frz_dist, dmin, pos, n, N, M, factor, n_total,
                                 offset, static_cast<cudaStream_t>(stream));
}

int pick_near_f64(const uint8_t* valid, const long long* leaf_of, const double* frz_dist,
                  const long long* dmin, long long* pos, int n, int N, int M, double factor,
                  long long n_total, long long offset, void* stream) {
  return launch_pick_near<double>(valid, leaf_of, frz_dist, dmin, pos, n, N, M, factor,
                                  n_total, offset, static_cast<cudaStream_t>(stream));
}

const char* madicp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
