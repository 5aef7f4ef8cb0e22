// Per-point pass of one MAD-tree build level and the leaf pick (K8), for
// Hopper (sm_90a).
//
// The level pass (cluster_kernel, stage_kernel), for each point i of a
// level with segment id g = idx[i] (live when 0 <= g < nseg) and node pack
// pack[g] = [mean (3), E row-major (9), parent leaf]:
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
// Bound on an H100: bytes, counted from each call's data
// (madicp_tpu_torch/probes/build_levels.py `call_cost`): every point's id
// read and next id written (8 B); a live point's position read; d read
// only by the points that retire, d_next written only by the points that
// advance; a live node's pack (13 values) and its 6 extents keys once;
// leaf_of and frz_dist written by the points that retire or freeze. The
// pick reads each valid point's leaf and distance once a kernel.
//
// Design (one thread a point; madicp_tpu_torch/kernels/build_points.py
// `plan` picks the path of a level):
//   * no warp merge of the points that share a node: `__reduce_min_sync`
//     writes a uniform register, so a warp whose lanes hold G nodes runs
//     G reductions one after the other, and that loop set the pace of
//     every level (PERF.md, K8's per-call trace).
//   * cluster path, the contended levels near the root (nseg <= 1024, so
//     that a float64 table fits the 48 KB a block has without an opt-in,
//     and >= 128 points a node): blocks of 512 points in clusters of 8. Each
//     lane min-reduces its 6 keys into its block's shared table with
//     native 32-bit shared atomics (a warp whose live lanes share one node
//     reduces first, with one uniform REDUX a column). float64 keys are a
//     high and a low word: the table takes the high words' minima, then,
//     after a barrier, the low words of the keys that hold them (a 64-bit
//     shared atomicMin is a compare-and-swap loop). After a cluster
//     barrier each block merges its slice of the cluster's tables through
//     distributed shared memory and issues one global atomicMin a touched
//     entry; a second barrier keeps every table alive until it is read.
//   * stage path, the other levels (~1 point a node a warp at the deep
//     ones): one global atomicMin a live point and column. A warp stages
//     its keys and nodes in shared memory, so each of its 6 atomic
//     instructions covers whole 24-byte rows of the table.
//   * every value is an _rn intrinsic in the plain version's order: nvcc
//     would contract a*b + c into an FMA, and one FMA sends a point on a
//     split plane to the other child.
// Integer minima are exact and order-free, so every path's result is the
// plain scatter's bit for bit, and a graph replay's too. The kernels
// allocate nothing (the wrapper fills each table per call), read nothing
// back to the host and launch on the caller's stream, so they can be
// captured in a CUDA graph.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "arith.cuh"

namespace {

namespace cg = cooperative_groups;
using madicp::Arith;

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int THREADS = 256;           // stage path, the pick
constexpr int CLUSTER_THREADS = 512;   // cluster path
constexpr int PACK = 13;
constexpr int EXT = 6;
constexpr int MAX_CLUSTER = 8;         // portable cluster size
constexpr int MAX_SMEM = 48 * 1024;    // a block's dynamic shared bytes without the opt-in

enum Path { CLUSTER = 0, STAGE = 1 };

// sqrt((x x + y y) + z z)
template <typename T>
__device__ __forceinline__ T norm3(T x, T y, T z) {
  using A = Arith<T>;
  return A::sqrt(A::add(A::add(A::mul(x, x), A::mul(y, y)), A::mul(z, z)));
}

struct Level {
  int n, nseg, sz, last;
};

// Point i's pass but the extents: its node g, its 6 keys, and its next
// id, shifted delta, leaf and freeze distance written; true when live.
template <typename T>
__device__ __forceinline__ bool point_pass(const T* __restrict__ points, const T* __restrict__ d,
                                           const int* __restrict__ idx,
                                           const T* __restrict__ pack,
                                           long long* __restrict__ leaf_of,
                                           T* __restrict__ frz_dist, T* __restrict__ d_next,
                                           int* __restrict__ idx_next, const Level& lv, int i,
                                           int& g, typename Arith<T>::Key (&key)[EXT]) {
  using A = Arith<T>;
  if (i >= lv.n) return false;
  g = __ldg(idx + i);
  if (g < 0 || g >= lv.nseg) {
    idx_next[i] = -1;
    return false;
  }
  const T* pk = pack + static_cast<long long>(g) * PACK;
  const T* p = points + 3ll * i;
  T d2[3], v[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) d2[c] = A::sub(__ldg(p + c), __ldg(pk + c));
#pragma unroll
  for (int c = 0; c < 3; ++c)
    v[c] = A::add(A::add(A::mul(__ldg(pk + 3 + c), d2[0]), A::mul(__ldg(pk + 6 + c), d2[1])),
                  A::mul(__ldg(pk + 9 + c), d2[2]));
  const bool dead = __ldg(pk + 12) > T(0);
#pragma unroll
  for (int c = 0; c < EXT; ++c) key[c] = A::key(c < 3 ? v[c] : -v[c - 3]);
  if (!dead && !lv.last) {
    T* dn = d_next + 3ll * i;
#pragma unroll
    for (int c = 0; c < 3; ++c) dn[c] = d2[c];
    idx_next[i] = 2 * g + (v[2] >= T(0) ? 1 : 0);
  } else {
    idx_next[i] = -1;
    const long long node = lv.sz + (g & (lv.sz - 1));
    if (dead) {  // the one read of d: the shift from the leaf's mean
      const T* di = d + 3ll * i;
      leaf_of[i] = node >> 1;
      frz_dist[i] = norm3(di[0], di[1], di[2]);
    } else {  // at the depth cap
      leaf_of[i] = node;
      frz_dist[i] = norm3(d2[0], d2[1], d2[2]);
    }
  }
  return true;
}

// a key from its high (signed) and low (unsigned) words
__device__ __forceinline__ long long join_key(int hi, unsigned lo) {
  return static_cast<long long>(
      (static_cast<unsigned long long>(static_cast<unsigned>(hi)) << 32) | lo);
}

template <typename T>
__global__ void __launch_bounds__(CLUSTER_THREADS)
cluster_kernel(const T* __restrict__ points, const T* __restrict__ d,
               const int* __restrict__ idx, const T* __restrict__ pack,
               typename Arith<T>::Key* __restrict__ ext, long long* __restrict__ leaf_of,
               T* __restrict__ frz_dist, T* __restrict__ d_next, int* __restrict__ idx_next,
               Level lv) {
  using A = Arith<T>;
  using Key = typename A::Key;
  constexpr bool WIDE = sizeof(Key) == 8;  // float64: keys in two words
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = lv.nseg * EXT;
  int* hi = reinterpret_cast<int*>(smem);             // float32: the keys
  unsigned* lo = reinterpret_cast<unsigned*>(hi + E);  // float64: the low words
  const Key big = A::big_key();
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    hi[e] = static_cast<int>(big >> (WIDE ? 32 : 0));
    if (WIDE) lo[e] = static_cast<unsigned>(big);
  }
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int g = 0;
  Key key[EXT];
  const bool live = point_pass<T>(points, d, idx, pack, leaf_of, frz_dist, d_next, idx_next,
                                  lv, i, g, key);
  if constexpr (!WIDE) {
    const unsigned live_mask = __ballot_sync(FULL_MASK, live);
    if (live) {
      const int first = __ffs(live_mask) - 1;
      const int g0 = __shfl_sync(live_mask, g, first);
      int* row = hi + g * EXT;
      if (__all_sync(live_mask, g == g0)) {  // one node: one REDUX a column
#pragma unroll
        for (int c = 0; c < EXT; ++c) {
          const int least = __reduce_min_sync(live_mask, key[c]);
          if ((threadIdx.x & 31) == first) atomicMin(row + c, least);
        }
      } else {
#pragma unroll
        for (int c = 0; c < EXT; ++c) atomicMin(row + c, key[c]);
      }
    }
  } else {
    if (live) {
#pragma unroll
      for (int c = 0; c < EXT; ++c) atomicMin(hi + g * EXT + c, static_cast<int>(key[c] >> 32));
    }
    __syncthreads();
    if (live) {
#pragma unroll
      for (int c = 0; c < EXT; ++c)
        if (static_cast<int>(key[c] >> 32) == hi[g * EXT + c])
          atomicMin(lo + g * EXT + c, static_cast<unsigned>(key[c]));
    }
  }

  // this block's slice of the cluster's tables, merged through DSMEM
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int per = (E + C - 1) / C;
  const int e_end = min(E, (rank + 1) * per);
  for (int e = rank * per + threadIdx.x; e < e_end; e += blockDim.x) {
    Key least = big;
    for (int r = 0; r < C; ++r) {
      const int h = cluster.map_shared_rank(hi, r)[e];
      Key k;
      if constexpr (WIDE) {
        k = join_key(h, cluster.map_shared_rank(lo, r)[e]);
      } else {
        k = h;
      }
      least = k < least ? k : least;
    }
    if (least != big) atomicMin(ext + e, least);
  }
  cluster.sync();  // no block leaves while a peer reads its table
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
stage_kernel(const T* __restrict__ points, const T* __restrict__ d,
             const int* __restrict__ idx, const T* __restrict__ pack,
             typename Arith<T>::Key* __restrict__ ext, long long* __restrict__ leaf_of,
             T* __restrict__ frz_dist, T* __restrict__ d_next, int* __restrict__ idx_next,
             Level lv) {
  using Key = typename Arith<T>::Key;
  __shared__ Key stage_key[THREADS * EXT];
  __shared__ int stage_node[THREADS];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int g = 0;
  Key key[EXT];
  const bool live = point_pass<T>(points, d, idx, pack, leaf_of, frz_dist, d_next, idx_next,
                                  lv, i, g, key);
  if (__ballot_sync(FULL_MASK, live) == 0) return;  // a whole warp retired
  const int lane = threadIdx.x & 31;
  Key* sk = stage_key + (threadIdx.x - lane) * EXT;
  int* sn = stage_node + (threadIdx.x - lane);
  sn[lane] = live ? g : -1;
#pragma unroll
  for (int c = 0; c < EXT; ++c) sk[lane * EXT + c] = key[c];
  __syncwarp();
  // instruction k: entries 32 k .. 32 k + 31 of the warp's (32, 6)
  // keys, row by row: ~5 whole rows of the table an instruction
#pragma unroll
  for (int k = 0; k < EXT; ++k) {
    const int e = k * 32 + lane;
    const int p = e / EXT;
    const int node = sn[p];
    if (node >= 0) atomicMin(ext + static_cast<long long>(node) * EXT + (e - p * EXT), sk[e]);
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
                   int* idx_next, int n, int nseg, int sz, int last, int path, int blocks,
                   int cluster, int smem, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const Level lv{n, nseg, sz, last};
  if (path == CLUSTER) {
    if (cluster < 1 || cluster > MAX_CLUSTER || blocks % cluster ||
        static_cast<long long>(blocks) * CLUSTER_THREADS < n || smem > MAX_SMEM ||
        smem < nseg * EXT * static_cast<int>(sizeof(typename Arith<T>::Key)))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks, 1, 1);
    cfg.blockDim = dim3(CLUSTER_THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, cluster_kernel<T>, points, d, idx, pack,
                                               ext, leaf_of, frz_dist, d_next, idx_next, lv);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else if (path == STAGE) {
    if (static_cast<long long>(blocks) * THREADS < n)
      return static_cast<int>(cudaErrorInvalidValue);
    stage_kernel<T><<<blocks, THREADS, 0, stream>>>(points, d, idx, pack, ext, leaf_of,
                                                    frz_dist, d_next, idx_next, lv);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
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
// path (0 cluster, 1 stage), blocks (a point a thread: 512 a block on
// the cluster path, 256 on the stage path), cluster (blocks a cluster,
// 1..8, dividing blocks), smem (dynamic shared bytes a block on the
// cluster path, at least nseg 6 key bytes and at most 48 KB), stream)
int advance_f32(const float* points, const float* d, const int* idx, const float* pack,
                int* ext, long long* leaf_of, float* frz_dist, float* d_next, int* idx_next,
                int n, int nseg, int sz, int last, int path, int blocks, int cluster, int smem,
                void* stream) {
  return launch_advance<float>(points, d, idx, pack, ext, leaf_of, frz_dist, d_next, idx_next,
                               n, nseg, sz, last, path, blocks, cluster, smem,
                               static_cast<cudaStream_t>(stream));
}

int advance_f64(const double* points, const double* d, const int* idx, const double* pack,
                long long* ext, long long* leaf_of, double* frz_dist, double* d_next,
                int* idx_next, int n, int nseg, int sz, int last, int path, int blocks,
                int cluster, int smem, void* stream) {
  return launch_advance<double>(points, d, idx, pack, ext, leaf_of, frz_dist, d_next,
                                idx_next, n, nseg, sz, last, path, blocks, cluster, smem,
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
