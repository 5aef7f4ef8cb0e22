// Approximate-NN descent of the MAD-tree forest (K6), for Hopper (sm_90a).
//
// For each entry i: a no-backtracking descent in the flat (R, 56) table
// `nav`, at rows base_i + node, from the root (node 1), from
// max(start[i], 1) when warm-started, or from node 0 (row 0 of its tree,
// unreal: the entry parks there) when valid[i] is false. Each row holds 7
// panels of 8 values: the node's own block, its 2 children and its 4
// grandchildren; a block is [mean or repr (3), split or normal (3), kids
// or bbox0, flags]. One row advances an entry up to 3 levels: the side
// value sval = (q - c) . n goes right when >= 0; flags >= 2 is real and
// flags == 3 a leaf; kids = left + 2 right child existence. Outputs: the
// LOCAL node id (int64), the final block (8 values) and, optionally, the
// margin: the least |sval| over every real interior node evaluated.
//
// Two ways to name an entry's tree and query:
//   * flat: entry i has its own query queries[i], already in the map
//     frame, and row offset base_q[i] (or base0 for all);
//   * ring (ring_q > 0): entries are tree-major, (T trees) x (ring_q
//     queries); entry i = t ring_q + j descends tree t at rows t ring_m +
//     node with query (t / ring_k) ring_q + j of a (T / ring_k, ring_q, 3)
//     operand: every group of ring_k consecutive trees (a sequence's
//     keyframes) shares its queries, which are never copied K-fold. The
//     queries are in the scan frame: the entry forms its map-frame query
//     from the pose X = pose[t / pose_k] of a (T / pose_k, 4, 4) operand
//     (a sequence's round pose, shared by its pose_k trees), in
//     registers,
//       q_c = ((m_x X_c0 + m_y X_c1) + m_z X_c2) + X_c3,
//     with _rn intrinsics in this order: K7's map-frame point `ml`
//     (csrc/icp_terms.cu) bit for bit, so the descent and the terms' gate
//     see one point. The step hands over its leaves and its pose, and no
//     GEMM forms a (B, L, 3) map-frame copy of them a round.
// A query is read through its operand's strides (q_group, q_row, q_col in
// elements; the flat form's group stride is unused): the step's leaves, a
// strided view of its leaf table, are read where they lie.
// With `merge` (ring or flat) an entry whose valid flag is false is not
// descended and its outputs are not written: the caller's buffers keep
// what they held (the certified schedule's re-association merges a
// round's fresh results into the previous round's this way, in place).
//
// It is the counterpart of madicp_tpu_torch/ops/tree.py `search_forest`
// and ops/icp_core.py `associate_ring` (plain versions: kernels/
// descent.py `descend_plain`, and `descend_ring_plain`, the plain descent
// followed by the merge's three torch.where), which port the JAX package's
// madicp_tpu/ops/tree.py:685 `search_forest`, gather path, and
// madicp_tpu/models/pipeline.py:569 `reassociate`; XLA lowered those, so
// no Pallas kernel stands behind them.
//
// Bound on an H100: the bytes of the distinct panels the descents read
// plus the queries in (12 bytes of a scan-frame point in float32, as many
// as a map-frame one, and 64 bytes a pose) and the entries' flags and
// outputs (3.35 TB/s). The transform is 9 products and 9 sums a descended
// entry, against ~8 operations a panel read. A
// descent is a chain of dependent panel reads (up to 3 a row, 6 rows at
// depth 16), most of them L2 or HBM misses, so the kernel is bound by how
// many chains it keeps in flight, not by the bytes.
//
// Design (one thread a descent):
//   * merged (descend_merge_kernel): a later certified round descends
//     ~16% of its entries, anywhere. Each warp reads CHUNKS x 32 flags,
//     queues the live entries (ballot ranks) in shared memory and
//     descends them one a lane, so a parked entry costs a flag read and
//     no thread, and the grid (one warp a 128 entries) runs in one wave.
//     Two entries a thread or four, their panel loads interleaved, were
//     slower in every case on an H100 (the registers they take cost more
//     resident threads than the loads in flight gain).
//   * a row read takes only the panels the entry needs: panel 0, the
//     child its first side picks, the grandchild its second side picks
//     (3 x 32 B in float32, against the whole 224 B row). Rows are 224 B
//     apart, so every panel is one 32-byte sector wherever the table
//     starts on one; VEC loads a panel as 16-byte vectors (the wrapper
//     checks the alignment).
//   * an entry stops after the first row in which it takes no step: the
//     plain loop would only read the same row again and change nothing
//     (panel 0 is bitwise the block it holds, the margin's min is
//     idempotent). An entry that stepped in a row reads the next one
//     while gathers remain, as the plain loop does. A parked entry costs
//     one panel read; under `merge` none.
//   * the side value is formed with _rn intrinsics in the plain version's
//     order, ((q - c) * n summed as (p0 + p1) + p2): nvcc would contract
//     a*b + c into an FMA, and one FMA flips a query that lies on a split
//     plane. So ids, blocks and margins equal the plain version's bit for
//     bit on the card.
//   * ring form: each descended entry reads its tree's pose (12 values at
//     one address across a warp's lanes: a broadcast, from L1 after the
//     first warp) and forms its query while its first panel read is in
//     flight, so the transform adds no latency to the chain; the merged
//     kernel forms it only for the live entries it queues. (A block-wide
//     load of the poses into shared memory behind a barrier put a
//     dependent load ahead of every block's flag scan: +24% on a KITTI
//     scan's merged rounds on an H100.) A query's rounding in this order
//     is within the certificate's floor eps_cert (kernels/
//     certify_slack.py: three products and three sums a coordinate,
//     |error| <= 2.01 eps (|m| + |t_c|), the bound the GEMM it replaces
//     met in any order).
// The kernel allocates nothing, reads nothing back to the host, writes
// each output element at most once (no atomics) and launches on the
// caller's stream, so it can be captured in a CUDA graph and a replay
// equals an eager call bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "arith.cuh"

namespace {

using madicp::Arith;

constexpr int NAV = 56;
constexpr int THREADS = 256;

// a panel of 8 values as 16-byte loads and stores
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void store_vec(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void load_vec(const double* p, double* out) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const double2 a = __ldg(reinterpret_cast<const double2*>(p) + k);
    out[2 * k] = a.x;
    out[2 * k + 1] = a.y;
  }
}

__device__ __forceinline__ void store_vec(double* p, const double* v) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    reinterpret_cast<double2*>(p)[k] = make_double2(v[2 * k], v[2 * k + 1]);
}

template <typename T, bool VEC>
__device__ __forceinline__ void load_panel(const T* p, T* out) {
  if (VEC) {
    load_vec(p, out);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) out[k] = __ldg(p + k);
  }
}

// torch.minimum: NaN if either is NaN, else the smaller
template <typename T>
__device__ __forceinline__ T minimum(T a, T b) {
  if (a != a || b != b) return Arith<T>::nan();
  return a < b ? a : b;
}

template <typename T>
struct Args {
  const T* nav;
  const T* queries;
  long long q_group, q_row, q_col;  // the queries' strides (elements)
  const int64_t* base_q;  // flat: (n,) row offsets, or null for base0
  long long base0;
  const uint8_t* valid;  // (n,) or null
  const int64_t* start;  // (n,) or null
  long long n;           // entries
  int depth, n_gathers, known_levels, merge;
  long long ring_q, ring_k, ring_m;  // ring_q > 0: the ring form
  const T* pose;                     // ring form: (T / pose_k, 4, 4) scan to map
  long long pose_k;                  // trees a pose
  int64_t* node_out;
  T* blk_out;
  T* margin_out;
};

// the descent of entry i (0 <= i < n): parked on row 0 of its tree where
// its valid flag is false (under merge the caller passes valid entries);
// in the ring form its query is mapped by its tree's pose, pose[t / pose_k]
template <typename T, bool VEC>
__device__ __forceinline__ void descend_one(const Args<T>& a, long long i) {
  using A = Arith<T>;
  long long qoff, base, t = 0;
  if (a.ring_q > 0) {
    t = i / a.ring_q;
    qoff = (t / a.ring_k) * a.q_group + (i - t * a.ring_q) * a.q_row;
    base = t * a.ring_m;
  } else {
    qoff = i * a.q_row;
    base = a.base_q != nullptr ? a.base_q[i] : a.base0;
  }
  const T* tree = a.nav + base * NAV;
  int64_t node = 1;
  if (a.start != nullptr) node = a.start[i] > 1 ? a.start[i] : 1;
  if (a.valid != nullptr && !a.valid[i]) node = 0;
  const T* qp = a.queries + qoff;
  T qx = qp[0], qy = qp[a.q_col], qz = qp[2 * a.q_col];
  T blk[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) blk[k] = T(0);
  // the first row's panel 0 is read while the query is formed
  const T* row = tree + node * NAV;
  if (a.n_gathers > 0) load_panel<T, VEC>(row, blk);
  if (a.pose != nullptr) {  // K7's ml: ((m_x X_c0 + m_y X_c1) + m_z X_c2) + X_c3
    const T* pp = a.pose + 16 * (t / a.pose_k);
    T X[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) X[k] = __ldg(pp + k);
    const T mx = qx, my = qy, mz = qz;
    qx = A::add(A::add(A::add(A::mul(mx, X[0]), A::mul(my, X[1])), A::mul(mz, X[2])), X[3]);
    qy = A::add(A::add(A::add(A::mul(mx, X[4]), A::mul(my, X[5])), A::mul(mz, X[6])), X[7]);
    qz = A::add(A::add(A::add(A::mul(mx, X[8]), A::mul(my, X[9])), A::mul(mz, X[10])), X[11]);
  }
  T margin = A::max_value();

  for (int g = 0; g < a.n_gathers; ++g) {
    if (g > 0) {
      row = tree + node * NAV;
      load_panel<T, VEC>(row, blk);
    }
    bool stepped = false;
    int b1 = 0;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      if (a.known_levels && g * 3 + s >= a.depth) break;  // below the depth cap
      const T p0 = A::mul(A::sub(qx, blk[0]), blk[3]);
      const T p1 = A::mul(A::sub(qy, blk[1]), blk[4]);
      const T p2 = A::mul(A::sub(qz, blk[2]), blk[5]);
      const T sval = A::add(A::add(p0, p1), p2);
      const bool side = sval >= T(0);
      const T kids = blk[6], flags = blk[7];
      const bool has = side ? kids >= T(2) : (kids == T(1) || kids == T(3));
      // every real interior node evaluated is consequential
      const bool consider = flags >= T(2) && flags != T(3);
      if (a.margin_out != nullptr && consider) margin = minimum(margin, fabs(sval));
      // no step: the rest of the row (and every later row) repeats this
      if (!(consider && has)) break;
      node = 2 * node + (side ? 1 : 0);
      stepped = true;
      if (s == 0) {
        load_panel<T, VEC>(row + 8 + 8 * side, blk);  // a child
        b1 = side;
      } else if (s == 1) {
        load_panel<T, VEC>(row + 24 + 16 * b1 + 8 * side, blk);  // a grandchild
      }
      // s == 2: the node steps, its block is read with the next row
    }
    if (!stepped) break;
  }

  a.node_out[i] = node;
  if (a.blk_out != nullptr) {
    if (VEC) {
      store_vec(a.blk_out + 8 * i, blk);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) a.blk_out[8 * i + k] = blk[k];
    }
  }
  if (a.margin_out != nullptr) a.margin_out[i] = margin;
}

// every entry, one a thread
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
descend_kernel(const Args<T> a) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i < a.n) descend_one<T, VEC>(a, i);
}

// merged: each warp scans CHUNKS x 32 entries' valid flags and queues the
// valid ones (ballot ranks) in shared memory; each batch of up to 32
// queued entries is descended one a lane. Parked entries cost a flag read
// and no lane, so a round whose few live entries lie anywhere takes about
// one descent's chain a warp, in one wave.
constexpr int WARPS = THREADS / 32;
constexpr int CHUNKS = 4;
// blocks an SM holds: float's merged descent capped at 40 registers keeps
// 1,536 threads' chains in flight (the query's transform would take it to
// 48 and 1,280); double's 56 registers are under its cap
template <typename T>
constexpr int merge_blocks() { return sizeof(T) == 4 ? 6 : 4; }

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, merge_blocks<T>())
descend_merge_kernel(const Args<T> a) {
  __shared__ long long queue[WARPS][64];
  const int lane = threadIdx.x & 31;
  long long* qw = queue[threadIdx.x >> 5];
  const long long tile0 =
      (static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5)) * 32 * CHUNKS + lane;
  unsigned bits = 0;  // chunk c's flag of this lane
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const long long e = tile0 + 32 * c;
    if (e < a.n && a.valid[e]) bits |= 1u << c;
  }
  const unsigned below = (1u << lane) - 1u;
  int c = 0, count = 0;  // chunks queued, entries in the queue (warp-uniform)
#pragma unroll 1
  while (c < CHUNKS || count > 0) {
    if (c < CHUNKS) {
      const bool live = (bits >> c) & 1u;
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      if (live) qw[count + __popc(mask & below)] = tile0 + 32 * c;
      count += __popc(mask);
      ++c;
    }
    if (count < 32 && (c < CHUNKS || count == 0)) continue;
    __syncwarp();
    const int take = count < 32 ? count : 32;
    const long long mine = lane < take ? qw[lane] : -1;
    const int rest = count - take;  // < 32: move them to the front
    const long long moved = lane < rest ? qw[take + lane] : 0;
    __syncwarp();
    if (lane < rest) qw[lane] = moved;
    count = rest;
    __syncwarp();
    if (mine >= 0) descend_one<T, VEC>(a, mine);
  }
}

template <typename T, bool VEC>
void launch_vec(const Args<T>& a, cudaStream_t stream) {
  const long long per_block = a.merge ? 32LL * CHUNKS * WARPS : THREADS;
  const unsigned blocks = static_cast<unsigned>((a.n + per_block - 1) / per_block);
  if (a.merge) {
    descend_merge_kernel<T, VEC><<<blocks, THREADS, 0, stream>>>(a);
  } else {
    descend_kernel<T, VEC><<<blocks, THREADS, 0, stream>>>(a);
  }
}

template <typename T>
int launch(const T* nav, const T* queries, long long q_group, long long q_row,
           long long q_col, const int64_t* base_q, long long base0,
           const uint8_t* valid, const int64_t* start, long long n, int depth,
           int n_gathers, int known_levels, int vec, long long ring_q, long long ring_k,
           long long ring_m, const T* pose, long long pose_k, int merge, int64_t* node_out,
           T* blk_out, T* margin_out, cudaStream_t stream) {
  if (merge && valid == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (pose != nullptr && (ring_q <= 0 || pose_k <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const Args<T> a{nav, queries, q_group, q_row, q_col, base_q, base0, valid, start, n, depth, n_gathers,
                  known_levels, merge, ring_q, ring_k, ring_m, pose, pose_k, node_out,
                  blk_out, margin_out};
  if (vec) {
    launch_vec<T, true>(a, stream);
  } else {
    launch_vec<T, false>(a, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain C interface for ctypes: (nav (R, 56), queries (n, 3) flat in the
// map frame or (T / ring_k, ring_q, 3) ring in the scan frame, their
// strides q_group, q_row, q_col in elements, base_q (n,) int64 or null
// with base0 the offset of every entry (flat), valid (n,) bool or null,
// start (n,) int64 or null, n, depth, n_gathers, known_levels (1: the
// depth cap applies, no warm start), vec (1: nav and blk_out are 16-byte
// aligned), ring_q (0: flat), ring_k, ring_m (rows a tree), pose (T /
// pose_k, 4, 4) the ring form's scan-to-map poses (null in the flat
// form), pose_k (trees a pose), merge (1: entries with valid false are
// neither descended nor written), node_out (n,) int64, blk_out (n, 8) or
// null, margin_out (n,) or null, stream). Every array but the queries is
// contiguous. Returns the cudaGetLastError() code after the launch (0 =
// success).
int descend_f32(const float* nav, const float* queries, long long q_group, long long q_row,
                long long q_col, const int64_t* base_q, long long base0, const uint8_t* valid,
                const int64_t* start, long long n, int depth, int n_gathers, int known_levels,
                int vec, long long ring_q, long long ring_k, long long ring_m, const float* pose,
                long long pose_k, int merge, int64_t* node_out, float* blk_out,
                float* margin_out, void* stream) {
  return launch<float>(nav, queries, q_group, q_row, q_col, base_q, base0, valid, start, n,
                       depth, n_gathers, known_levels, vec, ring_q, ring_k, ring_m, pose, pose_k,
                       merge, node_out, blk_out, margin_out, static_cast<cudaStream_t>(stream));
}

int descend_f64(const double* nav, const double* queries, long long q_group, long long q_row,
                long long q_col, const int64_t* base_q, long long base0, const uint8_t* valid,
                const int64_t* start, long long n, int depth, int n_gathers, int known_levels,
                int vec, long long ring_q, long long ring_k, long long ring_m,
                const double* pose, long long pose_k, int merge, int64_t* node_out,
                double* blk_out, double* margin_out, void* stream) {
  return launch<double>(nav, queries, q_group, q_row, q_col, base_q, base0, valid, start, n,
                        depth, n_gathers, known_levels, vec, ring_q, ring_k, ring_m, pose,
                        pose_k, merge, node_out, blk_out, margin_out,
                        static_cast<cudaStream_t>(stream));
}

const char* madicp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
