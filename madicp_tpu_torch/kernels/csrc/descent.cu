// Approximate-NN descent of the MAD-tree forest (K6), for Hopper (sm_90a).
//
// For each query i: a no-backtracking descent in the flat (R, 56) table
// `nav`, at rows base[i] + node, from the root (node 1), from
// max(start[i], 1) when warm-started, or from node 0 (row 0 of its tree,
// unreal: the query parks there) when valid[i] is false. Each row holds 7
// panels of 8 values: the node's own block, its 2 children and its 4
// grandchildren; a block is [mean or repr (3), split or normal (3), kids
// or bbox0, flags]. One row advances a query up to 3 levels: the side
// value sval = (q - c) . n goes right when >= 0; flags >= 2 is real and
// flags == 3 a leaf; kids = left + 2 right child existence. Outputs: the
// LOCAL node id (int64), the final block (8 values) and, optionally, the
// margin: the least |sval| over every real interior node evaluated.
//
// It is the counterpart of madicp_tpu_torch/ops/tree.py `search_forest`
// (plain version: kernels/descent.py `descend_plain`), which ports the
// JAX package's madicp_tpu/ops/tree.py:685 `search_forest`, gather path;
// XLA lowered that one, so no Pallas kernel stands behind it.
//
// Bound on an H100: the bytes of the distinct panels the descents read
// plus the queries in and the ids, blocks and margins out (3.35 TB/s);
// at the flagship (16 keyframes x 32768 leaves) that is well under 1 ms a
// scan. In practice it is latency-bound: a query's panel reads are
// dependent, up to 3 a row.
//
// Design (one thread a query):
//   * a row read takes only the panels the query needs: panel 0, then the
//     child panel its first side picks, then the grandchild panel its
//     second side picks (3 x 32 B in float32, against the whole 224 B
//     row). Rows are 224 B apart, so every panel is one 32-byte sector
//     wherever the table starts on one; VEC loads a panel as 16-byte
//     vectors (the wrapper checks the alignment).
//   * a query stops after the first row in which it takes no step: the
//     plain loop would only read the same row again and change nothing
//     (panel 0 is bitwise the block it holds, the margin's min is
//     idempotent). A query that stepped in a row reads the next one while
//     gathers remain, as the plain loop does: that fetches panel 0 of a
//     node entered on the third substep (whose block is stale until then)
//     and the node's own panel 0 wherever it entered through a copy.
//     A parked query (node 0) costs one panel read.
//   * the side value is formed with _rn intrinsics in the plain version's
//     order, ((q - c) * n summed as (p0 + p1) + p2): nvcc would contract
//     a*b + c into an FMA, and one FMA flips a query that lies on a split
//     plane. So ids, blocks and margins equal the plain version's bit for
//     bit on the card.
// The kernel writes every output of every query, allocates nothing, reads
// nothing back to the host and launches on the caller's stream, so it can
// be captured in a CUDA graph.

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

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
descend_kernel(const T* __restrict__ nav, const T* __restrict__ queries,
               const int64_t* __restrict__ base_q, int64_t base0,
               const uint8_t* __restrict__ valid, const int64_t* __restrict__ start,
               int n_queries, int depth, int n_gathers, int known_levels,
               int64_t* __restrict__ node_out, T* __restrict__ blk_out,
               T* __restrict__ margin_out) {
  using A = Arith<T>;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_queries) return;
  int64_t node = 1;
  if (start != nullptr) node = start[i] > 1 ? start[i] : 1;
  if (valid != nullptr && !valid[i]) node = 0;
  const int64_t base = base_q != nullptr ? base_q[i] : base0;
  const T qx = queries[3 * i], qy = queries[3 * i + 1], qz = queries[3 * i + 2];
  T blk[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) blk[k] = T(0);
  T margin = A::max_value();

  for (int g = 0; g < n_gathers; ++g) {
    const T* row = nav + (base + node) * NAV;
    load_panel<T, VEC>(row, blk);
    bool stepped = false;
    int b1 = 0;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      if (known_levels && g * 3 + s >= depth) break;  // below the depth cap
      const T p0 = A::mul(A::sub(qx, blk[0]), blk[3]);
      const T p1 = A::mul(A::sub(qy, blk[1]), blk[4]);
      const T p2 = A::mul(A::sub(qz, blk[2]), blk[5]);
      const T sval = A::add(A::add(p0, p1), p2);
      const bool side = sval >= T(0);
      const T kids = blk[6], flags = blk[7];
      const bool has = side ? kids >= T(2) : (kids == T(1) || kids == T(3));
      // every real interior node evaluated is consequential
      const bool consider = flags >= T(2) && flags != T(3);
      if (margin_out != nullptr && consider) margin = minimum(margin, fabs(sval));
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

  node_out[i] = node;
  if (blk_out != nullptr) {
    if (VEC) {
      store_vec(blk_out + 8 * static_cast<int64_t>(i), blk);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) blk_out[8 * static_cast<int64_t>(i) + k] = blk[k];
    }
  }
  if (margin_out != nullptr) margin_out[i] = margin;
}

template <typename T>
int launch(const T* nav, const T* queries, const int64_t* base_q, long long base0,
           const uint8_t* valid, const int64_t* start, int n_queries, int depth,
           int n_gathers, int known_levels, int vec, int64_t* node_out, T* blk_out,
           T* margin_out, cudaStream_t stream) {
  if (n_queries <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (n_queries + THREADS - 1) / THREADS;
  if (vec) {
    descend_kernel<T, true><<<blocks, THREADS, 0, stream>>>(
        nav, queries, base_q, base0, valid, start, n_queries, depth, n_gathers,
        known_levels, node_out, blk_out, margin_out);
  } else {
    descend_kernel<T, false><<<blocks, THREADS, 0, stream>>>(
        nav, queries, base_q, base0, valid, start, n_queries, depth, n_gathers,
        known_levels, node_out, blk_out, margin_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain C interface for ctypes: (nav (R, 56), queries (Q, 3), base_q (Q,)
// int64 or null with base0 the offset of every query, valid (Q,) bool or
// null, start (Q,) int64 or null, Q, depth, n_gathers, known_levels (1:
// the depth cap applies, no warm start), vec (1: nav and blk_out are
// 16-byte aligned), node_out (Q,) int64, blk_out (Q, 8) or null,
// margin_out (Q,) or null, stream). Every array is contiguous. Returns the
// cudaGetLastError() code after the launch (0 = success).
int descend_f32(const float* nav, const float* queries, const int64_t* base_q,
                long long base0, const uint8_t* valid, const int64_t* start,
                int n_queries, int depth, int n_gathers, int known_levels, int vec,
                int64_t* node_out, float* blk_out, float* margin_out, void* stream) {
  return launch<float>(nav, queries, base_q, base0, valid, start, n_queries, depth,
                       n_gathers, known_levels, vec, node_out, blk_out, margin_out,
                       static_cast<cudaStream_t>(stream));
}

int descend_f64(const double* nav, const double* queries, const int64_t* base_q,
                long long base0, const uint8_t* valid, const int64_t* start,
                int n_queries, int depth, int n_gathers, int known_levels, int vec,
                int64_t* node_out, double* blk_out, double* margin_out, void* stream) {
  return launch<double>(nav, queries, base_q, base0, valid, start, n_queries, depth,
                        n_gathers, known_levels, vec, node_out, blk_out, margin_out,
                        static_cast<cudaStream_t>(stream));
}

const char* madicp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
