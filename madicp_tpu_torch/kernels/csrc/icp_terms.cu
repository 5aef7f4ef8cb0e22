// Point-to-plane ICP terms and normal equations (K7), for Hopper (sm_90a).
//
// From an association payload (..., L, 8) = [f (3), n (3), bbox0, flags],
// the moving points m (..., L, 3) in the scan frame, the valid mask
// (..., L), the pose X (..., 4, 4) and optionally the live entries n_live
// (...) int64, each with leading axes that broadcast (strides, 0 where an
// axis broadcasts), for each entry l below the leading index's bound
// min(n_live, L) (L without n_live):
//   map frame ml_c = ((m_x R_c0 + m_y R_c1) + m_z R_c2) + t_c
//   gate      matched = |ml - f| <= b_max + b_ratio |m|, valid, flags == 3
//   residual  e = (ml - f) . n
//   Jacobian  J = [u, m x u], u = R^T n
//   weight    s = huber(|e|, rho) (1 - bbox0 / b_max)^2 matched
// and for each leading index the 21 sums of (s J)^T J and the 6 of s J e,
// filled into a symmetric H (..., 6, 6) and b (..., 6), plus matched
// (false from the bound on; not written at all where the caller takes no
// matched). Entries past the bound are not read: the pipeline's leaves are
// a prefix of their slots (get_leaves), so n_live = the count of valid
// leaves cuts off only entries whose terms are exactly zero.
//
// It is the counterpart of madicp_tpu_torch/ops/icp_core.py
// `terms_from_payload` (plain version: kernels/icp_terms.py
// `terms_plain`), which ports the JAX package's
// madicp_tpu/ops/icp_core.py:69 `terms_from_payload`; XLA lowered that
// one, so no Pallas kernel stands behind it.
//
// Bound on an H100: bytes (payload, points, valid and X in; matched, H and
// b out) at 3.35 TB/s; ~130 float operations an entry are ~1/10 of that
// at the float32 peak. At the flagship (16 keyframes x 32768 leaves) the
// payload alone is 16.8 MB a round, ~5 us; a KITTI scan's ~59,000 leaves
// in 131,072 slots read 30 MB of payload a round below the bound, 67 MB
// without it.
//
// Design (one launch a call):
//   * a thread-block cluster a leading index; its blocks split the
//     leading index's bound into contiguous tiles (formed in the kernel,
//     a whole number of warps each, so every block of the cluster walks
//     its share of the live entries whatever the bound), and a thread
//     walks its tile in steps of the block, loading each entry before it
//     forms the one before it. The work is
//     latency- and issue-bound (27 double FMAs and 13 conversions an
//     entry), so the wrapper's plan (kernels/icp_terms.py `plan`) puts as
//     many threads on a leading index as the card holds in one wave: the
//     block (256 or 512 threads, at most 128 registers each, so 16 warps
//     an SM) and the cluster (1..8 blocks) come from the clusters the
//     card reports it holds at once (icp_terms_max_clusters). On the H100
//     the flagship's 16 keyframes take clusters of 6 blocks of 512: 8
//     would take two waves (15 fit at once). The plan is made for L at
//     capture; a graph's replay re-tiles each scan's own bound.
//   * with matched wanted, the cluster's threads store zeros from the
//     bound to L as 16-byte vectors (a replay reuses the buffer, so a scan
//     with fewer leaves must not show the previous scan's flags).
//   * a thread forms each entry's values with _rn intrinsics in the plain
//     version's order (so `matched` equals it bit for bit; nvcc would
//     otherwise contract a*b + c into FMAs), the map-frame point ml
//     included (the wrapper no longer forms it with a GEMM), then adds the
//     27 terms in double.
//   * a contiguous payload row (8 values, 16-byte aligned) is read as two
//     16-byte loads (four in float64); a view broadcast along its entries
//     or strided takes scalar loads through its strides.
//   * the block reduces its 27 sums by warp shuffles, then the warps in
//     order through shared memory; after a cluster barrier the cluster's
//     first block adds its peers' partials through distributed shared
//     memory in rank order and writes H (both triangles) and b, and a
//     second barrier keeps every block alive until it has read them.
// Every sum has a fixed order and no atomics and no workspace exist, so a
// CUDA graph's replay equals the eager call bit for bit, and two streams
// never share scratch. The weight takes bbox0 times the reciprocal of
// b_max formed in the working type, as torch's CUDA division of a tensor
// by a host scalar does; the sums' order differs from the plain
// version's by design.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "arith.cuh"

namespace {

namespace cg = cooperative_groups;
using madicp::Arith;

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int REGS = 128;  // registers a thread, at most: 16 warps an SM
constexpr int NSUM = 27;  // 21 of H (upper triangle, row-major) and 6 of b
constexpr int NLEAD = 4;  // leading axes the wrapper pads to
constexpr int MAX_CLUSTER = 8;  // portable cluster size

// one operand's strides in elements: its leading axes, then its own two
struct View {
  long long lead[NLEAD];
  long long row;  // between entries (X: between rows)
  long long col;  // between values of an entry (X: between columns)
};

struct Params {
  long long shape[NLEAD];
  View pay, m, valid, x;
  long long live[NLEAD];  // n_live's leading strides
  int L, cluster;
};

__constant__ int H_ROW[21] = {0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 4, 4, 5};
__constant__ int H_COL[21] = {0, 1, 2, 3, 4, 5, 1, 2, 3, 4, 5, 2, 3, 4, 5, 3, 4, 5, 4, 5, 5};

// torch.clamp(x, min=lo): NaN passes through
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return x != x ? x : (x < lo ? lo : x);
}

__device__ __forceinline__ long long offset(const long long* lead, const long long* idx) {
  return idx[0] * lead[0] + idx[1] * lead[1] + idx[2] * lead[2] + idx[3] * lead[3];
}

__device__ __forceinline__ long long offset(const View& v, const long long* idx) {
  return offset(v.lead, idx);
}

// the 8 payload values of entry l: two (float) or four (double) 16-byte
// loads of a contiguous aligned row, else 8 strided scalar loads
template <typename T, bool VEC>
__device__ __forceinline__ void load_row(const T* __restrict__ pay, const View& v, int l,
                                         T (&f)[8]) {
  if constexpr (VEC) {
    const T* row = pay + 8ll * l;
    if constexpr (sizeof(T) == 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(row));
      const float4 b = __ldg(reinterpret_cast<const float4*>(row) + 1);
      f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
      f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
    } else {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const double2 a = __ldg(reinterpret_cast<const double2*>(row) + h);
        f[2 * h] = a.x;
        f[2 * h + 1] = a.y;
      }
    }
  } else {
    const T* row = pay + l * v.row;
#pragma unroll
    for (int c = 0; c < 8; ++c) f[c] = row[c * v.col];
  }
}

// one entry's inputs: its payload row, its moving point and valid flag
template <typename T>
struct Entry {
  T f[8], m[3];
  bool valid;
};

template <typename T, bool VEC>
__device__ __forceinline__ void load_entry(const T* __restrict__ pay, const T* __restrict__ mp,
                                           const uint8_t* __restrict__ vp, const Params& p,
                                           int l, Entry<T>& x) {
  load_row<T, VEC>(pay, p.pay, l, x.f);
  const T* mm = mp + l * p.m.row;
  x.m[0] = __ldg(mm);
  x.m[1] = __ldg(mm + p.m.col);
  x.m[2] = __ldg(mm + 2 * p.m.col);
  x.valid = __ldg(vp + l * p.valid.row) != 0;
}

// zeros into bytes [lo, hi) of row, by `nthreads` threads (this one
// `tid`): 16-byte stores from the first aligned byte, single bytes around
__device__ __forceinline__ void zero_bytes(uint8_t* __restrict__ row, int lo, int hi, int tid,
                                           int nthreads) {
  if (lo >= hi) return;
  const uintptr_t at = reinterpret_cast<uintptr_t>(row + lo);
  const int head = min(hi - lo, static_cast<int>((16 - at % 16) % 16));
  const int n16 = (hi - lo - head) / 16;
  if (tid < head) row[lo + tid] = 0;
  uint4* v = reinterpret_cast<uint4*>(row + lo + head);
  for (int i = tid; i < n16; i += nthreads) v[i] = make_uint4(0, 0, 0, 0);
  for (int i = lo + head + 16 * n16 + tid; i < hi; i += nthreads) row[i] = 0;
}

// entry l's values in the plain version's order, its matched flag
// written (where wanted) and its 27 terms added to acc
template <typename T>
__device__ __forceinline__ void form_entry(const Entry<T>& x, const T (&R)[3][3],
                                           const T (&t)[3], T inv_b_max, T b_ratio, T b_max,
                                           T rho, uint8_t* __restrict__ matched, int l,
                                           double (&acc)[NSUM]) {
  using A = Arith<T>;
  const T fx = x.f[0], fy = x.f[1], fz = x.f[2];
  const T nx = x.f[3], ny = x.f[4], nz = x.f[5];
  const T bbox0 = x.f[6], flags = x.f[7];
  const T mx = x.m[0], my = x.m[1], mz = x.m[2];
  // the map-frame point
  T ml[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    ml[c] = A::add(A::add(A::add(A::mul(mx, R[c][0]), A::mul(my, R[c][1])), A::mul(mz, R[c][2])),
                   t[c]);

  // adaptive-radius gate
  const T dx = A::sub(ml[0], fx), dy = A::sub(ml[1], fy), dz = A::sub(ml[2], fz);
  const T dist = A::sqrt(A::add(A::add(A::mul(dx, dx), A::mul(dy, dy)), A::mul(dz, dz)));
  const T rng = A::sqrt(A::add(A::add(A::mul(mx, mx), A::mul(my, my)), A::mul(mz, mz)));
  const T src_ball = A::add(A::mul(b_ratio, rng), b_max);
  const bool ok = dist <= src_ball && x.valid && flags == T(3);
  if (matched != nullptr) matched[l] = ok;

  // residual and analytic Jacobian, u = R^T n
  const T e = A::add(A::add(A::mul(dx, nx), A::mul(dy, ny)), A::mul(dz, nz));
  const T ux = A::add(A::add(A::mul(nx, R[0][0]), A::mul(ny, R[1][0])), A::mul(nz, R[2][0]));
  const T uy = A::add(A::add(A::mul(nx, R[0][1]), A::mul(ny, R[1][1])), A::mul(nz, R[2][1]));
  const T uz = A::add(A::add(A::mul(nx, R[0][2]), A::mul(ny, R[1][2])), A::mul(nz, R[2][2]));
  const T J[6] = {ux, uy, uz, A::sub(A::mul(my, uz), A::mul(mz, uy)),
                  A::sub(A::mul(mz, ux), A::mul(mx, uz)), A::sub(A::mul(mx, uy), A::mul(my, ux))};

  // Huber clamp times the squared planarity weight, gated
  const T chi = fabs(e);
  const T scale = chi > rho ? A::div(rho, clamp_min(chi, T(1e-30))) : T(1);
  T w = A::sub(T(1), A::mul(bbox0, inv_b_max));
  w = w != w ? w : (w < T(0) ? T(0) : (w > T(1) ? T(1) : w));
  const T s = A::mul(A::mul(A::mul(scale, w), w), ok ? T(1) : T(0));

  double Js[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) Js[a] = static_cast<double>(A::mul(J[a], s));
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int c = a; c < 6; ++c) acc[k++] += Js[a] * static_cast<double>(J[c]);
#pragma unroll
  for (int a = 0; a < 6; ++a) acc[21 + a] += Js[a] * static_cast<double>(e);
}

template <typename T, bool VEC, int THREADS>
__global__ void __launch_bounds__(THREADS, 65536 / (REGS * THREADS))
terms_kernel(Params p, const T* __restrict__ payload, const T* __restrict__ mpts,
             const uint8_t* __restrict__ valid, const T* __restrict__ X,
             const long long* __restrict__ n_live, T inv_b_max, T b_ratio, T b_max, T rho,
             uint8_t* __restrict__ matched_out, T* __restrict__ H, T* __restrict__ b) {
  constexpr int WARPS = THREADS / 32;
  __shared__ double red[WARPS][NSUM];
  __shared__ double part[NSUM];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lead = blockIdx.x / p.cluster;
  long long idx[NLEAD];
  long long rem = lead;
#pragma unroll
  for (int d = NLEAD - 1; d >= 0; --d) {
    idx[d] = rem % p.shape[d];
    rem /= p.shape[d];
  }
  const T* pay = payload + offset(p.pay, idx);
  const T* mp = mpts + offset(p.m, idx);
  const uint8_t* vp = valid + offset(p.valid, idx);
  const T* xp = X + offset(p.x, idx);
  T R[3][3], t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i][j] = xp[i * p.x.row + j * p.x.col];
    t[i] = xp[i * p.x.row + 3 * p.x.col];
  }
  uint8_t* matched =
      matched_out == nullptr ? nullptr : matched_out + static_cast<long long>(lead) * p.L;
  // the leading index's bound, and the block's tile of it
  int bound = p.L;
  if (n_live != nullptr) {
    const long long n = __ldg(n_live + offset(p.live, idx));
    bound = static_cast<int>(n < 0 ? 0 : (n < p.L ? n : p.L));
  }
  const int tile =
      static_cast<int>(((static_cast<long long>(bound) + p.cluster - 1) / p.cluster + 31) & ~31ll);

  double acc[NSUM];
#pragma unroll
  for (int k = 0; k < NSUM; ++k) acc[k] = 0.0;

  // the block's tile, a thread's entries a block apart; each entry's
  // loads are issued before the previous entry is formed
  const int hi = min(bound, (rank + 1) * tile);
  int l = rank * tile + threadIdx.x;
  Entry<T> cur;
  if (l < hi) load_entry<T, VEC>(pay, mp, vp, p, l, cur);
  for (; l < hi; l += THREADS) {
    Entry<T> next;
    if (l + THREADS < hi) load_entry<T, VEC>(pay, mp, vp, p, l + THREADS, next);
    form_entry<T>(cur, R, t, inv_b_max, b_ratio, b_max, rho, matched, l, acc);
    cur = next;
  }
  // matched reads false from the bound on
  if (matched != nullptr)
    zero_bytes(matched, bound, p.L, rank * THREADS + threadIdx.x, p.cluster * THREADS);

  // the block's 27 sums, in a fixed order: lanes, then warps
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NSUM; ++k) {
    double v = acc[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL_MASK, v, o);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < NSUM) {
    double v = 0.0;
#pragma unroll
    for (int w8 = 0; w8 < WARPS; ++w8) v += red[w8][threadIdx.x];
    part[threadIdx.x] = v;
  }
  // the cluster's partials, in rank order, by its first block
  cluster.sync();
  if (rank == 0 && threadIdx.x < NSUM) {
    const int k = threadIdx.x;
    double v = part[k];
    for (int r = 1; r < p.cluster; ++r) v += cluster.map_shared_rank(part, r)[k];
    const T out = static_cast<T>(v);
    if (k < 21) {
      H[lead * 36 + H_ROW[k] * 6 + H_COL[k]] = out;
      H[lead * 36 + H_COL[k] * 6 + H_ROW[k]] = out;
    } else {
      b[lead * 6 + k - 21] = out;
    }
  }
  cluster.sync();  // no block leaves while its partials are read
}

View read_view(const long long*& meta) {
  View v;
  for (int d = 0; d < NLEAD; ++d) v.lead[d] = *meta++;
  v.row = *meta++;
  v.col = *meta++;
  return v;
}

// the kernel for a working type, a load path and a block size
template <typename T>
using Kernel = void (*)(Params, const T*, const T*, const uint8_t*, const T*,
                        const long long*, T, T, T, T, uint8_t*, T*, T*);

template <typename T>
Kernel<T> kernel_for(bool vec, int threads) {
  if (threads == 256) return vec ? terms_kernel<T, true, 256> : terms_kernel<T, false, 256>;
  if (threads == 512) return vec ? terms_kernel<T, true, 512> : terms_kernel<T, false, 512>;
  return nullptr;
}

// a launch of `blocks` blocks of `threads` in clusters of `cluster`
cudaLaunchConfig_t cluster_config(int blocks, int threads, int cluster, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks), 1, 1);
  cfg.blockDim = dim3(static_cast<unsigned>(threads), 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// clusters of `cluster` blocks of `threads` the card holds at once (0
// where it holds none, or the kernel does not exist)
template <typename T>
int max_clusters(int threads, int cluster) {
  const Kernel<T> k = kernel_for<T>(true, threads);
  if (k == nullptr || cluster < 1 || cluster > MAX_CLUSTER) return 0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(cluster, threads, cluster, nullptr, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<const void*>(k), &cfg) != cudaSuccess) {
    cudaGetLastError();  // clear it: a query that fails launches nothing
    return 0;
  }
  return n;
}

template <typename T>
int launch(const long long* meta, const T* payload, const T* mpts, const uint8_t* valid,
           const T* X, const long long* n_live, double b_max, double b_ratio, double rho,
           int n_lead, uint8_t* matched, T* H, T* b, cudaStream_t stream) {
  Params p;
  for (int d = 0; d < NLEAD; ++d) p.shape[d] = *meta++;
  p.pay = read_view(meta);
  p.m = read_view(meta);
  p.valid = read_view(meta);
  p.x = read_view(meta);
  for (int d = 0; d < NLEAD; ++d) p.live[d] = *meta++;
  p.L = static_cast<int>(*meta++);
  p.cluster = static_cast<int>(*meta++);
  const int threads = static_cast<int>(*meta++);
  const bool vec = *meta++ != 0;
  const Kernel<T> k = kernel_for<T>(vec, threads);
  if (k == nullptr || p.cluster < 1 || p.cluster > MAX_CLUSTER || p.L < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_lead <= 0) return static_cast<int>(cudaGetLastError());
  // torch divides a tensor by a host scalar as a product with the
  // scalar's reciprocal, formed in the working type
  const T bm = static_cast<T>(b_max);
  const T inv = T(1) / bm;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(n_lead * p.cluster, threads, p.cluster,
                                                stream, attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, k, p, payload, mpts, valid, X, n_live, inv,
                                             static_cast<T>(b_ratio), bm,
                                             static_cast<T>(rho), matched, H, b);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain C interface for ctypes: (meta, payload, m, valid, X, n_live,
// b_max, b_ratio, rho, n_lead, matched (n_lead, L) bool, H (n_lead, 6, 6),
// b (n_lead, 6), stream); n_live (int64) and matched may be null (no
// bound; no matched written). `meta` (host memory, 36 values): the
// leading shape padded to 4 axes; then for payload, m, valid and X in
// turn 4 leading strides and 2 own strides, in elements; n_live's 4
// leading strides; then L, the cluster (blocks a leading index, 1..8), the
// block (256 or 512 threads) and 1 where every payload row is contiguous
// and 16-byte aligned (the vector loads). b_max, b_ratio and rho are rounded
// to the working type here, as torch rounds a host scalar. Returns the
// cudaGetLastError() code after the launch, or the launch's own error
// when the card refuses it (0 = success).
int icp_terms_f32(const long long* meta, const float* payload, const float* mpts,
                  const uint8_t* valid, const float* X, const long long* n_live, double b_max,
                  double b_ratio, double rho, int n_lead, uint8_t* matched, float* H, float* b,
                  void* stream) {
  return launch<float>(meta, payload, mpts, valid, X, n_live, b_max, b_ratio, rho, n_lead,
                       matched, H, b, static_cast<cudaStream_t>(stream));
}

int icp_terms_f64(const long long* meta, const double* payload, const double* mpts,
                  const uint8_t* valid, const double* X, const long long* n_live,
                  double b_max, double b_ratio, double rho, int n_lead, uint8_t* matched,
                  double* H, double* b, void* stream) {
  return launch<double>(meta, payload, mpts, valid, X, n_live, b_max, b_ratio, rho, n_lead,
                        matched, H, b, static_cast<cudaStream_t>(stream));
}

// Clusters of `cluster` blocks of `threads` (float64 when f64 is 1) the
// current card holds at once; 0 where it holds none.
int icp_terms_max_clusters(int f64, int threads, int cluster) {
  return f64 ? max_clusters<double>(threads, cluster) : max_clusters<float>(threads, cluster);
}

const char* madicp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
