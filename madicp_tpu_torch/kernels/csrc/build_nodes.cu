// Node math of one MAD-tree build level (K9), for Hopper (sm_90a).
//
// For each node g of a level (B 2^l nodes, node j of cloud b is g = b 2^l
// + j), from its moments mom[g] = [sum d (3), sum outer6(d) (6), count k]
// of points shifted by the parent's mean, and the parent's fields:
//   mean      parent mean + sum d / max(k, 1)
//   cov       (sum outer6 / max(k, 1) - outer6(shift)) k / max(k - 1, 1),
//             0 below 2 points
//   E         the closed-form eigenbasis of cov (Cardano: acos/cos roots,
//             row cross products, the degenerate fallbacks and the
//             canonical choice on degenerate pairs), columns ascending
//   has_pp, ppn   the plane predecessor: the shallowest ancestor whose
//             bbox0 < b_min hands its PCA normal down
//   n3        the nearest >= 3-point ancestor-or-self PCA normal
//   normal    ppn where there is a predecessor, else E[:, 0] (n3 of the
//             parent below 3 points, from level 1 on)
//   is_real   k > 0 and the parent is not a leaf
// written into the level's rows of the (B, M, 12) arena (mean, split =
// E[:, 2], normal, is_real), into packA (g, 13) = [mean, E row-major,
// parent leaf] and state (g, 8) = [ppn, n3, has_pp, is_real], and ext (g,
// 6) set to the key of the largest finite value for the point pass to
// min-reduce. The same launch closes the previous level: each parent's
// extents max(vmax, 0) - min(vmin, 0) from its ext keys, bbox0 = extents
// x and is_leaf = is_real and extents z < b_max into its arena row (the
// even child writes it). close_kernel closes the last level (the depth
// cap: every real node is a leaf); level 0 zeroes each cloud's row 0.
//
// It is the counterpart of madicp_tpu_torch/kernels/build_nodes.py
// `build_nodes_plain` and `close_level_plain` (with ops/eigh3.py
// `eigh3_parts`), which port the JAX package's madicp_tpu/ops/tree.py
// :457-490 (node math), madicp_tpu/ops/eigh3.py:61 `eigh3` and the level
// close :542-559, 575-579; XLA lowered those, so no Pallas kernel stands
// behind them.
//
// Bound on an H100: bytes, counted from each call (chip_smoke.py
// `build_call_cost`). A node reads its 10 moments and writes 13 + 8
// values, 6 keys and 10 arena values; with its sibling it reads its
// parent's mean and PCA normal (6 values of the pack), 8 state values and
// 6 keys, and writes the parent's bbox0 and is_leaf: ~230 B a node in
// float32, ~30 MB over a flagship build of 2^17 nodes. Its ~400 float
// operations a node (the eigensolver's six cross products and the roots
// dominate) take ~8e-4 ms at the float32 peak.
//
// Design: one thread a node, one launch a level. Every sum, product,
// difference and quotient is an _rn intrinsic in the plain version's
// order (nvcc would contract a*b + c into an FMA); the cross products are
// the one fused form torch.linalg.cross computes, fma(a_i, b_j, -(a_j
// b_i)); acos/cos/sqrt are the CUDA math library's (no fast math, as
// torch's own kernels); the constants (1/3, 1/6, 2 pi / 3, eps, tol_c,
// b_max, b_min) come from the wrapper as doubles and are rounded to the
// working type as torch rounds a Python scalar. So every output equals
// the plain version's on the card bit for bit. The kernel allocates
// nothing, reads nothing back to the host and launches on the caller's
// stream, so it can be captured in a CUDA graph.

#include <cuda_runtime.h>
#include <stdint.h>

#include "arith.cuh"

namespace {

using madicp::Arith;

constexpr int THREADS = 128;
constexpr int MOM = 10;
constexpr int PACK = 13;
constexpr int STATE = 8;
constexpr int ARENA = 12;
constexpr int EXT = 6;

struct Consts {  // Python scalars, as doubles
  double b_max, b_min, eps, tol_c, third, sixth, two_pi_thirds;
};

// torch.maximum: NaN if either is NaN, else the larger
template <typename T>
__device__ __forceinline__ T maximum(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// ops/eigh3.py, operation for operation
template <typename T>
struct Eigh3 {
  using A = Arith<T>;
  T eps, tol_c, third, sixth, two_pi_thirds;

  __device__ __forceinline__ T dot(const T* a, const T* b) const {
    return A::add(A::add(A::mul(a[0], b[0]), A::mul(a[1], b[1])), A::mul(a[2], b[2]));
  }

  // torch.linalg.cross: fma(a_i, b_j, -(a_j b_i))
  __device__ __forceinline__ void cross(const T* a, const T* b, T* c) const {
    c[0] = A::fma(a[1], b[2], -A::mul(a[2], b[1]));
    c[1] = A::fma(a[2], b[0], -A::mul(a[0], b[2]));
    c[2] = A::fma(a[0], b[1], -A::mul(a[1], b[0]));
  }

  __device__ __forceinline__ bool normalize(const T* v, T* out) const {
    const T n = A::sqrt(dot(v, v));
    const bool ok = n > eps;
    const T safe = ok ? n : T(1);
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c] = A::div(v[c], safe);
    return ok;
  }

  __device__ __forceinline__ bool eigvec(const T s[3][3], T lam, T* out) const {
    T r[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) r[i][j] = i == j ? A::sub(s[i][j], lam) : s[i][j];
    }
    T c01[3], c02[3], c12[3], v[3];
    cross(r[0], r[1], c01);
    cross(r[0], r[2], c02);
    cross(r[1], r[2], c12);
    const T n01 = dot(c01, c01), n02 = dot(c02, c02), n12 = dot(c12, c12);
    const bool best01 = n01 >= n02 && n01 >= n12;
    const bool best02 = !best01 && n02 >= n12;
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = best01 ? c01[c] : (best02 ? c02[c] : c12[c]);
    return normalize(v, out);
  }

  __device__ __forceinline__ void any_perp(const T* v, T* out) const {
    const bool use_ex = fabs(v[0]) <= fabs(v[1]);
    const T axis[3] = {use_ex ? T(1) : T(0), use_ex ? T(0) : T(1), T(0)};
    T c[3];
    cross(v, axis, c);
    normalize(c, out);
  }

  // the eigenvectors of symmetric a, ascending eigenvalues
  __device__ void solve(const T a[3][3], T* v0, T* v1, T* v2) const {
    T scale = fabs(a[0][0]);
#pragma unroll
    for (int e = 1; e < 9; ++e) scale = maximum(scale, fabs(a[e / 3][e % 3]));
    const T scale_safe = scale > T(0) ? scale : T(1);
    T s[3][3], b[3][3], bn[3][3];
#pragma unroll
    for (int e = 0; e < 9; ++e) s[e / 3][e % 3] = A::div(a[e / 3][e % 3], scale_safe);
    const T q = A::mul(A::add(A::add(s[0][0], s[1][1]), s[2][2]), third);
#pragma unroll
    for (int e = 0; e < 9; ++e) {
      const int i = e / 3, j = e % 3;
      b[i][j] = i == j ? A::sub(s[i][j], q) : s[i][j];
    }
    T p2 = A::mul(b[0][0], b[0][0]);
#pragma unroll
    for (int e = 1; e < 9; ++e) p2 = A::add(p2, A::mul(b[e / 3][e % 3], b[e / 3][e % 3]));
    p2 = A::mul(p2, sixth);
    const T p = A::sqrt(p2 < T(0) ? T(0) : p2);
    const bool degenerate_all = p < eps;
    const T p_safe = degenerate_all ? T(1) : p;
#pragma unroll
    for (int e = 0; e < 9; ++e) bn[e / 3][e % 3] = A::div(b[e / 3][e % 3], p_safe);
    // the expansion of ops/eigh3.py _det3, left to right
    T det = A::add(A::mul(A::mul(bn[0][0], bn[1][1]), bn[2][2]),
                   A::mul(A::mul(bn[0][1], bn[1][2]), bn[2][0]));
    det = A::add(det, A::mul(A::mul(bn[0][2], bn[1][0]), bn[2][1]));
    det = A::sub(det, A::mul(A::mul(bn[0][2], bn[1][1]), bn[2][0]));
    det = A::sub(det, A::mul(A::mul(bn[0][0], bn[1][2]), bn[2][1]));
    det = A::sub(det, A::mul(A::mul(bn[0][1], bn[1][0]), bn[2][2]));
    T r = A::mul(det, T(0.5));
    r = r < T(-1) ? T(-1) : (r > T(1) ? T(1) : r);  // torch.clamp (NaN passes)
    const T phi = A::mul(A::acos(r), third);
    const T two_p = A::mul(T(2), p);
    T l2 = A::add(q, A::mul(two_p, A::cos(phi)));
    T l0 = A::add(q, A::mul(two_p, A::cos(A::add(phi, two_pi_thirds))));
    T l1 = A::sub(A::sub(A::mul(T(3), q), l0), l2);
    if (degenerate_all) l0 = l1 = l2 = q;

    T w0[3], w2[3], x2[3], u[3], c[3];
    const bool ok0 = eigvec(s, l0, w0);
    const bool ok2 = eigvec(s, l2, w2);
    if (!ok0) {
      if (ok2) {
        any_perp(w2, w0);
      } else {
        w0[0] = T(1);
        w0[1] = w0[2] = T(0);
      }
    }
    // orthogonalise v2 against v0, fall back to a perpendicular
    const T d20 = dot(w2, w0);
#pragma unroll
    for (int k = 0; k < 3; ++k) u[k] = A::sub(w2[k], A::mul(d20, w0[k]));
    if (!normalize(u, x2)) any_perp(w0, x2);
    // canonicalise (near-)degenerate pairs
    const bool deg01 = A::sub(l1, l0) < tol_c;
    const bool deg12 = A::sub(l2, l1) < tol_c;
    if (deg01 && !deg12) any_perp(x2, w0);
    if (deg12 && !deg01) any_perp(w0, x2);
    cross(x2, w0, c);
    normalize(c, v1);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v0[k] = w0[k];
      v2[k] = x2[k];
    }
    if (degenerate_all) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        v0[k] = k == 0 ? T(1) : T(0);
        v1[k] = k == 1 ? T(1) : T(0);
        v2[k] = k == 2 ? T(1) : T(0);
      }
    }
  }
};

// a closed node's extents, max(vmax, 0) - min(vmin, 0), from its 6 keys
template <typename T>
__device__ __forceinline__ void extents(const typename Arith<T>::Key* key, T* out) {
  using A = Arith<T>;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const T vmin = A::from_key(key[c]);
    const T vmax = -A::from_key(key[3 + c]);
    out[c] = A::sub(vmax > T(0) ? vmax : T(0), vmin < T(0) ? vmin : T(0));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
nodes_kernel(const T* __restrict__ mom, const T* __restrict__ pack_p,
             const T* __restrict__ state_p, const typename Arith<T>::Key* __restrict__ ext_p,
             T* __restrict__ arena, T* __restrict__ pack, T* __restrict__ state,
             typename Arith<T>::Key* __restrict__ ext, int nseg, int sz, int M, Consts cs) {
  using A = Arith<T>;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= nseg) return;
  const int b = g / sz, j = g & (sz - 1);
  T* cloud = arena + static_cast<long long>(b) * M * ARENA;
  const T b_max = static_cast<T>(cs.b_max), b_min = static_cast<T>(cs.b_min);
  const bool root = pack_p == nullptr;

  // the parent's fields (the root's sentinel: shift 0, no pp, no n3)
  T par_mean[3] = {T(0), T(0), T(0)}, par_pca[3] = {T(0), T(0), T(0)};
  T par_ppn[3] = {T(0), T(0), T(0)}, par_n3[3] = {T(0), T(0), T(0)};
  T par_bbox0 = A::max_value();
  bool par_has_pp = false, par_leaf = false;
  if (root) {
#pragma unroll
    for (int c = 0; c < ARENA; ++c) cloud[c] = T(0);
  } else {
    const int pg = g >> 1;
    T ex[3];
    extents<T>(ext_p + static_cast<long long>(pg) * EXT, ex);
    const T* ps = state_p + static_cast<long long>(pg) * STATE;
    const T* pk = pack_p + static_cast<long long>(pg) * PACK;
    par_leaf = ps[7] > T(0) && ex[2] < b_max;
    par_bbox0 = ex[0];
    if ((j & 1) == 0) {  // close the parent's arena row
      T* row = cloud + static_cast<long long>((sz + j) >> 1) * ARENA;
      row[9] = ex[0];
      row[10] = par_leaf ? T(1) : T(0);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      par_mean[c] = pk[c];
      par_pca[c] = pk[3 + 3 * c];
      par_ppn[c] = ps[c];
      par_n3[c] = ps[3 + c];
    }
    par_has_pp = ps[6] > T(0);
  }

  const T* m = mom + static_cast<long long>(g) * MOM;
  const T k = m[9];
  const T k_safe = k < T(1) ? T(1) : k;
  T shift[3], mean[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    shift[c] = A::div(m[c], k_safe);
    mean[c] = A::add(par_mean[c], shift[c]);
  }
  const T outer[6] = {A::mul(shift[0], shift[0]), A::mul(shift[0], shift[1]),
                      A::mul(shift[0], shift[2]), A::mul(shift[1], shift[1]),
                      A::mul(shift[1], shift[2]), A::mul(shift[2], shift[2])};
  const T km1 = A::sub(k, T(1));
  const T bessel = A::div(k, km1 < T(1) ? T(1) : km1);
  const bool many = k >= T(2);
  T cov[6];
#pragma unroll
  for (int e = 0; e < 6; ++e)
    cov[e] = many ? A::mul(A::sub(A::div(m[3 + e], k_safe), outer[e]), bessel) : T(0);
  const T a[3][3] = {{cov[0], cov[1], cov[2]}, {cov[1], cov[3], cov[4]},
                     {cov[2], cov[4], cov[5]}};
  const Eigh3<T> eig{static_cast<T>(cs.eps), static_cast<T>(cs.tol_c),
                     static_cast<T>(cs.third), static_cast<T>(cs.sixth),
                     static_cast<T>(cs.two_pi_thirds)};
  T v0[3], v1[3], v2[3];
  eig.solve(a, v0, v1, v2);

  // plane predecessor, >= 3-point normal, the normal
  const bool below = par_bbox0 < b_min;
  const bool has_pp = par_has_pp || below;
  T ppn[3], n3[3], normal[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ppn[c] = par_has_pp ? par_ppn[c] : (below ? par_pca[c] : T(0));
    n3[c] = k >= T(3) ? v0[c] : par_n3[c];
    const T fallback = (!root && k < T(3)) ? par_n3[c] : v0[c];
    normal[c] = has_pp ? ppn[c] : fallback;
  }
  const bool is_real = k > T(0) && !par_leaf;

  T* pk = pack + static_cast<long long>(g) * PACK;
  T* st = state + static_cast<long long>(g) * STATE;
  T* row = cloud + static_cast<long long>(sz + j) * ARENA;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    pk[c] = mean[c];
    pk[3 + 3 * c] = v0[c];
    pk[4 + 3 * c] = v1[c];
    pk[5 + 3 * c] = v2[c];
    st[c] = ppn[c];
    st[3 + c] = n3[c];
    row[c] = mean[c];
    row[3 + c] = v2[c];
    row[6 + c] = normal[c];
  }
  pk[12] = par_leaf ? T(1) : T(0);
  st[6] = has_pp ? T(1) : T(0);
  st[7] = is_real ? T(1) : T(0);
  row[11] = is_real ? T(1) : T(0);
  typename Arith<T>::Key* ek = ext + static_cast<long long>(g) * EXT;
#pragma unroll
  for (int c = 0; c < EXT; ++c) ek[c] = A::big_key();
}

// the last level: bbox0 and is_leaf (every real node) of each node's row
template <typename T>
__global__ void __launch_bounds__(THREADS)
close_kernel(const T* __restrict__ state, const typename Arith<T>::Key* __restrict__ ext,
             T* __restrict__ arena, int nseg, int sz, int M) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= nseg) return;
  const int b = g / sz, j = g & (sz - 1);
  T ex[3];
  extents<T>(ext + static_cast<long long>(g) * EXT, ex);
  T* row = arena + (static_cast<long long>(b) * M + sz + j) * ARENA;
  row[9] = ex[0];
  row[10] = state[static_cast<long long>(g) * STATE + 7] > T(0) ? T(1) : T(0);
}

template <typename T>
int launch_nodes(const T* mom, const T* pack_p, const T* state_p,
                 const typename Arith<T>::Key* ext_p, T* arena, T* pack, T* state,
                 typename Arith<T>::Key* ext, int nseg, int sz, int M, int blocks,
                 Consts cs, cudaStream_t stream) {
  if (nseg > 0) {
    nodes_kernel<T><<<blocks, THREADS, 0, stream>>>(mom, pack_p, state_p, ext_p, arena, pack,
                                                    state, ext, nseg, sz, M, cs);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_close(const T* state, const typename Arith<T>::Key* ext, T* arena, int nseg,
                 int sz, int M, int blocks, cudaStream_t stream) {
  if (nseg > 0) close_kernel<T><<<blocks, THREADS, 0, stream>>>(state, ext, arena, nseg, sz, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain C interface for ctypes: (mom (nseg, 10), pack_prev (nseg / 2, 13)
// or null at level 0, state_prev (nseg / 2, 8) or null, ext_prev (nseg /
// 2, 6) keys or null, arena (B, M, 12), pack (nseg, 13), state (nseg, 8),
// ext (nseg, 6) keys, nseg, sz = 2^level, M, blocks, b_max, b_min, eps,
// tol_c, 1/3, 1/6, 2 pi / 3, stream). Keys are int32 (float32) or int64
// (float64). Every array is contiguous. Returns the cudaGetLastError()
// code after the launch (0 = success).
int nodes_f32(const float* mom, const float* pack_p, const float* state_p, const int* ext_p,
              float* arena, float* pack, float* state, int* ext, int nseg, int sz, int M,
              int blocks, double b_max, double b_min, double eps, double tol_c, double third,
              double sixth, double two_pi_thirds, void* stream) {
  return launch_nodes<float>(mom, pack_p, state_p, ext_p, arena, pack, state, ext, nseg, sz, M,
                             blocks, Consts{b_max, b_min, eps, tol_c, third, sixth,
                                            two_pi_thirds},
                             static_cast<cudaStream_t>(stream));
}

int nodes_f64(const double* mom, const double* pack_p, const double* state_p,
              const long long* ext_p, double* arena, double* pack, double* state,
              long long* ext, int nseg, int sz, int M, int blocks, double b_max, double b_min,
              double eps, double tol_c, double third, double sixth, double two_pi_thirds,
              void* stream) {
  return launch_nodes<double>(mom, pack_p, state_p, ext_p, arena, pack, state, ext, nseg, sz,
                              M, blocks, Consts{b_max, b_min, eps, tol_c, third, sixth,
                                                two_pi_thirds},
                              static_cast<cudaStream_t>(stream));
}

// (state (nseg, 8), ext (nseg, 6) keys, arena (B, M, 12), nseg, sz, M,
// blocks, stream); at the depth cap every real node is a leaf
int close_f32(const float* state, const int* ext, float* arena, int nseg, int sz, int M,
              int blocks, void* stream) {
  return launch_close<float>(state, ext, arena, nseg, sz, M, blocks,
                             static_cast<cudaStream_t>(stream));
}

int close_f64(const double* state, const long long* ext, double* arena, int nseg, int sz,
              int M, int blocks, void* stream) {
  return launch_close<double>(state, ext, arena, nseg, sz, M, blocks,
                              static_cast<cudaStream_t>(stream));
}

const char* madicp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
