// Point-to-plane ICP terms and normal equations (K7), for Hopper (sm_90a).
//
// From an association payload (..., L, 8) = [f (3), n (3), bbox0, flags],
// the moving points m (..., L, 3) in the scan frame, their map-frame
// positions ml = m R^T + t (..., L, 3), the valid mask (..., L) and the
// pose X (..., 4, 4), each with leading axes that broadcast (strides, 0
// where an axis broadcasts), for each entry:
//   gate      matched = |ml - f| <= b_max + b_ratio |m|, valid, flags == 3
//   residual  e = (ml - f) . n
//   Jacobian  J = [u, m x u], u = R^T n
//   weight    s = huber(|e|, rho) (1 - bbox0 / b_max)^2 matched
// and for each leading index the 21 sums of (s J)^T J and the 6 of s J e,
// filled into a symmetric H (..., 6, 6) and b (..., 6), plus matched.
//
// It is the counterpart of madicp_tpu_torch/ops/icp_core.py
// `terms_from_payload` (plain version: kernels/icp_terms.py
// `terms_plain`), which ports the JAX package's
// madicp_tpu/ops/icp_core.py:69 `terms_from_payload`; XLA lowered that
// one, so no Pallas kernel stands behind it.
//
// Bound on an H100: bytes (payload, points, valid and X in; matched, H and
// b out) at 3.35 TB/s; ~120 float operations an entry are ~1/10 of that
// at the float32 peak. At the flagship (16 keyframes x 32768 leaves) the
// payload alone is 16.8 MB a round, ~5 us.
//
// Design:
//   * kernel 1: one block a tile of L for one leading index; a thread an
//     entry at a time forms the per-entry values with _rn intrinsics in
//     the plain version's order (so `matched` equals it bit for bit; nvcc
//     would otherwise contract a*b + c into FMAs), then adds the 27 terms
//     in double. The block reduces them by warp shuffles and through
//     shared memory in a fixed order and writes its partial row to a
//     (lead, tiles, 27) double workspace the wrapper allocates.
//   * kernel 2: a thread a (leading index, sum) adds the tiles' partials in
//     double, in tile order, and writes H (both triangles) and b in the
//     working type.
// No float atomics and no workspace that outlives the call: a CUDA graph's
// replay equals the eager call bit for bit, and two streams never share
// scratch. The weight s is not bitwise the plain version's: torch divides
// a tensor by a host scalar (bbox0 / b_max) as a multiply by its
// reciprocal, this kernel divides; and the sums' order differs by design.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NSUM = 27;  // 21 of H (upper triangle, row-major) and 6 of b
constexpr int NLEAD = 4;  // leading axes the wrapper pads to

// one operand's strides in elements: its leading axes, then its own two
struct View {
  long long lead[NLEAD];
  long long row;  // between entries (X: between rows)
  long long col;  // between values of an entry (X: between columns)
};

struct Params {
  long long shape[NLEAD];
  View pay, ml, m, valid, x;
  int L, tiles, tile;
};

__constant__ int H_ROW[21] = {0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 4, 4, 5};
__constant__ int H_COL[21] = {0, 1, 2, 3, 4, 5, 1, 2, 3, 4, 5, 2, 3, 4, 5, 3, 4, 5, 4, 5, 5};

template <typename T>
struct Arith;

template <>
struct Arith<float> {
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
};

template <>
struct Arith<double> {
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
};

// torch.clamp(x, min=lo): NaN passes through
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return x != x ? x : (x < lo ? lo : x);
}

__device__ __forceinline__ long long offset(const View& v, const long long* idx) {
  return idx[0] * v.lead[0] + idx[1] * v.lead[1] + idx[2] * v.lead[2] + idx[3] * v.lead[3];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
terms_kernel(Params p, const T* __restrict__ payload, const T* __restrict__ ml,
             const T* __restrict__ mpts, const uint8_t* __restrict__ valid,
             const T* __restrict__ X, T b_max, T b_ratio, T rho,
             uint8_t* __restrict__ matched_out, double* __restrict__ ws) {
  using A = Arith<T>;
  __shared__ double red[WARPS][NSUM];
  const int lead = blockIdx.x / p.tiles;
  const int tile = blockIdx.x - lead * p.tiles;
  long long idx[NLEAD];
  long long rem = lead;
#pragma unroll
  for (int d = NLEAD - 1; d >= 0; --d) {
    idx[d] = rem % p.shape[d];
    rem /= p.shape[d];
  }
  const T* pay = payload + offset(p.pay, idx);
  const T* mlp = ml + offset(p.ml, idx);
  const T* mp = mpts + offset(p.m, idx);
  const uint8_t* vp = valid + offset(p.valid, idx);
  const T* xp = X + offset(p.x, idx);
  T R[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i][j] = xp[i * p.x.row + j * p.x.col];

  double acc[NSUM];
#pragma unroll
  for (int k = 0; k < NSUM; ++k) acc[k] = 0.0;

  const int lo = tile * p.tile;
  const int hi = min(p.L, lo + p.tile);
  for (int l = lo + threadIdx.x; l < hi; l += THREADS) {
    const T* f = pay + l * p.pay.row;
    const T fx = f[0], fy = f[p.pay.col], fz = f[2 * p.pay.col];
    const T nx = f[3 * p.pay.col], ny = f[4 * p.pay.col], nz = f[5 * p.pay.col];
    const T bbox0 = f[6 * p.pay.col], flags = f[7 * p.pay.col];
    const T* q = mlp + l * p.ml.row;
    const T mlx = q[0], mly = q[p.ml.col], mlz = q[2 * p.ml.col];
    const T* mm = mp + l * p.m.row;
    const T mx = mm[0], my = mm[p.m.col], mz = mm[2 * p.m.col];

    // adaptive-radius gate, in the plain version's order
    const T dx = A::sub(mlx, fx), dy = A::sub(mly, fy), dz = A::sub(mlz, fz);
    const T dist = A::sqrt(A::add(A::add(A::mul(dx, dx), A::mul(dy, dy)), A::mul(dz, dz)));
    const T rng = A::sqrt(A::add(A::add(A::mul(mx, mx), A::mul(my, my)), A::mul(mz, mz)));
    const T src_ball = A::add(A::mul(b_ratio, rng), b_max);
    const bool ok = dist <= src_ball && vp[l * p.valid.row] != 0 && flags == T(3);
    matched_out[static_cast<long long>(lead) * p.L + l] = ok;

    // residual and analytic Jacobian, u = R^T n
    const T e = A::add(A::add(A::mul(dx, nx), A::mul(dy, ny)), A::mul(dz, nz));
    const T ux = A::add(A::add(A::mul(nx, R[0][0]), A::mul(ny, R[1][0])), A::mul(nz, R[2][0]));
    const T uy = A::add(A::add(A::mul(nx, R[0][1]), A::mul(ny, R[1][1])), A::mul(nz, R[2][1]));
    const T uz = A::add(A::add(A::mul(nx, R[0][2]), A::mul(ny, R[1][2])), A::mul(nz, R[2][2]));
    const T J[6] = {ux, uy, uz, A::sub(A::mul(my, uz), A::mul(mz, uy)),
                    A::sub(A::mul(mz, ux), A::mul(mx, uz)),
                    A::sub(A::mul(mx, uy), A::mul(my, ux))};

    // Huber clamp times the squared planarity weight, gated
    const T chi = fabs(e);
    const T scale = chi > rho ? A::div(rho, clamp_min(chi, T(1e-30))) : T(1);
    T w = A::sub(T(1), A::div(bbox0, b_max));
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
    ws[static_cast<long long>(blockIdx.x) * NSUM + threadIdx.x] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
finish_kernel(const double* __restrict__ ws, int n_lead, int tiles, T* __restrict__ H,
              T* __restrict__ b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_lead * NSUM) return;
  const int lead = i / NSUM, k = i - lead * NSUM;
  const double* src = ws + static_cast<long long>(lead) * tiles * NSUM + k;
  double v = 0.0;
  for (int t = 0; t < tiles; ++t) v += src[static_cast<long long>(t) * NSUM];
  const T out = static_cast<T>(v);
  if (k < 21) {
    H[lead * 36 + H_ROW[k] * 6 + H_COL[k]] = out;
    H[lead * 36 + H_COL[k] * 6 + H_ROW[k]] = out;
  } else {
    b[lead * 6 + k - 21] = out;
  }
}

View read_view(const long long*& meta) {
  View v;
  for (int d = 0; d < NLEAD; ++d) v.lead[d] = *meta++;
  v.row = *meta++;
  v.col = *meta++;
  return v;
}

template <typename T>
int launch(const long long* meta, const T* payload, const T* ml, const T* mpts,
           const uint8_t* valid, const T* X, double b_max, double b_ratio, double rho,
           int n_lead, double* ws, uint8_t* matched, T* H, T* b, cudaStream_t stream) {
  Params p;
  for (int d = 0; d < NLEAD; ++d) p.shape[d] = *meta++;
  p.pay = read_view(meta);
  p.ml = read_view(meta);
  p.m = read_view(meta);
  p.valid = read_view(meta);
  p.x = read_view(meta);
  p.L = static_cast<int>(*meta++);
  p.tiles = static_cast<int>(*meta++);
  p.tile = static_cast<int>(*meta++);
  if (n_lead <= 0) return static_cast<int>(cudaGetLastError());
  terms_kernel<T><<<n_lead * p.tiles, THREADS, 0, stream>>>(
      p, payload, ml, mpts, valid, X, static_cast<T>(b_max), static_cast<T>(b_ratio),
      static_cast<T>(rho), matched, ws);
  const int n = n_lead * NSUM;
  finish_kernel<T><<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(ws, n_lead, p.tiles,
                                                                       H, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain C interface for ctypes: (meta, payload, ml, m, valid, X, b_max,
// b_ratio, rho, n_lead, workspace (n_lead, tiles, 27) doubles, matched
// (n_lead, L) bool, H (n_lead, 6, 6), b (n_lead, 6), stream). `meta`
// (host memory, 37 values): the leading shape padded to 4 axes; then for
// payload, ml, m, valid and X in turn 4 leading strides and 2 own
// strides, in elements; then L, tiles and the tile (entries a block).
// b_max, b_ratio and rho are rounded to the working type here, as torch
// rounds a host scalar. Returns the cudaGetLastError() code after the
// launches (0 = success).
int icp_terms_f32(const long long* meta, const float* payload, const float* ml,
                  const float* mpts, const uint8_t* valid, const float* X, double b_max,
                  double b_ratio, double rho, int n_lead, double* ws, uint8_t* matched,
                  float* H, float* b, void* stream) {
  return launch<float>(meta, payload, ml, mpts, valid, X, b_max, b_ratio, rho, n_lead, ws,
                       matched, H, b, static_cast<cudaStream_t>(stream));
}

int icp_terms_f64(const long long* meta, const double* payload, const double* ml,
                  const double* mpts, const uint8_t* valid, const double* X, double b_max,
                  double b_ratio, double rho, int n_lead, double* ws, uint8_t* matched,
                  double* H, double* b, void* stream) {
  return launch<double>(meta, payload, ml, mpts, valid, X, b_max, b_ratio, rho, n_lead, ws,
                        matched, H, b, static_cast<cudaStream_t>(stream));
}

const char* madicp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
