// The Gauss-Newton pose update (K10), for Hopper (sm_90a).
//
// For each sequence of a batch, from its pose X (4, 4) and its normal
// equations H (6, 6), b (6), state ordering [t (3), omega (3)]:
//   Jacobi scaling  d_i = sqrt(max(H_ii, 1e-30)), 1 where H_ii <= 0
//   solve           (H / (d d^T) + 1e-8 I) y = -b / d, a 6x6 LU with
//                   partial pivoting
//   step            dx = y / d; a component that is not finite is 0, and
//                   dx is 0 where sum_i H_ii <= 0 (no match)
//   trust region    dx scaled by min(1, 1 m / |dx_t|, 0.5 rad / |dx_w|)
//   increment       dX = [exp_so3(dx_w) | dx_t] (MAD-ICP's split form:
//                   the translation raw, not the SE(3) exponential);
//                   exp_so3 is I + W below theta^2 = 1e-8, else
//                   I + sin(theta) K + 2 sin^2(theta / 2) K^2, K = W / theta
//   update          X <- X dX
//
// It is the counterpart of madicp_tpu_torch/ops/icp_core.py `gn_se3_step`
// (plain version: kernels/gn_update.py `gn_update_plain`, the
// solve_gn -> clamp_step -> exp_se3_split -> product chain), which ports
// the JAX package's madicp_tpu/ops/icp_core.py:256 `gn_se3_step` (with
// `solve_gn` :209, `clamp_step` :242 and madicp_tpu/ops/lie.py:147
// `exp_se3_split`); XLA lowered that one, so no Pallas kernel stands
// behind it.
//
// Bound on an H100: a sequence reads 52 values and writes 16 (a few
// hundred bytes: nanoseconds at 3.35 TB/s) and does ~400 operations, so
// the bound is far below the launch itself (~1 us); what costs is the
// chain around it. The plain chain is ~70 launches a GN round (cuSOLVER's
// getrf and getrs among them, the scaling, the clamp, the exponential and
// a batched GEMM), each at least ~1 us in a CUDA graph.
//
// Design: one launch a round, one thread a sequence (a batch holds one to
// a few tens), everything in registers: every loop runs over constant
// bounds and is unrolled, and the pivot's row swap is a predicated select
// over the rows below, so no array is indexed by a value known only at
// run time (which would put it in local memory). Each sequence's result
// is a fixed sequence of operations with no atomics, so the same H, b give
// the same bits on every rank of a keyframe-sharded step and in every
// replay of a CUDA graph. sin and sqrt are the CUDA math library's IEEE
// functions (no fast math). The rounding differs from cuSOLVER's LU and
// cuBLAS's product, so the result agrees with the plain version to a
// tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 32;  // a block: sequences are few

struct View3 {  // strides in elements: between sequences, rows, columns
  long long seq, row, col;
};

__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ double sin_(double x) { return sin(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ bool finite_(float x) { return isfinite(x); }
__device__ __forceinline__ bool finite_(double x) { return isfinite(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
    gn_update_kernel(const T* __restrict__ X, View3 vx, const T* __restrict__ H, View3 vh,
                     const T* __restrict__ bv, View3 vb, int n, T* __restrict__ out) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  const T* Hs = H + s * vh.seq;
  const T* bs = bv + s * vb.seq;

  // Jacobi scaling
  T A[6][6], r[6], d[6];
  T trace = T(0);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const T hii = Hs[i * vh.row + i * vh.col];
    trace += hii;
    d[i] = hii > T(0) ? sqrt_(fmax(hii, T(1e-30))) : T(1);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) A[i][j] = Hs[i * vh.row + j * vh.col] / (d[i] * d[j]);
    A[i][i] += T(1e-8);
    r[i] = -(bs[i * vb.row] / d[i]);
  }

  // LU with partial pivoting (the first largest magnitude of the column),
  // eliminating into r as it goes
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    T best = fabs(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const T a = fabs(A[i][k]);
      if (a > best) {
        best = a;
        p = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (i == p) {
#pragma unroll
        for (int j = k; j < 6; ++j) {
          const T t = A[k][j];
          A[k][j] = A[i][j];
          A[i][j] = t;
        }
        const T t = r[k];
        r[k] = r[i];
        r[i] = t;
      }
    }
    // a zero pivot (the column is zero below it) eliminates nothing, as
    // LAPACK's getrf: its row's solve is not finite and zeroes out
    const bool pivot = A[k][k] != T(0);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const T l = pivot ? A[i][k] / A[k][k] : T(0);
#pragma unroll
      for (int j = k + 1; j < 6; ++j) A[i][j] -= l * A[k][j];
      r[i] -= l * r[k];
    }
  }
  T dx[6];
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    T acc = r[i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) acc -= A[i][j] * dx[j];
    dx[i] = acc / A[i][i];
  }
  const bool good = trace > T(0);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const T v = dx[i] / d[i];
    dx[i] = good && finite_(v) ? v : T(0);
  }

  // trust region: 1 m, 0.5 rad
  const T dt = sqrt_(dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]);
  const T dr = sqrt_(dx[3] * dx[3] + dx[4] * dx[4] + dx[5] * dx[5]);
  const T scale =
      fmin(fmin(T(1.0) / fmax(dt, T(1e-30)), T(0.5) / fmax(dr, T(1e-30))), T(1));
#pragma unroll
  for (int i = 0; i < 6; ++i) dx[i] *= scale;

  // exp_so3 of the rotation part
  const T wx = dx[3], wy = dx[4], wz = dx[5];
  const T theta_sq = wx * wx + wy * wy + wz * wz;
  T R[3][3];
  if (theta_sq < T(1e-8)) {
    R[0][0] = T(1), R[0][1] = -wz, R[0][2] = wy;
    R[1][0] = wz, R[1][1] = T(1), R[1][2] = -wx;
    R[2][0] = -wy, R[2][1] = wx, R[2][2] = T(1);
  } else {
    const T theta = sqrt_(theta_sq);
    const T kx = wx / theta, ky = wy / theta, kz = wz / theta;
    const T sn = sin_(theta);
    const T h = sin_(theta / T(2));
    const T omc = T(2) * (h * h);
    const T K[3][3] = {{T(0), -kz, ky}, {kz, T(0), -kx}, {-ky, kx, T(0)}};
    const T KK[3][3] = {{-(ky * ky + kz * kz), kx * ky, kx * kz},
                        {ky * kx, -(kx * kx + kz * kz), ky * kz},
                        {kz * kx, kz * ky, -(kx * kx + ky * ky)}};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) R[i][j] = (T(i == j) + sn * K[i][j]) + omc * KK[i][j];
    }
  }

  // X <- X dX, dX = [R | dx_t; 0 0 0 1]
  const T* Xs = X + s * vx.seq;
  T* o = out + s * 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const T x0 = Xs[i * vx.row], x1 = Xs[i * vx.row + vx.col],
            x2 = Xs[i * vx.row + 2 * vx.col], x3 = Xs[i * vx.row + 3 * vx.col];
#pragma unroll
    for (int j = 0; j < 3; ++j) o[i * 4 + j] = x0 * R[0][j] + x1 * R[1][j] + x2 * R[2][j];
    o[i * 4 + 3] = x0 * dx[0] + x1 * dx[1] + x2 * dx[2] + x3;
  }
}

View3 read_view(const long long* v) { return View3{v[0], v[1], v[2]}; }

template <typename T>
int launch(const long long* meta, const T* X, const T* H, const T* b, int n, T* out,
           cudaStream_t stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  gn_update_kernel<T><<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      X, read_view(meta), H, read_view(meta + 3), b, read_view(meta + 6), n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain C interface for ctypes: (meta, X, H, b, n, out (n, 4, 4)
// contiguous, stream). `meta` (host memory, 9 values): the strides in
// elements of X (n, 4, 4), H (n, 6, 6) and b (n, 6), each as (between
// sequences, between rows, between columns); b's column stride is unused.
// Returns the cudaGetLastError() code after the launch (0 = success).
int gn_update_f32(const long long* meta, const float* X, const float* H, const float* b, int n,
                  float* out, void* stream) {
  return launch<float>(meta, X, H, b, n, out, static_cast<cudaStream_t>(stream));
}

int gn_update_f64(const long long* meta, const double* X, const double* H, const double* b,
                  int n, double* out, void* stream) {
  return launch<double>(meta, X, H, b, n, out, static_cast<cudaStream_t>(stream));
}

const char* madicp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
