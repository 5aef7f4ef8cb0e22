// The Gauss-Newton pose update (K10), for Hopper (sm_90a).
//
// For each sequence of a batch, from its pose X (4, 4) and its normal
// equations, state ordering [t (3), omega (3)]: either K per-keyframe
// terms H_k (6, 6), b_k (6) with weights w_k, summed here in a fixed order
// (k = 0 .. K-1) into H = sum_k w_k H_k, b = sum_k w_k b_k (which are also
// written out), or H, b summed already (K = 1, weight 1):
//   Jacobi scaling  d_i = sqrt(max(H_ii, 1e-30)), 1 where H_ii <= 0;
//                   e_i = 1 / d_i
//   solve           (H (e e^T) + 1e-8 I) y = -b e, a 6x6 LU with partial
//                   pivoting (the first largest magnitude, as LAPACK's
//                   i?amax: a NaN is taken only where it comes first);
//                   the multipliers are the column times the pivot's
//                   reciprocal, and a column that is zero below its pivot
//                   (or whose pivot is zero) eliminates nothing; the
//                   substitution multiplies by the pivots' reciprocals
//   step            dx = y e; a component that is not finite is 0, and
//                   dx is 0 where sum_i H_ii <= 0 (no match)
//   trust region    dx scaled by min(1, 1 m / |dx_t|, 0.5 rad / |dx_w|)
//   increment       dX = [exp_so3(dx_w) | dx_t] (MAD-ICP's split form:
//                   the translation raw, not the SE(3) exponential);
//                   exp_so3 is I + W below theta^2 = 1e-8, else
//                   I + sin(theta) K + 2 sin^2(theta / 2) K^2, K = W / theta
//   update          X <- X dX
//
// It is the counterpart of madicp_tpu_torch/ops/icp_core.py `gn_se3_step`
// and of the keyframe sum of models/pipeline.py's rounds (plain version:
// kernels/gn_update.py `gn_update_plain`: the einsum, then solve_gn ->
// clamp_step -> exp_se3_split -> product), which port the JAX package's
// madicp_tpu/ops/icp_core.py:256 `gn_se3_step` (with `solve_gn` :209,
// `clamp_step` :242, madicp_tpu/ops/lie.py:147 `exp_se3_split`) and
// madicp_tpu/models/pipeline.py:432-433; XLA lowered those, so no Pallas
// kernel stands behind them. The zero-below rule is the JAX LU's: where
// H_ii is infinite, row and column i of the scaled system are zero but
// for a NaN pivot, and the other rows keep their values, so only the
// components that depend on that row zero out.
//
// Bound on an H100: a sequence reads 16 + 42 K + K values and writes 16
// (+ 42): a few kilobytes, nanoseconds at 3.35 TB/s, and ~450 + 84 K
// operations. What limits it is the launch (~1.1 us in a CUDA graph) and
// the chain of dependent steps inside one sequence.
//
// Design: one warp a sequence (blocks of WARPS warps), every operand
// contiguous. One warp runs the whole kernel, so its time is its chain
// and its instruction count: the first design took ~4.2 cycles an
// instruction of its SASS (PERF.md §6), so offsets are 32-bit, the
// keyframes of a batch immediates, and no step is coded twice.
// The lanes spread the loads: lane v sums value v of the 42 (and v + 32),
// all K keyframes' loads in flight before the first add. The sums pass through shared
// memory to lanes 0-5, which hold a row each of the scaled system and its
// right-hand side and form one scale each (a square root and a
// reciprocal: no division in the scaling); shuffles share them. The LU
// is lu6.cuh's (shared with K14): it swaps no data, `order` (3 bits a
// position, the same on every lane) says which lane holds which
// position. The substitution broadcasts one unknown a step. Every lane
// forms the clamp and exp_so3 (lie.cuh's) from the broadcast unknowns;
// lanes 0-15 form one entry each of X dX (lie.cuh's se3_entry). Each
// value is a fixed sequence of operations with no atomics, so the same
// inputs give the same bits on every rank of a keyframe-sharded step and
// in every replay of a CUDA graph. The LU and the substitution round one
// operation at a time in the plain version's order (_rn), as do the
// scaling, the step, exp_so3 and the product; sqrt and sin are the CUDA
// math library's IEEE functions (no fast math). The keyframe sum and the
// clamp's norms may round otherwise than the plain version's einsum and
// sums, so the result agrees with it to a tolerance.

#include <cuda_runtime.h>
#include <math.h>

#include "arith.cuh"
#include "lie.cuh"
#include "lu6.cuh"

namespace {

using madicp::Arith;

constexpr int WARPS = 4;  // sequences a block
constexpr int THREADS = 32 * WARPS;
constexpr int NV = 42;    // values of a sequence's system: H (36), then b (6)
constexpr int KC = 16;    // keyframes whose terms a lane has in flight at once
constexpr unsigned FULL_MASK = madicp::LU_FULL_MASK;
using madicp::lane_at;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    gn_update_kernel(const T* __restrict__ X, const T* __restrict__ H,
                     const T* __restrict__ bv, const T* __restrict__ w, int n, int K,
                     T* __restrict__ out, T* __restrict__ Hout, T* __restrict__ bout) {
  using A = Arith<T>;
  __shared__ T sys[WARPS][NV];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long s = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (s >= n) return;  // a whole warp: s is the warp's

  // phase: terms
  // X's row for this lane's entry of the product (lanes 0-15)
  const T* xr = X + s * 16 + ((lane >> 2) & 3) * 4;
  const T x0 = xr[0], x1 = xr[1], x2 = xr[2], x3 = xr[3];
  // lane v sums value v (an entry of H) and value v + 32 (H's last four,
  // then b) over the keyframes, in order; every offset but the sequence's
  // is 32-bit, and the keyframes of a batch are immediates
  const int v1 = lane + 32;
  const bool has1 = v1 < NV;
  const T* h0p = H + s * (36LL * K) + lane;
  const T* h1p = v1 < 36 ? H + s * (36LL * K) + v1 : bv + s * (6LL * K) + (v1 - 36);
  const int step1 = v1 < 36 ? 36 : 6;
  const T* ws = w == nullptr ? nullptr : w + s * K;
  T acc0 = T(0), acc1 = T(0);
  for (int k0 = 0; k0 < K; k0 += KC) {
    T h0[KC], h1[KC], wk[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const bool in = k0 + j < K;
      h0[j] = in ? h0p[(k0 + j) * 36] : T(0);
      h1[j] = in && has1 ? h1p[(k0 + j) * step1] : T(0);
      wk[j] = in && ws != nullptr ? ws[k0 + j] : T(1);
    }
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      if (k0 + j < K) {
        acc0 = k0 + j == 0 ? A::mul(wk[j], h0[j]) : A::fma(wk[j], h0[j], acc0);
        acc1 = k0 + j == 0 ? A::mul(wk[j], h1[j]) : A::fma(wk[j], h1[j], acc1);
      }
    }
  }
  sys[warp][lane] = acc0;
  if (has1) sys[warp][v1] = acc1;
  if (Hout != nullptr) {
    Hout[s * 36 + lane] = acc0;
    if (v1 < 36) Hout[s * 36 + v1] = acc1;
    else if (has1) bout[s * 6 + v1 - 36] = acc1;
  }
  __syncwarp();

  // phase: scaling
  // lane i < 6 holds row i (lanes 6-31 mirror row 5 and take no part) and
  // forms its scale; the others come by shuffles
  const int row = lane < 6 ? lane : 5;
  T trace = T(0);
#pragma unroll
  for (int j = 0; j < 6; ++j) trace = j == 0 ? sys[warp][0] : A::add(trace, sys[warp][7 * j]);
  const T hii = sys[warp][7 * row];
  const T ei = A::rcp(hii > T(0) ? A::sqrt(fmax(hii, T(1e-30))) : T(1));
  T e[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) e[j] = __shfl_sync(FULL_MASK, ei, j);
  T a[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    a[j] = A::mul(sys[warp][6 * row + j], A::mul(ei, e[j]));
    if (j == row) a[j] = A::add(a[j], T(1e-8));
  }
  T r = -A::mul(sys[warp][36 + row], ei);

  // phase: lu
  unsigned order;
  int pos, swaps;
  T ru, u;
  madicp::lu6(a, r, lane, order, pos, ru, u, swaps);

  // phase: substitution
  T y[6];
#pragma unroll
  for (int k = 5; k >= 0; --k) {
    y[k] = __shfl_sync(FULL_MASK, A::mul(r, ru), lane_at(order, k));
    if (pos < k) r = A::sub(r, A::mul(a[k], y[k]));
  }

  // phase: clamp
  const bool good = trace > T(0);
  T dx[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const T v = A::mul(y[j], e[j]);
    dx[j] = good && isfinite(v) ? v : T(0);
  }
  const T dt = A::sqrt(dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]);
  const T dr = A::sqrt(dx[3] * dx[3] + dx[4] * dx[4] + dx[5] * dx[5]);
  const T scale = fmin(fmin(A::div(T(1.0), fmax(dt, T(1e-30))),
                            A::div(T(0.5), fmax(dr, T(1e-30)))), T(1));
#pragma unroll
  for (int j = 0; j < 6; ++j) dx[j] *= scale;

  // phase: exp_so3
  T R[9];
  madicp::exp_so3(dx[3], dx[4], dx[5], R);

  // phase: product
  // X <- X dX, dX = [R | dx_t; 0 0 0 1]: lane 4 i + j forms entry (i, j)
  if (lane < 16) {
    const int j = lane & 3;
    const T c0 = j == 3 ? dx[0] : R[j];
    const T c1 = j == 3 ? dx[1] : R[3 + j];
    const T c2 = j == 3 ? dx[2] : R[6 + j];
    out[s * 16 + lane] = madicp::se3_entry(x0, x1, x2, x3, c0, c1, c2, j == 3);
  }
  // phase: end
}

template <typename T>
int launch(const T* X, const T* H, const T* b, const T* w, int n, int K, T* out, T* Hout,
           T* bout, cudaStream_t stream) {
  if (n < 0 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((n + WARPS - 1) / WARPS), block(THREADS);
  gn_update_kernel<T><<<grid, block, 0, stream>>>(X, H, b, w, n, K, out, Hout, bout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain C interface for ctypes: (X (n, 4, 4), H (n, K, 6, 6), b (n, K,
// 6), w (n, K), n, K, out (n, 4, 4), H_out (n, 6, 6), b_out (n, 6),
// stream), every tensor contiguous. Without weights (w null) the terms
// are summed already: K = 1, weight 1; H_out and b_out may then be null
// (not written). Returns the CUDA error code of the launch (0 = success).
int gn_update_f32(const float* X, const float* H, const float* b, const float* w, int n, int K,
                  float* out, float* Hout, float* bout, void* stream) {
  return launch<float>(X, H, b, w, n, K, out, Hout, bout, static_cast<cudaStream_t>(stream));
}

int gn_update_f64(const double* X, const double* H, const double* b, const double* w, int n,
                  int K, double* out, double* Hout, double* bout, void* stream) {
  return launch<double>(X, H, b, w, n, K, out, Hout, bout, static_cast<cudaStream_t>(stream));
}

const char* madicp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
