// Rigid-motion arithmetic shared by the hand-written kernels, one written
// order for every value, each operation rounded on its own (Arith's _rn
// intrinsics): the plain versions form the same values in the same order
// on per-component tensors (madicp_tpu_torch/ops/lie.py), so a kernel that
// uses these gets its plain version's bits.
//
//   * Trig: the CUDA math library's sin, atan2, asin and log (no fast
//     math), the functions torch's CUDA ops call.
//   * relative_pose: T_prev^-1 T_now of two row-major 4 x 4 poses P, Q:
//     R[i][j] = (P_0i Q_0j + P_1i Q_1j) + P_2i Q_2j, t_i = ((P_0i Q_03 +
//     P_1i Q_13) + P_2i Q_23) + s_i with s_i = -((P_0i P_03 + P_1i P_13) +
//     P_2i P_23) (ops/lie.py `relative_pose`).
//   * exp_so3: Rodrigues (lie_algebra.h:39-52): I + W where theta^2 < 1e-8,
//     else R_ii = 1 + omc KK_ii, R_ij = sn K_ij + omc KK_ij with K = W /
//     theta, sn = sin(theta), omc = 2 sin(theta / 2)^2 and K K in closed
//     form (KK_ii = -(k_a^2 + k_b^2), KK_ij = k_i k_j); theta^2 = (w_x^2 +
//     w_y^2) + w_z^2 (ops/lie.py `exp_so3_components`).
//   * se3_entry: entry (i, j) of A B for a rigid B: ((a_i0 b_0j + a_i1 b_1j)
//     + a_i2 b_2j), plus a_i3 where j = 3 (ops/lie.py `se3_compose`).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "arith.cuh"

namespace madicp {

template <typename T>
struct Trig;
template <>
struct Trig<float> {
  static __device__ __forceinline__ float sin(float x) { return sinf(x); }
  static __device__ __forceinline__ float atan2(float y, float x) { return atan2f(y, x); }
  static __device__ __forceinline__ float asin(float x) { return asinf(x); }
  static __device__ __forceinline__ float log(float x) { return logf(x); }
};
template <>
struct Trig<double> {
  static __device__ __forceinline__ double sin(double x) { return ::sin(x); }
  static __device__ __forceinline__ double atan2(double y, double x) { return ::atan2(y, x); }
  static __device__ __forceinline__ double asin(double x) { return ::asin(x); }
  static __device__ __forceinline__ double log(double x) { return ::log(x); }
};

// T_prev^-1 T_now of row-major poses P (T_prev) and Q (T_now)
template <typename T>
__device__ __forceinline__ void relative_pose(const T* P, const T* Q, T R[3][3], T t[3]) {
  using A = Arith<T>;
  auto col = [&](int i, const T* M, int c) {
    return A::add(A::add(A::mul(P[i], M[c]), A::mul(P[4 + i], M[4 + c])),
                  A::mul(P[8 + i], M[8 + c]));
  };
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i][j] = col(i, Q, j);
    t[i] = A::add(col(i, Q, 3), -col(i, P, 3));
  }
}

// exp_so3 of (wx, wy, wz), the rotation row-major
template <typename T>
__device__ __forceinline__ void exp_so3(T wx, T wy, T wz, T R[9]) {
  using A = Arith<T>;
  const T theta_sq = A::add(A::add(A::mul(wx, wx), A::mul(wy, wy)), A::mul(wz, wz));
  if (theta_sq < T(1e-8)) {  // I + W
    R[0] = T(1), R[1] = -wz, R[2] = wy;
    R[3] = wz, R[4] = T(1), R[5] = -wx;
    R[6] = -wy, R[7] = wx, R[8] = T(1);
    return;
  }
  const T theta = A::sqrt(theta_sq);
  const T k3[3] = {A::div(wx, theta), A::div(wy, theta), A::div(wz, theta)};
  const T sn = Trig<T>::sin(theta);
  const T h = Trig<T>::sin(A::mul(theta, T(0.5)));
  const T omc = A::mul(T(2), A::mul(h, h));
  const T sq[3] = {A::mul(k3[0], k3[0]), A::mul(k3[1], k3[1]), A::mul(k3[2], k3[2])};
  // K = W / theta: K01 = -kz, K02 = ky, K10 = kz, K12 = -kx, K20 = -ky, K21 = kx
  const T K[3][3] = {{T(0), -k3[2], k3[1]}, {k3[2], T(0), -k3[0]}, {-k3[1], k3[0], T(0)}};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (i == j) {
        const int a = i == 0 ? 1 : 0, b = i == 2 ? 1 : 2;
        R[4 * i] = A::add(T(1), A::mul(omc, -A::add(sq[a], sq[b])));
      } else {
        R[3 * i + j] = A::add(A::mul(sn, K[i][j]), A::mul(omc, A::mul(k3[i], k3[j])));
      }
    }
  }
}

// entry (i, j) of A B from row i of A (a0..a3) and column j of B's top
// three rows (b0, b1, b2); B's last row is [0 0 0 1]
template <typename T>
__device__ __forceinline__ T se3_entry(T a0, T a1, T a2, T a3, T b0, T b1, T b2, bool last) {
  using A = Arith<T>;
  const T o = A::add(A::add(A::mul(a0, b0), A::mul(a1, b1)), A::mul(a2, b2));
  return last ? A::add(o, a3) : o;
}

}  // namespace madicp
