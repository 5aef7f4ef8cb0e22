// A 6 x 6 LU with partial pivoting across the lanes of a warp, shared by
// K10 (the Gauss-Newton solve, gn_update.cu) and K14 (-log det of the last
// round's H, step_scalars.cu). The plain version is
// kernels/gn_update.py `lu_factor` (`lu_solve` and ops/icp_core.py
// `neg_logdet` run it), the same steps in tensor ops.
//
// Lane i < 6 holds row i of the system in a[6] and its right-hand side r
// (lanes 6-31 mirror row 5 and take no part). The LU swaps no data:
// `order` (3 bits a position, the same on every lane) says which lane
// holds which position. Each pivot step gathers the column by position
// with shuffles and every lane runs the pivot search on it: the first
// largest magnitude (LAPACK's i?amax: a NaN is taken only where it comes
// first). The pivot row comes by shuffles and the rows below eliminate in
// parallel: the multiplier is the column times the pivot's reciprocal, and
// a column that is zero below its pivot, or whose pivot is zero,
// eliminates nothing. Each value rounds one operation at a time (_rn).
// On return a lane's `pos` is its row's position, `ru` the reciprocal of
// its pivot and `u` the pivot (both where pos < 6), and `swaps` (every
// lane) counts the steps whose pivot row was not the diagonal's.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "arith.cuh"

namespace madicp {

constexpr unsigned LU_FULL_MASK = 0xffffffffu;
// position j -> the lane that holds it, 3 bits a position: lane j at first
constexpr unsigned LU_IDENTITY_ORDER = 0u | 1u << 3 | 2u << 6 | 3u << 9 | 4u << 12 | 5u << 15;

__device__ __forceinline__ int lane_at(unsigned order, int pos) {
  return static_cast<int>((order >> (3 * pos)) & 7u);
}

template <typename T>
__device__ __forceinline__ void lu6(T a[6], T& r, int lane, unsigned& order, int& pos, T& ru,
                                    T& u, int& swaps) {
  using A = Arith<T>;
  order = LU_IDENTITY_ORDER;
  pos = lane < 6 ? lane : 7;  // this lane's row's position
  ru = T(0);                  // the reciprocal of its pivot, once it is one
  u = T(0);
  swaps = 0;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const T col = a[k];
    T c[6];
#pragma unroll
    for (int j = k; j < 6; ++j) c[j] = __shfl_sync(LU_FULL_MASK, col, lane_at(order, j));
    int p = k;
    T best = fabs(c[k]), piv = c[k];
    int nonzero = c[k] != T(0);
#pragma unroll
    for (int j = k + 1; j < 6; ++j) {
      const T m = fabs(c[j]);
      if (m > best) {
        best = m;
        p = j;
        piv = c[j];
      }
      nonzero += c[j] != T(0);
    }
    const bool skip = piv == T(0) || nonzero == 1;  // only the pivot is nonzero
    swaps += p != k;
    const int pl = lane_at(order, p), kl = lane_at(order, k);
    order = (order & ~(7u << (3 * k)) & ~(7u << (3 * p))) | (static_cast<unsigned>(pl) << (3 * k)) |
            (static_cast<unsigned>(kl) << (3 * p));
    if (lane == pl) {
      pos = k;
    } else if (lane == kl) {
      pos = p;
    }
    const T rp = A::rcp(piv);
    if (lane == pl) {
      ru = rp;
      u = piv;
    }
    T prow[6];
#pragma unroll
    for (int j = k + 1; j < 6; ++j) prow[j] = __shfl_sync(LU_FULL_MASK, a[j], pl);
    const T pr = __shfl_sync(LU_FULL_MASK, r, pl);
    if (pos > k && !skip) {
      const T l = A::mul(col, rp);
#pragma unroll
      for (int j = k + 1; j < 6; ++j) a[j] = A::sub(a[j], A::mul(l, prow[j]));
      r = A::sub(r, A::mul(l, pr));
    }
  }
}

}  // namespace madicp
