// The certified round's slack pass (K11), for Hopper (sm_90a).
//
// In each later round of the certified exact schedule, an entry (sequence
// b, keyframe k, leaf l) keeps its cached association while its descent's
// path margin, less the map-frame displacement of its query since that
// descent, stays above a rounding floor. From the previous and current
// poses Xp, X (B, 4, 4), the leaves m (B, L, 3), their norms r_norm (B, L),
// the slack (B, K, L), leaves_valid (B, L) and kf_live (B, K), for each
// entry:
//   motion bound  dR = R - Rp, dt = t - tp,
//                 d_c = ((m_x dR_c0 + m_y dR_c1) + m_z dR_c2) + dt_c,
//                 bound = sqrt((d_0^2 + d_1^2) + d_2^2)
//   rounding floor eps_cert = (64 eps) ((1 + |t|) + r_norm),
//                 |t| = sqrt((t_0^2 + t_1^2) + t_2^2)
//   slack         slack -= bound, in place
//   need          (slack <= eps_cert) & leaves_valid & kf_live
//   count         n_descents[b] += the sequence's need entries
// The bound is a norm of differences, with no trig: an angle bound's
// rounding (~sqrt(eps) near 0) would certify near-zero-slack entries
// unsoundly.
//
// It is the counterpart of madicp_tpu_torch/models/pipeline.py's certified
// rounds (plain version: kernels/certify_slack.py `certify_slack_plain`),
// which port the JAX package's madicp_tpu/models/pipeline.py:531-558
// `motion_bound` and `eps_cert` and the round's slack, uncertified set and
// count (:647-648, :664-665); XLA lowered those, so no Pallas kernel
// stands behind them.
//
// Bound on an H100: bytes. The slack is read and written (8 bytes an
// entry in float32), need written (1), the leaves, their norms and flags
// read once a leaf: at the flagship (16 keyframes x 32768 leaves) ~4.9 MB,
// ~1.5 us at 3.35 TB/s; ~30 operations a leaf and 3 an entry.
//
// Design: one launch a round, one thread a leaf (blocks of 256 leaves of
// one sequence), looping over the K keyframes: the leaf's bound and floor
// are formed once, each keyframe's slack is a coalesced read and write
// along L. need is a soundness decision, so the kernel forms every value
// with _rn intrinsics in the plain version's order (nvcc would otherwise
// contract a*b + c into FMAs) and agrees with it bit for bit. The count
// adds each block's need entries (warp sums, then one integer atomic a
// block): integer sums are exact in any order, so a replay equals the
// eager call.

#include <cuda_runtime.h>
#include <stdint.h>

#include <limits>

#include "arith.cuh"

namespace {

using madicp::Arith;

constexpr int THREADS = 256;
constexpr unsigned FULL_MASK = 0xffffffffu;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    certify_slack_kernel(T* __restrict__ slack, const T* __restrict__ Xp,
                         const T* __restrict__ X, const T* __restrict__ pts,
                         const T* __restrict__ r_norm, const uint8_t* __restrict__ leaves_valid,
                         const uint8_t* __restrict__ kf_live, int K, int L, T floor_scale,
                         uint8_t* __restrict__ need, unsigned long long* __restrict__ n_descents) {
  using A = Arith<T>;
  __shared__ unsigned warp_counts[THREADS / 32];
  const int b = blockIdx.y;
  const int l = blockIdx.x * THREADS + threadIdx.x;
  unsigned count = 0;
  if (l < L) {
    const T* x = X + b * 16;
    const T* xp = Xp + b * 16;
    const T* m = pts + (static_cast<long long>(b) * L + l) * 3;
    const T mx = m[0], my = m[1], mz = m[2];
    T dsq = T(0);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T d = A::add(
          A::add(A::add(A::mul(mx, A::sub(x[c * 4 + 0], xp[c * 4 + 0])),
                        A::mul(my, A::sub(x[c * 4 + 1], xp[c * 4 + 1]))),
                 A::mul(mz, A::sub(x[c * 4 + 2], xp[c * 4 + 2]))),
          A::sub(x[c * 4 + 3], xp[c * 4 + 3]));
      dsq = c == 0 ? A::mul(d, d) : A::add(dsq, A::mul(d, d));
    }
    const T bound = A::sqrt(dsq);
    const T t_norm = A::sqrt(A::add(A::add(A::mul(x[3], x[3]), A::mul(x[7], x[7])),
                                    A::mul(x[11], x[11])));
    const T eps = A::mul(floor_scale,
                         A::add(A::add(T(1), t_norm), r_norm[static_cast<long long>(b) * L + l]));
    const bool valid = leaves_valid[static_cast<long long>(b) * L + l] != 0;
    for (int k = 0; k < K; ++k) {
      const long long at = (static_cast<long long>(b) * K + k) * L + l;
      const T s = A::sub(slack[at], bound);
      slack[at] = s;
      const bool nd = s <= eps && valid && kf_live[b * K + k] != 0;
      need[at] = nd;
      count += nd;
    }
  }
  count = __reduce_add_sync(FULL_MASK, count);
  if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) total += warp_counts[w];
    if (total) atomicAdd(n_descents + b, static_cast<unsigned long long>(total));
  }
}

template <typename T>
int launch(T* slack, const T* Xp, const T* X, const T* pts, const T* r_norm,
           const uint8_t* leaves_valid, const uint8_t* kf_live, int B, int K, int L,
           uint8_t* need, long long* n_descents, cudaStream_t stream) {
  if (B < 0 || K < 0 || L < 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || L == 0) return static_cast<int>(cudaGetLastError());
  // 64 eps: an exact power of two in the working type
  const T floor_scale = T(64) * std::numeric_limits<T>::epsilon();
  const dim3 grid((L + THREADS - 1) / THREADS, B);
  certify_slack_kernel<T><<<grid, THREADS, 0, stream>>>(
      slack, Xp, X, pts, r_norm, leaves_valid, kf_live, K, L, floor_scale, need,
      reinterpret_cast<unsigned long long*>(n_descents));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain C interface for ctypes: (slack (B, K, L), Xp (B, 4, 4), X (B, 4,
// 4), pts (B, L, 3), r_norm (B, L), leaves_valid (B, L) bool, kf_live (B,
// K) bool, B, K, L, need (B, K, L) bool, n_descents (B,) int64, stream),
// every tensor contiguous; slack and n_descents are updated in place.
// Returns the cudaGetLastError() code after the launch (0 = success).
int certify_slack_f32(float* slack, const float* Xp, const float* X, const float* pts,
                      const float* r_norm, const uint8_t* leaves_valid, const uint8_t* kf_live,
                      int B, int K, int L, uint8_t* need, long long* n_descents, void* stream) {
  return launch<float>(slack, Xp, X, pts, r_norm, leaves_valid, kf_live, B, K, L, need,
                       n_descents, static_cast<cudaStream_t>(stream));
}

int certify_slack_f64(double* slack, const double* Xp, const double* X, const double* pts,
                      const double* r_norm, const uint8_t* leaves_valid,
                      const uint8_t* kf_live, int B, int K, int L, uint8_t* need,
                      long long* n_descents, void* stream) {
  return launch<double>(slack, Xp, X, pts, r_norm, leaves_valid, kf_live, B, K, L, need,
                        n_descents, static_cast<cudaStream_t>(stream));
}

const char* madicp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
