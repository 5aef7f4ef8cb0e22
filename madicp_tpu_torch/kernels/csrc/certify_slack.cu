// The certified round's slack pass (K11), for Hopper (sm_90a).
//
// In each later round of the certified exact schedule, an entry (sequence
// b, keyframe k, leaf l) keeps its cached association while its descent's
// path margin, less the map-frame displacement of its query since that
// descent, stays above a rounding floor. From the previous and current
// poses Xp, X (B, 4, 4), the leaves m (B, L, 3), their norms r_norm (B, L),
// the slack (B, K, L), leaves_valid (B, L), kf_live (B, K) and
// optionally the live leaves n_live (B,) int64, for each entry below its
// sequence's bound min(n_live, L) (L without n_live):
//   motion bound  dR = R - Rp, dt = t - tp,
//                 d_c = ((m_x dR_c0 + m_y dR_c1) + m_z dR_c2) + dt_c,
//                 bound = sqrt((d_0^2 + d_1^2) + d_2^2)
//   rounding floor eps_cert = (64 eps) ((1 + |t|) + r_norm),
//                 |t| = sqrt((t_0^2 + t_1^2) + t_2^2)
//   slack         slack -= bound, in place
//   need          (slack <= eps_cert) & leaves_valid & kf_live
//   count         n_descents[b] += the sequence's need entries
// and from the bound on: slack kept, need false. The pipeline's leaves are
// a prefix of their slots (get_leaves) and n_live their count, so nothing
// past the bound was ever live.
// The bound is a norm of differences, with no trig: an angle bound's
// rounding (~sqrt(eps) near 0) would certify near-zero-slack entries
// unsoundly. The floor covers the rounding of the descent's query, which
// K6 forms in its kernel as ((m_x R_c0 + m_y R_c1) + m_z R_c2) + t_c, no
// FMA: |error| <= 2.01 eps (sqrt(3) r + |t|), the bound the GEMM that
// formed it before met in any order (kernels/certify_slack.py `eps_cert`).
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
// read once a leaf: at the flagship (16 keyframes x 32768 leaves) ~5.3 MB,
// ~1.6 us at 3.35 TB/s; ~45 operations a leaf and 3 an entry. In a round
// the slack was written two launches before, so it is read from L2. Past
// the bound only need is written (1 byte an entry).
//
// Design: one launch a round over (leaf tile, keyframe group, sequence):
// a block of 256 threads, TX = 64 along the leaves and 4 along the
// keyframes, covers TX x N leaves (N = 16 bytes of the working type: 4 in
// float32, 2 in float64) and KG = 4 x KPT = 16 keyframes of one sequence
// (one sequence at the flagship: 128 blocks in float32, 256 in float64,
// about one an SM). A thread owns N leaves of KPT = 4 keyframes: it loads
// their slack as KPT 16-byte vectors and the tile's leaves, norms and
// flags before it reads a pose (all its loads in flight before its first
// store), the block forms each leaf's bound and floor once into shared
// memory (one leaf a thread, the same _rn sequence in the plain version's
// order: nvcc would otherwise contract a*b + c into FMAs), and the thread
// writes the slack back as 16-byte vectors and `need` as one 4- (2-) byte
// store a keyframe. A row length L that is not a multiple of N (or a
// slack or need that is not so aligned) takes the same kernel with scalar
// loads and stores. need agrees with the plain version bit for bit. The
// count adds each block's need entries (warp sums, then one integer
// atomic a block): integer sums are exact in any order, so a replay
// equals the eager call. PERF.md §6 (PR 15) has the A/B of six block
// shapes behind this one: at B = 4 in float64 (1.6 waves) none matched
// the one-thread-a-leaf loop it replaced.
//
// The bound: a block whose leaf tile lies wholly at or past its
// sequence's bound stores need = 0 for its entries (16-byte stores where
// need's rows allow, else a thread's words) and loads nothing else; a
// tile that straddles the bound masks leaf by leaf.

#include <cuda_runtime.h>
#include <stdint.h>

#include <limits>

#include "arith.cuh"

namespace {

using madicp::Arith;

constexpr int THREADS = 256;
constexpr int TX = 64;   // threads along the leaves; THREADS / TX along the keyframes
constexpr int KPT = 4;   // keyframes a thread
// blocks an SM must hold (__launch_bounds__: a register cap of 48)
constexpr int MIN_BLOCKS = 5;
constexpr unsigned FULL_MASK = 0xffffffffu;

template <typename T>
struct Lanes;  // 16 bytes of the working type, and a need word of as many leaves
template <>
struct Lanes<float> {
  static constexpr int N = 4;
  using Vec = float4;
  using Need = uint32_t;
};
template <>
struct Lanes<double> {
  static constexpr int N = 2;
  using Vec = double2;
  using Need = uint16_t;
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    certify_slack_kernel(T* __restrict__ slack, const T* __restrict__ Xp,
                         const T* __restrict__ X, const T* __restrict__ pts,
                         const T* __restrict__ r_norm, const uint8_t* __restrict__ leaves_valid,
                         const uint8_t* __restrict__ kf_live,
                         const long long* __restrict__ n_live, int K, int L, bool zero16,
                         T floor_scale, uint8_t* __restrict__ need,
                         unsigned long long* __restrict__ n_descents) {
  using A = Arith<T>;
  using V = typename Lanes<T>::Vec;
  using Need = typename Lanes<T>::Need;
  constexpr int N = Lanes<T>::N;
  constexpr int TL = TX * N;           // leaves a block
  constexpr int KG = THREADS / TX * KPT;  // keyframes a block
  __shared__ T s_bound[TL], s_eps[TL];
  __shared__ uint8_t s_valid[TL];
  __shared__ unsigned warp_counts[THREADS / 32];
  const int b = blockIdx.z;
  const int tile = blockIdx.x * TL;
  const int tx = threadIdx.x % TX;
  const int k_first = blockIdx.y * KG + (threadIdx.x / TX) * KPT;
  const int l_first = tile + tx * N;  // this thread's first leaf
  const long long bL = static_cast<long long>(b) * L;
  int bound = L;
  if (n_live != nullptr) {
    const long long n = n_live[b];
    bound = static_cast<int>(n < 0 ? 0 : (n < L ? n : L));
  }

  // a tile wholly past the bound: need = 0 for its entries, nothing else
  if (tile >= bound) {
    if (zero16) {  // L and need a multiple of 16 bytes: a 16-byte chunk of a row a thread
      constexpr int CHUNKS = TL / 16;  // of a keyframe's row in the tile
      const int k = blockIdx.y * KG + threadIdx.x / CHUNKS;
      const int l = tile + threadIdx.x % CHUNKS * 16;
      if (threadIdx.x < KG * CHUNKS && k < K && l < L)
        *reinterpret_cast<uint4*>(need + (static_cast<long long>(b) * K + k) * L + l) =
            make_uint4(0, 0, 0, 0);
    } else {
#pragma unroll
      for (int q = 0; q < KPT; ++q) {
        const int k = k_first + q;
        const long long at = (static_cast<long long>(b) * K + k) * L + l_first;
#pragma unroll
        for (int e = 0; e < N; ++e)
          if (k < K && l_first + e < L) need[at + e] = 0;
      }
    }
    return;
  }

  // phase: loads
  T sv[KPT][N] = {};
  bool live[KPT];
#pragma unroll
  for (int q = 0; q < KPT; ++q) {
    const int k = k_first + q;
    live[q] = k < K && kf_live[b * K + k] != 0;
    const T* row = slack + (static_cast<long long>(b) * K + k) * L + l_first;
    if (VEC) {
      if (k < K && l_first < L) {
        const V v = *reinterpret_cast<const V*>(row);
        sv[q][0] = v.x;
        sv[q][1] = v.y;
        if constexpr (N == 4) {
          sv[q][2] = v.z;
          sv[q][3] = v.w;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e)
        if (k < K && l_first + e < L) sv[q][e] = row[e];
    }
  }
  // the tile's leaves, one a thread (the first TL threads): its point,
  // norm and flag
  static_assert(TL <= THREADS, "a leaf a thread");
  const int lt = tile + threadIdx.x;  // this thread's leaf of the bound
  const bool bounds = threadIdx.x < TL && lt < bound;
  T mx = T(0), my = T(0), mz = T(0), rn = T(0);
  bool valid = false;
  if (bounds) {
    const T* m = pts + (bL + lt) * 3;
    mx = m[0], my = m[1], mz = m[2];
    rn = r_norm[bL + lt];
    valid = leaves_valid[bL + lt] != 0;
  }

  // phase: bound (the poses: X is the update's output, the launch before)
  const T* x = X + b * 16;
  const T* xp = Xp + b * 16;
  if (bounds) {
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
    const T t_norm = A::sqrt(A::add(A::add(A::mul(x[3], x[3]), A::mul(x[7], x[7])),
                                    A::mul(x[11], x[11])));
    s_bound[threadIdx.x] = A::sqrt(dsq);
    s_eps[threadIdx.x] = A::mul(floor_scale, A::add(A::add(T(1), t_norm), rn));
    s_valid[threadIdx.x] = valid;
  }
  __syncthreads();

  // phase: entries
  unsigned count = 0;
#pragma unroll
  for (int q = 0; q < KPT; ++q) {
    const int k = k_first + q;
    if (k >= K) continue;
    const long long at = (static_cast<long long>(b) * K + k) * L + l_first;
    Need word = 0;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      // past the bound the slack is kept and need is false; past L (the
      // last tile's tail) nothing is read, counted or stored
      if (l_first + e < bound) {
        const int t = tx * N + e;
        sv[q][e] = A::sub(sv[q][e], s_bound[t]);
        const bool nd = sv[q][e] <= s_eps[t] && s_valid[t] && live[q];
        word |= static_cast<Need>(nd) << (8 * e);
        count += nd;
      }
    }
    if (VEC) {
      if (l_first < L) {
        V v;
        v.x = sv[q][0];
        v.y = sv[q][1];
        if constexpr (N == 4) {
          v.z = sv[q][2];
          v.w = sv[q][3];
        }
        *reinterpret_cast<V*>(slack + at) = v;
        *reinterpret_cast<Need*>(need + at) = word;
      }
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        if (l_first + e < L) {
          slack[at + e] = sv[q][e];
          need[at + e] = static_cast<uint8_t>((word >> (8 * e)) & 1u);
        }
      }
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
  // phase: end
}

template <typename T>
int launch(T* slack, const T* Xp, const T* X, const T* pts, const T* r_norm,
           const uint8_t* leaves_valid, const uint8_t* kf_live, const long long* n_live, int B,
           int K, int L, uint8_t* need, long long* n_descents, cudaStream_t stream) {
  constexpr int N = Lanes<T>::N;
  if (B < 0 || K < 0 || L < 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || K == 0 || L == 0) return static_cast<int>(cudaGetLastError());
  // 64 eps: an exact power of two in the working type
  const T floor_scale = T(64) * std::numeric_limits<T>::epsilon();
  constexpr int tl = TX * N, kg = THREADS / TX * KPT;
  const dim3 grid((L + tl - 1) / tl, (K + kg - 1) / kg, B), block(THREADS);
  const bool vec = L % N == 0 && reinterpret_cast<uintptr_t>(slack) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(need) % N == 0;
  const bool zero16 = L % 16 == 0 && reinterpret_cast<uintptr_t>(need) % 16 == 0;
  auto* kernel = vec ? certify_slack_kernel<T, true> : certify_slack_kernel<T, false>;
  kernel<<<grid, block, 0, stream>>>(slack, Xp, X, pts, r_norm, leaves_valid, kf_live, n_live,
                                     K, L, zero16, floor_scale, need,
                                     reinterpret_cast<unsigned long long*>(n_descents));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain C interface for ctypes: (slack (B, K, L), Xp (B, 4, 4), X (B, 4,
// 4), pts (B, L, 3), r_norm (B, L), leaves_valid (B, L) bool, kf_live (B,
// K) bool, n_live (B,) int64 or null, B, K, L, need (B, K, L) bool,
// n_descents (B,) int64, stream), every tensor contiguous; slack and
// n_descents are updated in place.
// Returns the CUDA error code of the launch (0 = success).
int certify_slack_f32(float* slack, const float* Xp, const float* X, const float* pts,
                      const float* r_norm, const uint8_t* leaves_valid, const uint8_t* kf_live,
                      const long long* n_live, int B, int K, int L, uint8_t* need,
                      long long* n_descents, void* stream) {
  return launch<float>(slack, Xp, X, pts, r_norm, leaves_valid, kf_live, n_live, B, K, L, need,
                       n_descents, static_cast<cudaStream_t>(stream));
}

int certify_slack_f64(double* slack, const double* Xp, const double* X, const double* pts,
                      const double* r_norm, const uint8_t* leaves_valid,
                      const uint8_t* kf_live, const long long* n_live, int B, int K, int L,
                      uint8_t* need, long long* n_descents, void* stream) {
  return launch<double>(slack, Xp, X, pts, r_norm, leaves_valid, kf_live, n_live, B, K, L,
                        need, n_descents, static_cast<cudaStream_t>(stream));
}

const char* madicp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
