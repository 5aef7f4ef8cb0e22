// The deskew sweep (K12), for Hopper (sm_90a).
//
// From a batch of clouds points (B, N, 3), a flag a sequence do (B,), each
// sequence's last two trajectory poses T_prev, T_now (B, 4, 4) and the
// sensor rate hz (one value on the device): every valid point of a `do`
// sequence moved by its azimuth bin's rigid motion, every other point
// copied, written in the cloud's own order.
//   motion     the naive velocity of T_prev^-1 T_now over ts = 1 / hz,
//              v_lin = t_rel / ts, v_ang = log_so3(R_rel) / ts; at bin k
//              the time t_k = -ts + k (ts / (CHUNKS - 1)), the rotation
//              exp_so3(v_ang t_k) and the translation v_lin t_k
//              (pipeline.cpp:82-108);
//   binned     bin = clamp(floor((pi - az) / res), 0, CHUNKS - 1),
//              az = atan2(y, x), res = 2 pi / CHUNKS;
//   reference  over the sweep in descending azimuth: the keys (azimuths,
//              -inf where a point is invalid) of a stable ascending sort
//              and their order, read from the end; with
//              c_j = clamp(ceil((pi - key_j) / res - 1), 0, CHUNKS - 1)
//              at sorted position j, k_j = clamp(min(j + 1, j + min_{i <= j}
//              (c_i - i))) is the bin of point order[j] (the reference's
//              once-per-point bin advance, pipeline.cpp:97-122, in closed
//              form);
//   apply      out_c = ((R_c0 x + R_c1 y) + R_c2 z) + t_c.
// Every value is formed with _rn intrinsics in the plain version's order
// (kernels/deskew.py `bin_motion_plain`, `deskew_sweep_plain`; nvcc would
// otherwise contract a*b + c into FMAs): the relative pose's products
// written out, log_so3's near-pi, regular and Taylor branches, exp_so3's
// theta^2 < 1e-8 branch and K K in closed form; pi and res are the
// working type's values of the wrapper's doubles, the divisions are IEEE
// (torch's CUDA division by a host scalar multiplies by a reciprocal; the
// plain version divides by 0-dim tensors), and atan2, acos and sin are
// the CUDA math library's, which torch's CUDA ops call (no fast math). c
// and j are exact integers (N < 2^24), so the prefix minimum is an
// integer minimum: exact in any order, and the kernel equals the plain
// version bit for bit, bins and cloud.
//
// It is the counterpart of madicp_tpu_torch/ops/deskew.py `deskew_cloud`
// and the step's select (models/pipeline.py `_odometry_step`), which port
// the JAX package's madicp_tpu/ops/deskew.py `deskew_cloud` (with
// `_bin_times_and_motion`) and madicp_tpu/models/pipeline.py:707-714; XLA
// lowered those, so no Pallas kernel stands behind them.
//
// Bound on an H100: bytes. A float32 flagship sequence (131072 points):
// the reference mode reads its sorted keys (4 bytes), their order (8) and
// the points (12) once and writes the cloud (12): ~4.7 MB, ~1.4 us at
// 3.35 TB/s; binned reads the points and valid (13), writes 12: ~3.3 MB,
// ~1.0 us. Binned ~140 operations a moved point (atan2 and the bin ~25,
// the motion of its bin ~100, the apply 18): ~9 MFLOP, far below the
// bytes' time; the reference mode forms a tile's few motions once.
//
// Design, one launch a call in either mode, one thread a point (blocks of
// THREADS, one grid row a sequence):
//   velocity   thread 0 of each block forms it (log_so3 and the divisions:
//              a chain of a few hundred dependent instructions) into
//              shared memory while the block's loads are in flight; hz is
//              read on the device (no host read: the call captures in a
//              CUDA graph). No table of the 1024 bins is written to or
//              read from device memory.
//   reference  a block takes THREADS consecutive sorted positions. As c_i
//              lies in [0, CHUNKS - 1], c_i - i >= -i > c_j - j for every
//              i <= j - CHUNKS: the prefix minimum at j is the minimum
//              over the CHUNKS positions up to j. So a block reads its own
//              keys and the CHUNKS keys before them (coalesced; L2 serves
//              the neighbours' overlap) and needs no pass over the tiles
//              before it, no second launch and no workspace. The order
//              and the point gathers are issued before the scan, which
//              does not depend on them; an invalid point's key is -inf (c
//              = CHUNKS - 1), so neither its azimuth nor its mask is
//              gathered. The advance moves at most one bin a position and
//              never back, so a tile's bins are one run k_lo .. k_hi (~4
//              at the flagship's 64 points a bin): their motions are
//              formed once, a thread each, into shared memory, not once a
//              point. The block writes out[order[j]] directly (a
//              permutation: every point once). A point is read and written
//              as a pair and a scalar (two requests to L2, not three, each
//              way: the scattered accesses are what a random order pays
//              for). At
//              B = 1 the flagship's 512 blocks are ~4 an SM.
//   binned     one thread a point in the cloud's order: its own atan2 and
//              bin while the velocity is formed. A block whose moved points
//              span fewer than THREADS bins (a sweep in column order: ~4)
//              forms those motions once into shared memory as the
//              reference mode does; otherwise (a random order: ~230 of the
//              1024 bins a block) each point forms its own in registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "arith.cuh"
#include "lie.cuh"

namespace {

using madicp::Arith;
using madicp::Trig;

constexpr int CHUNKS = 1024;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL_MASK = 0xffffffffu;

// a sequence's naive velocity and the bins' time step
template <typename T>
struct Velocity {
  T lin[3], ang[3];
  T ts, delta;  // 1 / hz, ts / (CHUNKS - 1)
};

// Velocity of T_prev^-1 T_now (P, Q: the two poses, row-major 4 x 4) at
// rate hz: R[i][j] = (P_0i Q_0j + P_1i Q_1j) + P_2i Q_2j, t_i = ((P_0i Q_03
// + P_1i Q_13) + P_2i Q_23) + s_i with s_i = -((P_0i P_03 + P_1i P_13) +
// P_2i P_23); then log_so3 (ops/lie.py, lie_algebra.h:54-89).
template <typename T>
__device__ Velocity<T> velocity(const T* __restrict__ P, const T* __restrict__ Q, T hz, T pi) {
  using A = Arith<T>;
  T R[3][3], t[3];
  madicp::relative_pose(P, Q, R, t);
  const T tr = A::add(A::add(R[0][0], R[1][1]), R[2][2]);
  T w[3];
  if (A::add(tr, T(1)) < T(1e-10)) {
    // near pi: the axis from the column of a diagonal entry that is not -1
    const int i = fabs(A::add(R[2][2], T(1))) > T(1e-5) ? 2
                  : fabs(A::add(R[1][1], T(1))) > T(1e-5) ? 1 : 0;
    T d = A::add(T(2), A::mul(T(2), R[i][i]));
    d = d < T(1e-30) ? T(1e-30) : d;
    const T f = A::div(pi, A::sqrt(d));
#pragma unroll
    for (int r = 0; r < 3; ++r) w[r] = A::mul(f, r == i ? A::add(T(1), R[i][i]) : R[r][i]);
  } else {
    const T tr3 = A::sub(tr, T(3));
    T mag;
    if (tr3 < T(-1e-7)) {
      T x = A::mul(A::sub(tr, T(1)), T(0.5));
      x = x < T(-1) ? T(-1) : (x > T(1) ? T(1) : x);
      const T theta = A::acos(x);
      const T sn = Trig<T>::sin(theta);
      mag = A::div(theta, fabs(sn) < T(1e-30) ? T(1) : A::mul(T(2), sn));
    } else {  // Taylor
      mag = A::sub(T(0.5), A::div(A::mul(tr3, tr3), T(12)));
    }
    w[0] = A::mul(mag, A::sub(R[2][1], R[1][2]));
    w[1] = A::mul(mag, A::sub(R[0][2], R[2][0]));
    w[2] = A::mul(mag, A::sub(R[1][0], R[0][1]));
  }
  Velocity<T> v;
  v.ts = A::div(T(1), hz);
  v.delta = A::div(v.ts, T(CHUNKS - 1));
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    v.lin[c] = A::div(t[c], v.ts);
    v.ang[c] = A::div(w[c], v.ts);
  }
  return v;
}

// bin k's rigid motion [exp_so3(v_ang t_k) | v_lin t_k] (exp_so3 of
// lie.cuh), the rotation row-major
template <typename T>
struct Motion {
  T R[9], t[3];
};

template <typename T>
__device__ __forceinline__ Motion<T> bin_motion(const Velocity<T>& v, int k) {
  using A = Arith<T>;
  const T tk = A::add(-v.ts, A::mul(v.delta, static_cast<T>(k)));
  const T wx = A::mul(v.ang[0], tk), wy = A::mul(v.ang[1], tk), wz = A::mul(v.ang[2], tk);
  Motion<T> m;
  madicp::exp_so3(wx, wy, wz, m.R);
#pragma unroll
  for (int c = 0; c < 3; ++c) m.t[c] = A::mul(v.lin[c], tk);
  return m;
}

// o = ((R_c0 x + R_c1 y) + R_c2 z) + t_c
template <typename T>
__device__ __forceinline__ void apply(const Motion<T>& m, T x, T y, T z, T o[3]) {
  using A = Arith<T>;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[c] = A::add(A::add(A::add(A::mul(m.R[3 * c], x), A::mul(m.R[3 * c + 1], y)),
                         A::mul(m.R[3 * c + 2], z)),
                  m.t[c]);
  }
}

// A point's three values as two accesses, one of them a pair, with no
// branch: point p starts on a pair boundary where p is even (x, y the
// pair, z alone), and its y does where p is odd (x alone, y, z the pair),
// when the array starts on one (`paired`); otherwise three scalar
// accesses.
template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using V = float2;
};
template <>
struct Pair<double> {
  using V = double2;
};

template <typename T>
__device__ __forceinline__ void load_point(const T* __restrict__ points, long long p,
                                           bool paired, T& x, T& y, T& z) {
  using V = typename Pair<T>::V;
  const T* q = points + 3 * p;
  if (!paired) {
    x = q[0], y = q[1], z = q[2];
    return;
  }
  const bool odd = p & 1;
  const V a = *reinterpret_cast<const V*>(q + odd);
  const T s = q[odd ? 0 : 2];
  x = odd ? s : a.x, y = odd ? a.x : a.y, z = odd ? a.y : s;
}

template <typename T>
__device__ __forceinline__ void store_point(T* __restrict__ out, long long p, bool paired,
                                            const T o[3]) {
  using V = typename Pair<T>::V;
  T* q = out + 3 * p;
  if (!paired) {
    q[0] = o[0], q[1] = o[1], q[2] = o[2];
    return;
  }
  const bool odd = p & 1;
  *reinterpret_cast<V*>(q + odd) = odd ? V{o[1], o[2]} : V{o[0], o[1]};
  q[odd ? 0 : 2] = odd ? o[0] : o[2];
}

template <typename T>
__device__ __forceinline__ bool pair_aligned(const T* a, const T* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) %
          sizeof(typename Pair<T>::V)) == 0;
}

// bin = clamp(floor((pi - az) / res), 0, CHUNKS - 1)
template <typename T>
__device__ __forceinline__ int binned_bin(T az, T pi, T res) {
  using A = Arith<T>;
  const T q = floor(A::div(A::sub(pi, az), res));
  return q < T(0) ? 0 : (q > T(CHUNKS - 1) ? CHUNKS - 1 : static_cast<int>(q));
}

// c = clamp(ceil((pi - key) / res - 1), 0, CHUNKS - 1); an invalid point's
// key is -inf, so its c is CHUNKS - 1
template <typename T>
__device__ __forceinline__ int sweep_target(T key, T pi, T res) {
  using A = Arith<T>;
  const T q = ceil(A::sub(A::div(A::sub(pi, key), res), T(1)));
  return q < T(0) ? 0 : (q > T(CHUNKS - 1) ? CHUNKS - 1 : static_cast<int>(q));
}

// k = clamp(min(j + 1, j + pref), 0, CHUNKS - 1)
__device__ __forceinline__ int advance(int j, int pref) {
  const int k = min(j + 1, j + pref);
  return k < 0 ? 0 : (k > CHUNKS - 1 ? CHUNKS - 1 : k);
}

// the sequence's velocity, formed by thread 0 into s_v (the caller's
// barrier follows); `moves` is the block's do flag
template <typename T>
__device__ __forceinline__ void share_velocity(bool moves, const T* __restrict__ T_prev,
                                               const T* __restrict__ T_now,
                                               const T* __restrict__ hz, long long b, T pi,
                                               Velocity<T>* s_v) {
  if (moves && threadIdx.x == 0) *s_v = velocity(T_prev + 16 * b, T_now + 16 * b, *hz, pi);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    binned_kernel(const T* __restrict__ points, const uint8_t* __restrict__ valid,
                  const uint8_t* __restrict__ do_, const T* __restrict__ T_prev,
                  const T* __restrict__ T_now, const T* __restrict__ hz, int N, T pi, T res,
                  T* __restrict__ out, int* __restrict__ bins) {
  __shared__ Velocity<T> s_v;
  __shared__ Motion<T> s_motion[THREADS];  // bins lo .. hi of the block's moved points
  __shared__ int s_lo[WARPS], s_hi[WARPS];
  const long long b = blockIdx.y;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool in = i < N, moves = do_[b] != 0, paired = pair_aligned(points, out);
  const long long p = b * N + i;
  T x = T(0), y = T(0), z = T(0);
  bool live = false;
  if (in) {
    load_point(points, p, paired, x, y, z);
    live = moves && valid[p] != 0;
  }
  share_velocity(moves, T_prev, T_now, hz, b, pi, &s_v);
  const int bin = binned_bin(Trig<T>::atan2(y, x), pi, res);
  // the range of the moved points' bins: a block of a sweep in column
  // order holds a few bins, one in a random order most of the 1024
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lo_w = __reduce_min_sync(FULL_MASK, live ? bin : INT_MAX);
  const int hi_w = __reduce_max_sync(FULL_MASK, live ? bin : INT_MIN);
  if (lane == 0) s_lo[warp] = lo_w, s_hi[warp] = hi_w;
  __syncthreads();
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) lo = min(lo, s_lo[w]), hi = max(hi, s_hi[w]);
  // a few bins: their motions once, a thread each (uniform over the block)
  const bool table = hi >= lo && hi - lo < THREADS;
  if (table) {
    if (static_cast<int>(threadIdx.x) <= hi - lo)
      s_motion[threadIdx.x] = bin_motion(s_v, lo + static_cast<int>(threadIdx.x));
    __syncthreads();
  }
  if (!in) return;
  if (bins != nullptr) bins[p] = bin;
  T o[3] = {x, y, z};
  if (live) apply(table ? s_motion[bin - lo] : bin_motion(s_v, bin), x, y, z, o);
  store_point(out, p, paired, o);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    reference_kernel(const T* __restrict__ points, const uint8_t* __restrict__ do_,
                     const T* __restrict__ T_prev, const T* __restrict__ T_now,
                     const T* __restrict__ hz, const T* __restrict__ keys,
                     const long long* __restrict__ order, int N, T pi, T res,
                     T* __restrict__ out, int* __restrict__ bins) {
  __shared__ Velocity<T> s_v;
  __shared__ Motion<T> s_motion[THREADS];  // bins k_lo .. k_hi of the tile
  __shared__ int s_halo[WARPS], s_total[WARPS], s_first;
  const long long b = blockIdx.y, row = b * N;
  const bool moves = do_[b] != 0, paired = pair_aligned(points, out);
  const int first = blockIdx.x * THREADS;
  const int j = first + threadIdx.x;  // sorted position, descending azimuth
  const bool in = j < N;
  // this position's key and point: the ascending arrays read from the end
  T key = T(0), x = T(0), y = T(0), z = T(0);
  long long p = 0;
  if (in) {
    key = keys[row + (N - 1 - j)];
    p = row + order[row + (N - 1 - j)];
    load_point(points, p, paired, x, y, z);
  }
  // the minimum of c_i - i over the CHUNKS positions before the tile
  int halo = INT_MAX;
#pragma unroll
  for (int e = 0; e < CHUNKS / THREADS; ++e) {
    const int i = first - CHUNKS + e * THREADS + threadIdx.x;
    if (i >= 0) halo = min(halo, sweep_target(keys[row + (N - 1 - i)], pi, res) - i);
  }
  share_velocity(moves, T_prev, T_now, hz, b, pi, &s_v);
  // the tile's inclusive scan of c_j - j: lanes by shuffles, then warps
  const int v = in ? sweep_target(key, pi, res) - j : INT_MAX;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(FULL_MASK, incl, d);
    if (lane >= d) incl = min(incl, o);
  }
  halo = __reduce_min_sync(FULL_MASK, halo);
  if (lane == 31) s_total[warp] = incl;
  if (lane == 0) s_halo[warp] = halo;
  if (threadIdx.x == 0) s_first = v;
  __syncthreads();
  int carry = INT_MAX, before = INT_MAX;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    carry = min(carry, s_halo[w]);
    if (w < warp) before = min(before, s_total[w]);
  }
  int all = carry;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) all = min(all, s_total[w]);
  // the advance moves at most one bin a position and never back, so the
  // tile's bins are k_lo .. k_hi, at most THREADS of them: their motions
  // are formed once, a thread each
  const int last = min(first + THREADS, N) - 1;
  const int k_lo = advance(first, min(carry, s_first)), k_hi = advance(last, all);
  if (moves && static_cast<int>(threadIdx.x) <= k_hi - k_lo)
    s_motion[threadIdx.x] = bin_motion(s_v, k_lo + static_cast<int>(threadIdx.x));
  __syncthreads();
  if (!in) return;
  const int k = advance(j, min(min(carry, before), incl));
  if (bins != nullptr) bins[p] = k;
  T o[3] = {x, y, z};
  // an invalid point's key is -inf (a valid one's is its finite azimuth)
  if (moves && key >= -Arith<T>::max_value()) apply(s_motion[k - k_lo], x, y, z, o);
  store_point(out, p, paired, o);
}

template <typename T>
int launch_binned(const T* points, const uint8_t* valid, const uint8_t* do_, const T* T_prev,
                  const T* T_now, const T* hz, int B, int N, double pi, double res, T* out,
                  int* bins, cudaStream_t stream) {
  if (B < 0 || N < 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((N + THREADS - 1) / THREADS, B);
  binned_kernel<T><<<grid, THREADS, 0, stream>>>(points, valid, do_, T_prev, T_now, hz, N,
                                                 static_cast<T>(pi), static_cast<T>(res), out,
                                                 bins);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_reference(const T* points, const uint8_t* do_, const T* T_prev, const T* T_now,
                     const T* hz, const T* keys, const long long* order, int B, int N,
                     double pi, double res, T* out, int* bins, cudaStream_t stream) {
  if (B < 0 || N < 0 || B > 65535 || N >= (1 << 24))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((N + THREADS - 1) / THREADS, B);
  reference_kernel<T><<<grid, THREADS, 0, stream>>>(points, do_, T_prev, T_now, hz, keys, order,
                                                    N, static_cast<T>(pi), static_cast<T>(res),
                                                    out, bins);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain C interface for ctypes. Binned: (points (B, N, 3), valid (B, N)
// bool, do (B,) bool, T_prev, T_now (B, 4, 4), hz (one value), B, N, pi,
// res, out (B, N, 3), bins (B, N) int32 or NULL, stream). Reference:
// (points, do, T_prev, T_now, hz, keys (B, N), order (B, N) int64, then
// as binned). Every tensor contiguous. Returns the CUDA error code of the
// launch (0 = success).
int deskew_binned_f32(const float* points, const uint8_t* valid, const uint8_t* do_,
                      const float* T_prev, const float* T_now, const float* hz, int B, int N,
                      double pi, double res, float* out, int* bins, void* stream) {
  return launch_binned<float>(points, valid, do_, T_prev, T_now, hz, B, N, pi, res, out, bins,
                              static_cast<cudaStream_t>(stream));
}

int deskew_binned_f64(const double* points, const uint8_t* valid, const uint8_t* do_,
                      const double* T_prev, const double* T_now, const double* hz, int B, int N,
                      double pi, double res, double* out, int* bins, void* stream) {
  return launch_binned<double>(points, valid, do_, T_prev, T_now, hz, B, N, pi, res, out, bins,
                               static_cast<cudaStream_t>(stream));
}

int deskew_reference_f32(const float* points, const uint8_t* do_, const float* T_prev,
                         const float* T_now, const float* hz, const float* keys,
                         const long long* order, int B, int N, double pi, double res,
                         float* out, int* bins, void* stream) {
  return launch_reference<float>(points, do_, T_prev, T_now, hz, keys, order, B, N, pi, res, out,
                                 bins, static_cast<cudaStream_t>(stream));
}

int deskew_reference_f64(const double* points, const uint8_t* do_, const double* T_prev,
                         const double* T_now, const double* hz, const double* keys,
                         const long long* order, int B, int N, double pi, double res,
                         double* out, int* bins, void* stream) {
  return launch_reference<double>(points, do_, T_prev, T_now, hz, keys, order, B, N, pi, res,
                                  out, bins, static_cast<cudaStream_t>(stream));
}

const char* madicp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
