// The deskew sweep (K12), for Hopper (sm_90a).
//
// From a batch of clouds points (B, N, 3), their masks valid (B, N), a flag
// a sequence do (B,) and each sequence's per-bin motions R_bins (B, CHUNKS,
// 3, 3), t_trans (B, CHUNKS, 3): every valid point of a `do` sequence moved
// by its azimuth bin's motion, every other point copied, written in the
// cloud's own order. A point's bin:
//   binned     bin = clamp(floor((pi - az) / res), 0, CHUNKS - 1),
//              az = atan2(y, x), res = 2 pi / CHUNKS;
//   reference  over the sweep `order` (descending azimuth, from a stable
//              sort of the azimuths az that torch formed), with
//              c_j = clamp(ceil((pi - az_j) / res - 1), 0, CHUNKS - 1)
//              (CHUNKS - 1 for an invalid point) at sorted position j,
//              k_j = clamp(min(j + 1, j + min_{i <= j} (c_i - i))) is the
//              bin of point order[j] (the reference's once-per-point bin
//              advance, pipeline.cpp:97-122, in closed form).
//   apply      out_c = ((R_c0 x + R_c1 y) + R_c2 z) + t_c.
// Every value is formed with _rn intrinsics in the plain version's order
// (kernels/deskew.py `deskew_sweep_plain`; nvcc would otherwise contract
// a*b + c into FMAs), pi and res are the working type's values of the
// wrapper's doubles, and the division is IEEE (torch's CUDA division by a
// host scalar multiplies by a reciprocal; the plain version divides by a
// 0-dim tensor). c and j are exact integers (N < 2^24), so the prefix
// minimum is an integer minimum: exact in any order, and the kernel equals
// the plain version bit for bit, bins and cloud. The binned mode forms
// its own atan2 (atan2f / atan2, as torch's CUDA atan2 does); the
// reference mode reads torch's azimuths, the key it sorted.
//
// It is the counterpart of madicp_tpu_torch/ops/deskew.py `deskew_cloud`
// and the step's select (models/pipeline.py `_odometry_step`), which port
// the JAX package's madicp_tpu/ops/deskew.py `deskew_cloud` and
// madicp_tpu/models/pipeline.py:707-714; XLA lowered those, so no Pallas
// kernel stands behind them.
//
// Bound on an H100: bytes. A float32 flagship sequence (131072 points)
// reads its points (12 bytes), valid (1) and, in the reference mode, its
// order (8) and azimuths (4) once, writes the cloud (12) and reads the
// tables (48 KB): ~4.3 MB, ~1.3 us at 3.35 TB/s (binned ~3.3 MB, ~1.0 us);
// ~40 operations a point (atan2 ~20, the bin ~4, the apply 15).
//
// Design, one call a step whatever B is:
//   binned     one launch, one thread a point (blocks of 256 along the
//              points, one grid row a sequence).
//   reference  a pair: `tile_min_kernel` writes the minimum of c_j - j
//              over each tile of TILE = 1024 sorted positions (B x N/TILE
//              blocks: 128 at the flagship's B = 1, about one an SM, where
//              torch.cummin scans a row in one block); `reference_kernel`
//              takes the minimum of its tile's predecessors (at most 127
//              integers), scans its tile (4 positions a thread, then warp
//              shuffles, then the block's 8 warps), and moves point
//              order[j] by bin k_j straight into out[order[j]]: no
//              scatter of the bins and no second pass over the cloud.
// The tables are read through the read-only cache straight from global
// memory (48 KB a sequence in float32, 96 KB in float64: every block
// touches a few hundred bins of it, so staging a whole table in shared
// memory would read 48-96 KB a block for ~1,000 points' 12 values each).

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "arith.cuh"

namespace {

using madicp::Arith;

constexpr int CHUNKS = 1024;
constexpr int THREADS = 256;
constexpr int PPT = 4;                  // sorted positions a thread (reference)
constexpr int TILE = THREADS * PPT;     // sorted positions a block (kernels/deskew.py TILE)
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL_MASK = 0xffffffffu;

template <typename T>
struct Trig;
template <>
struct Trig<float> {
  static __device__ __forceinline__ float atan2(float y, float x) { return atan2f(y, x); }
};
template <>
struct Trig<double> {
  static __device__ __forceinline__ double atan2(double y, double x) { return ::atan2(y, x); }
};

// bin = clamp(floor((pi - az) / res), 0, CHUNKS - 1)
template <typename T>
__device__ __forceinline__ int binned_bin(T az, T pi, T res) {
  using A = Arith<T>;
  const T q = floor(A::div(A::sub(pi, az), res));
  return q < T(0) ? 0 : (q > T(CHUNKS - 1) ? CHUNKS - 1 : static_cast<int>(q));
}

// c = clamp(ceil((pi - az) / res - 1), 0, CHUNKS - 1); an invalid point's
// azimuth is -inf, so its c is CHUNKS - 1
template <typename T>
__device__ __forceinline__ int sweep_target(T az, bool valid, T pi, T res) {
  using A = Arith<T>;
  if (!valid) return CHUNKS - 1;
  const T q = ceil(A::sub(A::div(A::sub(pi, az), res), T(1)));
  return q < T(0) ? 0 : (q > T(CHUNKS - 1) ? CHUNKS - 1 : static_cast<int>(q));
}

// point p of sequence b moved by bin `bin`, or copied; written to out + 3 p
template <typename T>
__device__ __forceinline__ void move_point(const T* __restrict__ points,
                                           const T* __restrict__ R_bins,
                                           const T* __restrict__ t_trans, long long b,
                                           long long p, int bin, bool move, T* __restrict__ out) {
  using A = Arith<T>;
  const T x = points[3 * p], y = points[3 * p + 1], z = points[3 * p + 2];
  if (!move) {
    out[3 * p] = x;
    out[3 * p + 1] = y;
    out[3 * p + 2] = z;
    return;
  }
  const T* R = R_bins + (b * CHUNKS + bin) * 9;
  const T* t = t_trans + (b * CHUNKS + bin) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out[3 * p + c] = A::add(A::add(A::add(A::mul(__ldg(R + 3 * c), x),
                                          A::mul(__ldg(R + 3 * c + 1), y)),
                                   A::mul(__ldg(R + 3 * c + 2), z)),
                            __ldg(t + c));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    binned_kernel(const T* __restrict__ points, const uint8_t* __restrict__ valid,
                  const uint8_t* __restrict__ do_, const T* __restrict__ R_bins,
                  const T* __restrict__ t_trans, int N, T pi, T res, T* __restrict__ out,
                  int* __restrict__ bins) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= N) return;
  const long long b = blockIdx.y;
  const long long p = b * N + i;
  const int bin = binned_bin(Trig<T>::atan2(points[3 * p + 1], points[3 * p]), pi, res);
  if (bins != nullptr) bins[p] = bin;
  move_point(points, R_bins, t_trans, b, p, bin, do_[b] != 0 && valid[p] != 0, out);
}

// the minimum of an int over the block (every thread gets it)
__device__ __forceinline__ int block_min(int v, int* s_warp) {
  v = __reduce_min_sync(FULL_MASK, v);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = INT_MAX;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) m = min(m, s_warp[w]);
  __syncthreads();  // s_warp is reused
  return m;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    tile_min_kernel(const T* __restrict__ az, const uint8_t* __restrict__ valid,
                    const long long* __restrict__ order, int N, T pi, T res,
                    int* __restrict__ tile_min) {
  __shared__ int s_warp[WARPS];
  const long long b = blockIdx.y;
  const int first = blockIdx.x * TILE;
  int m = INT_MAX;
#pragma unroll
  for (int e = 0; e < PPT; ++e) {
    const int j = first + e * THREADS + threadIdx.x;
    if (j < N) {
      const long long p = b * N + order[b * N + j];
      m = min(m, sweep_target(az[p], valid[p] != 0, pi, res) - j);
    }
  }
  m = block_min(m, s_warp);
  if (threadIdx.x == 0) tile_min[b * gridDim.x + blockIdx.x] = m;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    reference_kernel(const T* __restrict__ points, const uint8_t* __restrict__ valid,
                     const uint8_t* __restrict__ do_, const T* __restrict__ R_bins,
                     const T* __restrict__ t_trans, const T* __restrict__ az,
                     const long long* __restrict__ order, int N, T pi, T res,
                     const int* __restrict__ tile_min, T* __restrict__ out,
                     int* __restrict__ bins) {
  __shared__ int s_warp[WARPS];
  const long long b = blockIdx.y;
  const bool seq_moves = do_[b] != 0;
  // the minimum over the tiles before this one
  int carry = INT_MAX;
  for (int t = threadIdx.x; t < static_cast<int>(blockIdx.x); t += THREADS)
    carry = min(carry, tile_min[b * gridDim.x + t]);
  carry = block_min(carry, s_warp);

  // this thread's PPT consecutive sorted positions and their prefix minima
  const int j0 = blockIdx.x * TILE + threadIdx.x * PPT;
  long long p[PPT];
  bool live[PPT];
  int v[PPT];
#pragma unroll
  for (int e = 0; e < PPT; ++e) {
    const int j = j0 + e;
    v[e] = INT_MAX;
    p[e] = -1;
    live[e] = false;
    if (j < N) {
      p[e] = b * N + order[b * N + j];
      live[e] = valid[p[e]] != 0;
      v[e] = sweep_target(az[p[e]], live[e], pi, res) - j;
    }
    if (e > 0) v[e] = min(v[e], v[e - 1]);
  }
  // the minimum over the threads before this one: a warp's inclusive
  // scan by shuffles, then the warps before it
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v[PPT - 1];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(FULL_MASK, incl, d);
    if (lane >= d) incl = min(incl, o);
  }
  int before = __shfl_up_sync(FULL_MASK, incl, 1);
  if (lane == 0) before = INT_MAX;
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) before = min(before, s_warp[w]);
  before = min(before, carry);

#pragma unroll
  for (int e = 0; e < PPT; ++e) {
    const int j = j0 + e;
    if (j >= N) break;
    const int pref = min(before, v[e]);
    int k = min(j + 1, j + pref);
    k = k < 0 ? 0 : (k > CHUNKS - 1 ? CHUNKS - 1 : k);
    if (bins != nullptr) bins[p[e]] = k;
    move_point(points, R_bins, t_trans, b, p[e], k, seq_moves && live[e], out);
  }
}

template <typename T>
int launch_binned(const T* points, const uint8_t* valid, const uint8_t* do_, const T* R_bins,
                  const T* t_trans, int B, int N, double pi, double res, T* out, int* bins,
                  cudaStream_t stream) {
  if (B < 0 || N < 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((N + THREADS - 1) / THREADS, B);
  binned_kernel<T><<<grid, THREADS, 0, stream>>>(points, valid, do_, R_bins, t_trans, N,
                                                 static_cast<T>(pi), static_cast<T>(res), out,
                                                 bins);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_reference(const T* points, const uint8_t* valid, const uint8_t* do_,
                     const T* R_bins, const T* t_trans, const T* az, const long long* order,
                     int B, int N, double pi, double res, int* tile_min, T* out, int* bins,
                     cudaStream_t stream) {
  if (B < 0 || N < 0 || B > 65535 || N >= (1 << 24))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((N + TILE - 1) / TILE, B);
  const T pi_t = static_cast<T>(pi), res_t = static_cast<T>(res);
  tile_min_kernel<T><<<grid, THREADS, 0, stream>>>(az, valid, order, N, pi_t, res_t, tile_min);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reference_kernel<T><<<grid, THREADS, 0, stream>>>(points, valid, do_, R_bins, t_trans, az,
                                                    order, N, pi_t, res_t, tile_min, out, bins);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain C interface for ctypes. Binned: (points (B, N, 3), valid (B, N)
// bool, do (B,) bool, R_bins (B, 1024, 3, 3), t_trans (B, 1024, 3), B, N,
// pi, res, out (B, N, 3), bins (B, N) int32 or NULL, stream). Reference:
// the same with az (B, N) and order (B, N) int64 after t_trans and the
// tile minima (B, ceil(N / 1024)) int32 before out. Every tensor
// contiguous. Returns the CUDA error code of the launches (0 = success).
int deskew_binned_f32(const float* points, const uint8_t* valid, const uint8_t* do_,
                      const float* R_bins, const float* t_trans, int B, int N, double pi,
                      double res, float* out, int* bins, void* stream) {
  return launch_binned<float>(points, valid, do_, R_bins, t_trans, B, N, pi, res, out, bins,
                              static_cast<cudaStream_t>(stream));
}

int deskew_binned_f64(const double* points, const uint8_t* valid, const uint8_t* do_,
                      const double* R_bins, const double* t_trans, int B, int N, double pi,
                      double res, double* out, int* bins, void* stream) {
  return launch_binned<double>(points, valid, do_, R_bins, t_trans, B, N, pi, res, out, bins,
                               static_cast<cudaStream_t>(stream));
}

int deskew_reference_f32(const float* points, const uint8_t* valid, const uint8_t* do_,
                         const float* R_bins, const float* t_trans, const float* az,
                         const long long* order, int B, int N, double pi, double res,
                         int* tile_min, float* out, int* bins, void* stream) {
  return launch_reference<float>(points, valid, do_, R_bins, t_trans, az, order, B, N, pi, res,
                                 tile_min, out, bins, static_cast<cudaStream_t>(stream));
}

int deskew_reference_f64(const double* points, const uint8_t* valid, const uint8_t* do_,
                         const double* R_bins, const double* t_trans, const double* az,
                         const long long* order, int B, int N, double pi, double res,
                         int* tile_min, double* out, int* bins, void* stream) {
  return launch_reference<double>(points, valid, do_, R_bins, t_trans, az, order, B, N, pi,
                                  res, tile_min, out, bins, static_cast<cudaStream_t>(stream));
}

const char* madicp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
