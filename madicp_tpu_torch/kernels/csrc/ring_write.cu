// The ring write (K13), for Hopper (sm_90a): the step's frame record and
// keyframe promotion, in place on the rings of a batch of B sequences.
//
//   frame record  the scan's tree nav (B, M, 56) moved by its pose X into
//                 the frame window's slot `head`: every panel [position
//                 (3), direction (3), scalar (2)] of every row (padding
//                 included, as the JAX package's nav @ A + c) becomes
//                 positions ((R_c0 x + R_c1 y) + R_c2 z) + t_c, directions
//                 (R_c0 n_x + R_c1 n_y) + R_c2 n_z, the scalars copied
//                 (reference applyTransform, mad_tree.cpp:165-172);
//   promotion     where `write`, the window's tree `best` copied into the
//                 keyframe ring's slot `slot`; nothing where not.
// `plan` (B, 4) = (head, best, slot, write) comes from K14's tail
// (step_scalars.cu). The positions and directions round one operation at
// a time (_rn) in the plain version's order (ops/tree.py
// `transform_tree`, kernels/ring_write.py `ring_write_plain`), so the
// rings equal the plain version's bit for bit.
//
// It is the counterpart of madicp_tpu_torch/models/pipeline.py
// `_odometry_step`'s frame record and promotion, which port the JAX
// package's madicp_tpu/ops/tree.py:939 `transform_tree`, the frame slot's
// `_set_slot` (madicp_tpu/models/pipeline.py:287, 751) and `do_promote`'s
// tree copy (:768-779, under a lax.cond); XLA lowered those, so no Pallas
// kernel stands behind them.
//
// Bound on an H100: bytes. A float32 flagship tree is 131072 rows x 56 x 4
// B = 29.4 MB: the frame record reads it once and writes it once (58.7
// MB, ~17.5 us at 3.35 TB/s); a promotion writes a tree more and, where
// `best` is not this scan's slot, reads one more (117 MB). Float64
// doubles each. About 18 operations a panel: far below the bytes.
//
// Design: one thread a 16-byte vector of the tree, a grid row a sequence,
// so each warp instruction loads or stores 512 contiguous bytes; a panel
// spans G = 8 / (16 / sizeof(T)) lanes (2 in float32, 4 in float64),
// which exchange its three positions and three directions by shuffles,
// and each lane forms its own vector's outputs. Both parts run in one
// launch: a lane writes its moved vector into the window and, where its
// sequence writes, the same vector into the keyframe slot when best ==
// head (the promoted tree is this scan's: no second read), else it copies
// its vector of the window's tree `best`, which no thread of this launch
// writes. A sequence that does not promote copies no keyframe tree: its
// threads read one flag; one launch beat two (the frame record, then the
// promotion) in every case measured. (One thread a whole panel stored
// each half of a warp's 1 KB in its own instruction: 1.9 TB/s.)

#include <cuda_runtime.h>
#include <stdint.h>

#include "arith.cuh"

namespace {

using madicp::Arith;

constexpr int THREADS = 256;
constexpr int PANEL = 8;  // values a panel: [position(3), direction(3), scalar(2)]
constexpr unsigned FULL_MASK = 0xffffffffu;

// a 16-byte vector of the working type
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using V = float4;
  static constexpr int N = 4;
  static __device__ __forceinline__ float get(const float4& v, int c) {
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
  }
  static __device__ __forceinline__ float4 make(const float o[4]) {
    return make_float4(o[0], o[1], o[2], o[3]);
  }
};
template <>
struct Vec<double> {
  using V = double2;
  static constexpr int N = 2;
  static __device__ __forceinline__ double get(const double2& v, int c) {
    return c == 0 ? v.x : v.y;
  }
  static __device__ __forceinline__ double2 make(const double o[2]) {
    return make_double2(o[0], o[1]);
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ring_write_kernel(const T* __restrict__ nav, const T* __restrict__ X,
                      const int* __restrict__ plan, T* __restrict__ fr, T* __restrict__ kf,
                      long long vectors, int F, int K_l) {
  using A = Arith<T>;
  using V = typename Vec<T>::V;
  constexpr int N = Vec<T>::N;      // values a vector
  constexpr int G = PANEL / N;      // lanes a panel
  const int b = blockIdx.y;
  const int4 pl = reinterpret_cast<const int4*>(plan)[b];  // head, best, slot, write
  const bool write = pl.w != 0;
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const bool in = i < vectors;
  V* win = reinterpret_cast<V*>(fr) + (static_cast<long long>(b) * F + pl.x) * vectors + i;
  V* key = reinterpret_cast<V*>(kf) + (static_cast<long long>(b) * K_l + pl.z) * vectors + i;
  const V* src = reinterpret_cast<const V*>(fr) + (static_cast<long long>(b) * F + pl.y) *
                 vectors + i;
  V v = {};
  if (in) v = reinterpret_cast<const V*>(nav)[static_cast<long long>(b) * vectors + i];
  // the panel's positions and directions from its G lanes (every lane of
  // the warp takes part: a panel's lanes are in or out together)
  const int lane = threadIdx.x & 31, base = lane & ~(G - 1), q = lane - base;
  T pn[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) pn[j] = __shfl_sync(FULL_MASK, Vec<T>::get(v, j % N), base + j / N);
  T x[12];  // rows 0-2 of the pose: [R | t]
#pragma unroll
  for (int j = 0; j < 12; ++j) x[j] = X[b * 16 + j];
  T o[N];
#pragma unroll
  for (int c = 0; c < N; ++c) {
    const int k = q * N + c;  // the value's place in the panel
    const bool pos = k < 3;
    const int r = pos ? k : k < 6 ? k - 3 : 0;  // the row of R (any for a scalar)
    const T a0 = pos ? pn[0] : pn[3], a1 = pos ? pn[1] : pn[4], a2 = pos ? pn[2] : pn[5];
    const T r0 = r == 0 ? x[0] : r == 1 ? x[4] : x[8];
    const T r1 = r == 0 ? x[1] : r == 1 ? x[5] : x[9];
    const T r2 = r == 0 ? x[2] : r == 1 ? x[6] : x[10];
    const T tr = r == 0 ? x[3] : r == 1 ? x[7] : x[11];
    const T m = A::add(A::add(A::mul(r0, a0), A::mul(r1, a1)), A::mul(r2, a2));
    o[c] = pos ? A::add(m, tr) : k < 6 ? m : Vec<T>::get(v, c);
  }
  if (!in) return;
  const V ov = Vec<T>::make(o);
  *win = ov;
  if (write) *key = pl.y == pl.x ? ov : *src;
}

template <typename T>
int launch(const T* nav, const T* X, const int* plan, T* fr, T* kf, int B, long long panels,
           int F, int K_l, cudaStream_t stream) {
  if (B < 0 || B > 65535 || panels < 0 || F < 1 || K_l < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || panels == 0) return static_cast<int>(cudaGetLastError());
  const long long vectors = panels * (PANEL / Vec<T>::N);  // 16-byte vectors a tree
  const long long blocks = (vectors + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), B), block(THREADS);
  ring_write_kernel<T><<<grid, block, 0, stream>>>(nav, X, plan, fr, kf, vectors, F, K_l);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain C interface for ctypes: (nav (B, M, 56), X (B, 4, 4), plan (B, 4)
// int32, fr (B, F, M, 56), kf (B, K_l, M, 56), B, panels = 7 M, F, K_l,
// stream), every tensor contiguous and 16-byte aligned; fr and kf
// are written in place. Returns the CUDA error code of the launch (0 =
// success).
int ring_write_f32(const float* nav, const float* X, const int* plan, float* fr, float* kf,
                   int B, long long panels, int F, int K_l, void* stream) {
  return launch<float>(nav, X, plan, fr, kf, B, panels, F, K_l,
                       static_cast<cudaStream_t>(stream));
}

int ring_write_f64(const double* nav, const double* X, const int* plan, double* fr,
                   double* kf, int B, long long panels, int F, int K_l, void* stream) {
  return launch<double>(nav, X, plan, fr, kf, B, panels, F, K_l,
                        static_cast<cudaStream_t>(stream));
}

const char* madicp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
