// The step's tail (K14 `tail`) in its one-block design, kept for the probe
// only: madicp_tpu_torch/probes/kernel_variants.py builds it and the two
// cut variants of it (the counts alone, the chain alone), and
// madicp_tpu_torch/probes/kernel_trace.py times them against the package's
// kernel (kernels/csrc/step_scalars.cu) on the same inputs.
//
// Design: one block of 256 threads a sequence. Warps 1, 2 and 3 take the
// velocity estimate and the trajectory, the LU of H and the window's
// poses, while warps 0 and 4-7 (160 threads) count the matched and valid
// flags with 16-byte loads in a strided loop (two loads a trip); after one
// barrier warp 0 forms the frame window, the argmin and the bookkeeping.
// Every output is a fresh tensor. The arithmetic is the package kernel's
// (the same _rn intrinsics in the same order), so both give the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cstring>

#include "arith.cuh"
#include "lie.cuh"
#include "lu6.cuh"

namespace {

using madicp::Arith;
using madicp::Trig;

constexpr int TAIL_THREADS = 256;
constexpr int TAIL_WARPS = TAIL_THREADS / 32;
constexpr int COUNT_THREADS = TAIL_THREADS - 3 * 32;  // warps 0 and 4-7
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr double E_THRESHOLD_VEL = 0.3162;  // ops/constants.py

// the tail's operands: B sequences; bools are one byte each
template <typename T>
struct TailIn {
  const T* X;             // (B, 4, 4) the pose the rounds ended on
  const T* H;             // (B, 6, 6) the last round's normal matrix
  const uint8_t* matched; // (B, L)
  const uint8_t* valid;   // (B, L)
  const T* hz;            // () the sensor rate
  const T* velocity;      // (B, 6)
  const T* traj;          // (B, W, 4, 4)
  const int* traj_count;  // (B,)
  const uint8_t* fr_valid;  // (B, F)
  const T* fr_weight;     // (B, F)
  const int* fr_seq;      // (B, F)
  const T* fr_pose;       // (B, F, 4, 4)
  const int* fr_head;     // (B,)
  const uint8_t* kf_valid;  // (B, K_l)
  const int* kf_head;     // (B,)
  const T* kf_pose;       // (B, 4, 4) keyframe_to_map
  const int* seq;         // (B,)
  const int* seq_kf;      // (B,) seq_keyframe
};
constexpr int TAIL_INPUTS = 18;

template <typename T>
struct TailOut {
  T* velocity;            // (B, 6)
  T* traj;                // (B, W, 4, 4)
  int* traj_count;        // (B,)
  T* ratio;               // (B,)
  long long* n_leaves;    // (B,)
  uint8_t* promote;       // (B,)
  uint8_t* fr_valid;      // (B, F)
  T* fr_weight;           // (B, F)
  int* fr_seq;            // (B, F)
  T* fr_pose;             // (B, F, 4, 4)
  int* fr_head;           // (B,)
  uint8_t* kf_valid;      // (B, K_l)
  int* kf_head;           // (B,)
  T* kf_pose;             // (B, 4, 4)
  int* seq_kf;            // (B,)
  int* seq;               // (B,)
  int* plan;              // (B, 4): head, best, slot (clamped), write
};
constexpr int TAIL_OUTPUTS = 17;

struct TailDims {
  int L, W, F, K_l, K, kf_offset;
};
constexpr int TAIL_DIMS = 6;

// (a, ia) before (b, ib) in torch.argmin's order: a NaN first, then the
// smaller value, then the lower index
template <typename T>
__device__ __forceinline__ bool before(T a, int ia, T b, int ib) {
  if (isnan(a)) return !isnan(b) || ia < ib;
  if (isnan(b)) return false;
  return a < b || (a == b && ia < ib);
}

template <typename T>
__global__ void __launch_bounds__(TAIL_THREADS)
    tail_kernel(const TailIn<T> in, const TailOut<T> out, const TailDims d, const T p_th) {
  using A = Arith<T>;
  __shared__ int s_count[TAIL_WARPS][2];
  __shared__ T s_nld;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = d.W, F = d.F;
  const T* X = in.X + b * 16;

  if (warp == 1) {
    // phase: velocity
    // lane w: the pair of the new trajectory's slot w (the old slot w + 1)
    // with X, for w < W - 1
    const T hz = in.hz[0];
    const T ts = A::div(T(1), hz);
    const int count = in.traj_count[b] + 1;
    const T n = static_cast<T>(count < W ? count : W);
    const int w = lane < W - 1 ? lane : 0;
    const T* P = in.traj + (static_cast<long long>(b) * W + w + 1) * 16;
    T R[3][3], t[3];
    madicp::relative_pose(P, X, R, t);
    T r02 = R[0][2];
    r02 = r02 < T(-1) ? T(-1) : (r02 > T(1) ? T(1) : r02);
    const T eul[3] = {Trig<T>::atan2(-R[1][2], R[2][2]), Trig<T>::asin(r02),
                      Trig<T>::atan2(-R[0][1], R[0][0])};
    const T dt = A::mul(static_cast<T>(W - 1 - w), ts);
    const bool active = static_cast<T>(w) >= A::sub(static_cast<T>(W), n) && n >= T(2);
    const T nm1 = A::sub(n, T(1));
    const T denom = nm1 < T(1) ? T(1) : nm1;
    const T weight = A::sub(T(1), A::div(static_cast<T>(W - 2 - w), denom));
    const T* v0 = in.velocity + b * 6;
    T e[6];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      e[c] = A::sub(A::mul(dt, v0[c]), t[c]);
      e[3 + c] = A::sub(A::mul(dt, v0[3 + c]), eul[c]);
    }
    T chi2 = A::mul(e[0], e[0]);
#pragma unroll
    for (int c = 1; c < 6; ++c) chi2 = A::add(chi2, A::mul(e[c], e[c]));
    const T chi = A::sqrt(chi2);
    const T thr = T(E_THRESHOLD_VEL);
    const T scale = chi > thr ? A::div(thr, chi < T(1e-30) ? T(1e-30) : chi) : T(1);
    const T s = A::mul(A::mul(scale, weight), active ? T(1) : T(0));
    const T sdt = A::mul(s, dt);
    const T hterm = A::mul(sdt, dt);
    T bterm[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) bterm[c] = A::mul(sdt, e[c]);
    // the sums over the pairs, in order
    T h = T(0), bs[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
    for (int q = 0; q < W - 1; ++q) {
      const T hq = __shfl_sync(FULL_MASK, hterm, q);
      h = q == 0 ? hq : A::add(h, hq);
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const T bq = __shfl_sync(FULL_MASK, bterm[c], q);
        bs[c] = q == 0 ? bq : A::add(bs[c], bq);
      }
    }
    if (lane < 6) {
      T bl = bs[0];
#pragma unroll
      for (int c = 1; c < 6; ++c) bl = lane == c ? bs[c] : bl;
      const T hc = h < T(1e-30) ? T(1e-30) : h;
      const T dx = h > T(0) ? A::div(-bl, hc) : T(0);
      out.velocity[b * 6 + lane] = A::add(v0[lane], dx);
    }
    // the trajectory: the old slots 1 .. W-1, then X
    const long long base = static_cast<long long>(b) * W * 16;
    for (int i = lane; i < W * 16; i += 32) {
      out.traj[base + i] = i < (W - 1) * 16 ? in.traj[base + 16 + i] : X[i - (W - 1) * 16];
    }
    if (lane == 0) out.traj_count[b] = count;
  } else if (warp == 2) {
    // phase: logdet
    const int row = lane < 6 ? lane : 5;
    T a[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) a[j] = in.H[b * 36 + row * 6 + j];
    T r = T(0);
    unsigned order;
    int pos, swaps;
    T ru, u;
    madicp::lu6(a, r, lane, order, pos, ru, u, swaps);
    int negative = swaps;
    bool bad = false;
    T sum = T(0);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const T uk = __shfl_sync(FULL_MASK, u, madicp::lane_at(order, k));
      negative += uk < T(0);
      bad = bad || !(uk < T(0) || uk > T(0));
      const T l = Trig<T>::log(fabs(uk));
      sum = k == 0 ? l : A::add(sum, l);
    }
    if (lane == 0) s_nld = !bad && negative % 2 == 0 ? -sum : Arith<T>::max_value();
  } else if (warp == 3) {
    // phase: window poses
    const int head = in.fr_head[b];
    const long long base = static_cast<long long>(b) * F * 16;
    for (int i = lane; i < F * 16; i += 32) {
      out.fr_pose[base + i] = (i >> 4) == head ? X[i & 15] : in.fr_pose[base + i];
    }
  } else {
    // phase: counts
    const int ct = warp == 0 ? lane : lane + 32 * (warp - 3);
    const uint8_t* m = in.matched + static_cast<long long>(b) * d.L;
    const uint8_t* v = in.valid + static_cast<long long>(b) * d.L;
    int nv = 0, nm = 0, done = 0;
    if (((reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v)) & 15) == 0) {
      const uint4* m4 = reinterpret_cast<const uint4*>(m);
      const uint4* v4 = reinterpret_cast<const uint4*>(v);
      const int n16 = d.L >> 4;
      for (int i = ct; i < n16; i += COUNT_THREADS) {
        const uint4 mm = m4[i], vv = v4[i];  // a byte a flag, 0 or 1
        nv += __popc(vv.x) + __popc(vv.y) + __popc(vv.z) + __popc(vv.w);
        nm += __popc(mm.x & vv.x) + __popc(mm.y & vv.y) + __popc(mm.z & vv.z) +
              __popc(mm.w & vv.w);
      }
      done = n16 << 4;
    }
    for (int i = done + ct; i < d.L; i += COUNT_THREADS) {
      nv += v[i] != 0;
      nm += (m[i] != 0) & (v[i] != 0);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      nv += __shfl_xor_sync(FULL_MASK, nv, o);
      nm += __shfl_xor_sync(FULL_MASK, nm, o);
    }
    if (lane == 0) {
      s_count[warp][0] = nv;
      s_count[warp][1] = nm;
    }
  }
  if (warp >= 1 && warp <= 3 && lane == 0) s_count[warp][0] = s_count[warp][1] = 0;
  __syncthreads();
  if (warp != 0) return;

  // phase: window
  int nv = 0, nm = 0;
#pragma unroll
  for (int k = 0; k < TAIL_WARPS; ++k) {
    nv += s_count[k][0];
    nm += s_count[k][1];
  }
  const T ratio = A::div(static_cast<T>(nm), static_cast<T>(nv > 1 ? nv : 1));
  const bool promote = ratio < p_th;
  const int head = in.fr_head[b], seq = in.seq[b];
  const bool here = lane < F;
  const int f = here ? b * F + lane : 0;
  const bool fv = here && (in.fr_valid[f] != 0 || lane == head);
  const T fw = lane == head ? s_nld : here ? in.fr_weight[f] : T(0);
  const int fs = lane == head ? seq : here ? in.fr_seq[f] : 0;
  // argmin of the valid weights (inf elsewhere; lanes past F never win)
  T key = fv ? fw : T(INFINITY);
  int idx = lane;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T k2 = __shfl_xor_sync(FULL_MASK, key, o);
    const int i2 = __shfl_xor_sync(FULL_MASK, idx, o);
    if (before(k2, i2, key, idx)) {
      key = k2;
      idx = i2;
    }
  }
  const int best = idx;
  const int best_seq = __shfl_sync(FULL_MASK, fs, best);
  if (here) {
    out.fr_valid[f] = promote ? fv && fs > best_seq : fv;
    out.fr_weight[f] = fw;
    out.fr_seq[f] = fs;
  }
  const int kf_head = in.kf_head[b];
  const int slot = kf_head - d.kf_offset;
  const bool write = promote && slot >= 0 && slot < d.K_l;
  for (int k = lane; k < d.K_l; k += 32) {
    const long long i = static_cast<long long>(b) * d.K_l + k;
    out.kf_valid[i] = in.kf_valid[i] != 0 || (write && k == slot);
  }
  if (lane < 16) {
    const T* from = best == head ? X : in.fr_pose + (static_cast<long long>(b) * F + best) * 16;
    out.kf_pose[b * 16 + lane] = promote ? from[lane] : in.kf_pose[b * 16 + lane];
  }
  if (lane == 0) {
    out.ratio[b] = ratio;
    out.n_leaves[b] = nv;
    out.promote[b] = promote;
    out.fr_head[b] = (head + 1) % F;
    out.kf_head[b] = promote ? (kf_head + 1) % d.K : kf_head;
    out.seq_kf[b] = promote ? best_seq : in.seq_kf[b];
    out.seq[b] = seq + 1;
    int* plan = out.plan + b * 4;
    plan[0] = head;
    plan[1] = best;
    plan[2] = slot < 0 ? 0 : slot >= d.K_l ? d.K_l - 1 : slot;
    plan[3] = write;
  }
  // phase: end
}

template <typename T>
int tail(void* const* ins, void* const* outs, const int* dims, double p_th, int n,
         cudaStream_t stream) {
  TailIn<T> in;
  TailOut<T> out;
  TailDims d;
  static_assert(sizeof(in) == TAIL_INPUTS * sizeof(void*), "TailIn holds pointers only");
  static_assert(sizeof(out) == TAIL_OUTPUTS * sizeof(void*), "TailOut holds pointers only");
  static_assert(sizeof(d) == TAIL_DIMS * sizeof(int), "TailDims holds ints only");
  memcpy(&in, ins, sizeof(in));
  memcpy(&out, outs, sizeof(out));
  memcpy(&d, dims, sizeof(d));
  if (n < 0 || d.L < 0 || d.W < 2 || d.W > 33 || d.F < 1 || d.F > 32 || d.K_l < 1 || d.K < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  tail_kernel<T><<<n, TAIL_THREADS, 0, stream>>>(in, out, d, static_cast<T>(p_th));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain C interface for ctypes. tail: (ins, outs: host arrays of the device
// pointers of TailIn and TailOut in their order, dims: host array of
// TailDims (L, W, F, K_l, K, kf_offset), p_th, n = B, stream); every
// tensor contiguous, bools one byte each. Each returns the CUDA error
// code of its launch (0 = success).
int tail_f32(void* const* ins, void* const* outs, const int* dims, double p_th, int n,
             void* stream) {
  return tail<float>(ins, outs, dims, p_th, n, static_cast<cudaStream_t>(stream));
}

int tail_f64(void* const* ins, void* const* outs, const int* dims, double p_th, int n,
             void* stream) {
  return tail<double>(ins, outs, dims, p_th, n, static_cast<cudaStream_t>(stream));
}

const char* madicp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
