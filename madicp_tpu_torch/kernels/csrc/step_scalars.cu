// The step's scalars (K14), for Hopper (sm_90a): the constant-velocity
// prediction before the Gauss-Newton rounds and the bookkeeping after
// them, for a batch of B sequences, each one launch a step.
//
//   predict  X0 = X [exp_so3(w / hz) | t / hz] for the velocity v = [t, w]
//            (MAD-ICP's split increment, pipeline.cpp:146-152);
//   tail     from the new pose X, the last round's H and matched flags,
//            the scan's leaf mask and the state (pipeline.cpp:197-262):
//            the counts of valid and of matched-and-valid leaves (as
//            integers: exact in any order), n_leaves, the inlier ratio
//            and promote = ratio < p_th; the trajectory shifted by X and
//            its count; the velocity estimate (vel_estimator.cpp:81-97:
//            nine pose pairs, each T_prev^-1 X, its residual, robust
//            clamp and weight, then sums over the pairs in order); -log
//            det H by an LU (lu6.cuh), the dtype's max where det H <= 0;
//            the frame record's weight, seq, pose, valid and head; the
//            best frame (argmin over the valid weights: the lowest index
//            wins a tie, a NaN wins as torch.argmin has it, 0 where every
//            weight is inf); the keyframe slot (the ring head less
//            kf_offset, written only where this process holds it), the
//            ring's valid flags and head, the dropped window frames, the
//            keyframe pose and seq, seq + 1; and `plan` (head, best, slot,
//            write) for K13 (ring_write.cu), which moves the trees.
//
// Every value is formed with _rn intrinsics in the plain version's order
// (kernels/step_scalars.py `predict_plain`, `tail_plain`: ops/lie.py
// `exp_se3_split` and `se3_compose`, models/vel_estimator.py
// `estimate_velocity`, ops/icp_core.py `neg_logdet`, all written one
// operation at a time on per-component tensors): divisions by hz and
// 1 / hz are IEEE divisions by the value on the device (the plain
// version divides by a 0-dim tensor), p_th is compared in the working
// type, and sin, atan2, asin and log are the CUDA math library's (no
// fast math), which torch's CUDA ops call. So each kernel equals its
// plain version bit for bit.
//
// It is the counterpart of madicp_tpu_torch/models/pipeline.py
// `_odometry_step`'s prediction and tail, which port the JAX package's
// madicp_tpu/models/pipeline.py:723 (madicp_tpu/ops/lie.py:147
// `exp_se3_split`) and :736-792 without the tree copies,
// madicp_tpu/models/vel_estimator.py:21 `estimate_velocity` and
// madicp_tpu/ops/icp_core.py:262 `neg_logdet`; XLA lowered those, so no
// Pallas kernel stands behind them.
//
// Bound on an H100: a sequence's tail reads 2 L bytes of flags (64 KB at
// the flagship's 32768 leaves) and ~2 KB of state and writes ~1.5 KB:
// ~20 ns at 3.35 TB/s; a few thousand operations. What limits both is the
// launch (~1.1 us in a CUDA graph) and the tail's dependent steps: the
// flags' round trips to memory, the LU, the transcendental functions of
// the pairs, the ordered sums, then the argmin.
//
// Design. predict: one warp a sequence; every lane forms the increment
// (six divisions, exp_so3), lanes 0-15 an entry of the product each.
// tail: one block of 256 threads a sequence, its warps on separate
// work. Warp 1: the velocity estimate and the trajectory (the nine pairs'
// three Euler angles on three groups of lanes, the ordered sums over the
// pairs through shared memory, one lane a sum). Warp 2: the LU of H and
// its logs (a lane a pivot's). Warp 3: the window's poses (into shared
// memory too). Warps 4-7: the flag counts; each thread loads COUNT_VEC
// 16-byte words of each row before it uses any, so one round trip to
// memory brings the flagship's rows (a byte a flag: popc of the words;
// rows that are not 16-byte aligned, and the last L % 16 flags, a byte at
// a time). Warp 0 loads the window's scalars at once, forms the argmin
// (lane f frame f, by shuffles) as soon as warp 2 has -log det (a named
// barrier of the two), then the ratio and the rest as soon as the counts
// and the poses are in shared memory (a named barrier with warps 3-7),
// with no round trip to memory after its loads, beside the velocity warp:
// the window needs nothing that warp forms. (A cluster of blocks a
// sequence, with the counts spread over it and met through distributed
// shared memory, was slower on the H100: its barriers cost more than the
// counts they spread.)
//
// The state's fields go to the destinations the wrapper hands over: fresh
// tensors, or the state's own tensors (the step's in-place form: then
// also X into the state's pose). In place, every field is read before it
// is overwritten: the velocity warp reads the trajectory's slots, the old
// velocity and the count into registers, then a warp barrier, then
// writes; the frame record writes only the head slot of the window's
// poses (a fresh destination takes the other slots too), and the
// keyframe pose comes from the copy in shared memory; warp 0's lanes
// read the heads, seq and their frame before its barriers, lane 0 writes
// seq after a warp barrier and the window's head (which warp 3 reads too)
// after the barrier with warp 3. No workspace: a CUDA graph's replay
// equals the eager call bit for bit.

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

constexpr int PREDICT_WARPS = 4;  // sequences a block
constexpr int TAIL_THREADS = 256;
constexpr int TAIL_WARPS = TAIL_THREADS / 32;
constexpr int COUNT_THREADS = TAIL_THREADS - 4 * 32;  // warps 4-7 count the flags
constexpr int COUNT_VEC = 16;     // 16-byte words of each flag row a thread loads at once
// named barriers of warp 0 (the window) with the warps it waits for
constexpr int LOGDET_BARRIER = 1;  // warp 2: -log det
constexpr int LOGDET_THREADS = 64;
constexpr int COUNTS_BARRIER = 2;  // warps 3-7: the window's poses and the counts
constexpr int COUNTS_THREADS = 6 * 32;
constexpr int MAX_FRAMES = 32;    // window frames: a frame a lane
constexpr int MAX_WINDOW = 33;    // trajectory poses: a pose pair a lane
constexpr int MAX_SHIFT = (MAX_WINDOW * 16 + 31) / 32;  // trajectory values a lane moves
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr double E_THRESHOLD_VEL = 0.3162;  // ops/constants.py

template <typename T>
__global__ void __launch_bounds__(32 * PREDICT_WARPS)
    predict_kernel(const T* __restrict__ X, const T* __restrict__ v, const T* __restrict__ hz,
                   int n, T* __restrict__ out) {
  using A = Arith<T>;
  const int lane = threadIdx.x & 31;
  const long long s = static_cast<long long>(blockIdx.x) * PREDICT_WARPS + (threadIdx.x >> 5);
  if (s >= n) return;  // a whole warp
  const T h = hz[0];
  T d[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) d[c] = A::div(v[s * 6 + c], h);
  T R[9];
  madicp::exp_so3(d[3], d[4], d[5], R);
  if (lane < 16) {
    const int j = lane & 3;
    const T* xr = X + s * 16 + (lane >> 2) * 4;
    const T c0 = j == 3 ? d[0] : R[j];
    const T c1 = j == 3 ? d[1] : R[3 + j];
    const T c2 = j == 3 ? d[2] : R[6 + j];
    out[s * 16 + lane] = madicp::se3_entry(xr[0], xr[1], xr[2], xr[3], c0, c1, c2, j == 3);
  }
}

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

// the destinations: the new state's fields (each a fresh tensor or the
// state's own: the same pointer as in TailIn), then the step's outputs
template <typename T>
struct TailOut {
  T* X;                   // (B, 4, 4) the state's pose; null: not written
  T* velocity;            // (B, 6)
  T* traj;                // (B, W, 4, 4)
  int* traj_count;        // (B,)
  uint8_t* fr_valid;      // (B, F)
  T* fr_weight;           // (B, F)
  int* fr_seq;            // (B, F)
  T* fr_pose;             // (B, F, 4, 4)
  int* fr_head;           // (B,)
  uint8_t* kf_valid;      // (B, K_l)
  int* kf_head;           // (B,)
  T* kf_pose;             // (B, 4, 4)
  int* seq;               // (B,)
  int* seq_kf;            // (B,)
  T* ratio;               // (B,)
  long long* n_leaves;    // (B,)
  uint8_t* promote;       // (B,)
  int* plan;              // (B, 4): head, best, slot (clamped), write
};
constexpr int TAIL_OUTPUTS = 18;

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

__device__ __forceinline__ void count_words(const uint4& mm, const uint4& vv, int& nv, int& nm) {
  nv += __popc(vv.x) + __popc(vv.y) + __popc(vv.z) + __popc(vv.w);  // a byte a flag, 0 or 1
  nm += __popc(mm.x & vv.x) + __popc(mm.y & vv.y) + __popc(mm.z & vv.z) + __popc(mm.w & vv.w);
}

template <typename T>
__global__ void __launch_bounds__(TAIL_THREADS)
    tail_kernel(const TailIn<T> in, const TailOut<T> out, const TailDims d, const T p_th) {
  using A = Arith<T>;
  __shared__ int s_count[TAIL_WARPS][2];
  __shared__ T s_nld;
  __shared__ T s_pose[MAX_FRAMES][16];  // the window's poses, the record's at its head
  __shared__ T s_terms[7][MAX_WINDOW - 1];  // the velocity's terms by pair
  const int b = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int W = d.W, F = d.F;
  const T* X = in.X + b * 16;

  // phase: loads
  // the count threads: warps 4-7 (g of COUNT_THREADS); thread g takes the
  // 16-byte words g, g + COUNT_THREADS, ... of both rows where both are
  // 16-byte aligned, and the bytes past them alike. Each loads COUNT_VEC
  // words of each row before it uses any (a word past the row reads the
  // row's last one and is not counted), so no instruction waits on them
  // here.
  const bool counts = warp >= 4;
  const int g = t - (TAIL_THREADS - COUNT_THREADS);
  const uint8_t* m = in.matched + static_cast<long long>(b) * d.L;
  const uint8_t* v = in.valid + static_cast<long long>(b) * d.L;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const int n16 = aligned ? d.L >> 4 : 0;
  const uint4* m4 = reinterpret_cast<const uint4*>(m);
  const uint4* v4 = reinterpret_cast<const uint4*>(v);
  uint4 mw[COUNT_VEC], vw[COUNT_VEC];
  int word = g;  // the first word of the thread's batch
  if (counts && word < n16) {
#pragma unroll
    for (int k = 0; k < COUNT_VEC; ++k) {
      const int i = min(word + k * COUNT_THREADS, n16 - 1);
      mw[k] = m4[i];
      vw[k] = v4[i];
    }
  }
  // warp 0 loads what the window needs now, so that no round trip to
  // memory follows its barriers (lane f frame f)
  const bool here = lane < F;
  const int f = b * F + (here ? lane : 0);
  int head = 0, seq = 0, kf_head = 0, seq_kf = 0, fs = 0;
  bool fv = false;
  T fw = T(0), kf_pose = T(0);
  if (warp == 0) {
    // phase: prefetch
    head = in.fr_head[b];
    seq = in.seq[b];
    kf_head = in.kf_head[b];
    seq_kf = in.seq_kf[b];
    if (here) {
      fv = in.fr_valid[f] != 0;
      fw = in.fr_weight[f];
      fs = in.fr_seq[f];
    }
    if (lane < 16) kf_pose = in.kf_pose[b * 16 + lane];
  }

  if (warp == 1) {
    // phase: velocity
    // lane w: the pair of the new trajectory's slot w (the old slot w + 1)
    // with X, for w < P = W - 1; every read before the warp barrier below.
    // Where three groups of P lanes fit in the warp, group k forms the
    // k-th Euler angle of its lane's pair (lane w + k P holds pair w), so
    // a lane runs one of the three functions, not all three.
    const int P = W - 1;
    const bool split = 3 * P <= 32;
    const T hz = in.hz[0];
    const T ts = A::div(T(1), hz);
    const int count = in.traj_count[b] + 1;
    const T n = static_cast<T>(count < W ? count : W);
    const int grp = split ? lane / P : 0;  // 3 and above: no group
    const int w = lane < P ? lane : split && grp < 3 ? lane - grp * P : 0;
    const long long tb = static_cast<long long>(b) * W * 16;
    T R[3][3], tt[3];
    madicp::relative_pose(in.traj + tb + (w + 1) * 16, X, R, tt);
    T shift[MAX_SHIFT];  // the new trajectory's values i = lane + 32 j
#pragma unroll
    for (int j = 0; j < MAX_SHIFT; ++j) {
      const int i = lane + 32 * j;
      shift[j] = i < (W - 1) * 16 ? in.traj[tb + 16 + i] : i < W * 16 ? X[i - (W - 1) * 16] : T(0);
    }
    T v0[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) v0[c] = in.velocity[b * 6 + c];
    T r02 = R[0][2];
    r02 = r02 < T(-1) ? T(-1) : (r02 > T(1) ? T(1) : r02);
    T eul[3];
    if (split) {
      // groups 0 and 2 the two atan2s, group 1 the asin
      T a;
      if (grp == 1) {
        a = Trig<T>::asin(r02);
      } else {
        a = Trig<T>::atan2(grp == 0 ? -R[1][2] : -R[0][1], grp == 0 ? R[2][2] : R[0][0]);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) eul[k] = __shfl_sync(FULL_MASK, a, w + k * P);
    } else {
      eul[0] = Trig<T>::atan2(-R[1][2], R[2][2]);
      eul[1] = Trig<T>::asin(r02);
      eul[2] = Trig<T>::atan2(-R[0][1], R[0][0]);
    }
    // phase: pairs
    const T dt = A::mul(static_cast<T>(W - 1 - w), ts);
    const bool active = static_cast<T>(w) >= A::sub(static_cast<T>(W), n) && n >= T(2);
    const T nm1 = A::sub(n, T(1));
    const T denom = nm1 < T(1) ? T(1) : nm1;
    const T weight = A::sub(T(1), A::div(static_cast<T>(W - 2 - w), denom));
    T e[6];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      e[c] = A::sub(A::mul(dt, v0[c]), tt[c]);
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
    // the sums over the pairs, in order: lane k sums term k (h, then the
    // six of b) over the pairs from shared memory
    if (lane < P) {
      s_terms[0][lane] = A::mul(sdt, dt);
#pragma unroll
      for (int c = 0; c < 6; ++c) s_terms[1 + c][lane] = A::mul(sdt, e[c]);
    }
    __syncwarp();
    // phase: sums
    T sum = T(0);
    if (lane < 7) {  // every term loaded before the first add
      T term[MAX_WINDOW - 1];
#pragma unroll
      for (int q = 0; q < MAX_WINDOW - 1; ++q) term[q] = q < P ? s_terms[lane][q] : T(0);
      sum = term[0];
#pragma unroll
      for (int q = 1; q < MAX_WINDOW - 1; ++q) sum = q < P ? A::add(sum, term[q]) : sum;
    }
    const T h = __shfl_sync(FULL_MASK, sum, 0);
    const T bl = __shfl_sync(FULL_MASK, sum, lane < 6 ? lane + 1 : 0);
    __syncwarp();  // every lane has read what the writes below overwrite
    if (lane < 6) {
      T vl = v0[0];
#pragma unroll
      for (int c = 1; c < 6; ++c) vl = lane == c ? v0[c] : vl;
      const T hc = h < T(1e-30) ? T(1e-30) : h;
      const T dx = h > T(0) ? A::div(-bl, hc) : T(0);
      out.velocity[b * 6 + lane] = A::add(vl, dx);
    }
    // the trajectory: the old slots 1 .. W-1, then X
#pragma unroll
    for (int j = 0; j < MAX_SHIFT; ++j) {
      const int i = lane + 32 * j;
      if (i < W * 16) out.traj[tb + i] = shift[j];
    }
    if (lane == 0) out.traj_count[b] = count;
    // phase: velocity_end
    return;  // nothing after this needs the velocity warp
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
    // lane i the log of its row's pivot; then the six in pivot order
    const T lu = Trig<T>::log(fabs(u));
    int negative = swaps;
    bool bad = false;
    T sum = T(0);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const int at = madicp::lane_at(order, k);
      const T uk = __shfl_sync(FULL_MASK, u, at);
      const T l = __shfl_sync(FULL_MASK, lu, at);
      negative += uk < T(0);
      bad = bad || !(uk < T(0) || uk > T(0));
      sum = k == 0 ? l : A::add(sum, l);
    }
    if (lane == 0) s_nld = !bad && negative % 2 == 0 ? -sum : Arith<T>::max_value();
    // phase: logdet_end
    asm volatile("bar.sync %0, %1;" ::"n"(LOGDET_BARRIER), "n"(LOGDET_THREADS) : "memory");
    return;
  } else if (warp == 3) {
    // phase: poses
    // the window's poses with the frame record's at the head, into shared
    // memory for the keyframe pose and into the destination (only the
    // head slot where it is the state's own), and X into the state's pose
    const int at = in.fr_head[b];
    const long long fb = static_cast<long long>(b) * F * 16;
    const bool fresh = out.fr_pose != in.fr_pose;
    for (int i = lane; i < F * 16; i += 32) {
      const T p = (i >> 4) == at ? X[i & 15] : in.fr_pose[fb + i];
      s_pose[i >> 4][i & 15] = p;
      if (fresh || (i >> 4) == at) out.fr_pose[fb + i] = p;
    }
    if (out.X != nullptr && lane < 16) out.X[b * 16 + lane] = X[lane];
    // phase: poses_end
    asm volatile("bar.sync %0, %1;" ::"n"(COUNTS_BARRIER), "n"(COUNTS_THREADS) : "memory");
    return;
  } else if (counts) {
    // phase: counts
    int nv = 0, nm = 0;
    while (word < n16) {
#pragma unroll
      for (int k = 0; k < COUNT_VEC; ++k) {
        if (word + k * COUNT_THREADS < n16) count_words(mw[k], vw[k], nv, nm);
      }
      word += COUNT_VEC * COUNT_THREADS;
      if (word < n16) {
#pragma unroll
        for (int k = 0; k < COUNT_VEC; ++k) {
          const int i = min(word + k * COUNT_THREADS, n16 - 1);
          mw[k] = m4[i];
          vw[k] = v4[i];
        }
      }
    }
    for (int i = (n16 << 4) + g; i < d.L; i += COUNT_THREADS) {
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
    asm volatile("bar.sync %0, %1;" ::"n"(COUNTS_BARRIER), "n"(COUNTS_THREADS) : "memory");
    return;
  }

  // phase: window
  // warp 0: the frame window (lane f frame f) once -log det is formed
  asm volatile("bar.sync %0, %1;" ::"n"(LOGDET_BARRIER), "n"(LOGDET_THREADS) : "memory");
  fv = here && (fv || lane == head);  // the frame record at the head
  fw = lane == head ? s_nld : fw;
  fs = lane == head ? seq : fs;
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
  const int slot = kf_head - d.kf_offset;
  // phase: argmin
  // what needs no count now (and no field another warp reads: warp 3
  // reads the window's head, written after the barrier below)
  if (here) {
    out.fr_weight[f] = fw;
    out.fr_seq[f] = fs;
  }
  __syncwarp();  // every lane has read seq
  if (lane == 0) {
    out.seq[b] = seq + 1;
    int* plan = out.plan + b * 4;
    plan[0] = head;
    plan[1] = best;
    plan[2] = slot < 0 ? 0 : slot >= d.K_l ? d.K_l - 1 : slot;
  }
  // then the counts (integers: exact in any order) and the window's poses
  asm volatile("bar.sync %0, %1;" ::"n"(COUNTS_BARRIER), "n"(COUNTS_THREADS) : "memory");
  int nv = 0, nm = 0;
  if (lane >= 4 && lane < TAIL_WARPS) {  // the count warps'
    nv = s_count[lane][0];
    nm = s_count[lane][1];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    nv += __shfl_xor_sync(FULL_MASK, nv, o);
    nm += __shfl_xor_sync(FULL_MASK, nm, o);
  }
  // phase: ratio
  const T ratio = A::div(static_cast<T>(nm), static_cast<T>(nv > 1 ? nv : 1));
  const bool promote = ratio < p_th;

  const bool write = promote && slot >= 0 && slot < d.K_l;
  if (here) out.fr_valid[f] = promote ? fv && fs > best_seq : fv;
  if (out.kf_valid != in.kf_valid) {  // a fresh destination: every flag
    for (int k = lane; k < d.K_l; k += 32) {
      const long long i = static_cast<long long>(b) * d.K_l + k;
      out.kf_valid[i] = in.kf_valid[i] != 0 || (write && k == slot);
    }
  } else if (write && lane == 0) {
    out.kf_valid[static_cast<long long>(b) * d.K_l + slot] = 1;
  }
  // the keyframe pose: the window's slot best (the frame record's where
  // best is the head)
  if (lane < 16) out.kf_pose[b * 16 + lane] = promote ? s_pose[best][lane] : kf_pose;
  if (lane == 0) {
    out.ratio[b] = ratio;
    out.n_leaves[b] = nv;
    out.promote[b] = promote;
    out.fr_head[b] = (head + 1) % F;
    out.kf_head[b] = promote ? (kf_head + 1) % d.K : kf_head;
    out.seq_kf[b] = promote ? best_seq : seq_kf;
    out.plan[b * 4 + 3] = write;
  }
  // phase: end
}

template <typename T>
int predict(const T* X, const T* v, const T* hz, int n, T* out, cudaStream_t stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((n + PREDICT_WARPS - 1) / PREDICT_WARPS), block(32 * PREDICT_WARPS);
  predict_kernel<T><<<grid, block, 0, stream>>>(X, v, hz, n, out);
  return static_cast<int>(cudaGetLastError());
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
  if (n < 0 || d.L < 0 || d.W < 2 || d.W > MAX_WINDOW || d.F < 1 || d.F > MAX_FRAMES ||
      d.K_l < 1 || d.K < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  tail_kernel<T><<<n, TAIL_THREADS, 0, stream>>>(in, out, d, static_cast<T>(p_th));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain C interface for ctypes. predict: (X (n, 4, 4), v (n, 6), hz (),
// n, out (n, 4, 4), stream). tail: (ins, outs: host arrays of the device
// pointers of TailIn and TailOut in their order, dims: host array of
// TailDims (L, W, F, K_l, K, kf_offset), p_th, n = B, stream);
// every tensor contiguous, bools one byte each; each destination of the
// new state is a fresh tensor or the state's own (the pointer in ins).
// Each returns the CUDA error code of its launch (0 = success).
int predict_f32(const float* X, const float* v, const float* hz, int n, float* out,
                void* stream) {
  return predict<float>(X, v, hz, n, out, static_cast<cudaStream_t>(stream));
}

int predict_f64(const double* X, const double* v, const double* hz, int n, double* out,
                void* stream) {
  return predict<double>(X, v, hz, n, out, static_cast<cudaStream_t>(stream));
}

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
