// The program's trace on the card (Hopper, sm_90a): one-thread stamps of
// the device clock at the step's phase boundaries, and the step's counts,
// written into a ring of slots that the host reads after the step.
//
// It replaces no TPU kernel: the JAX package has no device-side trace.
// It exists because a captured CUDA graph cannot record CUDA-event pairs
// for the host to read back, while a kernel node can read %globaltimer
// (nanoseconds, one clock for the whole card) on every replay.
//
//   ring    (slots, width) int64: a slot a step, chosen on the device by
//           the ring's own step count `tick` (so a chunk of steps enqueued
//           with no host read keeps every step's slot); columns:
//           [0] the tick of the step, [1] the scan's id (the state's seq
//           of the first sequence after the step: seq + 1), [2 + m] the
//           clock at mark m, then 5 counts a sequence at `off`;
//   cursor  (1,) int32: the slot of the step in flight, set by its first
//           stamp and read by the later ones;
//   tick    (1,) int64: steps begun, advanced by each first stamp.
//
// Bound: a launch. One thread writes a few words; a stamp's cost is the
// node it adds to the graph (~1-2 us of the card's time between
// dependent kernels), not its work. The counts walk a sequence's leaf
// flags once (131,072 bytes at the flagship: well under a microsecond at
// the memory rate), one block a sequence, in 16-byte vectors: a block
// that reads a byte a thread and waits for each load takes tens of
// microseconds for the same row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

__global__ void stamp_kernel(long long* ring, int* cursor, long long* tick, const int* seq,
                             int slots, int width, int mark) {
  const long long t = globaltimer();
  int slot;
  if (seq != nullptr) {  // the step's first stamp
    const long long k = *tick;
    slot = static_cast<int>(k % slots);
    *cursor = slot;
    *tick = k + 1;
    ring[static_cast<long long>(slot) * width] = k;
    ring[static_cast<long long>(slot) * width + 1] = static_cast<long long>(seq[0]) + 1;
  } else {
    slot = *cursor;
  }
  ring[static_cast<long long>(slot) * width + 2 + mark] = t;
}

constexpr int COUNT_THREADS = 1024;
constexpr int COUNT_UNROLL = 8;

// Block b: sequence b's (n_descents, valid keyframes, valid leaves, the
// leaf slots the terms kernels walk a round: K x valid leaves, and the
// slots they hold: K x L). A
// bool is a byte of 0 or 1, so a 16-byte vector of them counts as the
// population of its four words; 16-byte vectors where the row allows,
// each thread with COUNT_UNROLL loads in flight (one block walks a row of
// 131,072 flags in a few microseconds), bytes otherwise.
__global__ void counts_kernel(long long* ring, const int* cursor, int width, int off,
                              const long long* n_descents, const bool* kf_valid, int K,
                              const bool* leaves_valid, long long L) {
  const int b = blockIdx.x;
  const unsigned char* lv = reinterpret_cast<const unsigned char*>(leaves_valid) + b * L;
  long long n = 0;
  if (reinterpret_cast<uintptr_t>(lv) % 16 == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(lv);
    const long long nv = L / 16;
    for (long long i = threadIdx.x; i < nv; i += COUNT_THREADS * COUNT_UNROLL) {
      uint4 w[COUNT_UNROLL];
#pragma unroll
      for (int u = 0; u < COUNT_UNROLL; ++u) {
        const long long j = i + static_cast<long long>(u) * COUNT_THREADS;
        w[u] = j < nv ? v[j] : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < COUNT_UNROLL; ++u)
        n += __popc(w[u].x) + __popc(w[u].y) + __popc(w[u].z) + __popc(w[u].w);
    }
    for (long long i = nv * 16 + threadIdx.x; i < L; i += COUNT_THREADS) n += lv[i] != 0;
  } else {
    for (long long i = threadIdx.x; i < L; i += COUNT_THREADS) n += lv[i] != 0;
  }
  __shared__ long long part[COUNT_THREADS];
  part[threadIdx.x] = n;
  __syncthreads();
  for (int s = COUNT_THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) part[threadIdx.x] += part[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    int kv = 0;
    for (int k = 0; k < K; ++k) kv += kf_valid[b * K + k] ? 1 : 0;
    long long* row = ring + static_cast<long long>(*cursor) * width + off + 5 * b;
    row[0] = n_descents[b];
    row[1] = kv;
    row[2] = part[0];
    row[3] = K * part[0];
    row[4] = K * L;
  }
}

__global__ void now_kernel(long long* out) { out[0] = globaltimer(); }

}  // namespace

extern "C" {

// Plain C interface for ctypes. Every pointer is device memory; `seq`
// null marks a later stamp of the step. Each returns the CUDA error code
// of its launch (0 = success).
int stamp(long long* ring, int* cursor, long long* tick, const int* seq, int slots, int width,
          int mark, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(ring, cursor, tick, seq,
                                                               slots, width, mark);
  return static_cast<int>(cudaGetLastError());
}

// B sequences: n_descents (B,) int64, kf_valid (B, K) bool, leaves_valid
// (B, L) bool, each contiguous.
int counts(long long* ring, const int* cursor, int width, int off, const long long* n_descents,
           const bool* kf_valid, int K, const bool* leaves_valid, long long L, int B,
           void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  counts_kernel<<<B, COUNT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ring, cursor, width, off, n_descents, kf_valid, K, leaves_valid, L);
  return static_cast<int>(cudaGetLastError());
}

// The clock into out[0]: the trace's calibration against the host's.
int now(long long* out, void* stream) {
  now_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(out);
  return static_cast<int>(cudaGetLastError());
}

const char* madicp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
