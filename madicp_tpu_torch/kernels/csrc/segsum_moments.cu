// Per-level moment segment-sum of the MAD-tree build, for Hopper (sm_90a).
//
// Computes, for one tree level with `sz` nodes,
//     out[j, :] = sum over points p with idx[p] == j of
//                 [d, outer6(d), 1](p)          (10 columns)
// where d (n, 3) are the points shifted by their parent node's mean and
// ids outside [0, sz) drop. It replaces the TPU kernel
// madicp_tpu/ops/tree.py:279 `_segsum_moments_pallas` (a one-hot MXU
// contraction with a 3 x bf16 split) and the XLA scatter-add it stands
// in for (tree.py:451-455). The bf16 split was a workaround for the
// TPU's matrix unit and has no counterpart here.
//
// Bound on an H100 (3.35 TB/s): the function reads n x 16 B (d in f32
// plus a 4-byte id) = 2.1 MB at the flagship n = 131072 and writes at
// most 65536 x 10 x 4 B = 2.6 MB, so the least time is ~1.4 us per
// level; its ~19 flops per point are negligible. A build runs 17
// dependent levels, so in practice it is bound by launch latency and by
// contention: at level 0 every point adds into the same 10 sums.
//
// Precision: every path accumulates in double and rounds once into
// `out` (a float32 sum of the 131072 level-0 terms drifts past the 1e-5
// relative tolerance the build is held to). The sum order changes from
// run to run (global atomics); results match the plain version to
// reassociation only.
//
// Three paths, chosen on the host by `plan` (kernels/segsum.py) from n,
// sz and the SM count. None uses a shared-memory float or double atomic
// (on sm_90a those compile to a CAS loop, ATOMS.CAST.SPIN) and none
// loops once per distinct id:
//   * warp (contended, n >= 128 sz, and sz <= 32): each warp keeps a
//     private double table in shared memory. Per 32 points,
//     __match_any_sync groups the lanes by id and a 5-step reduction gives
//     every lane its group's sum, whatever the number of groups: at step o
//     a lane adds the partial of any lane of its id in the partner block
//     of o lanes (all of them hold the same partial). The group's first
//     lane adds the sums to the warp's table with a plain read-modify-
//     write: the leaders of one step hold distinct ids and a warp's steps
//     are ordered. The block then adds its warp tables in double and each
//     entry to the workspace with one global atomic.
//   * sort (contended, 32 < sz <= 4096): a block takes a tile of ~n/SMs
//     points, ranks them within their id (__match_any_sync and one native
//     shared integer atomic per id and warp step), scans the counts and
//     places the points in id order. Each warp then walks a slice of the
//     sorted tile 32 at a time with a segmented scan (head flags, at most
//     5 shuffle steps, a carry across steps) and adds each run's sums to
//     the workspace.
//   * point (the rest): a thread per point adds its 10 columns to the
//     workspace.
// Global atomics are native (RED.E.ADD.F64), but the L2 takes scattered
// ones at about one request a slot whatever their width: the sort and
// point paths stage a warp's rows in shared memory so each atomic
// instruction covers 32 consecutive sums (~8 sectors, not 32): the
// 1.2 M atomics of a flagship level took 19.7 us a kernel scattered (the
// parent design) and 7.7 staged (H100 80GB HBM3, 700 W).
// The rounding: where the table has at most 5120 entries (sz <= 512) the
// last block to finish (a ticket in the workspace's head) rounds the sums
// into `out` and zeroes them and the ticket: one launch. Larger tables
// take a second kernel that rounds and clears, ROUND_BATCH loads in
// flight a thread. The workspace is zeroed once by its owner and left
// zeroed by every call, so calls that share it must be ordered on one
// stream.
//
// The thresholds come from an A/B of every path at every flagship level
// on the card (python -m madicp_tpu_torch.probes.segsum_levels --paths;
// PERF.md; H100 80GB HBM3, 700 W): device us in a CUDA graph, float32,
// warp / sort: sz 1: 6.6 / 13.5, sz 32: 9.7 / 10.0, sz 64: 10.8 / 10.3,
// sz 256: 19.7 / 10.8; sort / point at sz 1024: 9.9 / 12.5, at 2048:
// 11.3 / 10.6.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int NCOL = 10;
constexpr int WS_HEAD = 2;          // workspace doubles before the sums (the ticket)
constexpr int ROUND_BATCH = 8;      // sums a thread reads at once when it rounds
constexpr int SORT_THREADS = 512;
constexpr int SORT_PPT = 8;         // points a thread ranks at most
constexpr int OFF_BITS = 12;        // SORT_THREADS * SORT_PPT = 1 << OFF_BITS
constexpr int MAX_SMEM = 96 * 1024;  // dynamic shared bytes a block may ask for
// a warp's staged rows: 32 rows of 10 doubles, then their 32 ids
constexpr int STAGE_BYTES = 32 * NCOL * sizeof(double) + 32 * sizeof(int);

enum Path { kPoint = 0, kSort = 1, kWarp = 2 };

template <typename T>
__device__ __forceinline__ void point_moments(const T* __restrict__ d, int p,
                                              double m[NCOL]) {
  const double x = static_cast<double>(__ldg(d + 3 * static_cast<size_t>(p)));
  const double y = static_cast<double>(__ldg(d + 3 * static_cast<size_t>(p) + 1));
  const double z = static_cast<double>(__ldg(d + 3 * static_cast<size_t>(p) + 2));
  m[0] = x;
  m[1] = y;
  m[2] = z;
  m[3] = x * x;
  m[4] = x * y;
  m[5] = x * z;
  m[6] = y * y;
  m[7] = y * z;
  m[8] = z * z;
  m[9] = 1.0;
}

__device__ __forceinline__ void zero_moments(double m[NCOL]) {
#pragma unroll
  for (int c = 0; c < NCOL; ++c) m[c] = 0.0;
}

// Adds the row m of every lane with `has` to acc (row id, 10 doubles),
// with neighbouring lanes on neighbouring addresses: the warp stages its
// rows in `stage` (STAGE_BYTES) and each atomic instruction then covers
// 32 consecutive (row, column) sums, ~8 sectors, not 32 scattered ones.
// Warp-uniform: every lane calls it.
__device__ __forceinline__ void add_rows(double* __restrict__ acc, bool has, int id,
                                         const double m[NCOL], unsigned char* stage) {
  const unsigned rows = __ballot_sync(FULL_MASK, has);
  if (!rows) return;
  const int lane = threadIdx.x % 32;
  double* val = reinterpret_cast<double*>(stage);
  int* row_id = reinterpret_cast<int*>(val + 32 * NCOL);
  if (has) {
    const int slot = __popc(rows & ((1u << lane) - 1));
#pragma unroll
    for (int c = 0; c < NCOL; ++c) val[slot * NCOL + c] = m[c];
    row_id[slot] = id;
  }
  __syncwarp();
  const int total = __popc(rows) * NCOL;
  for (int q = lane; q < total; q += 32) {
    const int r = q / NCOL;
    atomicAdd(acc + row_id[r] * NCOL + (q - r * NCOL), val[q]);
  }
  __syncwarp();
}

// The table entries e0, e0 + stride, ...: each workspace sum rounded once
// into `out` and cleared; ROUND_BATCH sums in flight a thread.
template <typename T>
__device__ __forceinline__ void round_clear(double* __restrict__ acc, int tab_n,
                                            T* __restrict__ out, int e0, int stride) {
  constexpr int U = ROUND_BATCH;
  for (int e = e0; e < tab_n; e += U * stride) {
    double v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = e + u * stride;
      v[u] = i < tab_n ? __ldcg(acc + i) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = e + u * stride;
      if (i < tab_n) {
        out[i] = static_cast<T>(v[u]);
        acc[i] = 0.0;
      }
    }
  }
}

// Called by every thread after its atomics: the last block of the grid
// rounds the table into `out` and leaves workspace and ticket zeroed.
template <typename T>
__device__ __forceinline__ void last_block_rounds(double* __restrict__ ws, int tab_n,
                                                  T* __restrict__ out, bool* last) {
  __threadfence();  // this thread's sums are visible before the ticket
  __syncthreads();
  if (threadIdx.x == 0)
    *last = atomicAdd(reinterpret_cast<unsigned*>(ws), 1u) == gridDim.x - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  round_clear(ws + WS_HEAD, tab_n, out, threadIdx.x, blockDim.x);
  if (threadIdx.x == 0) *reinterpret_cast<unsigned*>(ws) = 0u;
}

extern __shared__ __align__(16) unsigned char smem_raw[];

// ---------------------------------------------------------------- point --
// A thread per point, a grid-stride loop; shared: a stage a warp.
template <typename T, bool TICKET>
__global__ void point_kernel(const T* __restrict__ d, const int32_t* __restrict__ idx,
                             int n, int sz, double* __restrict__ ws, T* __restrict__ out) {
  __shared__ bool last;
  unsigned char* stage = smem_raw + (threadIdx.x / 32) * STAGE_BYTES;
  double* acc = ws + WS_HEAD;
  const int stride = gridDim.x * blockDim.x;
  for (int base = blockIdx.x * blockDim.x + threadIdx.x / 32 * 32; base < n;
       base += stride) {  // warp-uniform
    const int p = base + threadIdx.x % 32;
    const int id = p < n ? __ldg(idx + p) : -1;
    const bool in = id >= 0 && id < sz;
    double m[NCOL];
    if (in) {
      point_moments(d, p, m);
    } else {
      zero_moments(m);
    }
    add_rows(acc, in, id, m, stage);
  }
  if (TICKET) last_block_rounds(ws, NCOL * sz, out, &last);
}

// ----------------------------------------------------------------- warp --
// Block b takes points [b tile, (b + 1) tile); its warps take 32 of them
// at a time, strided. Shared: warp w's table of sz rows at tabs + w 10 sz.
template <typename T, bool TICKET>
__global__ void warp_kernel(const T* __restrict__ d, const int32_t* __restrict__ idx,
                            int n, int sz, int tile, double* __restrict__ ws,
                            T* __restrict__ out) {
  __shared__ bool last;
  double* tabs = reinterpret_cast<double*>(smem_raw);
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tab_n = NCOL * sz;
  for (int i = threadIdx.x; i < warps * tab_n; i += blockDim.x) tabs[i] = 0.0;
  __syncthreads();
  double* tab = tabs + warp * tab_n;
  const int lo = blockIdx.x * tile, hi = min(n, lo + tile);
  for (int base = lo + 32 * warp; base < hi; base += 32 * warps) {  // warp-uniform
    const int p = base + lane;
    int key = -1;
    if (p < hi) {
      const int id = __ldg(idx + p);
      if (id >= 0 && id < sz) key = id;
    }
    double m[NCOL];
    if (key >= 0) {
      point_moments(d, p, m);
    } else {
      zero_moments(m);
    }
    const unsigned same = __match_any_sync(FULL_MASK, key);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      // lanes of my id in the partner block of o lanes; any one of them
      // holds the partial of all of them
      const unsigned peers = same & (((1u << o) - 1) << ((lane ^ o) & ~(o - 1)));
      const bool take = key >= 0 && peers != 0;
      if (!__any_sync(FULL_MASK, take)) continue;
      const int src = take ? __ffs(peers) - 1 : lane;
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        const double v = __shfl_sync(FULL_MASK, m[c], src);
        if (take) m[c] += v;
      }
    }
    if (key >= 0 && lane == __ffs(same) - 1) {
#pragma unroll
      for (int c = 0; c < NCOL; ++c) tab[key * NCOL + c] += m[c];
    }
    __syncwarp();
  }
  __syncthreads();
  double* acc = ws + WS_HEAD;
  for (int e = threadIdx.x; e < tab_n; e += blockDim.x) {
    double s = 0.0;
    for (int w = 0; w < warps; ++w) s += tabs[w * tab_n + e];
    if (s != 0.0) atomicAdd(acc + e, s);
  }
  if (TICKET) last_block_rounds(ws, tab_n, out, &last);
}

// ----------------------------------------------------------------- sort --
// In-place exclusive scan of a[0, count) in shared memory by the whole
// block (blockDim.x a multiple of 32, `sums` 33 ints); returns the total.
__device__ __forceinline__ int block_exclusive_scan(int* a, int count, int* sums) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int per = (count + blockDim.x - 1) / blockDim.x;
  const int lo = min(count, threadIdx.x * per), hi = min(count, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += a[i];
  int incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < blockDim.x / 32 ? sums[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL_MASK, wi, o);
      if (lane >= o) wi += v;
    }
    sums[lane] = wi - w;
    if (lane == 31) sums[32] = wi;
  }
  __syncthreads();
  int run = sums[warp] + incl - s;
  for (int i = lo; i < hi; ++i) {
    const int c = a[i];
    a[i] = run;
    run += c;
  }
  const int total = sums[32];
  __syncthreads();
  return total;
}

// Block b takes points [b tile, (b + 1) tile), tile <= 1 << OFF_BITS.
// Shared: a stage a warp, the counts (then starts) of the sz ids, then
// the tile sorted by id as id << OFF_BITS | offset.
template <typename T, bool TICKET>
__global__ void __launch_bounds__(SORT_THREADS)
sort_kernel(const T* __restrict__ d, const int32_t* __restrict__ idx, int n, int sz,
            int tile, double* __restrict__ ws, T* __restrict__ out) {
  __shared__ bool last;
  __shared__ int sums[33];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* stage = smem_raw + warp * STAGE_BYTES;
  int* start = reinterpret_cast<int*>(smem_raw + warps * STAGE_BYTES);
  int* sorted = start + sz;
  const unsigned lower = (1u << lane) - 1;
  const int lo = blockIdx.x * tile, cnt = max(0, min(tile, n - lo));
  for (int i = threadIdx.x; i < sz; i += blockDim.x) start[i] = 0;
  __syncthreads();

  // 1. rank each kept point among the tile's points of its id
  int key[SORT_PPT], rank[SORT_PPT];
#pragma unroll
  for (int k = 0; k < SORT_PPT; ++k) {
    key[k] = -1;
    rank[k] = 0;
    if (k * static_cast<int>(blockDim.x) >= cnt) continue;  // block-uniform
    const int off = k * blockDim.x + threadIdx.x;
    if (off < cnt) {
      const int id = __ldg(idx + lo + off);
      if (id >= 0 && id < sz) key[k] = id;
    }
    const unsigned same = __match_any_sync(FULL_MASK, key[k]);
    const int leader = __ffs(same) - 1;
    int base = 0;
    if (key[k] >= 0 && lane == leader) base = atomicAdd(start + key[k], __popc(same));
    rank[k] = __shfl_sync(FULL_MASK, base, leader) + __popc(same & lower);
  }
  __syncthreads();
  // 2. counts -> starts; 3. place the points in id order
  const int total = block_exclusive_scan(start, sz, sums);
#pragma unroll
  for (int k = 0; k < SORT_PPT; ++k)
    if (key[k] >= 0)
      sorted[start[key[k]] + rank[k]] =
          key[k] << OFF_BITS | (k * static_cast<int>(blockDim.x) + threadIdx.x);
  __syncthreads();

  // 4. each warp a slice of the sorted tile, 32 places a step: a
  // segmented inclusive scan gives each run's last place its sums
  double* acc = ws + WS_HEAD;
  const int slice = (total + warps - 1) / warps;
  const int r_lo = warp * slice, r_hi = min(total, r_lo + slice);
  double carry[NCOL];
  zero_moments(carry);
  for (int base = r_lo; base < r_hi; base += 32) {  // warp-uniform
    const int pos = base + lane;
    const bool in = pos < r_hi;
    const int e = in ? sorted[pos] : 0;
    const int id = e >> OFF_BITS;
    double m[NCOL];
    if (in) {
      point_moments(d, lo + (e & ((1 << OFF_BITS) - 1)), m);
    } else {
      zero_moments(m);
    }
    const bool head = in && (pos == r_lo || (sorted[pos - 1] >> OFF_BITS) != id);
    const bool end = in && (pos == r_hi - 1 || (sorted[pos + 1] >> OFF_BITS) != id);
    const unsigned upto = __ballot_sync(FULL_MASK, head) & (lower | (1u << lane));
    const int seg = upto ? 31 - __clz(upto) : 0;  // first lane of my run in this step
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const bool take = lane - o >= seg;
      if (!__any_sync(FULL_MASK, take)) break;  // takes only shrink as o grows
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        const double v = __shfl_up_sync(FULL_MASK, m[c], o);
        if (take) m[c] += v;
      }
    }
    if (!upto) {  // my run began in an earlier step
#pragma unroll
      for (int c = 0; c < NCOL; ++c) m[c] += carry[c];
    }
    const bool open = __shfl_sync(FULL_MASK, in && !end, 31);
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const double v = __shfl_sync(FULL_MASK, m[c], 31);
      carry[c] = open ? v : 0.0;
    }
    add_rows(acc, end, id, m, stage);
  }
  if (TICKET) last_block_rounds(ws, NCOL * sz, out, &last);
}

// ---------------------------------------------------------------- round --
template <typename T>
__global__ void round_kernel(double* __restrict__ ws, int tab_n, T* __restrict__ out) {
  round_clear(ws + WS_HEAD, tab_n, out, blockIdx.x * blockDim.x + threadIdx.x,
              gridDim.x * blockDim.x);
}

// ---------------------------------------------------------------- launch --
template <typename K>
cudaError_t allow_smem(K kernel, cudaError_t prev) {
  if (prev != cudaSuccess) return prev;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
}

template <typename T>
cudaError_t configure() {
  static cudaError_t done = cudaErrorNotReady;
  if (done == cudaErrorNotReady) {
    cudaError_t e = allow_smem(warp_kernel<T, true>, cudaSuccess);
    e = allow_smem(warp_kernel<T, false>, e);
    e = allow_smem(sort_kernel<T, true>, e);
    done = allow_smem(sort_kernel<T, false>, e);
  }
  return done;
}

// Dynamic shared bytes of the accumulating kernel (the plan's `smem`).
size_t smem_bytes(int path, int sz, int threads, int tile) {
  const size_t warps = threads / 32;
  switch (path) {
    case kPoint:
      return warps * STAGE_BYTES;
    case kSort:
      return warps * STAGE_BYTES + static_cast<size_t>(sz + tile) * sizeof(int);
    case kWarp:
      return warps * NCOL * static_cast<size_t>(sz) * sizeof(double);
  }
  return 0;
}

template <typename T, bool TICKET>
void accumulate(const T* d, const int32_t* idx, int n, int sz, int path, int blocks,
                int threads, int tile, double* ws, T* out, cudaStream_t s) {
  const size_t smem = smem_bytes(path, sz, threads, tile);
  switch (path) {
    case kPoint:
      point_kernel<T, TICKET><<<blocks, threads, smem, s>>>(d, idx, n, sz, ws, out);
      break;
    case kSort:
      sort_kernel<T, TICKET><<<blocks, threads, smem, s>>>(d, idx, n, sz, tile, ws, out);
      break;
    case kWarp:
      warp_kernel<T, TICKET><<<blocks, threads, smem, s>>>(d, idx, n, sz, tile, ws, out);
      break;
  }
}

template <typename T>
int launch(const T* d, const int32_t* idx, int n, int sz, int path, int blocks,
           int threads, int tile, int round_blocks, double* ws, T* out,
           cudaStream_t s) {
  if (path < kPoint || path > kWarp || blocks < 1 || threads < 32 || threads % 32 ||
      sz < 1 || n < 0 || smem_bytes(path, sz, threads, tile) > MAX_SMEM ||
      (path == kSort && (tile > SORT_THREADS * SORT_PPT || threads != SORT_THREADS)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t cfg = configure<T>();
  if (cfg != cudaSuccess) return static_cast<int>(cfg);
  if (round_blocks > 0) {
    accumulate<T, false>(d, idx, n, sz, path, blocks, threads, tile, ws, out, s);
    round_kernel<T><<<round_blocks, 256, 0, s>>>(ws, NCOL * sz, out);
  } else {
    accumulate<T, true>(d, idx, n, sz, path, blocks, threads, tile, ws, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain C interface for ctypes: (d, idx, n points, sz nodes, path
// (0 point, 1 sort, 2 warp), blocks, threads a block, tile (points a
// block, sort and warp paths), round_blocks (0: the last block rounds),
// workspace, out, stream). The host plan (kernels/segsum.py `plan`)
// chooses every launch parameter. The workspace holds 2 + 10 sz doubles,
// zeroed once by the caller and left zeroed by every call. Every entry of
// `out` (sz * 10) is written. Returns the cudaGetLastError() code after
// the launches (0 = success).
int segsum_moments_f32(const float* d, const int32_t* idx, int n, int sz, int path,
                       int blocks, int threads, int tile, int round_blocks,
                       double* workspace, float* out, void* stream) {
  return launch<float>(d, idx, n, sz, path, blocks, threads, tile, round_blocks,
                       workspace, out, static_cast<cudaStream_t>(stream));
}

int segsum_moments_f64(const double* d, const int32_t* idx, int n, int sz, int path,
                       int blocks, int threads, int tile, int round_blocks,
                       double* workspace, double* out, void* stream) {
  return launch<double>(d, idx, n, sz, path, blocks, threads, tile, round_blocks,
                        workspace, out, static_cast<cudaStream_t>(stream));
}

const char* madicp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
