// Segment-sum design points of the scatter probe, for Hopper (sm_90a).
//
// Four kernels, each the Hopper counterpart of one TPU kernel of
// scripts/pallas_scatter_probe.py. Each computes that kernel's function;
// none is carried over block by block. Every id outside [0, m) drops.
//
// K2  onehot_segsum16_{f32,bf16x3}   vals_t (16, n), idx (n,) -> (16, m)
//     replaces make_onehot_segsum (pallas_scatter_probe.py:66, call :143).
//     * f32/highest: on the TPU both were an f32 one-hot product (the
//       plain `f32` dot lowered as one bf16 pass, error ~0.28; its Hopper
//       twin would be TF32). Here both are the scatter itself, in full
//       FP32 on CUDA cores: a thread per point adds its 16 values into a
//       per-block (16, m) table in shared memory, and each block then
//       adds its nonzero entries to the output with global atomics. The
//       shared table only pays where many rows share a table row (n >=
//       256 m, e.g. m <= 512 at n = 131072): at m = 1024 it ran 3.4x
//       slower than global atomics at m = 4096. Elsewhere the kernel adds
//       straight into the output with global atomics.
//       Bound: bytes, n x 68 B in + 64 m B out (~9 MB, ~2.7 us at
//       3.35 TB/s); in practice shared-atomic contention at small m,
//       where 131072 rows fall into 64 table rows.
//     * bf16x3: the one-hot matrix-unit product, as on the TPU, on the
//       tensor cores (nvcuda::wmma bf16 16x16x16, f32 accumulators).
//       Each value is truncation-split into three bf16 parts (hi/mid/lo,
//       pallas_scatter_probe.py:113-123) whose products with the 0/1
//       one-hot are exact; the three products accumulate in f32. Bound:
//       bytes, as for f32 (the function). The dense design adds 2 n m 16 3
//       tensor-core flops (~0.2 ms at m = 16384 on 989 TFLOP/s), its own
//       floor, which grows with m. The one-hot tile is built in
//       shared memory from the ids, 16 bytes a lane, never in device
//       memory; a warp keeps accumulators for 8 column tiles (128
//       columns) in registers and reuses each split A tile across them.
//       The tensor cores form each 16-point chunk's sums from zero; the
//       warp adds them into its accumulators with round-to-nearest f32
//       adds, because the tensor cores' own f32 accumulation truncates:
//       accumulating 64 chunks inside the MMA left 8.6e-4 of error at
//       m = 64 (H100 80GB HBM3, 700 W), next to the 1e-3 tolerance.
//       The warps' partial sums are combined by double atomics into a
//       scratch table and cast once, so adding hundreds of partials into
//       large sums rounds only once.
// K3  fused_moments16                d (n, 3), idx (n,) -> (m, 16)
//     replaces make_fused_moments (pallas_scatter_probe.py:155, call
//     :224), the TPU's one-hot contraction of the 10 moment columns
//     [d, outer6(d), 1] (plus 6 zero columns) on the matrix unit. Its
//     function is a scatter: bound by bytes (n x 16 B in, 64 m B out,
//     ~0.6-1.6 us). A dense contraction costs 2 n m 48 flops, which grows
//     with m (1.8 ms at m = 16384 when this kernel was one), so here a
//     thread per point reads its 12 bytes and its id, forms the 10
//     columns in registers and scatters them. Precision sets the rest: a
//     float32 sum of k terms of N(0, 1) moments in random order is off by
//     up to ~2.6e-4 at k = 256 and ~1.9e-3 at k = 1024 (numpy emulation),
//     against the probe's 1e-3. So no float32 sum holds more than about
//     MOM_F32_TERMS = 256 terms of an entry (ids spread evenly, as the
//     probe draws them); above that, sums are combined in double and
//     rounded once. The contention n / m picks the accumulator:
//     * n < 256 m (fewer than 256 terms an entry): the output is zeroed
//       by a memset and each point adds its row with three vector
//       atomics (float4, float4, float2: sm_90 global memory) straight
//       into it, so a point costs 3 atomics, not 10. The whole table in
//       one cluster's distributed shared memory, the issue's other
//       design for this regime, took 0.46/0.44 ms at m = 4096/16384
//       against 8.4/7.7 us here (8 SMs of remote shared atomics; H100
//       80GB HBM3, 700 W), and was dropped.
//     * n >= 256 m and m <= 2048: a per-block (10, m) float32 table in
//       shared memory with shared atomics, about two blocks an SM, and
//       more where a block would otherwise sum over 256 terms of an entry.
//       The 8 blocks of a thread-block cluster add their tables in double
//       over distributed shared memory, each block a slice, and each
//       cluster adds its slice to a double workspace with global atomics:
//       one atomic an entry a cluster, not a block, so the blocks can be
//       4x as many (m = 256: 29.3 us with 32 blocks and no cluster, 15.0
//       with 128 in clusters; H100 80GB HBM3, 700 W). The last block to
//       finish (a ticket counter) rounds the sums to float32 once, writes
//       the output, and zeroes the workspace and the ticket for the next
//       call: one launch, no memset, no cast kernel. No warp
//       pre-aggregation for m <= 32: each warp takes about one 32-point
//       step, so a conflict costs it a few serialised shared atomics
//       once, less than a shuffle reduction per distinct id (41-91 us at
//       segsum_moments.cu's sz 8-32 levels).
//     * n >= 256 m and m > 2048 (the table outgrows shared memory): each
//       point adds its 10 values to the double workspace with global
//       atomics, and a second kernel rounds the sums into the output and
//       zeroes the workspace. Not a probe shape; it keeps the precision.
// K4  rmw_segsum16                   vals (q, 16), idx (q,) -> (m, 16)
//     replaces rmw_kernel (pallas_scatter_probe.py:365, call :375), the
//     TPU's serial in-order read-modify-write loop. Every entry (id, c)
//     is 0.0f + v_r1 + v_r2 + ... over its rows in increasing row index:
//     bitwise a float32 np.add.at. Bound: bytes (~0.6 MB, ~0.2 us). The
//     order binds only inside one entry, so the entries spread over the
//     card: each block owns 16 consecutive ids (one thread an entry).
//     A block reads every id, 8192 rows a pass (warp w takes rows
//     512 w .. 512 w + 511, 32 at a time in order), and sorts the rows
//     of its ids stably by id: __match_any_sync plus popc of the lower
//     lanes ranks equal ids inside a warp step, per-warp counters carry
//     the rank across steps, and an exclusive scan over (id, warp) gives
//     each row its place. The sorted rows are staged in shared memory
//     with 16-byte cp.async copies, all in flight at once (`vals` must be
//     16-byte aligned), and each entry's thread adds its run in order:
//     the loads do not wait on the adds, so a chain of ~32 rows costs
//     ~32 shared loads and float32 adds, not ~32 memory latencies. The
//     TPU indexed out-of-range ids with undefined results; here they
//     drop. Each block reads all q ids, so the work grows as q m / 16
//     (the wrapper caps m at 2048: 128 reads of every id). At q = 8192, m = 256 this takes 4.5 us
//     against index_add_'s 2.9 (its own order). Three variants ran
//     slower in the same calls (H100 80GB HBM3, 700 W): 1024 threads
//     (5.5 us), a leader-only counter update with an 8-deep unrolled sum
//     (4.9), per-step histograms with a 4-deep pipelined sum (5.4-5.9).
// K5  scatter_segsum16               vals (q, 16), idx (q,) -> (m, 16)
//     replaces scat_kernel (pallas_scatter_probe.py:401, call :406), an
//     in-kernel `.at[].add(mode="drop")` that Mosaic could not lower.
//     Unordered: a thread per element (consecutive threads hit
//     consecutive columns of one row) adds into the output with global
//     atomics, or into K2's per-block shared table where n >= 256 m.
//     Bound: bytes, as K4.
//
// K2, K3 and K5 sum in an order that changes from run to run (atomics);
// they match a float64 sum to float32 reassociation only.
// Inputs must be finite: the dense contraction multiplies every value
// by 0 or 1. Outputs of K2 (f32) and K5 must be zeroed by the caller,
// and so must the double scratch of K2 (bf16x3), which writes every
// entry of its output, as K3 and K4 do. K3's workspace (where its path
// needs one) is zeroed once by its owner and left zeroed by every call;
// calls that share it must be ordered on one stream.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>

namespace {

using namespace nvcuda;
namespace cg = cooperative_groups;

constexpr int NCOL = 16;
constexpr int THREADS = 256;
constexpr size_t SCATTER_SMEM_MAX = 96 * 1024;  // shared table, m <= 1536
constexpr int SHARED_MIN_ROWS_PER_ID = 256;     // contention worth a table
constexpr unsigned FULL_MASK = 0xffffffffu;

constexpr int WARPS = 4;                 // warps per block of the mma kernel
constexpr int TILES = 8;                 // 16-column tiles a warp accumulates
constexpr int GROUP_COLS = 16 * TILES;   // 128 output columns per warp
constexpr int KMIN_CHUNKS = 16;          // least 16-point chunks per warp

constexpr int MOM_COLS = 10;             // [d, outer6(d), 1]
constexpr int MOM_THREADS = 512;
constexpr int MOM_SHARED_MAX_M = 2048;   // (10, m) float32 table, 80 KB
constexpr int MOM_ROWS_PER_BLOCK_ID = 4;  // least points a block per table row
constexpr int MOM_F32_TERMS = 256;        // most terms of an entry a float32 sum takes
constexpr int MOM_CLUSTER = 8;           // blocks of a cluster (portable size)

constexpr int RMW_THREADS = 512;
constexpr int RMW_WARPS = RMW_THREADS / 32;       // 16
constexpr int RMW_IDS = 16;                        // table rows a block owns
constexpr int RMW_CHUNK = 8192;                    // rows sorted a pass
constexpr int RMW_STEPS = RMW_CHUNK / RMW_THREADS; // 32-row steps a warp
constexpr int RMW_STAGE = 1024;                    // rows staged at once

struct RmwShared {
  float stage[RMW_STAGE * NCOL];  // staged rows, in sorted order
  int list[RMW_CHUNK];            // the pass's rows of this block, sorted
  int cnt[RMW_WARPS][RMW_IDS];    // per-warp counts, then offsets
  int seg[RMW_IDS + 1];           // each id's first place; seg[16]: total
};

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

// -------------------------------------------- K2 f32 and K5: scatter --
__device__ __forceinline__ void zero_table(float* tab, int tab_n) {
  for (int i = threadIdx.x; i < tab_n; i += blockDim.x) tab[i] = 0.f;
  __syncthreads();
}

__device__ __forceinline__ void flush_table(const float* tab, int tab_n,
                                            float* __restrict__ out) {
  __syncthreads();
  for (int i = threadIdx.x; i < tab_n; i += blockDim.x) {
    const float v = tab[i];
    if (v != 0.f) atomicAdd(out + i, v);
  }
}

// K2 f32: vals_t (16, n) -> out (16, m); a thread per point, table
// layout c * m + id (neighbouring threads: neighbouring points, random
// ids, spread banks).
template <bool SHARED>
__global__ void scatter_cols_kernel(const int32_t* __restrict__ idx,
                                    const float* __restrict__ vals_t, int n,
                                    int m, float* __restrict__ out) {
  extern __shared__ float tab[];
  if (SHARED) zero_table(tab, NCOL * m);
  const int stride = gridDim.x * blockDim.x;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n; p += stride) {
    const int id = idx[p];
    if (id < 0 || id >= m) continue;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const float v = vals_t[static_cast<size_t>(c) * n + p];
      if (SHARED) {
        atomicAdd(&tab[c * m + id], v);
      } else {
        atomicAdd(&out[static_cast<size_t>(c) * m + id], v);
      }
    }
  }
  if (SHARED) flush_table(tab, NCOL * m, out);
}

// K5: vals (n, 16) -> out (m, 16); a thread per element, table layout
// id * 16 + c (sixteen neighbouring threads share a row).
template <bool SHARED>
__global__ void scatter_rows_kernel(const int32_t* __restrict__ idx,
                                    const float* __restrict__ vals, int n,
                                    int m, float* __restrict__ out) {
  extern __shared__ float tab[];
  if (SHARED) zero_table(tab, NCOL * m);
  const int total = n * NCOL;
  const int stride = gridDim.x * blockDim.x;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += stride) {
    const int id = idx[e / NCOL];
    if (id < 0 || id >= m) continue;
    const int t = id * NCOL + (e % NCOL);
    if (SHARED) {
      atomicAdd(&tab[t], vals[e]);
    } else {
      atomicAdd(&out[t], vals[e]);
    }
  }
  if (SHARED) flush_table(tab, NCOL * m, out);
}

// ------------------------------------------ K4: in-order, spread out --
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Block b owns ids 16 b .. 16 b + 15; thread t < 256 owns the entry
// (16 b + t / 16, t % 16) and keeps its sum in a register across passes.
__global__ void __launch_bounds__(RMW_THREADS)
rmw_kernel(const int32_t* __restrict__ idx, const float* __restrict__ vals,
           int q, int m, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char rmw_smem[];
  RmwShared& s = *reinterpret_cast<RmwShared*>(rmw_smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lo = blockIdx.x * RMW_IDS;
  const int own_k = threadIdx.x / NCOL, own_c = threadIdx.x % NCOL;
  const bool owner = threadIdx.x < RMW_IDS * NCOL;
  const unsigned lower = (1u << lane) - 1;
  float acc = 0.f;
  for (int base = 0; base < q; base += RMW_CHUNK) {
    // 1. every id of the warp's 512 rows at once, then rank them in order
    const int row0 = base + warp * (RMW_STEPS * 32);
    int key[RMW_STEPS], rank[RMW_STEPS];
#pragma unroll
    for (int t = 0; t < RMW_STEPS; ++t) {
      const int r = row0 + t * 32 + lane;
      const int id = r < q ? idx[r] : -1;
      key[t] = (id >= lo && id < lo + RMW_IDS && id < m) ? id - lo : -1;
    }
    if (lane < RMW_IDS) s.cnt[warp][lane] = 0;
    __syncwarp();
#pragma unroll
    for (int t = 0; t < RMW_STEPS; ++t) {
      const unsigned same = __match_any_sync(FULL_MASK, key[t]);
      const int before = __popc(same & lower);
      rank[t] = key[t] >= 0 ? s.cnt[warp][key[t]] + before : 0;
      __syncwarp();
      if (key[t] >= 0 && before == 0) s.cnt[warp][key[t]] += __popc(same);
      __syncwarp();
    }
    __syncthreads();
    // 2. places: ids in order, inside an id the warps in (row) order
    if (warp == 0) {
      int tot = 0;
      if (lane < RMW_IDS)
        for (int w = 0; w < RMW_WARPS; ++w) tot += s.cnt[w][lane];
      int incl = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(FULL_MASK, incl, o);
        if (lane >= o) incl += v;
      }
      if (lane < RMW_IDS) {
        int off = incl - tot;
        s.seg[lane] = off;
        for (int w = 0; w < RMW_WARPS; ++w) {
          const int c = s.cnt[w][lane];
          s.cnt[w][lane] = off;
          off += c;
        }
        if (lane == RMW_IDS - 1) s.seg[RMW_IDS] = incl;
      }
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < RMW_STEPS; ++t)
      if (key[t] >= 0) s.list[s.cnt[warp][key[t]] + rank[t]] = row0 + t * 32 + lane;
    __syncthreads();
    // 3. stage the sorted rows, RMW_STAGE at a time; each owner adds its run
    const int total = s.seg[RMW_IDS];
    const int run_lo = owner ? s.seg[own_k] : 0, run_hi = owner ? s.seg[own_k + 1] : 0;
    for (int b0 = 0; b0 < total; b0 += RMW_STAGE) {
      const int nb = min(RMW_STAGE, total - b0);
      for (int e = threadIdx.x; e < nb * (NCOL / 4); e += RMW_THREADS)
        cp_async16(&s.stage[e * 4],
                   vals + static_cast<size_t>(s.list[b0 + e / 4]) * NCOL + (e % 4) * 4);
      cp_async_wait_all();
      __syncthreads();
      const int p_hi = min(run_hi, b0 + nb);
      for (int p = max(run_lo, b0); p < p_hi; ++p) acc += s.stage[(p - b0) * NCOL + own_c];
      __syncthreads();  // the stage is read before the next batch lands
    }
  }
  if (owner && lo + own_k < m) out[static_cast<size_t>(lo + own_k) * NCOL + own_c] = acc;
}

// ---------------------------------------------- K3: moments, scatter --
__device__ __forceinline__ void moment_row(const float* __restrict__ d, int p,
                                           float v[MOM_COLS]) {
  const float x = d[3 * p + 0], y = d[3 * p + 1], z = d[3 * p + 2];
  v[0] = x; v[1] = y; v[2] = z;
  v[3] = x * x; v[4] = x * y; v[5] = x * z; v[6] = y * y; v[7] = y * z; v[8] = z * z;
  v[9] = 1.f;
}

// The (10, m) double sums `acc` rounded once into the (m, 16) output
// (columns 10-15 zero), entries e0, e0 + stride, ...; each sum is read
// and then cleared by the one thread that writes it.
__device__ __forceinline__ void round_moments(double* __restrict__ acc, int m,
                                              float* __restrict__ out, int e0, int stride) {
  for (int e = e0; e < NCOL * m; e += stride) {
    const int c = e % NCOL;
    float v = 0.f;
    if (c < MOM_COLS) {
      double* s = acc + c * m + e / NCOL;
      v = static_cast<float>(__ldcg(s));
      *s = 0.0;
    }
    out[e] = v;
  }
}

// High contention: a (10, m) float32 table per block (layout c * m + id)
// with shared atomics. The 8 tables of a cluster are added in double, in
// rank order, over distributed shared memory (each block one slice of
// the entries), and go to the double workspace ws[1..] by atomics: one
// global atomic an entry per cluster, not per block. The last block to
// finish rounds once into the (m, 16) output and clears the workspace.
__global__ void __cluster_dims__(MOM_CLUSTER, 1, 1) __launch_bounds__(MOM_THREADS)
moments_shared_kernel(const int32_t* __restrict__ idx, const float* __restrict__ d,
                      int n, int m, double* __restrict__ ws, float* __restrict__ out) {
  extern __shared__ float mtab[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tab_n = MOM_COLS * m;
  zero_table(mtab, tab_n);
  const int stride = gridDim.x * blockDim.x;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n; p += stride) {
    const int id = idx[p];
    if (id < 0 || id >= m) continue;
    float v[MOM_COLS];
    moment_row(d, p, v);
#pragma unroll
    for (int c = 0; c < MOM_COLS; ++c) atomicAdd(&mtab[c * m + id], v[c]);
  }
  cluster.sync();
  double* acc = ws + 1;
  const int rank = static_cast<int>(cluster.block_rank());
  for (int i = rank * blockDim.x + threadIdx.x; i < tab_n; i += MOM_CLUSTER * blockDim.x) {
    double sum = 0.0;
#pragma unroll
    for (int j = 0; j < MOM_CLUSTER; ++j) sum += cluster.map_shared_rank(mtab, j)[i];
    if (sum != 0.0) atomicAdd(acc + i, sum);
  }
  __threadfence();  // this block's sums are visible before its ticket
  cluster.sync();   // and no block leaves while a peer reads its table
  __shared__ bool last;
  if (threadIdx.x == 0)
    last = atomicAdd(reinterpret_cast<unsigned*>(ws), 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  round_moments(acc, m, out, threadIdx.x, blockDim.x);
  if (threadIdx.x == 0) *reinterpret_cast<unsigned*>(ws) = 0u;
}

// High contention past the shared table's size: each point adds its 10
// values to the double sums ws[1..] with global atomics; moments_round_kernel
// then writes the output and clears them.
__global__ void __launch_bounds__(MOM_THREADS)
moments_double_kernel(const int32_t* __restrict__ idx, const float* __restrict__ d,
                      int n, int m, double* __restrict__ ws) {
  double* acc = ws + 1;
  const int stride = gridDim.x * blockDim.x;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n; p += stride) {
    const int id = idx[p];
    if (id < 0 || id >= m) continue;
    float v[MOM_COLS];
    moment_row(d, p, v);
#pragma unroll
    for (int c = 0; c < MOM_COLS; ++c) atomicAdd(acc + c * m + id, static_cast<double>(v[c]));
  }
}

__global__ void moments_round_kernel(double* __restrict__ ws, int m, float* __restrict__ out) {
  round_moments(ws + 1, m, out, blockIdx.x * blockDim.x + threadIdx.x, gridDim.x * blockDim.x);
}

// Low contention: each point adds its row into the zeroed (m, 16) output
// with three vector atomics (float4, float4, float2; sm_90 global memory).
__global__ void __launch_bounds__(MOM_THREADS)
moments_global_kernel(const int32_t* __restrict__ idx, const float* __restrict__ d,
                      int n, int m, float* __restrict__ out) {
  const int stride = gridDim.x * blockDim.x;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n; p += stride) {
    const int id = idx[p];
    if (id < 0 || id >= m) continue;
    float v[MOM_COLS];
    moment_row(d, p, v);
    float* row = out + static_cast<size_t>(id) * NCOL;
    atomicAdd(reinterpret_cast<float4*>(row), make_float4(v[0], v[1], v[2], v[3]));
    atomicAdd(reinterpret_cast<float4*>(row + 4), make_float4(v[4], v[5], v[6], v[7]));
    atomicAdd(reinterpret_cast<float2*>(row + 8), make_float2(v[8], v[9]));
  }
}

// ------------------------------------------- K2 bf16x3: tensor cores --
struct alignas(32) WarpTiles {
  __nv_bfloat16 a[3][16 * 16];      // hi/mid/lo of the A tile (c x k, row-major)
  __nv_bfloat16 b[TILES][16 * 16];  // one-hot tiles (k x col, row-major)
  float c[16 * 16];                 // accumulator staging (c x col)
};

// Truncation split: v == hi + mid + lo exactly, each with at most 8
// significant bits, so each is a bf16 bit pattern (the high half of its
// float32 bits). A rounding conversion would leave a residue.
__device__ __forceinline__ void split3(float v, __nv_bfloat16 part[3]) {
  const uint32_t b = __float_as_uint(v);
  const float r1 = v - __uint_as_float(b & 0xFFFF0000u);
  const uint32_t rb = __float_as_uint(r1);
  const float lo = r1 - __uint_as_float(rb & 0xFFFF0000u);
  part[0] = __ushort_as_bfloat16(static_cast<unsigned short>(b >> 16));
  part[1] = __ushort_as_bfloat16(static_cast<unsigned short>(rb >> 16));
  part[2] = __ushort_as_bfloat16(static_cast<unsigned short>(__float_as_uint(lo) >> 16));
}

// A tile of 16 value columns x 16 points starting at k0: lane -> point
// k0 + (lane % 16), columns 8 (lane / 16) .. + 8. Points past n are 0.
__device__ __forceinline__ void fill_a(const float* __restrict__ src, int n,
                                       int k0, int lane, WarpTiles& t) {
  const int k = lane % 16, half = lane / 16, p = k0 + k;
  const bool in = p < n;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = half * 8 + j;
    __nv_bfloat16 part[3];
    split3(in ? src[static_cast<size_t>(c) * n + p] : 0.f, part);
#pragma unroll
    for (int s = 0; s < 3; ++s) t.a[s][c * 16 + k] = part[s];
  }
}

// One-hot tiles of 16 points x 16 columns: lane -> point k0 + lane / 2,
// columns 8 (lane % 2) .. + 8 of each tile, one 16-byte store a tile.
__device__ __forceinline__ void fill_b(const int32_t* __restrict__ idx, int n,
                                       int m, int k0, int col0, int nt,
                                       int lane, WarpTiles& t) {
  const int k = lane / 2, h = lane % 2, p = k0 + k;
  int id = p < n ? idx[p] : -1;
  if (id < 0 || id >= m) id = -1;
#pragma unroll
  for (int tt = 0; tt < TILES; ++tt) {
    if (tt < nt) {
      const int rel = id - (col0 + tt * 16 + h * 8);  // < 0 when id == -1
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        w[q] = (rel == 2 * q ? 0x3F80u : 0u) | (rel == 2 * q + 1 ? 0x3F800000u : 0u);
      *reinterpret_cast<uint4*>(&t.b[tt][k * 16 + h * 8]) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Each warp owns 128 output columns (group g) and one slice of the
// 16-point chunks; its partial sums go to `acc64` (the (16, m) output's
// layout, in double) by global atomics.
__global__ void __launch_bounds__(WARPS * 32)
onehot_mma_kernel(const int32_t* __restrict__ idx, const float* __restrict__ src,
                  int n, int m, int groups, int ksplits, double* __restrict__ acc64) {
  __shared__ WarpTiles tiles[WARPS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int w = blockIdx.x * WARPS + warp;
  if (w >= groups * ksplits) return;  // uniform across the warp
  WarpTiles& t = tiles[warp];
  const int g = w % groups, ks = w / groups;
  const int col0 = g * GROUP_COLS;
  const int nt = min(TILES, (m - col0 + 15) / 16);
  const int chunks = (n + 15) / 16;
  const int per = (chunks + ksplits - 1) / ksplits;
  const int c_lo = ks * per, c_hi = min(chunks, c_lo + per);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TILES], sums;
#pragma unroll
  for (int tt = 0; tt < TILES; ++tt) wmma::fill_fragment(acc[tt], 0.f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[3];
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;

  for (int ch = c_lo; ch < c_hi; ++ch) {
    const int k0 = ch * 16;
    fill_a(src, n, k0, lane, t);
    fill_b(idx, n, m, k0, col0, nt, lane, t);
    __syncwarp();
#pragma unroll
    for (int s = 0; s < 3; ++s) wmma::load_matrix_sync(a[s], t.a[s], 16);
#pragma unroll
    for (int tt = 0; tt < TILES; ++tt) {
      if (tt < nt) {
        wmma::load_matrix_sync(b, t.b[tt], 16);
        wmma::fill_fragment(sums, 0.f);
#pragma unroll
        for (int s = 0; s < 3; ++s) wmma::mma_sync(sums, a[s], b, sums);
#pragma unroll
        for (int i = 0; i < sums.num_elements; ++i) acc[tt].x[i] += sums.x[i];
      }
    }
    __syncwarp();  // tiles consumed before the next chunk overwrites them
  }

#pragma unroll
  for (int tt = 0; tt < TILES; ++tt) {
    if (tt < nt) {
      wmma::store_matrix_sync(t.c, acc[tt], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int ci = e / 16, j = e % 16;  // coalesced in the output's columns
        const int col = col0 + tt * 16 + j;
        const float v = t.c[ci * 16 + j];
        if (col < m && v != 0.f)
          atomicAdd(acc64 + static_cast<size_t>(ci) * m + col, static_cast<double>(v));
      }
      __syncwarp();
    }
  }
}

__global__ void cast_kernel(const double* __restrict__ acc64, int total,
                            float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total) out[i] = static_cast<float>(acc64[i]);
}

// ------------------------------------------------------------ launch --
cudaError_t configure() {
  static cudaError_t done = cudaErrorNotReady;
  if (done == cudaErrorNotReady) {
    done = cudaFuncSetAttribute(scatter_cols_kernel<true>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(SCATTER_SMEM_MAX));
    if (done == cudaSuccess)
      done = cudaFuncSetAttribute(scatter_rows_kernel<true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(SCATTER_SMEM_MAX));
    if (done == cudaSuccess)
      done = cudaFuncSetAttribute(rmw_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(sizeof(RmwShared)));
    if (done == cudaSuccess)
      done = cudaFuncSetAttribute(moments_shared_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  MOM_COLS * MOM_SHARED_MAX_M * static_cast<int>(sizeof(float)));
  }
  return done;
}

// K3's accumulator at (n, m): see the header.
enum class MomPath { kFloat32, kShared, kDouble };

MomPath moments_path(int n, int m) {
  if (n / MOM_F32_TERMS < m) return MomPath::kFloat32;  // < 256 terms an entry
  return m <= MOM_SHARED_MAX_M ? MomPath::kShared : MomPath::kDouble;
}

template <bool ROWS>
int launch_scatter(const int32_t* idx, const float* vals, int n, int m,
                   float* out, cudaStream_t stream) {
  const cudaError_t cfg = configure();
  if (cfg != cudaSuccess) return static_cast<int>(cfg);
  const size_t tab_bytes = static_cast<size_t>(m) * NCOL * sizeof(float);
  const int per_block = ROWS ? THREADS / NCOL : THREADS;  // points per sweep
  const int sweep_blocks = n > 0 ? (n + per_block - 1) / per_block : 1;
  if (tab_bytes <= SCATTER_SMEM_MAX &&
      n / SHARED_MIN_ROWS_PER_ID >= m) {
    // about two blocks an SM, but at least 4 points per table row each
    const int blocks = std::max(1, std::min(std::min(2 * sm_count(), sweep_blocks), n / (4 * m)));
    if (ROWS) {
      scatter_rows_kernel<true><<<blocks, THREADS, tab_bytes, stream>>>(idx, vals, n, m, out);
    } else {
      scatter_cols_kernel<true><<<blocks, THREADS, tab_bytes, stream>>>(idx, vals, n, m, out);
    }
  } else {
    const int blocks = std::min(sweep_blocks, 32 * sm_count());
    if (ROWS) {
      scatter_rows_kernel<false><<<blocks, THREADS, 0, stream>>>(idx, vals, n, m, out);
    } else {
      scatter_cols_kernel<false><<<blocks, THREADS, 0, stream>>>(idx, vals, n, m, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain C interface for ctypes: (ids, values, n rows, m table rows,
// double scratch, output, stream); n and m are at most 2^26, so every
// index below fits in an int. Only K2 bf16x3 (16 m doubles, zeroed by
// the caller) and K3 (its workspace, fused_moments16_workspace(n, m)
// doubles, zeroed once, null where that is 0) use the scratch. Returns the cudaGetLastError()
// code after the launches (0 = success).

int onehot_segsum16_f32(const int32_t* idx, const float* vals_t, int n, int m,
                        double* /*scratch*/, float* out, void* stream) {
  return launch_scatter<false>(idx, vals_t, n, m, out,
                               static_cast<cudaStream_t>(stream));
}

int onehot_segsum16_bf16x3(const int32_t* idx, const float* vals_t, int n,
                           int m, double* scratch, float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (n + 15) / 16;
  const int groups = (m + GROUP_COLS - 1) / GROUP_COLS;
  const int target_warps = 16 * sm_count();
  const int max_splits = std::max(1, (chunks + KMIN_CHUNKS - 1) / KMIN_CHUNKS);
  const int ksplits = std::max(1, std::min(max_splits, (target_warps + groups - 1) / groups));
  const int blocks = (groups * ksplits + WARPS - 1) / WARPS;
  onehot_mma_kernel<<<blocks, WARPS * 32, 0, s>>>(idx, vals_t, n, m, groups, ksplits, scratch);
  const int total = NCOL * m;
  cast_kernel<<<(total + THREADS - 1) / THREADS, THREADS, 0, s>>>(scratch, total, out);
  return static_cast<int>(cudaGetLastError());
}

// Doubles of workspace fused_moments16 needs at (n, m): a ticket word,
// then the (10, m) double sums; 0 where it scatters in float32.
int fused_moments16_workspace(int n, int m) {
  return moments_path(n, m) == MomPath::kFloat32 ? 0 : 1 + MOM_COLS * m;
}

int fused_moments16(const int32_t* idx, const float* d, int n, int m,
                    double* workspace, float* out, void* stream) {
  const cudaError_t cfg = configure();
  if (cfg != cudaSuccess) return static_cast<int>(cfg);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sweep_blocks = std::max(1, (n + MOM_THREADS - 1) / MOM_THREADS);
  switch (moments_path(n, m)) {
    case MomPath::kShared: {
      // about two blocks an SM with enough points a table row in each,
      // and more where a block would sum over MOM_F32_TERMS terms of an entry
      const int fill = std::min(2 * sm_count(), n / (MOM_ROWS_PER_BLOCK_ID * m));
      const int precise = (n + MOM_F32_TERMS * m - 1) / (MOM_F32_TERMS * m);
      const int want = std::max(1, std::max(fill, precise));
      const int blocks = (want + MOM_CLUSTER - 1) / MOM_CLUSTER * MOM_CLUSTER;
      moments_shared_kernel<<<blocks, MOM_THREADS, MOM_COLS * m * sizeof(float), s>>>(
          idx, d, n, m, workspace, out);
      break;
    }
    case MomPath::kDouble: {
      moments_double_kernel<<<std::min(sweep_blocks, 8 * sm_count()), MOM_THREADS, 0, s>>>(
          idx, d, n, m, workspace);
      moments_round_kernel<<<(NCOL * m + THREADS - 1) / THREADS, THREADS, 0, s>>>(
          workspace, m, out);
      break;
    }
    case MomPath::kFloat32: {
      const cudaError_t z =
          cudaMemsetAsync(out, 0, static_cast<size_t>(m) * NCOL * sizeof(float), s);
      if (z != cudaSuccess) return static_cast<int>(z);
      moments_global_kernel<<<std::min(sweep_blocks, 8 * sm_count()), MOM_THREADS, 0, s>>>(
          idx, d, n, m, out);
      break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int rmw_segsum16(const int32_t* idx, const float* vals, int q, int m,
                 double* /*scratch*/, float* out, void* stream) {
  const cudaError_t cfg = configure();
  if (cfg != cudaSuccess) return static_cast<int>(cfg);
  rmw_kernel<<<(m + RMW_IDS - 1) / RMW_IDS, RMW_THREADS, sizeof(RmwShared),
               static_cast<cudaStream_t>(stream)>>>(idx, vals, q, m, out);
  return static_cast<int>(cudaGetLastError());
}

int scatter_segsum16(const int32_t* idx, const float* vals, int q, int m,
                     double* /*scratch*/, float* out, void* stream) {
  return launch_scatter<true>(idx, vals, q, m, out,
                              static_cast<cudaStream_t>(stream));
}

const char* madicp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
