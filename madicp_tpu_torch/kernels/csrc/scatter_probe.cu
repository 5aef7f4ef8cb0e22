// Segment-sum design points of the scatter probe, for Hopper (sm_90a).
//
// Four kernels, each the Hopper counterpart of one TPU kernel of
// scripts/pallas_scatter_probe.py. Each computes that kernel's function;
// none is carried over block by block. Every id outside [0, m) drops.
//
// K2, K3 and K5 are one scatter core, templated on the source of a
// point's values (a "Src" below: K2 reads 16 value columns, K3 forms 10
// moment columns from a point, K5 reads 16-wide rows) and on the output's
// layout. Their function is a scatter, bound by bytes: each input read
// once, the output written once. The contention (rows an id) picks the
// accumulator, and precision sets one rule: a float32 sum of k terms
// of N(0, 1) values in random order is off by up to ~2.6e-4 at k = 256
// and ~1.9e-3 at k = 1024 (numpy emulation, moment columns), against the
// probe's 1e-3, so no float32 sum holds more than about F32_TERMS = 256
// terms of an entry (ids spread evenly, as the probe draws them); above
// that, partial sums are combined in double and rounded once.
//   * Shared tables (n >= 256 m, m <= 2048): a per-block float32 table in
//     shared memory, about two blocks an SM and more where a block would
//     otherwise sum over 256 terms of an entry. The 8 blocks of a
//     thread-block cluster add their tables in double over distributed
//     shared memory, each block a slice, and each cluster adds its slice
//     to a double workspace with global atomics (one atomic an entry a
//     cluster, not a block: at m = 256, 29.3 us with 32 blocks and no
//     cluster, 15.0 with 128 in clusters; H100 80GB HBM3, 700 W). The last
//     block to finish (a ticket counter) rounds the sums once into the
//     output and zeroes the workspace and the ticket for the next call:
//     one launch. On sm_90a a shared-memory float atomicAdd is a CAS loop
//     (ATOMS.CAST.SPIN in the SASS; the global ones are native ATOMG.ADD),
//     which is most of this path's time.
//   * Double atomics (n >= 256 m, m > 2048): each point adds its values
//     to the double workspace with global atomics; a second kernel rounds
//     them into the output and zeroes the workspace. Not a probe shape;
//     it keeps the precision.
//   * Vector atomics (n < 256 m): float32 atomics of 16 bytes (sm_90
//     global memory) into (m, 16) rows, so a 16-wide row costs 4 atomics,
//     not 16. Where the output is those rows (K3, K5) they go straight
//     into it after a memset; K2's (16, m) output puts a point's values m
//     floats apart, so its rows are summed in the workspace and a second
//     kernel writes them to the output transposed and clears them.

// K2  onehot_segsum16                vals_t (16, n), idx (n,) -> (16, m)
//     replaces make_onehot_segsum (pallas_scatter_probe.py:66, call :143)
//     in all three modes. On the TPU f32 and highest were an f32 one-hot
//     product (the plain `f32` dot lowered as one bf16 pass, error ~0.28;
//     its Hopper twin would be TF32), and bf16x3 split each value into
//     three bf16 parts so the matrix unit's products with the 0/1 one-hot
//     were exact (:112-130). The split is exact, hi + mid + lo == v, and
//     the three products go into one float32 sum, so every mode's function
//     is the float32 segment sum of the values; here all three are that
//     scatter, in full FP32 on CUDA cores. (The one-hot product on the
//     tensor cores, nvcuda::wmma bf16 with the split, took 34 us at
//     m = 64 and 1865 us at m = 16384: 2 n m 48 flops for a scatter.)
//     A thread per point reads its 16 values (coalesced along each
//     column). Shared tables from n >= 256 m (m <= 512 at n = 131072),
//     layout c * m + id: neighbouring threads hold random ids, so their
//     shared atomics spread over the banks. Below, vector atomics into the
//     workspace and a transposing second kernel: two launches, no memset
//     (16 scalar atomics a point into a memset output took 2-3x as long;
//     H100 80GB HBM3, 700 W). Bound: bytes, n x 68 B in + 64 m B out
//     (~9 MB, ~2.7 us at 3.35 TB/s).
// K3  fused_moments16                d (n, 3), idx (n,) -> (m, 16)
//     replaces make_fused_moments (pallas_scatter_probe.py:155, call
//     :224), the TPU's one-hot contraction of the 10 moment columns
//     [d, outer6(d), 1] (plus 6 zero columns) on the matrix unit. A
//     dense contraction costs 2 n m 48 flops, which grows with m (1.8 ms
//     at m = 16384 when this kernel was one), so here a thread per point
//     reads its 12 bytes and its id, forms the 10 columns in registers and
//     scatters them: shared tables (layout c * m + id) from n >= 256 m,
//     else three vector atomics a point (float4, float4, float2) into the
//     output after a memset. The whole table in one cluster's distributed
//     shared memory, another design for that regime, took 0.46/0.44 ms at
//     m = 4096/16384 against 8.4/7.7 us (8 SMs of remote shared atomics;
//     H100 80GB HBM3, 700 W), and was dropped. No warp pre-aggregation for
//     m <= 32: each warp takes about one 32-point step, so a conflict
//     costs it a few serialised shared atomics once, less than a shuffle
//     reduction per distinct id (41-91 us at segsum_moments.cu's sz 8-32
//     levels). Bound: bytes, n x 16 B in, 64 m B out (~0.6-1.6 us).
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
//     Unordered. A thread per quarter row: at the probe's q = 8192,
//     m = 256, a memset and one float4 atomic a quarter row into the
//     output, 4 atomics a row, not 16. Table layout id * 16 + c where the
//     shared tables apply (q >= 256 m). Bound: bytes, as K4. At this size
//     the function is latency-bound: three one-launch designs without a
//     memset were slower (H100 80GB HBM3, 700 W): a cluster of 8 blocks
//     with shared tables stored once (9.1 us), one cluster that zeroes
//     the output, waits at the cluster barrier and then adds with float4
//     atomics (4.0-4.6), and blocks that own ids, zero their rows and add
//     the rows they list (4.6); this path took 3.3-3.4.

// K2, K3 and K5 sum in an order that changes from run to run (atomics);
// they match a float64 sum to float32 reassociation only. Their
// workspace (where a path needs one; <name>_workspace(n, m) doubles: a
// ticket word, padding, then the sums) is zeroed once by its owner and
// left zeroed by every call, so calls that share it must be ordered on
// one stream. K4 writes every entry of its output.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

namespace cg = cooperative_groups;

constexpr int NCOL = 16;
constexpr int THREADS = 256;             // round and transpose kernels
constexpr unsigned FULL_MASK = 0xffffffffu;

constexpr int SEG_THREADS = 512;         // scatter kernels
constexpr int SHARED_MAX_M = 2048;       // table rows; (16, m) float32 is 128 KB
constexpr int ROWS_PER_BLOCK_ID = 4;     // least points a block per table row
constexpr int F32_TERMS = 256;           // most terms of an entry a float32 sum takes
constexpr int CLUSTER = 8;               // blocks of a cluster (portable size)
constexpr int WS_HEAD = 2;               // workspace doubles before the sums
constexpr int LOADS_IN_FLIGHT = 8;       // K5's quarter rows a thread loads at once
constexpr int ROUND_BATCH = 8;           // sums a thread reads at once when it rounds
constexpr int MOM_COLS = 10;             // [d, outer6(d), 1]

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

__device__ __forceinline__ bool kept(int id, int m) { return id >= 0 && id < m; }

__device__ __forceinline__ void moment_row(const float* __restrict__ d, int p,
                                           float v[MOM_COLS]) {
  const float x = __ldg(d + 3 * p), y = __ldg(d + 3 * p + 1), z = __ldg(d + 3 * p + 2);
  v[0] = x; v[1] = y; v[2] = z;
  v[3] = x * x; v[4] = x * y; v[5] = x * z; v[6] = y * y; v[7] = y * z; v[8] = z * z;
  v[9] = 1.f;
}

// ------------------------------------------------------------ sources --
// A source holds the inputs and says, for the scatter core: how many
// values a point has (COLS), where value c of id sits in the table and in
// the workspace's sums (tab), which sum an output entry holds (tab_of_out,
// -1 for a zero column), whether the output is (m, 16) rows (OUT_ROWS),
// how its points are visited (for_each calls add(id, c, value) for every
// kept value) and how it adds (m, 16) rows with vector atomics (add_rows).

// K2: the (16, n) value columns, a thread per point; table, sums and
// output in the (16, m) layout.
struct ColsSrc {
  static constexpr int COLS = NCOL;
  static constexpr int LANES = 1;  // threads a point
  static constexpr bool OUT_ROWS = false;
  const float* v;
  int n;

  static __device__ __forceinline__ int tab(int id, int c, int m) { return c * m + id; }
  static __device__ __forceinline__ int tab_of_out(int e, int) { return e; }

  __device__ __forceinline__ void row(int p, float r[NCOL]) const {
#pragma unroll
    for (int c = 0; c < NCOL; ++c) r[c] = __ldg(v + static_cast<size_t>(c) * n + p);
  }

  template <class Add>
  __device__ __forceinline__ void for_each(const int32_t* __restrict__ idx, int m, Add add) const {
    const int stride = gridDim.x * blockDim.x;
    for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n; p += stride) {
      const int id = __ldg(idx + p);
      if (!kept(id, m)) continue;
      float r[NCOL];
      row(p, r);
#pragma unroll
      for (int c = 0; c < NCOL; ++c) add(id, c, r[c]);
    }
  }

  __device__ __forceinline__ void add_rows(const int32_t* __restrict__ idx, int m,
                                           float* __restrict__ rows) const {
    const int stride = gridDim.x * blockDim.x;
    for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n; p += stride) {
      const int id = __ldg(idx + p);
      if (!kept(id, m)) continue;
      float r[NCOL];
      row(p, r);
      float4* dst = reinterpret_cast<float4*>(rows + static_cast<size_t>(id) * NCOL);
#pragma unroll
      for (int q = 0; q < NCOL / 4; ++q)
        atomicAdd(dst + q, make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]));
    }
  }
};

// K3: the 10 moment columns of the (n, 3) points, a thread per point;
// table and sums (10, m), output (m, 16) with columns 10-15 zero.
struct MomSrc {
  static constexpr int COLS = MOM_COLS;
  static constexpr int LANES = 1;
  static constexpr bool OUT_ROWS = true;
  const float* d;
  int n;

  static __device__ __forceinline__ int tab(int id, int c, int m) { return c * m + id; }
  static __device__ __forceinline__ int tab_of_out(int e, int m) {
    const int c = e % NCOL;
    return c < COLS ? c * m + e / NCOL : -1;
  }

  template <class Add>
  __device__ __forceinline__ void for_each(const int32_t* __restrict__ idx, int m, Add add) const {
    const int stride = gridDim.x * blockDim.x;
    for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n; p += stride) {
      const int id = __ldg(idx + p);
      if (!kept(id, m)) continue;
      float r[COLS];
      moment_row(d, p, r);
#pragma unroll
      for (int c = 0; c < COLS; ++c) add(id, c, r[c]);
    }
  }

  // three vector atomics a point: float4, float4, float2
  __device__ __forceinline__ void add_rows(const int32_t* __restrict__ idx, int m,
                                           float* __restrict__ rows) const {
    const int stride = gridDim.x * blockDim.x;
    for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n; p += stride) {
      const int id = __ldg(idx + p);
      if (!kept(id, m)) continue;
      float r[COLS];
      moment_row(d, p, r);
      float* row = rows + static_cast<size_t>(id) * NCOL;
      atomicAdd(reinterpret_cast<float4*>(row), make_float4(r[0], r[1], r[2], r[3]));
      atomicAdd(reinterpret_cast<float4*>(row + 4), make_float4(r[4], r[5], r[6], r[7]));
      atomicAdd(reinterpret_cast<float2*>(row + 8), make_float2(r[8], r[9]));
    }
  }
};

// K5: the (n, 16) rows, a thread per quarter row; table, sums and output
// in the (m, 16) layout.
struct RowsSrc {
  static constexpr int COLS = NCOL;
  static constexpr int LANES = NCOL / 4;  // threads a row
  static constexpr bool OUT_ROWS = true;
  const float* v;
  int n;

  static __device__ __forceinline__ int tab(int id, int c, int) { return id * NCOL + c; }
  static __device__ __forceinline__ int tab_of_out(int e, int) { return e; }

  __device__ __forceinline__ float4 quarter(int t) const {  // any alignment
    const float* x = v + static_cast<size_t>(t) * 4;
    return make_float4(__ldg(x), __ldg(x + 1), __ldg(x + 2), __ldg(x + 3));
  }

  // The grid's stride is a multiple of 4, so a thread keeps its quarter.
  template <class Add>
  __device__ __forceinline__ void for_each(const int32_t* __restrict__ idx, int m, Add add) const {
    constexpr int U = LOADS_IN_FLIGHT;
    const int quads = n * LANES, stride = gridDim.x * blockDim.x;
    int t = blockIdx.x * blockDim.x + threadIdx.x;
    const int c0 = (t % LANES) * 4;
    auto add4 = [&](int id, float4 x) {
      add(id, c0, x.x);
      add(id, c0 + 1, x.y);
      add(id, c0 + 2, x.z);
      add(id, c0 + 3, x.w);
    };
    for (; t + (U - 1) * stride < quads; t += U * stride) {
      int id[U];
      float4 x[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        id[u] = __ldg(idx + (t + u * stride) / LANES);
        x[u] = quarter(t + u * stride);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (kept(id[u], m)) add4(id[u], x[u]);
    }
    for (; t < quads; t += stride) {
      const int id = __ldg(idx + t / LANES);
      if (kept(id, m)) add4(id, quarter(t));
    }
  }

  __device__ __forceinline__ void add_rows(const int32_t* __restrict__ idx, int m,
                                           float* __restrict__ rows) const {
    const int quads = n * LANES, stride = gridDim.x * blockDim.x;
    for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < quads; t += stride) {
      const int id = __ldg(idx + t / LANES);
      if (!kept(id, m)) continue;
      atomicAdd(reinterpret_cast<float4*>(rows + static_cast<size_t>(id) * NCOL) + t % LANES,
                quarter(t));
    }
  }
};

// ------------------------------------------------------ scatter core --
__device__ __forceinline__ void zero_table(float* tab, int tab_n) {
  for (int i = threadIdx.x; i < tab_n; i += blockDim.x) tab[i] = 0.f;
  __syncthreads();
}

// A workspace sum, read and cleared by the one thread that uses it.
__device__ __forceinline__ double take(double* s) {
  const double v = __ldcg(s);
  *s = 0.0;
  return v;
}

// The output entries e0, e0 + stride, ...: each the sum sum(t) of its
// table entry t, rounded once to float32, or 0 in a zero column;
// ROUND_BATCH sums in flight a thread.
template <class Src, class Sum>
__device__ __forceinline__ void write_out(int m, float* __restrict__ out, int e0, int stride,
                                          Sum sum) {
  constexpr int U = ROUND_BATCH;
  const int total = NCOL * m;
  for (int e = e0; e < total; e += U * stride) {
    double v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = e + u * stride < total ? Src::tab_of_out(e + u * stride, m) : -1;
      v[u] = t < 0 ? 0.0 : sum(t);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (e + u * stride < total) out[e + u * stride] = static_cast<float>(v[u]);
  }
}

// Shared tables: see the header.
template <class Src>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(SEG_THREADS)
shared_kernel(Src src, const int32_t* __restrict__ idx, int m, double* __restrict__ ws,
              float* __restrict__ out) {
  extern __shared__ float table[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tab_n = Src::COLS * m;
  zero_table(table, tab_n);
  src.for_each(idx, m, [&](int id, int c, float v) { atomicAdd(&table[Src::tab(id, c, m)], v); });
  cluster.sync();
  double* acc = ws + WS_HEAD;
  const int rank = static_cast<int>(cluster.block_rank());
  for (int i = rank * blockDim.x + threadIdx.x; i < tab_n; i += CLUSTER * blockDim.x) {
    double sum = 0.0;
#pragma unroll
    for (int j = 0; j < CLUSTER; ++j) sum += cluster.map_shared_rank(table, j)[i];
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
  write_out<Src>(m, out, threadIdx.x, blockDim.x, [&](int t) { return take(acc + t); });
  if (threadIdx.x == 0) *reinterpret_cast<unsigned*>(ws) = 0u;
}

// Double atomics into the workspace's sums; round_kernel then writes the
// output and clears them.
template <class Src>
__global__ void __launch_bounds__(SEG_THREADS)
double_kernel(Src src, const int32_t* __restrict__ idx, int m, double* __restrict__ ws) {
  double* acc = ws + WS_HEAD;
  src.for_each(idx, m, [&](int id, int c, float v) {
    atomicAdd(acc + Src::tab(id, c, m), static_cast<double>(v));
  });
}

template <class Src>
__global__ void round_kernel(double* __restrict__ ws, int m, float* __restrict__ out) {
  double* acc = ws + WS_HEAD;
  write_out<Src>(m, out, blockIdx.x * blockDim.x + threadIdx.x, gridDim.x * blockDim.x,
                 [&](int t) { return take(acc + t); });
}

// Vector atomics into zeroed (m, 16) rows.
template <class Src>
__global__ void __launch_bounds__(SEG_THREADS)
rows_kernel(Src src, const int32_t* __restrict__ idx, int m, float* __restrict__ rows) {
  src.add_rows(idx, m, rows);
}

// K2's float32 path: the (m, 16) rows summed in the workspace, written to
// the (16, m) output and cleared; a thread per quarter row, so reads and
// clears are coalesced and each store of a warp fills whole 32-byte
// sectors (8 neighbouring ids of 4 output rows).
__global__ void transpose_kernel(float* __restrict__ rows, int m, float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= m * (NCOL / 4)) return;
  const int id = t / 4, q = t % 4;
  float4* r = reinterpret_cast<float4*>(rows + static_cast<size_t>(id) * NCOL) + q;
  const float4 v = __ldcg(r);
  *r = make_float4(0.f, 0.f, 0.f, 0.f);
  float* o = out + static_cast<size_t>(4 * q) * m + id;
  o[0] = v.x;
  o[m] = v.y;
  o[2 * static_cast<size_t>(m)] = v.z;
  o[3 * static_cast<size_t>(m)] = v.w;
}

// -------------------------------------------- K4: in-order, spread out --
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

// ------------------------------------------------------------ launch --
cudaError_t configure() {
  static cudaError_t done = cudaErrorNotReady;
  if (done == cudaErrorNotReady) {
    const int f = static_cast<int>(sizeof(float));
    done = cudaFuncSetAttribute(shared_kernel<ColsSrc>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                ColsSrc::COLS * SHARED_MAX_M * f);
    if (done == cudaSuccess)
      done = cudaFuncSetAttribute(shared_kernel<MomSrc>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  MomSrc::COLS * SHARED_MAX_M * f);
    if (done == cudaSuccess)
      done = cudaFuncSetAttribute(shared_kernel<RowsSrc>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  RowsSrc::COLS * SHARED_MAX_M * f);
    if (done == cudaSuccess)
      done = cudaFuncSetAttribute(rmw_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(sizeof(RmwShared)));
  }
  return done;
}

// The scatter core's accumulator at (n rows, m ids): see the header.
enum class Path { kFloat32, kShared, kDouble };

template <class Src>
Path seg_path(int n, int m) {
  if (n / F32_TERMS >= m) return m <= SHARED_MAX_M ? Path::kShared : Path::kDouble;
  return Path::kFloat32;  // < 256 terms an entry
}

// Blocks of the shared-table path: about two an SM with enough points a
// table row in each, more where a block would sum over F32_TERMS terms of
// an entry, whole clusters.
int shared_blocks(int n, int m) {
  const int fill = std::min(2 * sm_count(), n / (ROWS_PER_BLOCK_ID * m));
  const int precise = (n + F32_TERMS * m - 1) / (F32_TERMS * m);
  const int want = std::max(1, std::max(fill, precise));
  return (want + CLUSTER - 1) / CLUSTER * CLUSTER;
}

template <class Src>
int workspace_doubles(int n, int m) {
  switch (seg_path<Src>(n, m)) {
    case Path::kShared:
    case Path::kDouble:
      return WS_HEAD + Src::COLS * m;
    case Path::kFloat32:
      return Src::OUT_ROWS ? 0 : WS_HEAD + NCOL * m / 2;  // (m, 16) float32 rows
  }
  return 0;
}

template <class Src>
int launch_segsum(const Src& src, const int32_t* idx, int n, int m, double* ws,
                  float* out, cudaStream_t s) {
  const cudaError_t cfg = configure();
  if (cfg != cudaSuccess) return static_cast<int>(cfg);
  const int sweep = std::max(1, std::min((n * Src::LANES + SEG_THREADS - 1) / SEG_THREADS,
                                         8 * sm_count()));
  switch (seg_path<Src>(n, m)) {
    case Path::kShared:
      shared_kernel<Src><<<shared_blocks(n, m), SEG_THREADS, Src::COLS * m * sizeof(float), s>>>(
          src, idx, m, ws, out);
      break;
    case Path::kDouble:
      double_kernel<Src><<<sweep, SEG_THREADS, 0, s>>>(src, idx, m, ws);
      round_kernel<Src><<<(NCOL * m + THREADS - 1) / THREADS, THREADS, 0, s>>>(ws, m, out);
      break;
    case Path::kFloat32:
      if constexpr (Src::OUT_ROWS) {
        const cudaError_t z =
            cudaMemsetAsync(out, 0, static_cast<size_t>(m) * NCOL * sizeof(float), s);
        if (z != cudaSuccess) return static_cast<int>(z);
        rows_kernel<Src><<<sweep, SEG_THREADS, 0, s>>>(src, idx, m, out);
      } else {
        float* rows = reinterpret_cast<float*>(ws + WS_HEAD);
        rows_kernel<Src><<<sweep, SEG_THREADS, 0, s>>>(src, idx, m, rows);
        transpose_kernel<<<(m * (NCOL / 4) + THREADS - 1) / THREADS, THREADS, 0, s>>>(rows, m, out);
      }
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain C interface for ctypes: (ids, values, n rows, m table rows,
// workspace, output, stream); n and m are at most 2^26, so every index
// below fits in an int. The workspace of K2, K3 and K5 is
// <name>_workspace(n, m) doubles, zeroed once by the caller and left
// zeroed by every call, null where that is 0; K4 takes none. Each
// returns the cudaGetLastError() code after the launches (0 = success).

int onehot_segsum16_workspace(int n, int m) { return workspace_doubles<ColsSrc>(n, m); }

int onehot_segsum16(const int32_t* idx, const float* vals_t, int n, int m,
                    double* workspace, float* out, void* stream) {
  return launch_segsum(ColsSrc{vals_t, n}, idx, n, m, workspace, out,
                       static_cast<cudaStream_t>(stream));
}

int fused_moments16_workspace(int n, int m) { return workspace_doubles<MomSrc>(n, m); }

int fused_moments16(const int32_t* idx, const float* d, int n, int m,
                    double* workspace, float* out, void* stream) {
  return launch_segsum(MomSrc{d, n}, idx, n, m, workspace, out,
                       static_cast<cudaStream_t>(stream));
}

int rmw_segsum16(const int32_t* idx, const float* vals, int q, int m,
                 double* /*workspace*/, float* out, void* stream) {
  const cudaError_t cfg = configure();
  if (cfg != cudaSuccess) return static_cast<int>(cfg);
  rmw_kernel<<<(m + RMW_IDS - 1) / RMW_IDS, RMW_THREADS, sizeof(RmwShared),
               static_cast<cudaStream_t>(stream)>>>(idx, vals, q, m, out);
  return static_cast<int>(cudaGetLastError());
}

int scatter_segsum16_workspace(int q, int m) { return workspace_doubles<RowsSrc>(q, m); }

int scatter_segsum16(const int32_t* idx, const float* vals, int q, int m,
                     double* workspace, float* out, void* stream) {
  return launch_segsum(RowsSrc{vals, q}, idx, q, m, workspace, out,
                       static_cast<cudaStream_t>(stream));
}

const char* madicp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
