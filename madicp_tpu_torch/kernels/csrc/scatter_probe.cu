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
//       sums of ~2000 (K3's x*x column at m = 64) rounds only once.
// K3  fused_moments16                d (n, 3), idx (n,) -> (m, 16)
//     replaces make_fused_moments (pallas_scatter_probe.py:155, call
//     :224): K2's bf16x3 tensor-core core with the A tile formed in
//     registers from d as the 10 moment columns [d, outer6(d), 1] plus 6
//     zero columns. The same function as segsum_moments.cu, by another
//     design (dense contraction in f32 instead of a scatter in double).
//     Bound: bytes (n x 16 B in, 64 m B out); the design's own floor is
//     K2 bf16x3's tensor-core flops.
// K4  rmw_segsum16                   vals (q, 16), idx (q,) -> (m, 16)
//     replaces rmw_kernel (pallas_scatter_probe.py:365, call :375), the
//     TPU's serial in-order read-modify-write loop. One block holds the
//     table in shared memory (m <= 2048); rows are staged 512 at a time
//     (16-byte loads: `vals` must be 16-byte aligned),
//     and each table entry (id, c) is owned by one thread (column c, id
//     mod 16: two id classes a warp). A warp reads 32 staged ids at once,
//     ballots the rows it owns and walks just those, in order, so no
//     thread scans rows it does not own (scanning every row in every
//     thread took 0.39-0.50 ms at q = 8192). So every entry sums
//     its rows in row order in float32: bitwise equal to np.add.at. The
//     TPU indexed out-of-range ids with undefined results; here they
//     drop. Bound: bytes (~0.6 MB, ~0.2 us); in practice one SM's
//     serial walk: each warp visits q/8 rows, one dependent shared
//     read-modify-write each.
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
// and so must the double scratch of K2 (bf16x3) and K3, which write
// every entry of their output, as K4 does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>

namespace {

using namespace nvcuda;

constexpr int NCOL = 16;
constexpr int THREADS = 256;
constexpr size_t SCATTER_SMEM_MAX = 96 * 1024;  // shared table, m <= 1536
constexpr int SHARED_MIN_ROWS_PER_ID = 256;     // contention worth a table
constexpr size_t RMW_SMEM_MAX = 128 * 1024;     // rmw table, m <= 2048
constexpr int RMW_CHUNK = 512;                  // rows staged per step
constexpr int RMW_GROUPS = THREADS / NCOL;      // 16 id classes, 2 a warp
constexpr unsigned FULL_MASK = 0xffffffffu;

constexpr int WARPS = 4;                 // warps per block of the mma kernel
constexpr int TILES = 8;                 // 16-column tiles a warp accumulates
constexpr int GROUP_COLS = 16 * TILES;   // 128 output columns per warp
constexpr int KMIN_CHUNKS = 16;          // least 16-point chunks per warp

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

// ----------------------------------------------- K4: in-order RMW ------
__global__ void __launch_bounds__(THREADS)
rmw_kernel(const int32_t* __restrict__ idx, const float* __restrict__ vals,
           int q, int m, float* __restrict__ out) {
  extern __shared__ float tab[];
  __shared__ __align__(16) float stage[RMW_CHUNK * NCOL];
  __shared__ int ids[RMW_CHUNK];
  const int tab_n = NCOL * m;
  for (int i = threadIdx.x; i < tab_n; i += blockDim.x) tab[i] = 0.f;
  // lane l of warp w owns the entries (id, l % 16) with id % 16 == 2 w + l / 16
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = lane % NCOL, half = lane / NCOL;
  constexpr int VEC = RMW_CHUNK * NCOL / 4 / THREADS;  // float4 a thread
  constexpr int IDS = RMW_CHUNK / THREADS;              // ids a thread
  for (int base = 0; base < q; base += RMW_CHUNK) {
    const int rows = min(RMW_CHUNK, q - base);
    // every load of the chunk in flight at once, then one barrier: a
    // load-store loop waited out one memory latency per row group
    const float4* src = reinterpret_cast<const float4*>(vals) +
                        static_cast<size_t>(base) * (NCOL / 4);
    float4 v[VEC];
    int id_in[IDS];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int i = threadIdx.x + k * THREADS;
      v[k] = i < rows * (NCOL / 4) ? src[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < IDS; ++k) {
      const int r = threadIdx.x + k * THREADS;
      id_in[k] = r < rows ? idx[base + r] : -1;
    }
    __syncthreads();  // the table is zeroed, the previous chunk consumed
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      reinterpret_cast<float4*>(stage)[threadIdx.x + k * THREADS] = v[k];
#pragma unroll
    for (int k = 0; k < IDS; ++k) ids[threadIdx.x + k * THREADS] = id_in[k];
    __syncthreads();
    for (int r0 = 0; r0 < rows; r0 += 32) {  // the warp's rows, in order
      const int id = r0 + lane < rows ? ids[r0 + lane] : -1;
      unsigned todo = __ballot_sync(FULL_MASK, id >= 0 && id < m &&
                                                   (id % RMW_GROUPS) / 2 == warp);
      while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const int j = __shfl_sync(FULL_MASK, id, src);
        if (j % 2 == half) tab[j * NCOL + c] += stage[(r0 + src) * NCOL + c];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < tab_n; i += blockDim.x) out[i] = tab[i];
}

// ------------------------------------- K2 bf16x3 and K3: tensor cores --
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
template <bool MOMENTS>
__device__ __forceinline__ void fill_a(const float* __restrict__ src, int n,
                                       int k0, int lane, WarpTiles& t) {
  const int k = lane % 16, half = lane / 16, p = k0 + k;
  const bool in = p < n;
  float v[8];
  if (MOMENTS) {
    const float x = in ? src[3 * p + 0] : 0.f;
    const float y = in ? src[3 * p + 1] : 0.f;
    const float z = in ? src[3 * p + 2] : 0.f;
    if (half == 0) {
      v[0] = x; v[1] = y; v[2] = z; v[3] = x * x;
      v[4] = x * y; v[5] = x * z; v[6] = y * y; v[7] = y * z;
    } else {
      v[0] = z * z; v[1] = in ? 1.f : 0.f;
#pragma unroll
      for (int j = 2; j < 8; ++j) v[j] = 0.f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = in ? src[static_cast<size_t>(half * 8 + j) * n + p] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    __nv_bfloat16 part[3];
    split3(v[j], part);
    const int c = half * 8 + j;
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
// 16-point chunks; its partial sums go to `acc` (the output's layout, in
// double) by global atomics.
template <bool MOMENTS>
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
    fill_a<MOMENTS>(src, n, k0, lane, t);
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
        // coalesced in the output's fast axis: columns for (16, m),
        // value columns for (m, 16)
        const int ci = MOMENTS ? e % 16 : e / 16;
        const int j = MOMENTS ? e / 16 : e % 16;
        const int col = col0 + tt * 16 + j;
        const float v = t.c[ci * 16 + j];
        if (col < m && v != 0.f) {
          double* dst = MOMENTS ? acc64 + static_cast<size_t>(col) * NCOL + ci
                                : acc64 + static_cast<size_t>(ci) * m + col;
          atomicAdd(dst, static_cast<double>(v));
        }
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
                                  static_cast<int>(RMW_SMEM_MAX));
  }
  return done;
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

template <bool MOMENTS>
int launch_onehot(const int32_t* idx, const float* src, int n, int m,
                  double* scratch, float* out, cudaStream_t stream) {
  const int chunks = (n + 15) / 16;
  const int groups = (m + GROUP_COLS - 1) / GROUP_COLS;
  const int target_warps = 16 * sm_count();
  const int max_splits = std::max(1, (chunks + KMIN_CHUNKS - 1) / KMIN_CHUNKS);
  const int ksplits = std::max(1, std::min(max_splits, (target_warps + groups - 1) / groups));
  const int blocks = (groups * ksplits + WARPS - 1) / WARPS;
  onehot_mma_kernel<MOMENTS><<<blocks, WARPS * 32, 0, stream>>>(
      idx, src, n, m, groups, ksplits, scratch);
  const int total = NCOL * m;
  cast_kernel<<<(total + THREADS - 1) / THREADS, THREADS, 0, stream>>>(scratch, total, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain C interface for ctypes: (ids, values, n rows, m table rows,
// double scratch of 16 m entries, output, stream); n and m are at most
// 2^26, so every index below fits in an int. The scratch is used,
// and must be zeroed, by the tensor-core kernels only; the scatter
// kernels need a zeroed output instead. Returns the cudaGetLastError()
// code after the launches (0 = success).

int onehot_segsum16_f32(const int32_t* idx, const float* vals_t, int n, int m,
                        double* /*scratch*/, float* out, void* stream) {
  return launch_scatter<false>(idx, vals_t, n, m, out,
                               static_cast<cudaStream_t>(stream));
}

int onehot_segsum16_bf16x3(const int32_t* idx, const float* vals_t, int n,
                           int m, double* scratch, float* out, void* stream) {
  return launch_onehot<false>(idx, vals_t, n, m, scratch, out,
                              static_cast<cudaStream_t>(stream));
}

int fused_moments16(const int32_t* idx, const float* d, int n, int m,
                    double* scratch, float* out, void* stream) {
  return launch_onehot<true>(idx, d, n, m, scratch, out,
                             static_cast<cudaStream_t>(stream));
}

int rmw_segsum16(const int32_t* idx, const float* vals, int q, int m,
                 double* /*scratch*/, float* out, void* stream) {
  const cudaError_t cfg = configure();
  if (cfg != cudaSuccess) return static_cast<int>(cfg);
  const size_t tab_bytes = static_cast<size_t>(m) * NCOL * sizeof(float);
  if (tab_bytes > RMW_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  rmw_kernel<<<1, THREADS, tab_bytes, static_cast<cudaStream_t>(stream)>>>(
      idx, vals, q, m, out);
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
