// Fused EHYB SpMV kernels for Hopper (sm_90a): the paper's Algorithm 3.
//
// Replaces the JAX package's Pallas TPU kernels
//   ehyb_fused      <- repro/kernels/ehyb_spmv.py::ehyb_fused_pallas
//                      (_ehyb_fused_kernel + _er_stage): uniform (V, W) tiles
//   ehyb_packed_fused <- repro/kernels/ehyb_spmv.py::ehyb_packed_fused_pallas
//                      (_ehyb_packed_fused_kernel): packed staircase
//   ehyb_ell        <- repro/kernels/ehyb_spmv.py::ehyb_ell_pallas
//                      (_ehyb_ell_kernel): the uniform tiles' ELL part alone
//   ehyb_ell_packed <- repro/kernels/ehyb_spmv.py::ehyb_ell_packed_pallas
//                      (_ehyb_packed_kernel): the staircase's ELL part alone
//   er              <- repro/kernels/ehyb_spmv.py::er_pallas (_er_kernel):
//                      uncached ER rows -> per-slot partial sums
// The fused kernels compute y_new = A x_new in the permuted space for one
// right-hand side; the ELL-only ones (the guarded apply's unfused level)
// compute y_parts = A_in x_parts, partition by partition, and are the fused
// bodies with the ER stage compiled out (template flag ELL_ONLY): they write
// each row's sum straight to y and need no shared output tile.
//
// What bounds them: device-memory bytes.  Per stored entry the kernel reads a
// value (4 or 2 bytes) and a uint16 local column (ELL) or an int32 global
// column (ER) and does 2 flops, so an H100 (3.35 TB/s, 67 TFLOP/s fp32) is
// memory-bound by two orders of magnitude.  With one block per partition and
// one partition per SM, what sets the pace is the bytes each SM keeps in
// flight (Little's law: ~25 GB/s per SM at ~0.7 us of latency needs ~18 KB
// in flight) and the largest partition's bytes.
//
// What the design does about it (the paper's mapping, now on its own
// hardware):
//   * one thread block per partition; the partition's x-slice is staged into
//     shared memory with coalesced loads, so every in-partition x read hits
//     shared memory and x crosses device memory once;
//   * row widths: rows are width-sorted inside a partition, so col_rows[p][k]
//     (the rows holding an entry in ELL column k) is non-increasing and row
//     i's width is the number of k with col_rows[p][k] > i -- a binary search
//     once per row over col_rows, staged into shared memory with col_starts
//     when they fit beside the tiles (`stage`), read through L1 otherwise;
//     every container carries col_rows, so no kernel reads a padded tail;
//   * packed kernel: column k of partition p is a contiguous run of
//     col_rows[p][k] entries at col_starts[p][k]; thread i reads entry
//     col_starts[p][k] + i, so a warp reads 32 neighbouring values and
//     columns.  The column loop runs to the row's width with no data-
//     dependent exit and is unrolled by kPackedUnroll, so each thread keeps
//     that many independent (value, column) loads in flight;
//   * uniform kernel: a group of G = row_lanes lanes per row of the
//     row-major (V, W) tile; lane l reads columns l, l + G, ... up to the
//     row's width, kUnroll loads in flight a lane, and the group reduces
//     with shuffles in a fixed order;
//   * ER stage: the compact stream -- the partition's live ER entries only,
//     one row pointer and one local row per live ER row, rows in descending
//     length -- read by groups of kErLanes lanes per row: lanes stride the
//     row's entries (coalesced), gather x through L2, reduce with shuffles
//     in a fixed order, and the group's leader adds the row's sum into the
//     block's fp32 output tile with a plain add after the ELL stage's
//     barrier.  No two live ER rows of a partition share a local row (the
//     host build checks it), so there are no atomics; the tile is then
//     written out once, in x's dtype;
//   * group widths are fixed per body (measured on elasticity3d(64) by
//     tools/ehyb_lane_sweep.py): 4 lanes an ER row and a row of #1's tile,
//     whose rows are short enough that narrow groups keep more rows in
//     flight; 8 lanes a row of #4's tile, which has no ER stage beside it;
//     4 lanes a row of #6's ER table.  The launch takes whole warps enough
//     for the larger stage, at most 1024 threads;
//   * determinism: every sum runs in a fixed order, so two launches on the
//     same inputs give the same bits;
//   * ER kernel (standalone, no caller on the hot path): a group of
//     kErRowLanes lanes per row of the row-major (Rr, W) ER table.  The
//     build sorts the table's rows by descending live count and fills each
//     row's live entries as a prefix, so er_col_rows (the rows with more
//     than k live entries) gives each row's width by the same binary
//     search as col_rows; the lanes stride that prefix only (coalesced,
//     kErRowUnroll loads in flight), gather x through L2 and read each entry
//     once for up to 32 rhs columns held in registers.  The group sums
//     with shuffles in a fixed order -- no atomics, deterministic.  Its
//     bytes are the live entries' (plus a sector of tail a row and
//     array), not the padded table's.
// Accumulation is fp32 for fp32 and bf16 tables.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int kMaxThreads = 1024;
constexpr int kPackedUnroll = 8;  // packed ELL loads in flight per thread
constexpr int kUnroll = 4;        // loads in flight per lane of a row group
constexpr int kErLanes = 4;       // lanes of an ER row (#1, #2)
// lanes of a row of the uniform tiles: #1 (beside the ER stage) or #4
__host__ __device__ constexpr int row_lanes(bool ell_only) {
  return ell_only ? 8 : 4;
}

// The compact ER stream of the partitions (EHYBDevice.er_s_*).
template <typename T>
struct ErStream {
  const int* part_ptr;  // (P+1,) rows of partition p: [part_ptr[p], [p+1])
  const int* row_ptr;   // (Rlive+1,) entries of row r
  const int* rows;      // (Rlive,) local row of row r
  const int* cols;      // (nnz_er,) global columns
  const T* vals;        // (nnz_er,)
};

// Shared memory of a block: the fp32 y tile [V] unless ELL_ONLY, the
// x-slice [V] in the table dtype, then (when staged) the int metadata:
// col_rows [W], then col_starts [W+1] for the packed kernel.
template <bool ELL_ONLY>
__host__ __device__ constexpr size_t tile_bytes(int V) {
  return ELL_ONLY ? 0 : (size_t)V * sizeof(float);
}
template <typename T, bool ELL_ONLY>
__host__ __device__ constexpr size_t smem_bytes(int V) {
  return tile_bytes<ELL_ONLY>(V) + (size_t)V * sizeof(T);
}

template <typename T>
__device__ __forceinline__ void stage_x_slice(const T* __restrict__ x, T* xs,
                                              int p, int V) {
  const T* src = x + (size_t)p * V;
  for (int j = threadIdx.x; j < V; j += blockDim.x) xs[j] = src[j];
}

__device__ __forceinline__ void stage_ints(int* dst,
                                           const int* __restrict__ src,
                                           int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) dst[j] = src[j];
}

// Row i's width: the number of k with cr[k] > i (cr non-increasing).
__device__ __forceinline__ int row_width(const int* cr, int W, int i) {
  int lo = 0, hi = W;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cr[mid] > i)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Sum over the G lanes of a group (G divides 32), in a fixed order; lane 0
// of the group holds the result.  Every lane of the warp must call it.
template <int G>
__device__ __forceinline__ float group_sum(float acc) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off, G);
  return acc;
}

// Row i's ELL sum: to y directly (ELL_ONLY), else to the shared tile.
template <typename T, bool ELL_ONLY>
__device__ __forceinline__ void put_row(T* __restrict__ y, float* ys, int p,
                                        int V, int i, float acc) {
  if constexpr (ELL_ONLY)
    y[(size_t)p * V + i] = from_f<T>(acc);
  else
    ys[i] = acc;
}

// One lane's share of a row of the row-major tile: columns lane, lane + G,
// ... below w, kUnroll independent loads at a time.
template <typename T, int G>
__device__ __forceinline__ float uniform_row(const T* __restrict__ vr,
                                             const uint16_t* __restrict__ cr,
                                             const T* xs, int w, int lane) {
  float acc = 0.f;
  int k = lane;
  for (; k + (kUnroll - 1) * G < w; k += kUnroll * G) {
    T v[kUnroll];
    uint16_t c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = vr[k + u * G];
      c[u] = cr[k + u * G];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc += to_f(v[u]) * to_f(xs[c[u]]);
  }
  for (; k < w; k += G) acc += to_f(vr[k]) * to_f(xs[cr[k]]);
  return acc;
}

// The partition's live ER rows from the compact stream, kErLanes lanes a
// row, each row's sum added into the shared y tile at its local row (called
// after the ELL stage has written every row of ys; local rows are distinct).
template <typename T>
__device__ __forceinline__ void er_stage(float* ys, const T* __restrict__ x,
                                         const ErStream<T>& er, int p) {
  constexpr int G = kErLanes;
  const int lane = threadIdx.x & (G - 1);
  const int grp = threadIdx.x / G;
  const int ngrp = blockDim.x / G;
  const int r_begin = er.part_ptr[p], r_end = er.part_ptr[p + 1];
  for (int r0 = r_begin; r0 < r_end; r0 += ngrp) {  // uniform trip count
    const int r = r0 + grp;
    float acc = 0.f;
    if (r < r_end) {
      const int end = er.row_ptr[r + 1];
      int j = er.row_ptr[r] + lane;
      for (; j + (kUnroll - 1) * G < end; j += kUnroll * G) {
        T v[kUnroll];
        int c[kUnroll];
        float xv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          v[u] = er.vals[j + u * G];
          c[u] = er.cols[j + u * G];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) xv[u] = to_f(x[c[u]]);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc += to_f(v[u]) * xv[u];
      }
      for (; j < end; j += G) acc += to_f(er.vals[j]) * to_f(x[er.cols[j]]);
    }
    acc = group_sum<G>(acc);
    if (lane == 0 && r < r_end) ys[er.rows[r]] += acc;
  }
}

template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ y, const float* ys,
                                           int p, int V) {
  T* dst = y + (size_t)p * V;
  for (int j = threadIdx.x; j < V; j += blockDim.x) dst[j] = from_f<T>(ys[j]);
}

// The ER stage and the tile's store (the fused kernels' common end).
template <typename T>
__device__ __forceinline__ void finish(T* __restrict__ y, float* ys,
                                       const T* __restrict__ x,
                                       const ErStream<T>& er, int p, int V,
                                       int has_er) {
  __syncthreads();
  if (has_er) {
    er_stage<T>(ys, x, er, p);
    __syncthreads();
  }
  store_tile(y, ys, p, V);
}

// Uniform tiles: row_lanes(ELL_ONLY) lanes per row, each row read to its
// width from col_rows.
template <typename T, bool ELL_ONLY>
__global__ void __launch_bounds__(kMaxThreads) ehyb_fused_kernel(
    const T* __restrict__ x, T* __restrict__ y, const T* __restrict__ ell_vals,
    const uint16_t* __restrict__ ell_cols, const int* __restrict__ col_rows,
    ErStream<T> er, int V, int W, int has_er, int stage) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ys = reinterpret_cast<float*>(smem);
  T* xs = reinterpret_cast<T*>(smem + tile_bytes<ELL_ONLY>(V));
  int* meta = reinterpret_cast<int*>(smem + smem_bytes<T, ELL_ONLY>(V));
  const int p = blockIdx.x;
  stage_x_slice(x, xs, p, V);
  const int* cr = col_rows + (size_t)p * W;
  if (stage) {
    stage_ints(meta, cr, W);
    cr = meta;
  }
  __syncthreads();
  constexpr int G = row_lanes(ELL_ONLY);
  const int lane = threadIdx.x & (G - 1);
  const int grp = threadIdx.x / G;
  const int ngrp = blockDim.x / G;
  const size_t tile = (size_t)p * V * W;
  for (int i0 = 0; i0 < V; i0 += ngrp) {  // uniform trip count
    const int i = i0 + grp;
    float acc = 0.f;
    if (i < V) {
      const int w = row_width(cr, W, i);
      acc = uniform_row<T, G>(ell_vals + tile + (size_t)i * W,
                              ell_cols + tile + (size_t)i * W, xs, w, lane);
    }
    acc = group_sum<G>(acc);
    if (lane == 0 && i < V) put_row<T, ELL_ONLY>(y, ys, p, V, i, acc);
  }
  if constexpr (!ELL_ONLY) finish<T>(y, ys, x, er, p, V, has_er);
}

// Packed staircase: a thread per row; kErLanes lanes per ER row.
template <typename T, bool ELL_ONLY>
__global__ void __launch_bounds__(kMaxThreads) ehyb_packed_fused_kernel(
    const T* __restrict__ x, T* __restrict__ y,
    const T* __restrict__ packed_vals, const uint16_t* __restrict__ packed_cols,
    const int* __restrict__ col_starts, const int* __restrict__ col_rows,
    ErStream<T> er, int V, int L, int W, int has_er, int stage) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ys = reinterpret_cast<float*>(smem);
  T* xs = reinterpret_cast<T*>(smem + tile_bytes<ELL_ONLY>(V));
  int* meta = reinterpret_cast<int*>(smem + smem_bytes<T, ELL_ONLY>(V));
  const int p = blockIdx.x;
  stage_x_slice(x, xs, p, V);
  const int* cr = col_rows + (size_t)p * W;
  const int* cs = col_starts + (size_t)p * (W + 1);
  if (stage) {
    stage_ints(meta, cr, W);
    stage_ints(meta + W, cs, W + 1);
    cr = meta;
    cs = meta + W;
  }
  __syncthreads();
  const T* pv = packed_vals + (size_t)p * L;
  const uint16_t* pc = packed_cols + (size_t)p * L;
  for (int i = threadIdx.x; i < V; i += blockDim.x) {
    const int w = row_width(cr, W, i);
    float acc = 0.f;
    int k = 0;
    for (; k + kPackedUnroll <= w; k += kPackedUnroll) {
      T v[kPackedUnroll];
      uint16_t c[kPackedUnroll];
#pragma unroll
      for (int u = 0; u < kPackedUnroll; ++u) {
        const int off = cs[k + u] + i;
        v[u] = pv[off];
        c[u] = pc[off];
      }
#pragma unroll
      for (int u = 0; u < kPackedUnroll; ++u)
        acc += to_f(v[u]) * to_f(xs[c[u]]);
    }
    for (; k < w; ++k) {
      const int off = cs[k] + i;
      acc += to_f(pv[off]) * to_f(xs[pc[off]]);
    }
    put_row<T, ELL_ONLY>(y, ys, p, V, i, acc);
  }
  if constexpr (!ELL_ONLY) finish<T>(y, ys, x, er, p, V, has_er);
}

constexpr int kErRowLanes = 4;    // #6: lanes of a row of the ER table
constexpr int kErRowUnroll = 4;   // #6: entries in flight a lane
constexpr int kErThreads = 256;   // #6: threads of a block
constexpr int kErStageMax = 4096; // #6: er_col_rows staged up to this W

// Row e's partials for columns c0 .. c0 + RC - 1 of R: out[e * R + c] =
// sum over the row's live prefix (k < w) of er_vals[e][k] *
// x[er_cols[e][k] * R + c].  The G lanes of the row's group stride the
// prefix (coalesced: it is contiguous in the row-major table), kErRowUnroll
// entries in flight a lane, each entry's value and column read once for
// the RC columns; the group sums with an xor butterfly, which leaves the
// same bits on every lane, and lane j % G writes column c0 + j.
template <typename T, int RC>
__device__ __forceinline__ void er_row(const T* __restrict__ x,
                                       T* __restrict__ out,
                                       const T* __restrict__ vr,
                                       const int* __restrict__ cr, int w,
                                       int lane, int e, bool live, int R,
                                       int c0) {
  constexpr int G = kErRowLanes;
  const int rc = min(RC, R - c0);
  const T* xc = x + c0;
  float acc[RC];
#pragma unroll
  for (int j = 0; j < RC; ++j) acc[j] = 0.f;
  constexpr int U = kErRowUnroll;
  int k = lane;
  for (; k + (U - 1) * G < w; k += U * G) {
    T v[U];
    int c[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      v[u] = vr[k + u * G];
      c[u] = cr[k + u * G];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const T* xr = xc + (size_t)c[u] * R;
#pragma unroll
      for (int j = 0; j < RC; ++j)
        if (j < rc) acc[j] += to_f(v[u]) * to_f(xr[j]);
    }
  }
  for (; k < w; k += G) {
    const float a = to_f(vr[k]);
    const T* xr = xc + (size_t)cr[k] * R;
#pragma unroll
    for (int j = 0; j < RC; ++j)
      if (j < rc) acc[j] += a * to_f(xr[j]);
  }
#pragma unroll
  for (int j = 0; j < RC; ++j) {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off, G);
    if (live && j < rc && (j & (G - 1)) == lane)
      out[(size_t)e * R + c0 + j] = from_f<T>(acc[j]);
  }
}

// #6: a group of kErRowLanes lanes per row of the (Rr, W) table; the row's
// live width from a binary search over er_col_rows (non-increasing, the ER
// rows with more than k live entries), staged in shared memory when W <=
// kErStageMax.  Rows past the live count, and the sublane padding rows,
// have width 0 and write 0.  Every lane of a warp runs the shuffles, rows
// past Rr included (they write nothing).
template <typename T, int RC>
__global__ void __launch_bounds__(kErThreads) er_kernel(
    const T* __restrict__ x, T* __restrict__ out,
    const T* __restrict__ er_vals, const int* __restrict__ er_cols,
    const int* __restrict__ er_col_rows, int Rr, int W, int R) {
  extern __shared__ int ecr_s[];
  const int* ecr = er_col_rows;
  if (W <= kErStageMax) {
    stage_ints(ecr_s, er_col_rows, W);
    ecr = ecr_s;
  }
  __syncthreads();
  constexpr int G = kErRowLanes;
  const int lane = threadIdx.x & (G - 1);
  const int e = blockIdx.x * (kErThreads / G) + threadIdx.x / G;
  const bool live = e < Rr;
  const int w = live ? row_width(ecr, W, e) : 0;
  const T* vr = er_vals + (size_t)(live ? e : 0) * W;
  const int* cr = er_cols + (size_t)(live ? e : 0) * W;
  for (int c0 = 0; c0 < R; c0 += RC)
    er_row<T, RC>(x, out, vr, cr, w, lane, e, live, R, c0);
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// Everything a launch of the SpMV bodies takes; the ER stream and
// col_starts are unused where a body does not read them.
template <typename T>
struct Args {
  const T* x;
  T* y;
  const T* vals;          // (P, V, W) tiles or (P, L) staircase
  const uint16_t* cols;
  const int* col_starts;  // packed only
  const int* col_rows;    // (P, W)
  ErStream<T> er;
  int P, V, L, W, n_er_rows, has_er, stage;
  cudaStream_t stream;
};

// Threads of a block: whole warps enough for the larger stage (a thread or
// a lane group a row, a lane group an ER row; n_er_rows bounds a
// partition's live ER rows), at most kMaxThreads.
template <bool PACKED, bool ELL_ONLY>
int block_threads(int V, int n_er_rows, int has_er) {
  long work = PACKED ? V : (long)V * row_lanes(ELL_ONLY);
  if (!ELL_ONLY && has_er) {
    const long er_work = (long)n_er_rows * kErLanes;
    if (er_work > work) work = er_work;
  }
  if (work > kMaxThreads) work = kMaxThreads;
  return work < 32 ? 32 : (int)((work + 31) / 32 * 32);
}

template <typename T, bool PACKED, bool ELL_ONLY>
int launch(const Args<T>& a) {
  if (a.P < 1 || a.V < 1 || a.W < 0 || a.n_er_rows < 0)
    return (int)cudaErrorInvalidValue;
  const int threads = block_threads<PACKED, ELL_ONLY>(a.V, a.n_er_rows,
                                                      a.has_er);
  const int n_meta = a.stage ? (PACKED ? 2 * a.W + 1 : a.W) : 0;
  const size_t smem = smem_bytes<T, ELL_ONLY>(a.V) + (size_t)n_meta * 4;
  if constexpr (PACKED) {
    auto kernel = ehyb_packed_fused_kernel<T, ELL_ONLY>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<a.P, threads, smem, a.stream>>>(
        a.x, a.y, a.vals, a.cols, a.col_starts, a.col_rows, a.er, a.V, a.L,
        a.W, a.has_er, a.stage);
  } else {
    auto kernel = ehyb_fused_kernel<T, ELL_ONLY>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<a.P, threads, smem, a.stream>>>(a.x, a.y, a.vals, a.cols,
                                             a.col_rows, a.er, a.V, a.W,
                                             a.has_er, a.stage);
  }
  return (int)cudaGetLastError();
}

template <bool PACKED, bool ELL_ONLY, typename T>
int run(const void* x, void* y, const void* vals, const void* cols,
        const void* col_starts, const void* col_rows, const void* const* er,
        int P, int V, int L, int W, int n_er_rows, int has_er, int stage,
        void* stream) {
  const ErStream<T> s{
      er ? static_cast<const int*>(er[0]) : nullptr,
      er ? static_cast<const int*>(er[1]) : nullptr,
      er ? static_cast<const int*>(er[2]) : nullptr,
      er ? static_cast<const int*>(er[3]) : nullptr,
      er ? static_cast<const T*>(er[4]) : nullptr};
  Args<T> a{static_cast<const T*>(x),
            static_cast<T*>(y),
            static_cast<const T*>(vals),
            static_cast<const uint16_t*>(cols),
            static_cast<const int*>(col_starts),
            static_cast<const int*>(col_rows),
            s,
            P, V, L, W, n_er_rows, has_er, stage,
            static_cast<cudaStream_t>(stream)};
  return launch<T, PACKED, ELL_ONLY>(a);
}

// The body's instance for the table dtype (0 = float32, 1 = bfloat16).
// `er` points at the five ER stream pointers, or is null (ELL-only).
template <bool PACKED, bool ELL_ONLY>
int run_dtype(int dtype, const void* x, void* y, const void* vals,
              const void* cols, const void* col_starts, const void* col_rows,
              const void* const* er, int P, int V, int L, int W,
              int n_er_rows, int has_er, int stage, void* stream) {
  if (dtype == 0)
    return run<PACKED, ELL_ONLY, float>(x, y, vals, cols, col_starts,
                                        col_rows, er, P, V, L, W, n_er_rows,
                                        has_er, stage, stream);
  if (dtype == 1)
    return run<PACKED, ELL_ONLY, __nv_bfloat16>(
        x, y, vals, cols, col_starts, col_rows, er, P, V, L, W, n_er_rows,
        has_er, stage, stream);
  return (int)cudaErrorInvalidValue;
}

// The narrowest register accumulator that holds min(R, 32) columns; wider
// R runs in chunks of 32, each chunk re-reading the row's prefix.
template <typename T>
int launch_er(const void* x, void* out, const void* er_vals,
              const void* er_cols, const void* er_col_rows, int Rr, int W,
              int R, cudaStream_t stream) {
  if (Rr < 1 || W < 1 || R < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (Rr + kErThreads / kErRowLanes - 1) /
                     (kErThreads / kErRowLanes);
  const size_t smem = W <= kErStageMax ? (size_t)W * sizeof(int) : 0;
  auto args = [&](auto kernel) {
    kernel<<<blocks, kErThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out),
        static_cast<const T*>(er_vals), static_cast<const int*>(er_cols),
        static_cast<const int*>(er_col_rows), Rr, W, R);
    return (int)cudaGetLastError();
  };
  if (R == 1) return args(er_kernel<T, 1>);
  if (R <= 4) return args(er_kernel<T, 4>);
  if (R <= 8) return args(er_kernel<T, 8>);
  if (R <= 16) return args(er_kernel<T, 16>);
  return args(er_kernel<T, 32>);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
// x, y (n_pad,) in the permuted space; col_rows (P, W) the rows of each
// ELL column; the ER stream as EHYBDevice.er_s_*, with n_er_rows its live
// ER rows; stage = 1 puts col_rows (and col_starts) in shared memory
// beside the tiles.  Each body picks its block size itself.
extern "C" int ehyb_fused(int dtype, const void* x, void* y,
                          const void* ell_vals, const void* ell_cols,
                          const void* col_rows, const void* er_part_ptr,
                          const void* er_row_ptr, const void* er_rows,
                          const void* er_cols, const void* er_vals, int P,
                          int V, int W, int n_er_rows, int has_er, int stage,
                          void* stream) {
  const void* er[5] = {er_part_ptr, er_row_ptr, er_rows, er_cols, er_vals};
  return run_dtype<false, false>(dtype, x, y, ell_vals, ell_cols, nullptr,
                                 col_rows, er, P, V, 0, W, n_er_rows, has_er,
                                 stage, stream);
}

extern "C" int ehyb_packed_fused(int dtype, const void* x, void* y,
                                 const void* packed_vals,
                                 const void* packed_cols,
                                 const void* col_starts, const void* col_rows,
                                 const void* er_part_ptr,
                                 const void* er_row_ptr, const void* er_rows,
                                 const void* er_cols, const void* er_vals,
                                 int P, int V, int L, int W, int n_er_rows,
                                 int has_er, int stage, void* stream) {
  const void* er[5] = {er_part_ptr, er_row_ptr, er_rows, er_cols, er_vals};
  return run_dtype<true, false>(dtype, x, y, packed_vals, packed_cols,
                                col_starts, col_rows, er, P, V, L, W,
                                n_er_rows, has_er, stage, stream);
}

// ELL-only instances: x_parts, y_parts (P, V) contiguous, one rhs.
extern "C" int ehyb_ell(int dtype, const void* x_parts, void* y_parts,
                        const void* ell_vals, const void* ell_cols,
                        const void* col_rows, int P, int V, int W, int stage,
                        void* stream) {
  return run_dtype<false, true>(dtype, x_parts, y_parts, ell_vals, ell_cols,
                                nullptr, col_rows, nullptr, P, V, 0, W, 0, 0,
                                stage, stream);
}

extern "C" int ehyb_ell_packed(int dtype, const void* x_parts, void* y_parts,
                               const void* packed_vals,
                               const void* packed_cols,
                               const void* col_starts, const void* col_rows,
                               int P, int V, int L, int W, int stage,
                               void* stream) {
  return run_dtype<true, true>(dtype, x_parts, y_parts, packed_vals,
                               packed_cols, col_starts, col_rows, nullptr, P,
                               V, L, W, 0, 0, stage, stream);
}

// ER partials: x (n_pad, R) and out (Rr, R) row-major; er_vals, er_cols
// (Rr, W) row-major, int32 global columns; er_col_rows (W,) the rows with
// more than k live entries (EHYBDevice.er_col_rows).  Only each row's live
// prefix is read.
extern "C" int er(int dtype, const void* x, void* out, const void* er_vals,
                  const void* er_cols, const void* er_col_rows, int Rr, int W,
                  int R, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_er<float>(x, out, er_vals, er_cols, er_col_rows, Rr, W, R,
                            s);
  if (dtype == 1)
    return launch_er<__nv_bfloat16>(x, out, er_vals, er_cols, er_col_rows,
                                    Rr, W, R, s);
  return (int)cudaErrorInvalidValue;
}
