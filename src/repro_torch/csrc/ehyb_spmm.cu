// Fused and ELL-only EHYB SpMM kernels for Hopper (sm_90a): the multi-rhs
// apply Y = A X, X of shape (n_pad, K), row-major, in the permuted space.
//
// Replaces the JAX package's Pallas TPU kernels of repro/kernels/ehyb_spmm.py
//   ehyb_fused_spmm        <- ehyb_fused_spmm_pallas (_ehyb_fused_spmm_kernel,
//                             _ell_sweep + _er_stage): uniform (V, W) tiles
//   ehyb_packed_fused_spmm <- ehyb_packed_fused_spmm_pallas
//                             (_ehyb_packed_fused_spmm_kernel): staircase
//   ehyb_ell_spmm          <- ehyb_ell_spmm_pallas: uniform tiles, no ER
//   ehyb_ell_packed_spmm   <- ehyb_ell_packed_spmm_pallas: staircase, no ER
// The ELL-only kernels take x_parts (P, V, K) and return y_parts (P, V, K),
// which is the same memory as (n_pad, K).
//
// What bounds them: device-memory bytes.  Each stored entry (a value of 4 or
// 2 bytes and a uint16 local column) is read once per rhs chunk and feeds
// 2 flops per rhs column: at K = 16 that is about 5 flops per byte of A,
// under the H100's fp32 ridge of 20 (67 TFLOP/s over 3.35 TB/s), while the
// bytes of X and Y grow with K.  The ER entries' X rows are gathered through
// L2 (X is about the size of L2 at K = 16).
//
// What the design does about it (the paper's mapping, one thread block per
// partition, as in csrc/ehyb_spmv.cu):
//   * the block sweeps the K columns in chunks of Kc; the wrapper picks Kc
//     so that the partition's (V, Kc) x tile in the table dtype and the
//     (V, Kc) fp32 output tile fit the block's shared memory, and Kc never
//     exceeds KC, the width of the per-thread register accumulator (a
//     template parameter: 4, 8, 16 or 32).  A plan sized for the batch
//     (ExecutionConfig.k) reads A once; on a plan sized for fewer columns
//     A is read once per chunk;
//   * per chunk the x tile is staged into shared memory once, so every
//     in-partition x read hits shared memory.  The output tile is stored
//     column by column, [j][v], so thread i's stores of row i fall on
//     neighbouring banks.  The x tile is stored row by row, [v][j]
//     (kXRowMajor), where Kc fills whole 16-byte chunks of a KC-wide row
//     (Kc = 4, 8, 16 or 32 in fp32; 8, 16 or 32 in bf16): an entry's Kc
//     values are then Kc * size / 16 16-byte loads, not Kc scalar ones,
//     and each row's chunks are swizzled by the row (chunk q of row v at
//     q ^ (v mod chunks)), so the random rows of a warp's entries spread
//     over the banks.  Other Kc keep the column-by-column [j][v] tile and
//     scalar loads.  On elasticity3d(64) at K = 16 the row-major tile took
//     #10 from 0.472 to 0.387 ms and #9 from 1.16 to 0.751 ms
//     (tools/ehyb_lane_sweep.py, H100 80GB HBM3, 700 W);
//   * ELL stage: thread per row.  The packed kernel takes row i's width
//     once, by a binary search over col_rows (non-increasing; in shared
//     memory beside the tiles when it fits), and reads column k's entry at
//     col_starts[p][k] + i (coalesced across a warp), kEllUnroll entries
//     in flight a thread and no data-dependent exit; the uniform kernel
//     reads its row of the (V, W) tile, strided;
//   * ER stage (HAS_ER): the compact ER stream (EHYBDevice.er_s_*), the
//     partition's live ER entries only, rows longest first.  A group of
//     er_group(KC) lanes takes one live row: lane (s, j) holds column
//     c0 + j and sums the row's entries s, s + S, ... (S = er_split(KC)
//     sub-groups), reading each (value, column) pair at the same address
//     as the group's other lanes and gathering X[col * K + c0 + j], so the
//     group's gathers are contiguous.  With kErGroupLanes = 4 no row is
//     split (S = 1 at every Kc): on the k = 1 plan at K = 16 (Kc = 4) a
//     split into 2, 4 or 8 sub-groups took #8 from 1.36 to 1.41, 1.56 and
//     1.93 ms (tools/ehyb_lane_sweep.py, H100 80GB HBM3, 700 W), so each
//     column's sum keeps one order whatever the chunk width.  Split
//     sub-groups' sums would meet in a fixed-order shuffle; lane (0, j) adds
//     the row's sum into the output tile with a plain add after the ELL
//     stage's barrier: no two live ER rows of a partition share a local
//     row (the host build checks it), so there are no atomics and two
//     launches give the same bits;
//   * the tile is written out once per chunk, in X's dtype;
//   * the CUDA source picks each block's size: whole warps enough for a
//     thread a row and a lane group an ER row, at most max_threads(KC,
//     PACKED): 1,024 for the packed kernels (512 at Kc > 16), 512 for the
//     uniform ones, as before.
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

constexpr int kEllUnroll = 4;      // packed ELL entries in flight a thread
constexpr int kErUnroll = 4;       // ER entries in flight a lane
constexpr int kErGroupLanes = 4;   // lanes of an ER row group at least
constexpr bool kXRowMajor = true;  // x tile [v][j] (true) or [j][v]

// Threads of a block at most.  32 accumulators a thread need more than the
// 64 registers a 1,024-thread block leaves; the uniform kernels' threads
// read their rows strided and lean on L1 (what shared memory leaves of it),
// which more rows in flight would thrash.
__host__ __device__ constexpr int max_threads(int KC, bool packed) {
  return KC >= 32 || !packed ? 512 : 1024;
}
// ER sub-groups a row (entries split S ways) and lanes of a row's group.
__host__ __device__ constexpr int er_split(int KC) {
  return KC >= kErGroupLanes ? 1 : kErGroupLanes / KC;
}
__host__ __device__ constexpr int er_group(int KC) {
  return KC * er_split(KC);
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

struct SpmmArgs {
  const void* x;          // (n_pad, K) row-major
  void* y;                // (n_pad, K)
  const void* vals;       // uniform (P, V, W) | packed (P, L)
  const uint16_t* cols;   // same shape, local columns
  const int* col_starts;  // packed only: (P, W + 1)
  const int* col_rows;    // packed only: (P, W), non-increasing along W
  const int* er_part_ptr; // the compact ER stream (HAS_ER), as ErStream
  const int* er_row_ptr;
  const int* er_rows;
  const int* er_cols;
  const void* er_vals;
  int V, W, L, K, Kc, n_er_rows, stage;
};

// The x tile's layout: element (v, j) of a chunk of kc <= KC columns.  VEC
// (kXRowMajor, Kc == KC and KC values fill whole 16-byte chunks): rows of
// KC values, chunk q of row v stored at chunk q ^ (v mod NQ).
template <typename T, int KC>
struct XTile {
  static constexpr int E = 16 / (int)sizeof(T);  // values a 16-byte chunk
  static constexpr int NQ = KC / E;              // chunks a row
  __device__ static int at(int v, int j, int V) {
    if constexpr (NQ >= 1) {
      const int q = (j / E) ^ (v & (NQ - 1));
      return v * KC + q * E + j % E;
    }
    return j * V + v;
  }
};

__device__ __forceinline__ void widen(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void widen(const uint4& u, float (&f)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    f[2 * m] = __uint_as_float(w[m] << 16);
    f[2 * m + 1] = __uint_as_float(w[m] & 0xffff0000u);
  }
}

// acc[j] += a * x[col][j] for the kc <= KC live columns of local row col.
template <typename T, int KC, bool VEC>
__device__ __forceinline__ void fma_x(float (&acc)[KC], float a, const T* xs,
                                      int col, int kc, int V) {
  if constexpr (VEC) {
    using X = XTile<T, KC>;
    const uint4* row = reinterpret_cast<const uint4*>(xs + (size_t)col * KC);
#pragma unroll
    for (int q = 0; q < X::NQ; ++q) {
      float f[X::E];
      widen(row[q ^ (col & (X::NQ - 1))], f);
#pragma unroll
      for (int t = 0; t < X::E; ++t) acc[q * X::E + t] += a * f[t];
    }
  } else {
#pragma unroll
    for (int j = 0; j < KC; ++j)
      if (j < kc) acc[j] += a * to_f(xs[(size_t)j * V + col]);
  }
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

// Row i's ELL sum on the packed staircase, to its width w.
template <typename T, int KC, bool VEC>
__device__ __forceinline__ void packed_row(float (&acc)[KC],
                                           const T* __restrict__ pv,
                                           const uint16_t* __restrict__ pc,
                                           const int* cs, const T* xs, int i,
                                           int w, int kc, int V) {
  int k = 0;
  for (; k + kEllUnroll <= w; k += kEllUnroll) {
    T v[kEllUnroll];
    uint16_t c[kEllUnroll];
#pragma unroll
    for (int u = 0; u < kEllUnroll; ++u) {
      const int off = cs[k + u] + i;
      v[u] = pv[off];
      c[u] = pc[off];
    }
#pragma unroll
    for (int u = 0; u < kEllUnroll; ++u)
      fma_x<T, KC, VEC>(acc, to_f(v[u]), xs, c[u], kc, V);
  }
  for (; k < w; ++k) {
    const int off = cs[k] + i;
    fma_x<T, KC, VEC>(acc, to_f(pv[off]), xs, pc[off], kc, V);
  }
}

// The partition's live ER rows, one er_group(KC)-lane group a row, each
// row's kc sums added into the output tile ys ([j][v]) at its local row.
template <typename T, int KC>
__device__ __forceinline__ void er_stage(float* ys, const T* __restrict__ x,
                                         const ErStream<T>& er, int p, int V,
                                         int K, int c0, int kc) {
  constexpr int S = er_split(KC), G = er_group(KC);
  const int lane = threadIdx.x % G;
  const int j = lane % KC, s = lane / KC;
  const int grp = threadIdx.x / G, ngrp = blockDim.x / G;
  const int r_begin = er.part_ptr[p], r_end = er.part_ptr[p + 1];
  const bool col = j < kc;
  const T* xc = x + c0 + j;
  for (int r0 = r_begin; r0 < r_end; r0 += ngrp) {  // uniform trip count
    const int r = r0 + grp;
    float acc = 0.f;
    if (r < r_end) {
      const int end = er.row_ptr[r + 1];
      int e = er.row_ptr[r] + s;
      for (; e + (kErUnroll - 1) * S < end; e += kErUnroll * S) {
        T v[kErUnroll];
        int c[kErUnroll];
        float xv[kErUnroll];
#pragma unroll
        for (int u = 0; u < kErUnroll; ++u) {
          v[u] = er.vals[e + u * S];
          c[u] = er.cols[e + u * S];
        }
#pragma unroll
        for (int u = 0; u < kErUnroll; ++u)
          xv[u] = col ? to_f(xc[(size_t)c[u] * K]) : 0.f;
#pragma unroll
        for (int u = 0; u < kErUnroll; ++u) acc += to_f(v[u]) * xv[u];
      }
      for (; e < end; e += S)
        acc += to_f(er.vals[e]) * (col ? to_f(xc[(size_t)er.cols[e] * K])
                                       : 0.f);
    }
#pragma unroll
    for (int off = G / 2; off >= KC; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off, G);
    if (s == 0 && col && r < r_end) ys[j * V + er.rows[r]] += acc;
  }
}

template <typename T, int KC, bool PACKED, bool HAS_ER, bool VEC>
__global__ void __launch_bounds__(max_threads(KC, PACKED))
    ehyb_spmm_kernel(SpmmArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int V = a.V, K = a.K, W = a.W;
  float* ys = reinterpret_cast<float*>(smem);
  T* xs = reinterpret_cast<T*>(smem + (size_t)V * a.Kc * sizeof(float));
  int* meta = reinterpret_cast<int*>(smem + (size_t)V * a.Kc *
                                                (sizeof(float) + sizeof(T)));
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);
  const int p = blockIdx.x;
  const size_t row0 = (size_t)p * V;
  const int* cr = nullptr;
  const int* cs = nullptr;
  if constexpr (PACKED) {
    cr = a.col_rows + (size_t)p * W;
    cs = a.col_starts + (size_t)p * (W + 1);
    if (a.stage) {
      for (int t = threadIdx.x; t < 2 * W + 1; t += blockDim.x)
        meta[t] = t < W ? cr[t] : cs[t - W];
      cr = meta;
      cs = meta + W;
    }
  }
  const ErStream<T> er{a.er_part_ptr, a.er_row_ptr, a.er_rows, a.er_cols,
                       static_cast<const T*>(a.er_vals)};

  for (int c0 = 0; c0 < K; c0 += a.Kc) {
    const int kc = min(a.Kc, K - c0);
    // x tile of this partition and chunk -> shared memory
    for (int t = threadIdx.x; t < V * kc; t += blockDim.x) {
      const int v = t / kc, j = t - v * kc;
      const int at = VEC ? XTile<T, KC>::at(v, j, V) : j * V + v;
      xs[at] = x[(row0 + v) * K + c0 + j];
    }
    __syncthreads();

    for (int i = threadIdx.x; i < V; i += blockDim.x) {
      float acc[KC];
#pragma unroll
      for (int j = 0; j < KC; ++j) acc[j] = 0.f;
      if constexpr (PACKED) {
        packed_row<T, KC, VEC>(acc, static_cast<const T*>(a.vals) +
                                        (size_t)p * a.L,
                               a.cols + (size_t)p * a.L, cs, xs, i,
                               row_width(cr, W, i), kc, V);
      } else {
        const size_t r = (row0 + i) * W;
        const T* vr = static_cast<const T*>(a.vals) + r;
        const uint16_t* cl = a.cols + r;
        for (int k = 0; k < W; ++k)
          fma_x<T, KC, VEC>(acc, to_f(vr[k]), xs, cl[k], kc, V);
      }
#pragma unroll
      for (int j = 0; j < KC; ++j)
        if (j < kc) ys[j * V + i] = acc[j];
    }
    __syncthreads();

    if constexpr (HAS_ER) {
      er_stage<T, KC>(ys, x, er, p, V, K, c0, kc);
      __syncthreads();
    }

    for (int t = threadIdx.x; t < V * kc; t += blockDim.x) {
      const int v = t / kc, j = t - v * kc;
      y[(row0 + v) * K + c0 + j] = from_f<T>(ys[j * V + v]);
    }
    __syncthreads();  // the next chunk reuses xs and ys
  }
}

// Threads of a block: whole warps enough for a thread a row and a lane
// group an ER row (n_er_rows bounds a partition's live ER rows), at most
// max_threads(KC, PACKED).
template <int KC, bool PACKED, bool HAS_ER>
int block_threads(int V, int n_er_rows) {
  long work = V;
  if (HAS_ER && (long)n_er_rows * er_group(KC) > work)
    work = (long)n_er_rows * er_group(KC);
  if (work > max_threads(KC, PACKED)) work = max_threads(KC, PACKED);
  return work < 32 ? 32 : (int)((work + 31) / 32 * 32);
}

template <typename T, int KC, bool PACKED, bool HAS_ER, bool VEC>
int launch_kc(const SpmmArgs& a, int P, cudaStream_t stream) {
  auto kernel = ehyb_spmm_kernel<T, KC, PACKED, HAS_ER, VEC>;
  const size_t smem = (size_t)a.V * a.Kc * (sizeof(float) + sizeof(T)) +
                      (PACKED && a.stage ? (size_t)(2 * a.W + 1) * 4 : 0);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<P, block_threads<KC, PACKED, HAS_ER>(a.V, a.n_er_rows), smem,
           stream>>>(a);
  return (int)cudaGetLastError();
}

// The x tile row by row where kXRowMajor asks for it and Kc fills whole
// 16-byte chunks of a KC-wide register accumulator, else column by column.
template <typename T, int KC, bool PACKED, bool HAS_ER>
int launch_layout(const SpmmArgs& a, int P, cudaStream_t stream) {
  if constexpr (kXRowMajor && KC * sizeof(T) % 16 == 0) {
    if (a.Kc == KC) return launch_kc<T, KC, PACKED, HAS_ER, true>(a, P, stream);
  }
  return launch_kc<T, KC, PACKED, HAS_ER, false>(a, P, stream);
}

// The narrowest register accumulator that holds Kc columns.
template <typename T, bool PACKED, bool HAS_ER>
int launch_t(const SpmmArgs& a, int P, cudaStream_t stream) {
  if (a.Kc < 1 || a.K < 1 || a.V < 1 || a.W < 0 || a.n_er_rows < 0)
    return (int)cudaErrorInvalidValue;
  if (a.Kc <= 4) return launch_layout<T, 4, PACKED, HAS_ER>(a, P, stream);
  if (a.Kc <= 8) return launch_layout<T, 8, PACKED, HAS_ER>(a, P, stream);
  if (a.Kc <= 16) return launch_layout<T, 16, PACKED, HAS_ER>(a, P, stream);
  if (a.Kc <= 32) return launch_layout<T, 32, PACKED, HAS_ER>(a, P, stream);
  return (int)cudaErrorInvalidValue;
}

template <bool PACKED, bool HAS_ER>
int launch(int dtype, const SpmmArgs& a, int P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_t<float, PACKED, HAS_ER>(a, P, s);
  if (dtype == 1) return launch_t<__nv_bfloat16, PACKED, HAS_ER>(a, P, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Kc: rhs columns per chunk (1..32).
// The ER stream as EHYBDevice.er_s_* (part_ptr, row_ptr, rows, cols, vals),
// n_er_rows its live ER rows; stage = 1 puts col_rows and col_starts in
// shared memory beside the tiles.  Returns a cudaError_t (0 = launched).
extern "C" int ehyb_fused_spmm(int dtype, const void* x, void* y,
                               const void* ell_vals, const void* ell_cols,
                               const void* er_part_ptr,
                               const void* er_row_ptr, const void* er_rows,
                               const void* er_cols, const void* er_vals,
                               int P, int V, int W, int n_er_rows, int K,
                               int Kc, void* stream) {
  SpmmArgs a{x, y, ell_vals, static_cast<const uint16_t*>(ell_cols), nullptr,
             nullptr, static_cast<const int*>(er_part_ptr),
             static_cast<const int*>(er_row_ptr),
             static_cast<const int*>(er_rows),
             static_cast<const int*>(er_cols), er_vals, V, W, 0, K, Kc,
             n_er_rows, 0};
  return launch<false, true>(dtype, a, P, stream);
}

extern "C" int ehyb_packed_fused_spmm(
    int dtype, const void* x, void* y, const void* packed_vals,
    const void* packed_cols, const void* col_starts, const void* col_rows,
    const void* er_part_ptr, const void* er_row_ptr, const void* er_rows,
    const void* er_cols, const void* er_vals, int P, int V, int L, int W,
    int n_er_rows, int K, int Kc, int stage, void* stream) {
  SpmmArgs a{x, y, packed_vals, static_cast<const uint16_t*>(packed_cols),
             static_cast<const int*>(col_starts),
             static_cast<const int*>(col_rows),
             static_cast<const int*>(er_part_ptr),
             static_cast<const int*>(er_row_ptr),
             static_cast<const int*>(er_rows),
             static_cast<const int*>(er_cols), er_vals, V, W, L, K, Kc,
             n_er_rows, stage};
  return launch<true, true>(dtype, a, P, stream);
}

extern "C" int ehyb_ell_spmm(int dtype, const void* x_parts, void* y_parts,
                             const void* ell_vals, const void* ell_cols, int P,
                             int V, int W, int K, int Kc, void* stream) {
  SpmmArgs a{x_parts, y_parts, ell_vals,
             static_cast<const uint16_t*>(ell_cols), nullptr, nullptr,
             nullptr, nullptr, nullptr, nullptr, nullptr, V, W, 0, K, Kc, 0,
             0};
  return launch<false, false>(dtype, a, P, stream);
}

extern "C" int ehyb_ell_packed_spmm(int dtype, const void* x_parts,
                                    void* y_parts, const void* packed_vals,
                                    const void* packed_cols,
                                    const void* col_starts,
                                    const void* col_rows, int P, int V, int L,
                                    int W, int K, int Kc, int stage,
                                    void* stream) {
  SpmmArgs a{x_parts, y_parts, packed_vals,
             static_cast<const uint16_t*>(packed_cols),
             static_cast<const int*>(col_starts),
             static_cast<const int*>(col_rows), nullptr, nullptr, nullptr,
             nullptr, nullptr, V, W, L, K, Kc, 0, stage};
  return launch<true, false>(dtype, a, P, stream);
}
