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
//     A is read once per chunk.  The uniform ELL-only kernel holds no
//     output tile (it writes each row's sums straight to y), so at the same
//     Kc its block holds half the shared memory: on the k = 16 plan (V =
//     1,504, Kc = 16, fp32) 96 KB against 192.5 KB, the rest left to L1
//     (two blocks an SM would fit it, at 512 threads: min_blocks);
//   * per chunk the x tile is staged into shared memory once, so every
//     in-partition x read hits shared memory.  The output tile is stored
//     column by column, [j][v], so the packed kernels' thread i's stores
//     of row i fall on neighbouring banks (a uniform lane group's lanes
//     store columns of one row: one bank when V is a multiple of 32).
//     The x tile is stored row by row, [v][j] (kXRowMajor), where Kc
//     fills whole 16-byte chunks of a KC-wide row (Kc = 4, 8, 16 or 32
//     in fp32; 8, 16 or 32 in bf16): an entry's Kc
//     values are then Kc * size / 16 16-byte loads, not Kc scalar ones,
//     and each row's chunks are swizzled by the row (chunk q of row v at
//     q ^ (v mod chunks)), so the random rows of a warp's entries spread
//     over the banks.  Other Kc keep the column-by-column [j][v] tile and
//     scalar loads.  On elasticity3d(64) at K = 16 the row-major tile took
//     #10 from 0.472 to 0.387 ms and #9 from 1.16 to 0.751 ms
//     (tools/ehyb_lane_sweep.py, H100 80GB HBM3, 700 W);
//   * row widths: every kernel takes row i's width by a binary search over
//     col_rows (non-increasing; in shared memory beside the tiles when it
//     fits) and reads no slot at or past it, so a padded slot (value 0,
//     column 0) is never read: neither its bytes nor a non-finite x[0];
//   * ELL stage, packed: a thread per row reads column k's entry at
//     col_starts[p][k] + i (coalesced across a warp), kEllUnroll entries
//     in flight a thread and no data-dependent exit;
//   * ELL stage, uniform: a group of kUniformLanes (G) lanes per row of
//     the row-major (V, W) tile.  Lane l reads entries l, l + G, ... below
//     the row's width, kUniformUnroll (value, column) pairs in flight, so
//     a warp reads 32 / G rows a load, each as one contiguous run of G
//     values and G columns (a thread a row would read 32 rows W entries
//     apart: 32 sectors a load, most of each waiting in L1, which the
//     tiles leave ~30 KB of).  Each lane sums its entries
//     into its KC-wide register accumulator with the x tile's 16-byte
//     loads; the group then reduce-scatters its KC partials by shuffles in
//     a fixed order (KC/2 + KC/4 + ... a lane, not KC log2 G), and lane l
//     writes the sums of columns [l KC/G, (l + 1) KC/G) (of column l / (G
//     / KC) when KC < G): into the output tile (fused kernel) or straight
//     to y (ELL-only kernel).  On elasticity3d(64) at K = 16 the live
//     entries are 46.0M of the tile's 64.3M slots;
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
//     thread (packed) or kUniformLanes lanes (uniform) a row and a lane
//     group an ER row, at most max_threads(KC, PACKED): 1,024 (512 at
//     Kc > 16);
//   * the uniform kernels' constants are tools/ehyb_lane_sweep.py --sweep
//     spmm's pick on elasticity3d(64) at K = 16 (H100 80GB HBM3, 700 W):
//     4 lanes a row, 4 entries in flight a lane, 1,024 threads.  On the
//     k = 16 plan (fp32) #9 took 0.307 ms with 4 lanes against 0.342 (2),
//     0.381 (8), 0.445 (16) and 0.417 with a thread a row read to its
//     width, and #7 0.736 against 0.763, 0.803, 0.862 and 0.909; 512
//     threads with two blocks an SM gave #9 0.304 but #7 1.131 (its tiles
//     hold the SM alone), and on the k = 1 plan (132 blocks, one an SM)
//     #9 1.068 against 0.858; 8 entries in flight gave #9 0.313 and #7
//     0.754 (on the k = 1 plan, Kc = 4, #9 0.745 against 0.858).
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
constexpr int kUniformLanes = 4;       // lanes of a row of the uniform tile
constexpr int kUniformUnroll = 4;      // its entries in flight a lane
constexpr int kUniformThreads = 1024;  // uniform kernels' block, at most

// Threads of a block at most.  32 accumulators a thread need more than the
// 64 registers a 1,024-thread block leaves.
__host__ __device__ constexpr int max_threads(int KC, bool packed) {
  return KC >= 32 ? 512 : packed ? 1024 : kUniformThreads;
}
// Blocks an SM is to hold at least: two of the uniform ELL-only kernel at
// Kc <= 16 and at most 512 threads (no output tile, so two x tiles fit the
// SM's shared memory; registers are capped to let them), else one.  Stated
// even at one, it lets ptxas spend the registers the thread cap leaves (64
// at 1,024 threads, where the cap alone left #8 and #10 at 46 and 49): at
// K = 16 on elasticity3d(64) the cap alone took #8 and #10 0.815 and 0.388
// ms against 0.699 and 0.295 (tools/ehyb_lane_sweep.py, variant
// launch-bounds-threads-only; H100 80GB HBM3, 700 W).
__host__ __device__ constexpr int min_blocks(int KC, bool packed,
                                             bool has_er) {
  return !packed && !has_er && KC <= 16 && max_threads(KC, packed) <= 512
             ? 2
             : 1;
}
// Lanes a row of the ELL stage: a thread a row of the staircase,
// kUniformLanes a row of the uniform tile.
__host__ __device__ constexpr int row_lanes(bool packed) {
  return packed ? 1 : kUniformLanes;
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
  const int* col_rows;    // (P, W), non-increasing along W
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

// One lane's share of a row of the uniform (V, W) tile: entries lane,
// lane + G, ... below w, kUniformUnroll (value, column) pairs in flight.
template <typename T, int KC, bool VEC, int G>
__device__ __forceinline__ void uniform_row(float (&acc)[KC],
                                            const T* __restrict__ vr,
                                            const uint16_t* __restrict__ cl,
                                            const T* xs, int w, int lane,
                                            int kc, int V) {
  constexpr int U = kUniformUnroll;
  int k = lane;
  for (; k + (U - 1) * G < w; k += U * G) {
    T v[U];
    uint16_t c[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      v[u] = vr[k + u * G];
      c[u] = cl[k + u * G];
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      fma_x<T, KC, VEC>(acc, to_f(v[u]), xs, c[u], kc, V);
  }
  for (; k < w; k += G) fma_x<T, KC, VEC>(acc, to_f(vr[k]), xs, cl[k], kc, V);
}

// Reduce-scatter of a lane group's N partials over the lane masks M, M/2,
// ..., 1 (M = G/2; groups are aligned runs of G lanes of a warp).  At each
// mask a lane keeps the half of its values that its bit selects (the upper
// half when set) and adds its partner's copy of that half; once one value
// is left the remaining masks sum it.  Afterwards a[0..max(N/G, 1)) of lane
// l hold the group's sums of columns l * N/G + t (N >= G), or of column
// l / (G/N) (N < G).  Each sum's order is fixed.  Every lane of the warp
// must call it.
template <int KC, int N, int M>
__device__ __forceinline__ void reduce_scatter(float (&a)[KC], int lane) {
  if constexpr (M >= 1) {
    if constexpr (N > 1) {
      const bool up = (lane & M) != 0;
#pragma unroll
      for (int t = 0; t < N / 2; ++t) {
        const float send = up ? a[t] : a[t + N / 2];
        const float keep = up ? a[t + N / 2] : a[t];
        a[t] = keep + __shfl_xor_sync(0xffffffffu, send, M);
      }
      reduce_scatter<KC, N / 2, M / 2>(a, lane);
    } else {
      a[0] += __shfl_xor_sync(0xffffffffu, a[0], M);
      reduce_scatter<KC, 1, M / 2>(a, lane);
    }
  }
}

// The uniform tile's ELL stage: kUniformLanes lanes a row, each row read to
// its width; the row's kc sums go to the output tile ys ([j][v]) when TILE,
// else straight to y (row-major (n_pad, K), columns c0 ...).
template <typename T, int KC, bool TILE, bool VEC>
__device__ __forceinline__ void uniform_rows(const SpmmArgs& a, const T* xs,
                                             float* ys, const int* cr, int p,
                                             int c0, int kc) {
  constexpr int G = kUniformLanes;
  constexpr int NV = KC >= G ? KC / G : 1;      // sums a lane writes
  constexpr int SPREAD = KC >= G ? 1 : G / KC;  // lanes holding each sum
  const int V = a.V, W = a.W;
  const int lane = threadIdx.x % G, grp = threadIdx.x / G;
  const int ngrp = blockDim.x / G;
  const int c = lane / SPREAD * NV;
  const size_t row0 = (size_t)p * V;
  const T* vals = static_cast<const T*>(a.vals);
  T* y = static_cast<T*>(a.y);
  for (int i0 = 0; i0 < V; i0 += ngrp) {  // uniform trip count
    const int i = i0 + grp;
    float acc[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) acc[j] = 0.f;
    if (i < V) {
      const size_t r = (row0 + i) * W;
      uniform_row<T, KC, VEC, G>(acc, vals + r, a.cols + r, xs,
                                 row_width(cr, W, i), lane, kc, V);
    }
    reduce_scatter<KC, KC, G / 2>(acc, lane);
    if (i < V && lane % SPREAD == 0) {
#pragma unroll
      for (int t = 0; t < NV; ++t) {
        if (c + t < kc) {
          if constexpr (TILE)
            ys[(c + t) * V + i] = acc[t];
          else
            y[(row0 + i) * a.K + c0 + c + t] = from_f<T>(acc[t]);
        }
      }
    }
  }
}

// Shared memory of a block: the fp32 (V, Kc) output tile unless the kernel
// writes its rows straight to y (the uniform ELL-only kernel), the (V, Kc)
// x tile in the table dtype, then (when staged) the int row metadata:
// col_rows [W], and col_starts [W + 1] for the staircase.
__host__ __device__ constexpr bool has_tile(bool packed, bool has_er) {
  return packed || has_er;
}
template <typename T, bool PACKED, bool HAS_ER>
__host__ __device__ constexpr size_t tiles_bytes(int V, int Kc) {
  return (size_t)V * Kc *
         ((has_tile(PACKED, HAS_ER) ? sizeof(float) : 0) + sizeof(T));
}
__host__ __device__ constexpr int meta_ints(bool packed, int W) {
  return packed ? 2 * W + 1 : W;
}

template <typename T, int KC, bool PACKED, bool HAS_ER, bool VEC>
__global__ void __launch_bounds__(max_threads(KC, PACKED),
                                  min_blocks(KC, PACKED, HAS_ER))
    ehyb_spmm_kernel(SpmmArgs a) {
  constexpr bool TILE = has_tile(PACKED, HAS_ER);
  extern __shared__ __align__(16) unsigned char smem[];
  const int V = a.V, K = a.K, W = a.W;
  float* ys = reinterpret_cast<float*>(smem);
  T* xs = reinterpret_cast<T*>(
      smem + (TILE ? (size_t)V * a.Kc * sizeof(float) : 0));
  int* meta = reinterpret_cast<int*>(
      smem + tiles_bytes<T, PACKED, HAS_ER>(V, a.Kc));
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);
  const int p = blockIdx.x;
  const size_t row0 = (size_t)p * V;
  const int* cr = a.col_rows + (size_t)p * W;
  const int* cs = PACKED ? a.col_starts + (size_t)p * (W + 1) : nullptr;
  if (a.stage) {
    for (int t = threadIdx.x; t < meta_ints(PACKED, W); t += blockDim.x)
      meta[t] = t < W ? cr[t] : cs[t - W];
    cr = meta;
    if constexpr (PACKED) cs = meta + W;
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

    if constexpr (PACKED) {
      for (int i = threadIdx.x; i < V; i += blockDim.x) {
        float acc[KC];
#pragma unroll
        for (int j = 0; j < KC; ++j) acc[j] = 0.f;
        packed_row<T, KC, VEC>(acc, static_cast<const T*>(a.vals) +
                                        (size_t)p * a.L,
                               a.cols + (size_t)p * a.L, cs, xs, i,
                               row_width(cr, W, i), kc, V);
#pragma unroll
        for (int j = 0; j < KC; ++j)
          if (j < kc) ys[j * V + i] = acc[j];
      }
    } else {
      uniform_rows<T, KC, TILE, VEC>(a, xs, ys, cr, p, c0, kc);
    }
    __syncthreads();

    if constexpr (HAS_ER) {
      er_stage<T, KC>(ys, x, er, p, V, K, c0, kc);
      __syncthreads();
    }

    if constexpr (TILE) {
      for (int t = threadIdx.x; t < V * kc; t += blockDim.x) {
        const int v = t / kc, j = t - v * kc;
        y[(row0 + v) * K + c0 + j] = from_f<T>(ys[j * V + v]);
      }
      __syncthreads();  // the next chunk reuses xs and ys
    }
  }
}

// Threads of a block: whole warps enough for row_lanes(PACKED) lanes a row
// and a lane group an ER row (n_er_rows bounds a partition's live ER rows),
// at most max_threads(KC, PACKED).
template <int KC, bool PACKED, bool HAS_ER>
int block_threads(int V, int n_er_rows) {
  long work = (long)V * row_lanes(PACKED);
  if (HAS_ER && (long)n_er_rows * er_group(KC) > work)
    work = (long)n_er_rows * er_group(KC);
  if (work > max_threads(KC, PACKED)) work = max_threads(KC, PACKED);
  return work < 32 ? 32 : (int)((work + 31) / 32 * 32);
}

template <typename T, int KC, bool PACKED, bool HAS_ER, bool VEC>
int launch_kc(const SpmmArgs& a, int P, cudaStream_t stream) {
  auto kernel = ehyb_spmm_kernel<T, KC, PACKED, HAS_ER, VEC>;
  const size_t smem = tiles_bytes<T, PACKED, HAS_ER>(a.V, a.Kc) +
                      (a.stage ? (size_t)meta_ints(PACKED, a.W) * 4 : 0);
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
// col_rows (P, W) int32, non-increasing along W: row i's width is the
// number of k with col_rows[p][k] > i.  The ER stream as EHYBDevice.er_s_*
// (part_ptr, row_ptr, rows, cols, vals), n_er_rows its live ER rows;
// stage = 1 puts col_rows (and col_starts) in shared memory beside the
// tiles.  Returns a cudaError_t (0 = launched).
extern "C" int ehyb_fused_spmm(int dtype, const void* x, void* y,
                               const void* ell_vals, const void* ell_cols,
                               const void* col_rows, const void* er_part_ptr,
                               const void* er_row_ptr, const void* er_rows,
                               const void* er_cols, const void* er_vals,
                               int P, int V, int W, int n_er_rows, int K,
                               int Kc, int stage, void* stream) {
  SpmmArgs a{x, y, ell_vals, static_cast<const uint16_t*>(ell_cols), nullptr,
             static_cast<const int*>(col_rows),
             static_cast<const int*>(er_part_ptr),
             static_cast<const int*>(er_row_ptr),
             static_cast<const int*>(er_rows),
             static_cast<const int*>(er_cols), er_vals, V, W, 0, K, Kc,
             n_er_rows, stage};
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
                             const void* ell_vals, const void* ell_cols,
                             const void* col_rows, int P, int V, int W, int K,
                             int Kc, int stage, void* stream) {
  SpmmArgs a{x_parts, y_parts, ell_vals,
             static_cast<const uint16_t*>(ell_cols), nullptr,
             static_cast<const int*>(col_rows), nullptr, nullptr, nullptr,
             nullptr, nullptr, V, W, 0, K, Kc, 0, stage};
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
