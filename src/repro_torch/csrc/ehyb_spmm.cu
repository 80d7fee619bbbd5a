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
// bytes of X and Y grow with K.
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
//     in-partition x read hits shared memory.  Both tiles are stored
//     column by column, [j][v]: the threads of a warp read the x rows of
//     their entries' random local columns, and with [j][v] the 32 reads of
//     one column j fall on scattered banks (row by row, [v][j] with
//     kc = 16, they would share two banks);
//   * ELL stage: thread per row; the packed kernel reads column k's entry
//     of row i at col_starts[p][k] + i (coalesced across a warp) and stops
//     at the first k with i >= col_rows[p][k] (the staircase is monotone);
//     the uniform kernel reads its row of the (V, W) tile, strided;
//   * ER stage (HAS_ER): thread per ER slot; it gathers kc neighbouring
//     values of row col of the full X (row-major, through L2) and adds
//     into the block's fp32 output tile with shared-memory atomicAdd.
//     Padded slots carry local row 0 and value 0, so the sum stays
//     deterministic: each live row has one live slot, the rest add 0;
//   * the tile is written out once per chunk, in X's dtype.
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

constexpr int kMaxThreads = 512;

struct SpmmArgs {
  const void* x;          // (n_pad, K) row-major
  void* y;                // (n_pad, K)
  const void* vals;       // uniform (P, V, W) | packed (P, L)
  const uint16_t* cols;   // same shape, local columns
  const int* col_starts;  // packed only: (P, W + 1)
  const int* col_rows;    // packed only: (P, W), non-increasing along W
  const void* er_vals;    // (P, E, We)
  const int* er_cols;     // (P, E, We) global columns
  const int* er_rows;     // (P, E) local rows
  int V, W, L, E, We, K, Kc;
};

// acc[j] += a * xr[j * stride] for the kc <= KC live columns of one x row.
template <int KC, typename T>
__device__ __forceinline__ void fma_row(float (&acc)[KC], float a,
                                        const T* xr, int kc, int stride) {
#pragma unroll
  for (int j = 0; j < KC; ++j)
    if (j < kc) acc[j] += a * to_f(xr[(size_t)j * stride]);
}

template <typename T, int KC, bool PACKED, bool HAS_ER>
__global__ void __launch_bounds__(kMaxThreads) ehyb_spmm_kernel(SpmmArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int V = a.V, K = a.K, W = a.W;
  float* ys = reinterpret_cast<float*>(smem);
  T* xs = reinterpret_cast<T*>(smem + (size_t)V * a.Kc * sizeof(float));
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);
  const int p = blockIdx.x;
  const size_t row0 = (size_t)p * V;

  for (int c0 = 0; c0 < K; c0 += a.Kc) {
    const int kc = min(a.Kc, K - c0);
    // x tile of this partition and chunk -> shared memory, [j][v]
    for (int t = threadIdx.x; t < V * kc; t += blockDim.x) {
      const int v = t / kc, j = t - v * kc;
      xs[j * V + v] = x[(row0 + v) * K + c0 + j];
    }
    __syncthreads();

    for (int i = threadIdx.x; i < V; i += blockDim.x) {
      float acc[KC];
#pragma unroll
      for (int j = 0; j < KC; ++j) acc[j] = 0.f;
      if constexpr (PACKED) {
        const T* pv = static_cast<const T*>(a.vals) + (size_t)p * a.L;
        const uint16_t* pc = a.cols + (size_t)p * a.L;
        const int* cs = a.col_starts + (size_t)p * (W + 1);
        const int* cr = a.col_rows + (size_t)p * W;
        for (int k = 0; k < W; ++k) {
          if (i >= __ldg(cr + k)) break;  // staircase: col_rows non-increasing
          const int off = __ldg(cs + k) + i;
          fma_row<KC>(acc, to_f(pv[off]), xs + pc[off], kc, V);
        }
      } else {
        const size_t r = (row0 + i) * W;
        const T* vr = static_cast<const T*>(a.vals) + r;
        const uint16_t* cr = a.cols + r;
        for (int k = 0; k < W; ++k)
          fma_row<KC>(acc, to_f(vr[k]), xs + cr[k], kc, V);
      }
#pragma unroll
      for (int j = 0; j < KC; ++j)
        if (j < kc) ys[j * V + i] = acc[j];
    }
    __syncthreads();

    if constexpr (HAS_ER) {
      const size_t tile = (size_t)p * a.E * a.We;
      const T* ev = static_cast<const T*>(a.er_vals);
      for (int e = threadIdx.x; e < a.E; e += blockDim.x) {
        const T* vr = ev + tile + (size_t)e * a.We;
        const int* cr = a.er_cols + tile + (size_t)e * a.We;
        float acc[KC];
#pragma unroll
        for (int j = 0; j < KC; ++j) acc[j] = 0.f;
        for (int k = 0; k < a.We; ++k)
          fma_row<KC>(acc, to_f(vr[k]), x + (size_t)cr[k] * K + c0, kc, 1);
        const int row = a.er_rows[(size_t)p * a.E + e];
#pragma unroll
        for (int j = 0; j < KC; ++j)
          if (j < kc) atomicAdd(ys + j * V + row, acc[j]);
      }
      __syncthreads();
    }

    for (int t = threadIdx.x; t < V * kc; t += blockDim.x) {
      const int v = t / kc, j = t - v * kc;
      y[(row0 + v) * K + c0 + j] = from_f<T>(ys[j * V + v]);
    }
    __syncthreads();  // the next chunk reuses xs and ys
  }
}

template <typename T, int KC, bool PACKED, bool HAS_ER>
int launch_kc(const SpmmArgs& a, int P, int threads, cudaStream_t stream) {
  auto kernel = ehyb_spmm_kernel<T, KC, PACKED, HAS_ER>;
  const size_t smem = (size_t)a.V * a.Kc * (sizeof(float) + sizeof(T));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<P, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The narrowest register accumulator that holds Kc columns.
template <typename T, bool PACKED, bool HAS_ER>
int launch_t(const SpmmArgs& a, int P, int threads, cudaStream_t stream) {
  if (a.Kc < 1 || a.K < 1 || threads < 1 || threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  if (a.Kc <= 4) return launch_kc<T, 4, PACKED, HAS_ER>(a, P, threads, stream);
  if (a.Kc <= 8) return launch_kc<T, 8, PACKED, HAS_ER>(a, P, threads, stream);
  if (a.Kc <= 16)
    return launch_kc<T, 16, PACKED, HAS_ER>(a, P, threads, stream);
  if (a.Kc <= 32)
    return launch_kc<T, 32, PACKED, HAS_ER>(a, P, threads, stream);
  return (int)cudaErrorInvalidValue;
}

template <bool PACKED, bool HAS_ER>
int launch(int dtype, const SpmmArgs& a, int P, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_t<float, PACKED, HAS_ER>(a, P, threads, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16, PACKED, HAS_ER>(a, P, threads, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Kc: rhs columns per chunk (1..32).
// Returns a cudaError_t (0 = launched).
extern "C" int ehyb_fused_spmm(int dtype, const void* x, void* y,
                               const void* ell_vals, const void* ell_cols,
                               const void* er_vals, const void* er_cols,
                               const void* er_rows, int P, int V, int W,
                               int E, int We, int K, int Kc, int threads,
                               void* stream) {
  SpmmArgs a{x, y, ell_vals, static_cast<const uint16_t*>(ell_cols), nullptr,
             nullptr, er_vals, static_cast<const int*>(er_cols),
             static_cast<const int*>(er_rows), V, W, 0, E, We, K, Kc};
  return launch<false, true>(dtype, a, P, threads, stream);
}

extern "C" int ehyb_packed_fused_spmm(
    int dtype, const void* x, void* y, const void* packed_vals,
    const void* packed_cols, const void* col_starts, const void* col_rows,
    const void* er_vals, const void* er_cols, const void* er_rows, int P,
    int V, int L, int W, int E, int We, int K, int Kc, int threads,
    void* stream) {
  SpmmArgs a{x, y, packed_vals, static_cast<const uint16_t*>(packed_cols),
             static_cast<const int*>(col_starts),
             static_cast<const int*>(col_rows), er_vals,
             static_cast<const int*>(er_cols),
             static_cast<const int*>(er_rows), V, W, L, E, We, K, Kc};
  return launch<true, true>(dtype, a, P, threads, stream);
}

extern "C" int ehyb_ell_spmm(int dtype, const void* x_parts, void* y_parts,
                             const void* ell_vals, const void* ell_cols, int P,
                             int V, int W, int K, int Kc, int threads,
                             void* stream) {
  SpmmArgs a{x_parts, y_parts, ell_vals,
             static_cast<const uint16_t*>(ell_cols), nullptr, nullptr, nullptr,
             nullptr, nullptr, V, W, 0, 0, 0, K, Kc};
  return launch<false, false>(dtype, a, P, threads, stream);
}

extern "C" int ehyb_ell_packed_spmm(int dtype, const void* x_parts,
                                    void* y_parts, const void* packed_vals,
                                    const void* packed_cols,
                                    const void* col_starts,
                                    const void* col_rows, int P, int V, int L,
                                    int W, int K, int Kc, int threads,
                                    void* stream) {
  SpmmArgs a{x_parts, y_parts, packed_vals,
             static_cast<const uint16_t*>(packed_cols),
             static_cast<const int*>(col_starts),
             static_cast<const int*>(col_rows), nullptr, nullptr, nullptr, V,
             W, L, 0, 0, K, Kc};
  return launch<true, false>(dtype, a, P, threads, stream);
}
