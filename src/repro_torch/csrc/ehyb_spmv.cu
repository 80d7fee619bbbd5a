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
// value (4 or 2 bytes) and a uint16 local column and does 2 flops, so an H100
// (3.35 TB/s, 67 TFLOP/s fp32) is memory-bound by two orders of magnitude.
//
// What the design does about it (the paper's mapping, now on its own
// hardware):
//   * one thread block per partition; the partition's x-slice is staged into
//     shared memory with coalesced loads, so every in-partition x read hits
//     shared memory and x crosses device memory once;
//   * packed kernel: column k of partition p is a contiguous run of
//     col_rows[p][k] entries at col_starts[p][k]; thread i reads entry
//     col_starts[p][k] + i, so a warp reads 32 neighbouring values and
//     columns, and stops at the first k with i >= col_rows[p][k] (valid
//     because col_rows is non-increasing: the staircase-monotone invariant);
//   * uniform kernel: thread per row over the row-major (V, W) tile -- the
//     plainest form of the algorithm; its loads are strided (uncoalesced);
//   * ER stage: the partition's own ER rows gather from the full x (through
//     L2) and scatter into the block's fp32 output tile in shared memory with
//     shared-memory atomicAdd -- padded ER slots all carry local row 0 (value
//     0), so several writers share that row; the tile is then written out
//     once, in x's dtype.
//   * ER kernel (standalone, no caller on the hot path): one warp per row
//     of the row-major (Rr, W) ER table; lane j reads slots j, j + 32, ...
//     (coalesced along W), gathers x through L2 and the warp reduces with
//     shuffles in a fixed order -- no atomics, deterministic.  Padded slots
//     carry value 0 and column 0 and add 0.  It reads the padded table, so
//     its bytes are the table's (Rr * W), not the live entries'.
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

// Shared memory: float y tile [V], then the x-slice [V] in the table dtype.
template <typename T>
__device__ __forceinline__ void stage_x_slice(const T* __restrict__ x, T* xs,
                                              int p, int V) {
  const T* src = x + (size_t)p * V;
  for (int j = threadIdx.x; j < V; j += blockDim.x) xs[j] = src[j];
}

// ER rows of partition p: gather from the full x, atomically add into the
// shared y tile (called after the ELL stage has written every row of ys).
template <typename T>
__device__ __forceinline__ void er_stage(float* ys, const T* __restrict__ x,
                                         const T* __restrict__ er_vals,
                                         const int* __restrict__ er_cols,
                                         const int* __restrict__ er_rows,
                                         int p, int E, int We) {
  const size_t tile = (size_t)p * E * We;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const T* vr = er_vals + tile + (size_t)e * We;
    const int* cr = er_cols + tile + (size_t)e * We;
    float acc = 0.f;
    for (int k = 0; k < We; ++k) acc += to_f(vr[k]) * to_f(x[cr[k]]);
    atomicAdd(&ys[er_rows[(size_t)p * E + e]], acc);
  }
}

template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ y, const float* ys,
                                           int p, int V) {
  T* dst = y + (size_t)p * V;
  for (int j = threadIdx.x; j < V; j += blockDim.x) dst[j] = from_f<T>(ys[j]);
}

constexpr int kMaxThreads = 1024;

// Shared memory of a block: the fp32 y tile unless ELL_ONLY, then the
// x-slice in the table dtype.
template <typename T, bool ELL_ONLY>
__host__ __device__ constexpr size_t smem_bytes(int V) {
  return (size_t)V * ((ELL_ONLY ? 0 : sizeof(float)) + sizeof(T));
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

template <typename T, bool ELL_ONLY>
__global__ void __launch_bounds__(kMaxThreads) ehyb_fused_kernel(
    const T* __restrict__ x, T* __restrict__ y, const T* __restrict__ ell_vals,
    const uint16_t* __restrict__ ell_cols, const T* __restrict__ er_vals,
    const int* __restrict__ er_cols, const int* __restrict__ er_rows, int V,
    int W, int E, int We, int has_er) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ys = reinterpret_cast<float*>(smem);
  T* xs = reinterpret_cast<T*>(smem + smem_bytes<T, ELL_ONLY>(V)
                               - (size_t)V * sizeof(T));
  const int p = blockIdx.x;
  stage_x_slice(x, xs, p, V);
  __syncthreads();
  const size_t tile = (size_t)p * V * W;
  for (int i = threadIdx.x; i < V; i += blockDim.x) {
    const T* vr = ell_vals + tile + (size_t)i * W;
    const uint16_t* cr = ell_cols + tile + (size_t)i * W;
    float acc = 0.f;
    for (int k = 0; k < W; ++k) acc += to_f(vr[k]) * to_f(xs[cr[k]]);
    put_row<T, ELL_ONLY>(y, ys, p, V, i, acc);
  }
  if constexpr (!ELL_ONLY) {
    __syncthreads();
    if (has_er) {
      er_stage(ys, x, er_vals, er_cols, er_rows, p, E, We);
      __syncthreads();
    }
    store_tile(y, ys, p, V);
  }
}

template <typename T, bool ELL_ONLY>
__global__ void __launch_bounds__(kMaxThreads) ehyb_packed_fused_kernel(
    const T* __restrict__ x, T* __restrict__ y,
    const T* __restrict__ packed_vals, const uint16_t* __restrict__ packed_cols,
    const int* __restrict__ col_starts, const int* __restrict__ col_rows,
    const T* __restrict__ er_vals, const int* __restrict__ er_cols,
    const int* __restrict__ er_rows, int V, int L, int W, int E, int We,
    int has_er) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ys = reinterpret_cast<float*>(smem);
  T* xs = reinterpret_cast<T*>(smem + smem_bytes<T, ELL_ONLY>(V)
                               - (size_t)V * sizeof(T));
  const int p = blockIdx.x;
  stage_x_slice(x, xs, p, V);
  __syncthreads();
  const T* pv = packed_vals + (size_t)p * L;
  const uint16_t* pc = packed_cols + (size_t)p * L;
  const int* cs = col_starts + (size_t)p * (W + 1);
  const int* cr = col_rows + (size_t)p * W;
  for (int i = threadIdx.x; i < V; i += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < W; ++k) {
      if (i >= __ldg(cr + k)) break;  // staircase: col_rows non-increasing
      const int off = __ldg(cs + k) + i;
      acc += to_f(pv[off]) * to_f(xs[pc[off]]);
    }
    put_row<T, ELL_ONLY>(y, ys, p, V, i, acc);
  }
  if constexpr (!ELL_ONLY) {
    __syncthreads();
    if (has_er) {
      er_stage(ys, x, er_vals, er_cols, er_rows, p, E, We);
      __syncthreads();
    }
    store_tile(y, ys, p, V);
  }
}

constexpr int kErWarps = 8;  // ER rows (one per warp) of an ER block

// out[e * R + r] = sum_k er_vals[e][k] * x[er_cols[e][k] * R + r]; block
// (blockIdx.x, r) takes rows blockIdx.x * kErWarps + warp.
template <typename T>
__global__ void __launch_bounds__(kErWarps * 32) er_kernel(
    const T* __restrict__ x, T* __restrict__ out,
    const T* __restrict__ er_vals, const int* __restrict__ er_cols, int Rr,
    int W, int R) {
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kErWarps + (threadIdx.x >> 5);
  const int r = blockIdx.y;
  if (e >= Rr) return;  // whole warps only: the shuffles below stay full
  const T* vr = er_vals + (size_t)e * W;
  const int* cr = er_cols + (size_t)e * W;
  float acc = 0.f;
  for (int k = lane; k < W; k += 32)
    acc += to_f(vr[k]) * to_f(x[(size_t)cr[k] * R + r]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[(size_t)e * R + r] = from_f<T>(acc);
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, bool ELL_ONLY = false>
int launch_fused(const void* x, void* y, const void* ell_vals,
                 const void* ell_cols, const void* er_vals, const void* er_cols,
                 const void* er_rows, int P, int V, int W, int E, int We,
                 int has_er, int threads, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, ELL_ONLY>(V);
  cudaError_t err = prepare(ehyb_fused_kernel<T, ELL_ONLY>, smem);
  if (err != cudaSuccess) return (int)err;
  ehyb_fused_kernel<T, ELL_ONLY><<<P, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<const T*>(ell_vals), static_cast<const uint16_t*>(ell_cols),
      static_cast<const T*>(er_vals), static_cast<const int*>(er_cols),
      static_cast<const int*>(er_rows), V, W, E, We, has_er);
  return (int)cudaGetLastError();
}

template <typename T, bool ELL_ONLY = false>
int launch_packed(const void* x, void* y, const void* packed_vals,
                  const void* packed_cols, const void* col_starts,
                  const void* col_rows, const void* er_vals,
                  const void* er_cols, const void* er_rows, int P, int V,
                  int L, int W, int E, int We, int has_er, int threads,
                  cudaStream_t stream) {
  const size_t smem = smem_bytes<T, ELL_ONLY>(V);
  cudaError_t err = prepare(ehyb_packed_fused_kernel<T, ELL_ONLY>, smem);
  if (err != cudaSuccess) return (int)err;
  ehyb_packed_fused_kernel<T, ELL_ONLY><<<P, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<const T*>(packed_vals),
      static_cast<const uint16_t*>(packed_cols),
      static_cast<const int*>(col_starts), static_cast<const int*>(col_rows),
      static_cast<const T*>(er_vals), static_cast<const int*>(er_cols),
      static_cast<const int*>(er_rows), V, L, W, E, We, has_er);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_er(const void* x, void* out, const void* er_vals,
              const void* er_cols, int Rr, int W, int R, cudaStream_t stream) {
  if (Rr < 1 || W < 1 || R < 1 || R > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((Rr + kErWarps - 1) / kErWarps, R);
  er_kernel<T><<<grid, kErWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<const T*>(er_vals), static_cast<const int*>(er_cols), Rr, W,
      R);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int ehyb_fused(int dtype, const void* x, void* y,
                          const void* ell_vals, const void* ell_cols,
                          const void* er_vals, const void* er_cols,
                          const void* er_rows, int P, int V, int W, int E,
                          int We, int has_er, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fused<float>(x, y, ell_vals, ell_cols, er_vals, er_cols,
                               er_rows, P, V, W, E, We, has_er, threads, s);
  if (dtype == 1)
    return launch_fused<__nv_bfloat16>(x, y, ell_vals, ell_cols, er_vals,
                                       er_cols, er_rows, P, V, W, E, We,
                                       has_er, threads, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ehyb_packed_fused(int dtype, const void* x, void* y,
                                 const void* packed_vals,
                                 const void* packed_cols,
                                 const void* col_starts, const void* col_rows,
                                 const void* er_vals, const void* er_cols,
                                 const void* er_rows, int P, int V, int L,
                                 int W, int E, int We, int has_er, int threads,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_packed<float>(x, y, packed_vals, packed_cols, col_starts,
                                col_rows, er_vals, er_cols, er_rows, P, V, L,
                                W, E, We, has_er, threads, s);
  if (dtype == 1)
    return launch_packed<__nv_bfloat16>(x, y, packed_vals, packed_cols,
                                        col_starts, col_rows, er_vals, er_cols,
                                        er_rows, P, V, L, W, E, We, has_er,
                                        threads, s);
  return (int)cudaErrorInvalidValue;
}

// ELL-only instances: x_parts, y_parts (P, V) contiguous, one rhs.
extern "C" int ehyb_ell(int dtype, const void* x_parts, void* y_parts,
                        const void* ell_vals, const void* ell_cols, int P,
                        int V, int W, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fused<float, true>(x_parts, y_parts, ell_vals, ell_cols,
                                     nullptr, nullptr, nullptr, P, V, W, 0, 0,
                                     0, threads, s);
  if (dtype == 1)
    return launch_fused<__nv_bfloat16, true>(x_parts, y_parts, ell_vals,
                                             ell_cols, nullptr, nullptr,
                                             nullptr, P, V, W, 0, 0, 0,
                                             threads, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ehyb_ell_packed(int dtype, const void* x_parts, void* y_parts,
                               const void* packed_vals,
                               const void* packed_cols,
                               const void* col_starts, const void* col_rows,
                               int P, int V, int L, int W, int threads,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_packed<float, true>(x_parts, y_parts, packed_vals,
                                      packed_cols, col_starts, col_rows,
                                      nullptr, nullptr, nullptr, P, V, L, W,
                                      0, 0, 0, threads, s);
  if (dtype == 1)
    return launch_packed<__nv_bfloat16, true>(
        x_parts, y_parts, packed_vals, packed_cols, col_starts, col_rows,
        nullptr, nullptr, nullptr, P, V, L, W, 0, 0, 0, threads, s);
  return (int)cudaErrorInvalidValue;
}

// ER partials: x (n_pad, R) and out (Rr, R) row-major; er_vals, er_cols
// (Rr, W) row-major, int32 global columns.
extern "C" int er(int dtype, const void* x, void* out, const void* er_vals,
                  const void* er_cols, int Rr, int W, int R, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_er<float>(x, out, er_vals, er_cols, Rr, W, R, s);
  if (dtype == 1)
    return launch_er<__nv_bfloat16>(x, out, er_vals, er_cols, Rr, W, R, s);
  return (int)cudaErrorInvalidValue;
}
