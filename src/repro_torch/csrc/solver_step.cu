// Fused CG step for Hopper (sm_90a): the Krylov loop's vector updates and
// both dot products in one launch.
//
// Replaces the JAX package's Pallas TPU kernel
//   cg_update <- repro/kernels/solver_step.py::fused_cg_update
//                (_cg_update_kernel)
// which computes, for (n,) vectors,
//   x' = x + alpha p,   r' = r - alpha ap,   z' = minv * r'
//   rz = <r', z'>,      rr = <r', r'>
// with x, r, p, ap (and so x', r', z') in fp32 or bf16, minv in fp32, alpha
// one fp32 element on the device, and the dots accumulated in fp32 from the
// unrounded r' and z'.
//
// What bounds it: device-memory bytes.  It reads five vectors and writes
// three for ~10 flops an element (32 B an element in fp32, 18 B in bf16),
// so an H100 (3.35 TB/s, 67 TFLOP/s fp32) is memory-bound by two orders of
// magnitude.  At the solve's size (n_pad = 789,888: 25 MB in fp32) a launch
// also pays fixed latencies of the same order as the streaming: getting the
// first bytes in flight, and finishing the cross-block sum.
//
// The TPU kernel accumulates both dots into one output block that every
// grid step revisits, which is well defined only on the TPU's sequential
// grid.  Blocks here run in parallel and in no order, so the design is:
//   * grid: a function of n and the SM count only (the wrapper's
//     ``launch_grid``): ceil(n / kChunk) blocks, capped at kBlocksPerSm per
//     SM; a block walks chunks blockIdx.x, blockIdx.x + gridDim.x, ...
//   * in a chunk, thread t owns the vectors j * kThreads + t of V elements
//     each, V = 16 bytes of the vectors' dtype (4 fp32, 8 bf16), so every
//     16-byte load and store instruction of a warp covers 512 contiguous
//     bytes; minv, fp32, takes V / 4 16-byte loads a vector.  A thread
//     issues every load of a chunk before it computes.  The vector that
//     crosses n, and every vector of the instance taken when a base
//     pointer is not 16-byte aligned (template flag kAligned = false), runs
//     the same arithmetic on scalar loads;
//   * each thread sums rz and rr in fp32, element by element in a fixed
//     order; the block sums its threads with a warp xor-shuffle tree and a
//     fixed tree over the warps, and thread 0 writes the block's pair to
//     partials[blockIdx.x];
//   * completion: thread 0 draws a ticket with an acquire-release atomic
//     add (cuda::atomic_ref), which releases the block's partial; the
//     block that draws gridDim.x - 1 is the last, and its acquire covers
//     every earlier release in the ticket's release sequence.  It reads
//     every block's partial from L2 (__ldcg: never a stale L1 line), sums
//     them in block order with the same fixed trees, writes dots[0..1] and
//     stores 0 back into the ticket for the next launch on the stream.  No
//     float atomics: the bits do not depend on which block finishes last,
//     and two launches on the same inputs give the same dots.
// So a call is one device kernel: the wrapper takes partials and dots from
// the caching allocator and keeps one ticket a (device, stream), zeroed once
// when it is made.  NaN and Inf pass through every load, tree and tail:
// the sums are plain adds.
//
// tools/ehyb_lane_sweep.py --sweep cg times the constants below, a ticket
// drawn with __threadfence() + atomicAdd, and a thread that owns kUnit
// contiguous elements (a warp's 16-byte fp32 loads then stride 32 bytes);
// PERF.md has the times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <cuda/atomic>

namespace {

constexpr int kThreads = 256;     // threads a block
constexpr int kUnits = 2;         // 8-element units a thread per chunk
constexpr int kBlocksPerSm = 4;   // grid cap: blocks a streaming multiprocessor
constexpr int kUnit = 8;          // elements a unit
constexpr int kWarps = kThreads / 32;
constexpr long long kChunk = (long long)kThreads * kUnits * kUnit;
static_assert(kThreads % 32 == 0 && kWarps <= 32, "whole warps, at most 32");

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

// Elements a 16-byte load of T: 4 fp32, 8 bf16.
template <typename T>
constexpr int kVec = 16 / sizeof(T);

// V fp32 elements at p (16-byte aligned): V / 4 16-byte loads.
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[V]) {
#pragma unroll
  for (int k = 0; k < V / 4; ++k) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p) + k);
    v[4 * k] = a.x;
    v[4 * k + 1] = a.y;
    v[4 * k + 2] = a.z;
    v[4 * k + 3] = a.w;
  }
}

// One 16-byte load of T at p into fp32 registers.
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  load_f32<4>(p, v);
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    memcpy(&h, &w[i], sizeof(h));
    const float2 f = __bfloat1622float2(h);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// One 16-byte store of T at p from fp32 registers.
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    memcpy(&w[i], &h, sizeof(h));
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// One element of the step in fp32; rz and rr take its terms in element
// order.
__device__ __forceinline__ void step(float x, float r, float p, float ap,
                                     float m, float alpha, float& xn,
                                     float& rn, float& zn, float& rz,
                                     float& rr) {
  xn = x + alpha * p;
  rn = r - alpha * ap;
  zn = m * rn;
  rz += rn * zn;
  rr += rn * rn;
}

// The block's sum of v, in a fixed order; valid on every lane of warp 0.
// smem holds kWarps pairs; a caller that uses it twice passes a barrier
// between the two calls.
__device__ __forceinline__ float2 block_sum(float2 v, float2* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? smem[lane] : make_float2(0.f, 0.f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
    }
  }
  return v;
}

template <typename T, bool kAligned>
__global__ void __launch_bounds__(kThreads)
cg_update_kernel(const T* __restrict__ x, const T* __restrict__ r,
                 const T* __restrict__ p, const T* __restrict__ ap,
                 const float* __restrict__ minv,
                 const float* __restrict__ alpha_ptr, T* __restrict__ xo,
                 T* __restrict__ ro, T* __restrict__ zo,
                 float2* __restrict__ partials, float* __restrict__ dots,
                 unsigned int* __restrict__ ticket, long long n) {
  constexpr int V = kVec<T>;
  constexpr int kLoads = kUnits * kUnit / V;  // vectors a thread per chunk
  __shared__ float2 s_warp[kWarps];
  __shared__ bool s_last;
  const float alpha = __ldg(alpha_ptr);
  float rz = 0.f, rr = 0.f;
  for (long long c = blockIdx.x; c * kChunk < n; c += gridDim.x) {
    long long e0[kLoads];
    bool whole[kLoads];
    float vx[kLoads][V], vr[kLoads][V], vp[kLoads][V], va[kLoads][V],
        vm[kLoads][V];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      e0[j] = c * kChunk + ((long long)j * kThreads + threadIdx.x) * V;
      whole[j] = kAligned && e0[j] + V <= n;
      if (whole[j]) {
        load_vec(x + e0[j], vx[j]);
        load_vec(r + e0[j], vr[j]);
        load_vec(p + e0[j], vp[j]);
        load_vec(ap + e0[j], va[j]);
        load_f32<V>(minv + e0[j], vm[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      if (whole[j]) {
        float ox[V], orr[V], oz[V];
#pragma unroll
        for (int i = 0; i < V; ++i)
          step(vx[j][i], vr[j][i], vp[j][i], va[j][i], vm[j][i], alpha,
               ox[i], orr[i], oz[i], rz, rr);
        store_vec(xo + e0[j], ox);
        store_vec(ro + e0[j], orr);
        store_vec(zo + e0[j], oz);
      } else {
        // the vector that crosses n, or an unaligned base pointer
        for (int i = 0; i < V; ++i) {
          const long long e = e0[j] + i;
          if (e >= n) break;
          float xn, rn, zn;
          step(to_f(x[e]), to_f(r[e]), to_f(p[e]), to_f(ap[e]), minv[e],
               alpha, xn, rn, zn, rz, rr);
          xo[e] = from_f<T>(xn);
          ro[e] = from_f<T>(rn);
          zo[e] = from_f<T>(zn);
        }
      }
    }
  }

  const float2 sum = block_sum(make_float2(rz, rr), s_warp);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = sum;
    // release this block's partial; the last block also acquires every
    // other block's (the ticket's release sequence)
    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> t(*ticket);
    s_last = t.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  float2 acc = make_float2(0.f, 0.f);
  for (unsigned int b = threadIdx.x; b < gridDim.x; b += kThreads) {
    const float2 q = __ldcg(partials + b);   // from L2, never a stale L1
    acc.x += q.x;
    acc.y += q.y;
  }
  acc = block_sum(acc, s_warp);
  if (threadIdx.x == 0) {
    dots[0] = acc.x;
    dots[1] = acc.y;
    cuda::atomic_ref<unsigned int, cuda::thread_scope_device>(*ticket).store(
        0u, cuda::memory_order_relaxed);   // ready for the next launch
  }
}

template <typename T>
int launch(const void* x, const void* r, const void* p, const void* ap,
           const void* minv, const void* alpha, void* xo, void* ro, void* zo,
           void* partials, void* dots, void* ticket, long long n, int grid,
           int aligned, cudaStream_t s) {
  auto args = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(r),
        static_cast<const T*>(p), static_cast<const T*>(ap),
        static_cast<const float*>(minv), static_cast<const float*>(alpha),
        static_cast<T*>(xo), static_cast<T*>(ro), static_cast<T*>(zo),
        static_cast<float2*>(partials), static_cast<float*>(dots),
        static_cast<unsigned int*>(ticket), n);
  };
  if (aligned)
    args(cg_update_kernel<T, true>);
  else
    args(cg_update_kernel<T, false>);
  return (int)cudaGetLastError();
}

}  // namespace

// The kernel's constants, for the wrapper's grid: threads a block, elements
// a thread per chunk, blocks an SM at most.
extern "C" void cg_update_geometry(int* out) {
  out[0] = kThreads;
  out[1] = kUnits * kUnit;
  out[2] = kBlocksPerSm;
}

// x, r, p, ap, xo, ro, zo (n,) of the dtype (0 fp32, 1 bf16); minv (n,)
// fp32; alpha one fp32; partials (grid,) float pairs; dots (2,) fp32;
// ticket one uint32 that is 0 on entry (and is again on exit).  aligned:
// every vector's base pointer is 16-byte aligned.
extern "C" int cg_update(int dtype, const void* x, const void* r,
                         const void* p, const void* ap, const void* minv,
                         const void* alpha, void* xo, void* ro, void* zo,
                         void* partials, void* dots, void* ticket, int n,
                         int grid, int aligned, void* stream) {
  if (n < 0 || grid < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, r, p, ap, minv, alpha, xo, ro, zo, partials,
                         dots, ticket, n, grid, aligned, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, r, p, ap, minv, alpha, xo, ro, zo,
                                 partials, dots, ticket, n, grid, aligned, s);
  return (int)cudaErrorInvalidValue;
}
