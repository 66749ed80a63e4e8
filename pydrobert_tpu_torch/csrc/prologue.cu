// The CTC decode prologue and the hoisted top-M, one kernel for Hopper.
//
// Replaces pydrobert_tpu/ops/pallas.py:_prologue_kernel (entry
// decode_prologue_pallas) and pydrobert_tpu/ops/pallas.py:_topm_kernel
// (entry top_m_pallas). Templated on STATS: with it, each row (t, n) of
// logits (T, N, V + 1) yields the max over all V + 1 lanes, the sum of
// expf(x - max), the raw blank logit at lane V, and the exact top-M of
// x[:V] (+ g_bias when one is given); without it, a row of V lanes yields
// its exact top-M alone. Selection semantics live in select.cuh.
//
// Bound: memory. At the headline shape (T=500, N=32, V=1024, M=32, f32) it
// must read 500*32*1025*4 B = 65.6 MB and write 16,000 rows *
// (2*32*4 + 3*4) B = 4.3 MB, so the least time is about 21 us at
// 3.35 TB/s. This simple design (one warp per row, the row staged once in
// shared memory, M sequential argmax rounds) is probably bound by its
// selection rounds instead: each round is a 5-step shuffle reduction plus a
// 32-element rescan of the winner's strip. Async copies, multi-row tiles
// and a cheaper selection are left for later work.
//
// Plain C interface for ctypes: each entry returns cudaGetLastError() after
// its launch, allocates nothing, and runs on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

#include "select.cuh"

namespace pydt {

constexpr int kMaxWarpsPerBlock = 4;

template <typename T>
__device__ __forceinline__ float load_f32(const T* p);

template <>
__device__ __forceinline__ float load_f32<float>(const float* p) {
  return *p;
}

template <>
__device__ __forceinline__ float load_f32<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// max that propagates NaN, as torch.amax does
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

template <typename T, bool STATS>
__global__ void prologue_kernel(
    const T* __restrict__ x, const float* __restrict__ bias, int64_t rows,
    int V, int M, float* __restrict__ vals, int* __restrict__ idx,
    float* __restrict__ mx_out, float* __restrict__ den_out,
    float* __restrict__ blank_out) {
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (row >= rows) return;  // whole warps exit together
  const int L = STATS ? V + 1 : V;  // lanes of one input row
  const T* xr = x + row * (int64_t)L;
  float* xs = reinterpret_cast<float*>(smem + (int64_t)warp * L);

  // pass 1: stage the row (upcast to f32, exact) and take its max
  float m = -INFINITY;
  for (int j = lane; j < L; j += kWarp) {
    const float v = load_f32<T>(xr + j);
    xs[j] = v;
    if (STATS) m = nan_max(m, v);
  }
  __syncwarp();

  // pass 2: sum of expf(x - max) and the blank; the row's f32 values turn
  // into total-order keys in place (lane V, the blank, is not a candidate)
  int32_t* keys = reinterpret_cast<int32_t*>(xs);
  if (STATS) {
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    float s = 0.f;
    for (int j = lane; j < L; j += kWarp) s += expf(xs[j] - m);
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      mx_out[row] = m;
      den_out[row] = s;
      blank_out[row] = xs[V];
    }
  }
  __syncwarp();
  for (int j = lane; j < V; j += kWarp) {
    const float g = (STATS && bias != nullptr) ? xs[j] + bias[j] : xs[j];
    keys[j] = total_order_key(g);
  }
  __syncwarp();

  select_top_m(keys, V, M, lane, vals + row * (int64_t)M,
               idx + row * (int64_t)M);
}

// Warps per block that fit the row in shared memory, or 0 if none does.
inline int warps_per_block(int lanes, int64_t smem_limit) {
  const int64_t per_warp = (int64_t)lanes * 4;
  int w = kMaxWarpsPerBlock;
  while (w > 0 && per_warp * w > smem_limit) --w;
  return w;
}

// Launches look the device's limits up once, not on every call.
constexpr int kMaxDevices = 64;

// The current device's opt-in shared memory per block (0 on error).
inline int64_t smem_limit_bytes(int dev) {
  static std::atomic<int> cache[kMaxDevices];  // 0: not looked up yet
  int bytes = 0;
  if (dev < kMaxDevices) bytes = cache[dev].load(std::memory_order_relaxed);
  if (bytes != 0) return bytes;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  if (dev < kMaxDevices) cache[dev].store(bytes, std::memory_order_relaxed);
  return bytes;
}

// Let the kernel take the device's whole opt-in shared memory, once per
// device.
template <typename T, bool STATS>
cudaError_t allow_smem(int dev, int64_t limit) {
  static std::atomic<bool> done[kMaxDevices];
  if (dev < kMaxDevices && done[dev].load(std::memory_order_relaxed))
    return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      prologue_kernel<T, STATS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)limit);
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_relaxed);
  return err;
}

template <typename T, bool STATS>
int launch(const void* x, const float* bias, int64_t rows, int V, int M,
           float* vals, int* idx, float* mx, float* den, float* blank,
           void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t limit = smem_limit_bytes(dev);
  const int lanes = STATS ? V + 1 : V;
  const int w = warps_per_block(lanes, limit);
  if (w == 0) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)lanes * 4 * w;
  err = allow_smem<T, STATS>(dev, limit);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0) return (int)cudaSuccess;
  auto kernel = prologue_kernel<T, STATS>;
  const int64_t blocks = (rows + w - 1) / w;
  kernel<<<(unsigned)blocks, w * kWarp, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), bias, rows, V, M, vals, idx, mx, den, blank);
  return (int)cudaGetLastError();
}

}  // namespace pydt

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. bias may be null.
int pydt_decode_prologue(const void* logits, int dtype, const float* bias,
                         int64_t rows, int V, int M, float* vals, int* idx,
                         float* mx, float* den, float* blank, void* stream) {
  if (dtype == 0)
    return pydt::launch<float, true>(logits, bias, rows, V, M, vals, idx, mx,
                                     den, blank, stream);
  if (dtype == 1)
    return pydt::launch<__nv_bfloat16, true>(logits, bias, rows, V, M, vals,
                                             idx, mx, den, blank, stream);
  return (int)cudaErrorInvalidValue;
}

int pydt_top_m(const void* x, int dtype, int64_t rows, int V, int M,
               float* vals, int* idx, void* stream) {
  if (dtype == 0)
    return pydt::launch<float, false>(x, nullptr, rows, V, M, vals, idx,
                                      nullptr, nullptr, nullptr, stream);
  if (dtype == 1)
    return pydt::launch<__nv_bfloat16, false>(x, nullptr, rows, V, M, vals,
                                              idx, nullptr, nullptr, nullptr,
                                              stream);
  return (int)cudaErrorInvalidValue;
}

// Largest row (in lanes) one warp can stage, for the wrappers' checks.
int pydt_max_row_lanes() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  return (int)(pydt::smem_limit_bytes(dev) / 4);
}

}  // extern "C"
