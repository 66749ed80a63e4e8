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
// 3.35 TB/s. Design: one warp per row, several rows a block and several
// blocks an SM, so enough rows are in flight to cover the loads' latency.
// The warp loads its row with 16-byte loads, all in flight before any is
// used (rows are only 4-byte aligned at V + 1 = 1,025 f32 lanes, so a
// scalar head reaches the first aligned address and a scalar tail ends
// the row), and stages it in shared memory: with stats as f32, taking the
// max, then one more pass makes the sum and the radix keys; without, as
// radix keys straight away. A radix select (select.cuh) then picks the top
// M in one to four passes over shared memory, a few hundred instructions
// a row in place of M dependent argmax rounds. Those integer instructions
// and the stats pass, not the memory, keep the kernel at about 3x its
// bound.
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

constexpr int kMaxWarpsPerBlock = 8;
constexpr int kChunk = 8;  // 16-byte loads a lane keeps in flight

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

// a 16-byte vector of T as f32 (exact), element e at out[e]
__device__ __forceinline__ void unpack(uint4 u, float* out, const float*) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(uint4 u, float* out,
                                       const __nv_bfloat16*) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);  // bf16 is f32's top half
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// max that propagates NaN, as torch.amax does
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// Shared words of one warp: the staged row, shifted by up to 3 words so
// that its 16-byte vectors land aligned, then the selection's.
__host__ __device__ inline int64_t warp_words(int lanes, int M) {
  return (((int64_t)lanes + 3 + 3) & ~3LL) + select_words(M);
}

template <typename T, bool STATS>
__global__ void prologue_kernel(
    const T* __restrict__ x, const float* __restrict__ bias, int64_t rows,
    int V, int M, float* __restrict__ vals, int* __restrict__ idx,
    float* __restrict__ mx_out, float* __restrict__ den_out,
    float* __restrict__ blank_out) {
  constexpr int VN = 16 / sizeof(T);  // elements of one 16-byte load
  extern __shared__ __align__(16) int32_t smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (row >= rows) return;  // whole warps exit together
  const int L = STATS ? V + 1 : V;  // lanes of one input row
  const int64_t words = warp_words(L, M);
  const int row_words = (int)(words - select_words(M));
  const T* xr = x + row * (int64_t)L;
  // h scalar lanes reach a 16-byte boundary, then nv vectors, then a tail
  int h = (int)(((16 - ((uintptr_t)xr & 15)) & 15) / sizeof(T));
  h = h < L ? h : L;
  const int nv = (L - h) / VN;
  const int tail = h + nv * VN;
  int32_t* base = smem + warp * words;
  float* xs = reinterpret_cast<float*>(base + ((4 - (h & 3)) & 3));
  uint32_t* work = reinterpret_cast<uint32_t*>(base + row_words);

  // pass 1: stage the row (upcast to f32, exact) and take its max, or
  // without stats stage its keys
  float m = -INFINITY;
  uint32_t lane_max = 0;  // of this lane's keys
  for (int q0 = 0; q0 < nv; q0 += kChunk * kWarp) {
    uint4 u[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int q = q0 + c * kWarp + lane;
      if (q < nv) u[c] = __ldg(reinterpret_cast<const uint4*>(xr + h) + q);
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int q = q0 + c * kWarp + lane;
      if (q < nv) {
        float f[VN];
        unpack(u[c], f, xr);
#pragma unroll
        for (int e = 0; e < VN; e += 4) {
          if (STATS) {
            m = nan_max(nan_max(m, nan_max(f[e], f[e + 1])),
                        nan_max(f[e + 2], f[e + 3]));
            *reinterpret_cast<float4*>(xs + h + q * VN + e) =
                make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
          } else {  // no stats: the keys go straight in
            const uint4 k =
                make_uint4(radix_key(f[e]), radix_key(f[e + 1]),
                           radix_key(f[e + 2]), radix_key(f[e + 3]));
            lane_max = max(max(lane_max, max(k.x, k.y)), max(k.z, k.w));
            *reinterpret_cast<uint4*>(xs + h + q * VN + e) = k;
          }
        }
      }
    }
  }
  uint32_t* keys = reinterpret_cast<uint32_t*>(xs);
  for (int j = lane; j < h; j += kWarp) {
    const float v = load_f32<T>(xr + j);
    if (STATS) {
      xs[j] = v;
      m = nan_max(m, v);
    } else {
      keys[j] = radix_key(v);
      lane_max = max(lane_max, keys[j]);
    }
  }
  if (lane < L - tail) {
    const float v = load_f32<T>(xr + tail + lane);
    if (STATS) {
      xs[tail + lane] = v;
      m = nan_max(m, v);
    } else {
      keys[tail + lane] = radix_key(v);
      lane_max = max(lane_max, keys[tail + lane]);
    }
  }
  __syncwarp();

  // pass 2, with stats: sum of expf(x - max) and the blank; the row's f32
  // values turn into radix keys in place (lane V, the blank, is not a
  // candidate)
  if (STATS) {
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
      m = nan_max(m, __shfl_xor_sync(kFull, m, off));
    float s = 0.f;
    for (int j = lane; j < L; j += kWarp) {
      const float v = xs[j];
      s += expf(v - m);
      if (j < V) {
        keys[j] = radix_key(bias != nullptr ? v + bias[j] : v);
        lane_max = max(lane_max, keys[j]);
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
      s += __shfl_xor_sync(kFull, s, off);
    if (lane == 0) {
      mx_out[row] = m;
      den_out[row] = s;
      blank_out[row] = xs[V];
    }
    __syncwarp();
  }

  select_top_m(keys, V, M, lane, lane_max, work, vals + row * (int64_t)M,
               idx + row * (int64_t)M);
}

// Warps per block whose shared memory fits, or 0 if none does.
inline int warps_per_block(int lanes, int M, int64_t smem_limit) {
  const int64_t per_warp = warp_words(lanes, M) * 4;
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
  const int w = warps_per_block(lanes, M, limit);
  if (w == 0) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)warp_words(lanes, M) * 4 * w;
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

// Shared words one warp takes for a row of `lanes` and a top-M, and the
// most one warp can take, for the wrappers' checks.
int64_t pydt_prologue_warp_words(int lanes, int M) {
  return pydt::warp_words(lanes, M);
}

int pydt_max_warp_words() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  return (int)(pydt::smem_limit_bytes(dev) / 4);
}

}  // extern "C"
