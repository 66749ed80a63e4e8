// SpecAugment's apply (time warp and both masks) in one pass, for Hopper.
//
// Replaces pydrobert_tpu/ops/pallas.py:_sa_kernel (entry
// spec_augment_apply_kernel). For feats (N, T, F):
//
//   out[n, t, f] = keep ? w0[n, t] * x[n, t0[n, t], f]
//                         + w1[n, t] * x[n, t1[n, t], f]
//                       : +0.0
//   keep = !tmask[n, t] && !fmask[n, f]
//
// in float32, with I/O in bfloat16 or float32. Without t0 (a null pointer)
// there is no warp and out = x where kept. A masked output is +0.0 whatever
// the input holds (-x, inf, NaN): the JAX package's XLA path, not its TPU
// kernel's multiply by keep.
//
// The TPU kernel builds a one-hot (T, T) matrix and multiplies it into the
// block on the matrix unit; here each output row is a direct gather of its
// two source rows and a lerp. The products and the sum are rounded one by
// one (__fmul_rn, __fadd_rn: no fused multiply-add), so the result is the
// plain PyTorch version's bit for bit; float32 to bfloat16 rounds to
// nearest even, with NaN as 0x7fc0, as PyTorch does.
//
// Bound: memory. At the training shape (N=32, T=1000, F=80, f32) it must
// write 10.24 MB and read at most 10.24 MB of feats, plus up to 17 bytes of
// per-frame parameters per frame: at most about 6.3 us at 3.35 TB/s, and
// less where the masks hide frames and columns, which need no reading.
// One thread block covers a tile of frames of one utterance (blockIdx.y);
// each thread moves one 16-byte vector of a row (4 floats or 8 bfloat16)
// where F allows it. A frame that is masked in time reads nothing; the
// masked columns of a kept frame are still read.
//
// A one-wave design, persistent blocks that stage each tile's parameters
// and the source rows its kept frames read in shared memory by
// cp.async.bulk on mbarriers, was bit-exact but slower at the training
// shape in both dtypes: it pays the two round trips in every block before
// the first store, where this grid's later waves hide them (PERF.md).
//
// Plain C interface for ctypes: the entry returns cudaGetLastError() after
// its launch, allocates nothing, and runs on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace pydt_sa {

// 128 rather than 256: smaller blocks retire sooner, so the grid's 2-3
// waves turn over faster (PERF.md)
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);

template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

// round to nearest even, NaN as 0x7fc0: c10::BFloat16's conversion
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  uint32_t u = __float_as_uint(v);
  uint16_t h;
  if (v != v) {
    h = 0x7fc0;
  } else {
    u += 0x7fffu + ((u >> 16) & 1u);
    h = (uint16_t)(u >> 16);
  }
  return __ushort_as_bfloat16(h);
}

// VEC elements of T at p, as one 16-byte access where they fill one
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float* out) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[k] = to_f32(e[k]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[k] = to_f32(p[k]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float* in) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < VEC; ++k) e[k] = from_f32<T>(in[k]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = from_f32<T>(in[k]);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    sa_kernel(const T* __restrict__ x, const int* __restrict__ t0,
              const int* __restrict__ t1, const float* __restrict__ w0,
              const float* __restrict__ w1,
              const uint8_t* __restrict__ tmask,
              const uint8_t* __restrict__ fmask, int T_, int F,
              T* __restrict__ out) {
  const int n = blockIdx.y;
  const int vpr = F / VEC;  // vectors per row
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (int64_t)T_ * vpr) return;
  const int t = (int)(i / vpr);
  const int f = (int)(i % vpr) * VEC;
  const int64_t row = (int64_t)n * T_ + t;
  T* o = out + row * F + f;
  float acc[VEC];
  if (tmask != nullptr && tmask[row]) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    store<T, VEC>(o, acc);
    return;
  }
  if (t0 != nullptr) {
    // indices are clamped for memory safety; callers pass them in [0, T)
    const int s0 = min(max(t0[row], 0), T_ - 1);
    const int s1 = min(max(t1[row], 0), T_ - 1);
    const float c0 = w0[row], c1 = w1[row];
    float b[VEC];
    load<T, VEC>(x + ((int64_t)n * T_ + s0) * F + f, acc);
    load<T, VEC>(x + ((int64_t)n * T_ + s1) * F + f, b);
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      acc[k] = __fadd_rn(__fmul_rn(c0, acc[k]), __fmul_rn(c1, b[k]));
  } else {
    load<T, VEC>(x + row * F + f, acc);
  }
  if (fmask != nullptr) {
    const uint8_t* fm = fmask + (int64_t)n * F + f;
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (fm[k]) acc[k] = 0.f;
  }
  store<T, VEC>(o, acc);
}

template <typename T, int VEC>
int launch(const void* x, const int* t0, const int* t1, const float* w0,
           const float* w1, const uint8_t* tmask, const uint8_t* fmask, int N,
           int T_, int F, void* out, void* stream) {
  const int64_t work = (int64_t)T_ * (F / VEC);
  if (N == 0 || work == 0) return (int)cudaSuccess;
  const int64_t bx = (work + kThreads - 1) / kThreads;
  if (bx > 0x7fffffff || N > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)bx, (unsigned)N);
  sa_kernel<T, VEC><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), t0, t1, w0, w1, tmask, fmask, T_, F,
      static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace pydt_sa

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. vec: 1, or 16 bytes' worth of elements
// (4 float32, 8 bfloat16) when F is a multiple of it and x and out are
// 16-byte aligned. t0, t1, w0, w1 are null together (no warp); tmask and
// fmask may each be null (no mask).
int pydt_spec_augment_apply(const void* x, int dtype, const int* t0,
                            const int* t1, const float* w0, const float* w1,
                            const uint8_t* tmask, const uint8_t* fmask, int N,
                            int T, int F, int vec, void* out, void* stream) {
  using pydt_sa::launch;
  if (dtype == 0 && vec == 4)
    return launch<float, 4>(x, t0, t1, w0, w1, tmask, fmask, N, T, F, out,
                            stream);
  if (dtype == 0 && vec == 1)
    return launch<float, 1>(x, t0, t1, w0, w1, tmask, fmask, N, T, F, out,
                            stream);
  if (dtype == 1 && vec == 8)
    return launch<__nv_bfloat16, 8>(x, t0, t1, w0, w1, tmask, fmask, N, T, F,
                                    out, stream);
  if (dtype == 1 && vec == 1)
    return launch<__nv_bfloat16, 1>(x, t0, t1, w0, w1, tmask, fmask, N, T, F,
                                    out, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
