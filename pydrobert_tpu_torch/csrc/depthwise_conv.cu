// The Conformer's depthwise convolution over time in one pass, for Hopper.
//
// Replaces no TPU kernel. The JAX package writes this op as K shifted
// multiply-adds (pydrobert_tpu/models/conformer.py _DepthwiseConv1D), which
// XLA fuses into one loop; eager PyTorch runs the same loop as 2K
// elementwise launches (plus a padded copy and two parameter casts), each
// reading and writing the whole activation: about 80 times the bytes the op
// needs at K = 32. This kernel is that loop's CUDA version. For y (N, T, C)
// in the compute dtype D (bfloat16 or float32), kernel (K, C) and bias (C)
// in float32:
//
//   s_0 = D(bias[c]),  s_{k+1} = D(s_k + D(yp[n, t + k, c] * D(kernel[k, c])))
//   out[n, t, c] = s_K
//
// where yp is y with `left` rows of +0.0 before it and K - 1 - left after
// (F.pad's zeros). Every product and every sum is rounded to D, in the
// loop's order, so the output equals the loop's bit for bit. A halo row is
// multiplied like any other (0 * inf is NaN there as in the loop).
//
// Rounding. Float32 uses __fmul_rn and __fadd_rn (never contracted into an
// FMA). Bfloat16 uses Hopper's packed mul.rn.bf16x2 and add.rn.bf16x2: each
// rounds the exact result once to bfloat16, where the loop rounds it to
// float32 first and then to bfloat16. Float32 carries more than 2 x 8 + 2
// significand bits, so the two roundings give the same value for a product
// or a sum (double rounding is innocuous); the card tests check both
// operations over every pair of bfloat16 bit patterns, NaNs included, against
// the loop. The parameters are rounded to D here (cvt.rn, as PyTorch's cast).
//
// Bound: bytes. The op reads y once and writes out once (2 N T C sizeof(D));
// at the offline cells' (256, 875, 512) and (512, 875, 256) bfloat16 that is
// 0.46 GB, ~0.14 ms at 3.35 TB/s. A block takes one utterance (blockIdx.z),
// a tile of channels (blockIdx.y; each thread owns one 16-byte vector of
// them) and a tile of rows (blockIdx.x): each thread walks kRows consecutive
// output rows down the taps, keeping the kRows input rows that tap k needs
// in a register ring and loading one new row a tap, so each input vector
// reaches a thread once per kRows + K - 1 rows of work (the neighbouring
// threads' overlapping rows come from L1, not DRAM). The tile's rounded
// weights and bias sit in shared memory. Per 16 bytes loaded a thread issues
// 2 x kRows packed operations, so the arithmetic hides under the memory
// traffic. The row tile shrinks with T (the 39-row stream chunk takes one
// tile of 5 row groups, the 875-row batch 14 tiles of 8).
//
// Plain C interface for ctypes: the entry returns cudaGetLastError() after
// its launch, allocates nothing, and runs on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace pydt_dw {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // output rows a thread walks down the taps
constexpr int kMaxVectors = 32;  // channel vectors a block takes in a row

// A unit is what one instruction computes: two bfloat16 lanes (uint32_t),
// one bfloat16 lane (uint16_t) or one float32.
__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint16_t mul(uint16_t a, uint16_t b) {
  uint16_t d;
  asm("mul.rn.bf16 %0, %1, %2;" : "=h"(d) : "h"(a), "h"(b));
  return d;
}
__device__ __forceinline__ uint16_t add(uint16_t a, uint16_t b) {
  uint16_t d;
  asm("add.rn.bf16 %0, %1, %2;" : "=h"(d) : "h"(a), "h"(b));
  return d;
}
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// float32 parameters of channels c (and c + 1; C is even there) as a
// unit; absent channels (c >= C, past the last tile's end) as +0.0
__device__ __forceinline__ void param(const float* p, int c, int C, uint32_t& u) {
  u = c < C ? bf16_bits(p[c]) | ((uint32_t)bf16_bits(p[c + 1]) << 16) : 0u;
}
__device__ __forceinline__ void param(const float* p, int c, int C, uint16_t& u) {
  u = c < C ? bf16_bits(p[c]) : (uint16_t)0;
}
__device__ __forceinline__ void param(const float* p, int c, int C, float& u) {
  u = c < C ? p[c] : 0.f;
}

template <typename U>
constexpr int kLanes = std::is_same<U, uint32_t>::value ? 2 : 1;

// NU units of U: one 16-byte access where they fill one
template <typename U, int NU>
struct alignas(NU * sizeof(U) == 16 ? 16 : alignof(U)) Vec {
  U u[NU];
};

template <typename U, int NU>
__device__ __forceinline__ Vec<U, NU> load(const U* p) {
  Vec<U, NU> v;
  if constexpr (NU * sizeof(U) == 16) {
    *reinterpret_cast<uint4*>(v.u) = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
#pragma unroll
    for (int j = 0; j < NU; ++j) v.u[j] = p[j];
  }
  return v;
}

template <typename U, int NU>
__device__ __forceinline__ void store(U* p, const Vec<U, NU>& v) {
  if constexpr (NU * sizeof(U) == 16) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(v.u);
  } else {
#pragma unroll
    for (int j = 0; j < NU; ++j) p[j] = v.u[j];
  }
}

// grid (row tiles, channel tiles, N), block (vectors, row groups); x and
// out are (N, T, CU) units, CU = C / lanes; the dynamic shared memory holds
// (K + 1) x blockDim.x x NU units: the rounded kernel rows, then the bias
template <typename U, int NU>
__global__ void __launch_bounds__(kThreads)
    dw_kernel(const U* __restrict__ x, const float* __restrict__ kernel,
              const float* __restrict__ bias, int T, int C, int K, int left,
              U* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  U* ws = reinterpret_cast<U*>(smem);
  constexpr int L = kLanes<U>;
  const int CU = C / L;
  const int CV = (CU + NU - 1) / NU;  // vectors in a row
  const int bx = blockDim.x;
  const int width = bx * NU;  // units of the tile's channels
  const int tid = threadIdx.y * bx + threadIdx.x;
  const int u0 = blockIdx.y * width;  // first unit of the tile
  for (int i = tid; i < (K + 1) * width; i += blockDim.x * blockDim.y) {
    const int k = i / width;
    const int c = (u0 + i % width) * L;
    param(k < K ? kernel + (int64_t)k * C : bias, c, C, ws[i]);
  }
  __syncthreads();

  const int v = blockIdx.y * bx + threadIdx.x;
  const int t0 = (blockIdx.x * blockDim.y + threadIdx.y) * kRows;
  if (v >= CV || t0 >= T) return;
  const int64_t base = (int64_t)blockIdx.z * T * CU + (int64_t)v * NU;
  const U* xn = x + base;
  const U* wt = ws + threadIdx.x * NU;

  Vec<U, NU> acc[kRows], ring[kRows];
  const Vec<U, NU> b = *reinterpret_cast<const Vec<U, NU>*>(wt + K * width);
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = b;
  // ring slot j % kRows holds input row t0 - left + j (+0.0 outside [0, T))
  auto fetch = [&](int j, Vec<U, NU>& dst) {
    const int t = t0 - left + j;
    if ((unsigned)t < (unsigned)T) {
      dst = load<U, NU>(xn + (int64_t)t * CU);
    } else {
#pragma unroll
      for (int q = 0; q < NU; ++q) dst.u[q] = U(0);
    }
  };
#pragma unroll
  for (int j = 0; j + 1 < kRows; ++j) fetch(j, ring[j]);
  for (int kb = 0; kb < K; kb += kRows) {
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      const int k = kb + s;
      if (k < K) {
        fetch(k + kRows - 1, ring[(s + kRows - 1) % kRows]);
        const Vec<U, NU> w = *reinterpret_cast<const Vec<U, NU>*>(wt + k * width);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const Vec<U, NU>& y = ring[(r + s) % kRows];  // row t0 + r + k - left
#pragma unroll
          for (int q = 0; q < NU; ++q)
            acc[r].u[q] = add(acc[r].u[q], mul(y.u[q], w.u[q]));
        }
      }
    }
  }
  U* on = out + base;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (t0 + r < T) store<U, NU>(on + (int64_t)(t0 + r) * CU, acc[r]);
}

template <typename U, int NU>
int launch(const void* x, const float* kernel, const float* bias, int N, int T,
           int C, int K, int left, void* out, void* stream) {
  constexpr int L = kLanes<U>;
  if (N == 0 || T == 0 || C == 0) return (int)cudaSuccess;
  if (K < 1 || left < 0 || left >= K || C % L != 0 || (C / L) % NU != 0)
    return (int)cudaErrorInvalidValue;
  const int CV = C / L / NU;
  int bx = CV < kMaxVectors ? CV : kMaxVectors;
  // the weights' tile fits the default 48 KB of shared memory
  while (bx > 1 && (size_t)(K + 1) * bx * NU * sizeof(U) > 48 * 1024) bx /= 2;
  const size_t smem = (size_t)(K + 1) * bx * NU * sizeof(U);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int groups_max = kThreads / bx;
  const int groups_need = (T + kRows - 1) / kRows;
  const int by = groups_need < groups_max ? groups_need : groups_max;
  const int64_t gx = ((int64_t)T + (int64_t)kRows * by - 1) / ((int64_t)kRows * by);
  const int gy = (CV + bx - 1) / bx;
  if (gx > 0x7fffffff || gy > 65535 || N > 65535)
    return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)N), block(bx, by);
  dw_kernel<U, NU><<<grid, block, smem, (cudaStream_t)stream>>>(
      static_cast<const U*>(x), kernel, bias, T, C, K, left, static_cast<U*>(out));
  return (int)cudaGetLastError();
}

}  // namespace pydt_dw

extern "C" {

// x, out (N, T, C), contiguous, in dtype 0 = float32 or 1 = bfloat16;
// kernel (K, C) and bias (C) float32, contiguous. vec: 16 bytes' worth of
// elements (4 float32, 8 bfloat16) when C is a multiple of it and x and out
// are 16-byte aligned, else 1. left in [0, K).
int pydt_depthwise_conv1d(const void* x, int dtype, const float* kernel,
                          const float* bias, int N, int T, int C, int K,
                          int left, int vec, void* out, void* stream) {
  using pydt_dw::launch;
  if (dtype == 0 && vec == 4)
    return launch<float, 4>(x, kernel, bias, N, T, C, K, left, out, stream);
  if (dtype == 0 && vec == 1)
    return launch<float, 1>(x, kernel, bias, N, T, C, K, left, out, stream);
  if (dtype == 1 && vec == 8)
    return launch<uint32_t, 4>(x, kernel, bias, N, T, C, K, left, out, stream);
  if (dtype == 1 && vec == 1)
    return launch<uint16_t, 1>(x, kernel, bias, N, T, C, K, left, out, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
