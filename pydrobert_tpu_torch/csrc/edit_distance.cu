// Batched Levenshtein distances, one warp per sequence, for Hopper.
//
// Replaces pydrobert_tpu/ops/pallas.py:_ed_kernel (entry
// edit_distance_kernel): float32 distances (N,) from time-major int32
// ref (R, N) and hyp (H, N) with per-sequence lengths, costs ins/del/sub
// and exclude_last. The DP is the distance-only path of the JAX package's
// _string_matching_jit. Each hypothesis step t = 1..H + off - 1 (off = 0
// with exclude_last, else 1) that is still inside the hypothesis
// (t - off < hyp_len) does
//
//   up[i]  = row[i] + ins * (hyp_len >= t)
//   new[0] = up[0],  new[i] = min(up[i], row[i-1] + sub * (ref[i-1] != tok))
//   row[i] = cummin_j<=i (new[j] - j*del) + i*del      (the deletions)
//
// and the distance is row[min(ref_len, R)].
//
// The deletion relaxation is a min-plus prefix scan; the change of
// variables u[j] = new[j] - j*del turns it into a plain running min, which
// is exact in any order, so every sum and product here rounds exactly as
// the plain PyTorch version's does (__fadd_rn, __fmul_rn: no fused
// multiply-add) and the two agree bit for bit. The TPU kernel does the
// scan by doubling over a VMEM-resident (R+1, 128) tile; here the row of
// one sequence lives in shared memory, each lane owns a contiguous strip of
// it, takes the running min of its strip, and a 5-step shuffle scan across
// the warp carries the strips' minima up.
//
// Bound: latency. The H steps run one after another, each a few dependent
// shared-memory passes and a shuffle scan; the bytes (one read of ref and
// hyp, one float out per sequence) and the operations are tiny next to
// that. Hypothesis tokens are fetched 32 steps at a time, one per lane,
// and handed round by shuffles; a sequence stops at its own length.
//
// Plain C interface for ctypes: the entry returns cudaGetLastError() after
// its launch, allocates nothing, and runs on the caller's stream.

#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

namespace pydt_ed {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

// torch.minimum: NaN wins, else the smaller, the first on ties
__device__ __forceinline__ float nan_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

__global__ void __launch_bounds__(kWarp)
    ed_kernel(const int* __restrict__ ref, const int* __restrict__ hyp,
              const int* __restrict__ ref_lens,
              const int* __restrict__ hyp_lens, int R, int H, int N, float ins,
              float del, float sub, int off, float* __restrict__ out) {
  extern __shared__ float smem[];
  int* toks = reinterpret_cast<int*>(smem);  // ref[:, n], R tokens
  float* cur = smem + R;                      // the DP row, R + 1 entries
  float* nxt = cur + R + 1;
  const int n = blockIdx.x;
  const int lane = threadIdx.x;
  for (int i = lane; i < R; i += kWarp) toks[i] = ref[(int64_t)i * N + n];
  for (int i = lane; i <= R; i += kWarp) cur[i] = __fmul_rn((float)i, del);
  __syncwarp();

  const int hl = hyp_lens[n];
  // not_done(t) = t - off < hl is monotone in t: stop at the last such step
  const int steps = min(H + off - 1, hl + off - 1);
  const int strip = (R + 1 + kWarp - 1) / kWarp;
  const int lo = lane * strip;
  const int hi = min(lo + strip, R + 1);
  int tok_cache = 0;
  for (int t = 1; t <= steps; ++t) {
    const int slot = (t - 1) & (kWarp - 1);
    if (slot == 0) {
      const int j = t - 1 + lane;
      tok_cache = j < H ? hyp[(int64_t)j * N + n] : 0;
    }
    const int tok = __shfl_sync(kFull, tok_cache, slot);
    const float ins_t = __fmul_rn(ins, hl >= t ? 1.f : 0.f);
    // this lane's strip: new values in u-space and their running min
    float run = INFINITY;
    for (int i = lo; i < hi; ++i) {
      float v = __fadd_rn(cur[i], ins_t);
      if (i > 0) {
        const float s =
            __fadd_rn(cur[i - 1], __fmul_rn(sub, toks[i - 1] != tok ? 1.f : 0.f));
        v = nan_min(v, s);
      }
      const float u = __fsub_rn(v, __fmul_rn((float)i, del));
      run = i == lo ? u : nan_min(run, u);
      nxt[i] = run;
    }
    // the minimum of every strip below this lane's
    float incl = run;
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const float y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl = nan_min(y, incl);
    }
    const float below = __shfl_up_sync(kFull, incl, 1);
    for (int i = lo; i < hi; ++i) {
      const float u = lane > 0 ? nan_min(below, nxt[i]) : nxt[i];
      nxt[i] = __fadd_rn(u, __fmul_rn((float)i, del));
    }
    __syncwarp();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  if (lane == 0) out[n] = cur[min(max(ref_lens[n], 0), R)];
}

constexpr int kMaxDevices = 64;

// Let the kernel take up to `bytes` of dynamic shared memory, once per
// device for the largest size asked so far.
cudaError_t allow_smem(int dev, size_t bytes) {
  static std::atomic<size_t> granted[kMaxDevices];
  if (bytes <= 48 * 1024) return cudaSuccess;
  if (dev < kMaxDevices &&
      granted[dev].load(std::memory_order_relaxed) >= bytes)
    return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      ed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices)
    granted[dev].store(bytes, std::memory_order_relaxed);
  return err;
}

}  // namespace pydt_ed

extern "C" {

// Shared memory of one sequence, (2R + 1) 4-byte words plus R tokens; the
// wrapper checks it against pydt_max_warp_words() first.
int pydt_edit_distance(const int* ref, const int* hyp, const int* ref_lens,
                       const int* hyp_lens, int R, int H, int N, float ins,
                       float del, float sub, int exclude_last, float* out,
                       void* stream) {
  if (N == 0) return (int)cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)(3 * R + 2) * 4;
  err = pydt_ed::allow_smem(dev, smem);
  if (err != cudaSuccess) return (int)err;
  pydt_ed::ed_kernel<<<N, pydt_ed::kWarp, smem, (cudaStream_t)stream>>>(
      ref, hyp, ref_lens, hyp_lens, R, H, N, ins, del, sub,
      exclude_last ? 0 : 1, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
