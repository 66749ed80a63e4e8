// Batched Levenshtein distances as an anti-diagonal wavefront across one
// warp per sequence, for Hopper.
//
// Replaces pydrobert_tpu/ops/pallas.py:_ed_kernel (entry
// edit_distance_kernel): float32 distances (N,) from time-major int32
// ref (R, N) and hyp (H, N) with per-sequence lengths, costs ins/del/sub
// and exclude_last. The DP is the distance-only path of the JAX package's
// _string_matching_jit. Each hypothesis step t = 1..steps (steps =
// min(H, hyp_len) + off - 1, off = 0 with exclude_last, else 1) does
//
//   up[i]  = row[i] + ins * (hyp_len >= t)
//   new[0] = up[0], new[i] = min(up[i], row[i-1] + (ref[i-1] != tok ? sub : 0))
//   row[i] = cummin_j<=i (new[j] - j*del) + i*del      (the deletions)
//
// and the distance is row[min(ref_len, R)].
//
// Bound: the DP's dependency chain, not bytes or operations. Cell (t, i)
// needs (t-1, i), (t-1, i-1) and the running minimum through (t, i-1), so
// the longest sequence is a chain of about steps + R dependent cells; the
// bytes (one read of ref and hyp, a float out) and the operations are tiny
// next to it.
//
// Design. Lane l of the sequence's warp owns the K consecutive columns
// [l*K, l*K + K), K the smallest of 1, 2, 4, 8, 16, 32 with 32*K >= R + 1,
// and keeps their row and reference tokens in registers. At wavefront step
// s lane l computes row t = s - l of its strip, so the warp walks
// anti-diagonals of strips: steps + ceil((R + 1) / K) - 1 steps in all. One
// __shfl_up_sync pair hands lane l what lane l - 1 made one step earlier:
// the running minimum in u-space through its strip for row t, and its last
// column for row t (kept as the diagonal of row t + 1). Per step a lane
// takes its strip's u-values and their prefix minima, which need only the
// last step's row, then one minimum with the value from the left closes
// the chain. Each lane reads row t's token from a ring of 64 in shared
// memory that the warp fills 32 tokens at a time, loaded 32 steps ahead.
// The costs are rounded once, outside the loop. With one warp on an SM
// nothing hides an instruction's latency, so a step costs its dependent
// instructions: where the launcher shows that no DP value can be inf or
// NaN, the minimum skips its NaN tests. Past 32*32 columns the strip lives
// in lane-private shared memory, interleaved so the lanes hit 32 different
// banks, and the running minimum is folded cell by cell under the same
// schedule.
//
// Exactness: the change of variables u[j] = new[j] - j*del turns the
// deletions into a plain running minimum. nan_min (torch.minimum: NaN
// wins, else the smaller, the first on ties) is associative, so taking it
// as strip prefix then one minimum from the left gives the cummin's result
// to the bit. Every sum and product rounds alone (__fadd_rn, __fmul_rn,
// __fsub_rn: no fused multiply-add), as in the plain PyTorch version.
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
constexpr int kMaxRegStrip = 32;  // the largest strip kept in registers

// torch.minimum: NaN wins, else the smaller, the first on ties. Where the
// launcher has shown that no DP value can be inf or NaN (kFinite), the
// plain "smaller, first on ties" is the same function in fewer
// instructions.
template <bool kFinite>
__device__ __forceinline__ float nan_min(float a, float b) {
  if (!kFinite) {
    if (a != a) return a;
    if (b != b) return b;
  }
  return b < a ? b : a;
}

// The per-sequence scalars both kernels share.
struct Seq {
  int steps;  // hypothesis rows the DP takes
  int col;    // the distance's column, min(max(ref_len, 0), R)
};

__device__ __forceinline__ Seq seq_of(const int* ref_lens, const int* hyp_lens,
                                      int R, int H, int off, int n) {
  Seq q;
  // not_done(t) = t - off < hl is monotone in t: stop at the last such step
  q.steps = min(H + off - 1, hyp_lens[n] + off - 1);
  q.col = min(max(ref_lens[n], 0), R);
  return q;
}

// The hypothesis tokens in a ring of 64 in shared memory: at step s lane l
// reads token s - l - 1, so the warp reads 32 consecutive tokens. Chunk c
// (tokens 32c .. 32c + 31) takes ring half c & 1; it is written at step
// 32c, when no lane reads chunk c - 2 any more, from a register loaded 32
// steps before.
struct TokenRing {
  int* ring;
  int next;  // chunk (s >> 5) + 1, one token a lane
  __device__ __forceinline__ int load(const int* hyp, int N, int n, int steps,
                                      int chunk, int lane) {
    const int j = chunk * kWarp + lane;
    return j < steps ? hyp[(int64_t)j * N + n] : 0;
  }
  __device__ __forceinline__ void init(int* smem, const int* hyp, int N, int n,
                                       int steps, int lane) {
    ring = smem;
    ring[lane] = load(hyp, N, n, steps, 0, lane);
    ring[kWarp + lane] = load(hyp, N, n, steps, 1, lane);
    next = load(hyp, N, n, steps, 2, lane);
    __syncwarp();
  }
  // before step s's reads; the whole warp calls it at every step
  __device__ __forceinline__ void advance(const int* hyp, int N, int n,
                                          int steps, int s, int lane) {
    if ((s & (kWarp - 1)) == 0 && s >= 2 * kWarp) {
      __syncwarp();  // the last reads of chunk (s >> 5) - 2 are done
      ring[((s >> 5) & 1) * kWarp + lane] = next;
      next = load(hyp, N, n, steps, (s >> 5) + 1, lane);
      __syncwarp();
    }
  }
  __device__ __forceinline__ int at(int s, int lane) const {
    return ring[(s - lane - 1) & (2 * kWarp - 1)];
  }
};

// Strips of K <= 32 columns in registers.
// (kWarp, 1): one warp a block, so ptxas may give a lane all the registers
// its strip needs instead of capping it for occupancy the kernel never has
template <int K, bool kFinite>
__global__ void __launch_bounds__(kWarp, 1)
    ed_wave_kernel(const int* __restrict__ ref, const int* __restrict__ hyp,
                   const int* __restrict__ ref_lens,
                   const int* __restrict__ hyp_lens, int R, int H, int N,
                   float ins, float del, float sub, int off,
                   float* __restrict__ out) {
  __shared__ int ring_s[2 * kWarp];
  const int n = blockIdx.x;
  const int lane = threadIdx.x;
  const Seq q = seq_of(ref_lens, hyp_lens, R, H, off, n);
  const int lo = lane * K;
  float row[K];   // row t - 1 of this strip, then row t
  float idel[K];  // i * del of column i = lo + j
  int rtok[K];    // ref[i - 1]
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int i = lo + j;
    idel[j] = __fmul_rn((float)i, del);
    row[j] = idel[j];
    rtok[j] = (i >= 1 && i <= R) ? ref[(int64_t)(i - 1) * N + n] : 0;
  }
  // ins * (hyp_len >= t), rounded as the plain version rounds it (hyp_len
  // >= t holds at every row a lane makes); a match adds exactly 0, also
  // at sub = inf, as XLA's select does (not sub * 0, which is NaN there)
  const float ins_t = __fmul_rn(ins, 1.f);
  const float sub_ne = sub, sub_eq = 0.f;
  const int lanes = (R + K) / K;  // strips holding a column, ceil((R+1)/K)
  TokenRing toks;
  toks.init(ring_s, hyp, N, n, q.steps, lane);
  // what this lane hands to the right after each step: its running minimum
  // in u-space and its last column, both of the row it made
  float run_out = INFINITY, last_out = row[K - 1];
  float diag = 0.f;  // the left strip's last column of row t - 1
  const int total = q.steps > 0 ? q.steps + lanes - 1 : 0;
  for (int s = 1; s <= total; ++s) {
    toks.advance(hyp, N, n, q.steps, s, lane);
    float run_in = __shfl_up_sync(kFull, run_out, 1);
    const float last_in = __shfl_up_sync(kFull, last_out, 1);
    if (lane == 0) run_in = INFINITY;  // nan_min(inf, x) is x, to the bit
    const int t = s - lane;
    if (t >= 1 && t <= q.steps && lane < lanes) {
      const int tok = toks.at(s, lane);
      // the strip's u-values and their prefix minima, in place of row t - 1
      float left = diag, pre = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float old = row[j];
        float v = __fadd_rn(old, ins_t);
        if (j > 0 || lane > 0)  // column 0 has no substitution
          v = nan_min<kFinite>(v, __fadd_rn(left, rtok[j] != tok ? sub_ne : sub_eq));
        const float u = __fsub_rn(v, idel[j]);
        pre = j == 0 ? u : nan_min<kFinite>(pre, u);
        row[j] = pre;
        left = old;
      }
#pragma unroll
      for (int j = 0; j < K; ++j)
        row[j] = __fadd_rn(nan_min<kFinite>(run_in, row[j]), idel[j]);
      run_out = nan_min<kFinite>(run_in, pre);
      last_out = row[K - 1];
    }
    diag = last_in;
  }
  if (q.steps <= 0) {
    if (lane == 0) out[n] = __fmul_rn((float)q.col, del);
  } else if (lane == q.col / K) {
    float d = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (lo + j == q.col) d = row[j];
    out[n] = d;
  }
}

// Strips of k > 32 columns in shared memory: column lo + j of lane l at
// word j * 32 + l, its reference token in a second array of the same
// layout, then the token ring.
template <bool kFinite>
__global__ void __launch_bounds__(kWarp, 1)
    ed_wave_smem_kernel(const int* __restrict__ ref,
                        const int* __restrict__ hyp,
                        const int* __restrict__ ref_lens,
                        const int* __restrict__ hyp_lens, int R, int H, int N,
                        float ins, float del, float sub, int off, int k,
                        float* __restrict__ out) {
  extern __shared__ float smem[];
  float* row = smem;
  int* rtok = reinterpret_cast<int*>(smem + k * kWarp);
  const int n = blockIdx.x;
  const int lane = threadIdx.x;
  const Seq q = seq_of(ref_lens, hyp_lens, R, H, off, n);
  const int lo = lane * k;
  for (int j = 0; j < k; ++j) {
    const int i = lo + j;
    row[j * kWarp + lane] = __fmul_rn((float)i, del);
    rtok[j * kWarp + lane] =
        (i >= 1 && i <= R) ? ref[(int64_t)(i - 1) * N + n] : 0;
  }
  const float ins_t = __fmul_rn(ins, 1.f);
  const float sub_ne = sub, sub_eq = 0.f;
  const int lanes = (R + k) / k;
  TokenRing toks;
  toks.init(rtok + k * kWarp, hyp, N, n, q.steps, lane);
  float run_out = INFINITY, last_out = row[(k - 1) * kWarp + lane];
  float diag = 0.f;
  const int total = q.steps > 0 ? q.steps + lanes - 1 : 0;
  for (int s = 1; s <= total; ++s) {
    toks.advance(hyp, N, n, q.steps, s, lane);
    float run = __shfl_up_sync(kFull, run_out, 1);
    const float last_in = __shfl_up_sync(kFull, last_out, 1);
    if (lane == 0) run = INFINITY;
    const int t = s - lane;
    if (t >= 1 && t <= q.steps && lane < lanes) {
      const int tok = toks.at(s, lane);
      float left = diag, cell = 0.f;
      for (int j = 0; j < k; ++j) {
        const int i = lo + j;
        const float old = row[j * kWarp + lane];
        float v = __fadd_rn(old, ins_t);
        if (i > 0)
          v = nan_min<kFinite>(
              v, __fadd_rn(left, rtok[j * kWarp + lane] != tok ? sub_ne : sub_eq));
        const float id = __fmul_rn((float)i, del);
        run = nan_min<kFinite>(run, __fsub_rn(v, id));
        cell = __fadd_rn(run, id);
        row[j * kWarp + lane] = cell;
        left = old;
      }
      run_out = run;
      last_out = cell;
    }
    diag = last_in;
  }
  if (q.steps <= 0) {
    if (lane == 0) out[n] = __fmul_rn((float)q.col, del);
  } else if (lane == q.col / k) {
    out[n] = row[(q.col - lo) * kWarp + lane];
  }
}

// Columns of one lane's strip: ceil((R + 1) / 32), rounded up to a power of
// two while it fits the registers, else as it is.
__host__ __device__ inline int strip_of(int R) {
  const int k = (R + kWarp) / kWarp;
  if (k > kMaxRegStrip) return k;
  int K = 1;
  while (K < k) K <<= 1;
  return K;
}

// Dynamic shared memory of the shared-memory kernel: the strips' rows and
// reference tokens and the token ring; none for the register buckets.
inline size_t smem_bytes(int R) {
  const int k = strip_of(R);
  return k > kMaxRegStrip ? (size_t)(2 * k + 2) * kWarp * 4 : 0;
}

// Whether no DP value can be inf or NaN: finite costs, and every value is a
// sum of at most R + H + 1 of them in magnitude, far below FLT_MAX.
inline bool finite_dp(int R, int H, float ins, float del, float sub) {
  const double c = std::fabs((double)ins) + std::fabs((double)del) +
                   std::fabs((double)sub);
  return std::isfinite(c) && c * ((double)R + (double)H + 2.0) < 1e37;
}

constexpr int kMaxDevices = 64;

// Let the shared-memory kernel take up to `bytes` of dynamic shared memory,
// once per device for the largest size asked so far.
template <bool kFinite>
cudaError_t allow_smem(int dev, size_t bytes) {
  static std::atomic<size_t> granted[kMaxDevices];
  if (bytes <= 48 * 1024) return cudaSuccess;
  if (dev < kMaxDevices &&
      granted[dev].load(std::memory_order_relaxed) >= bytes)
    return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(ed_wave_smem_kernel<kFinite>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices)
    granted[dev].store(bytes, std::memory_order_relaxed);
  return err;
}

template <bool kFinite>
int launch(const int* ref, const int* hyp, const int* ref_lens,
           const int* hyp_lens, int R, int H, int N, float ins, float del,
           float sub, int off, float* out, cudaStream_t st) {
  const int K = strip_of(R);
#define PYDT_ED_LAUNCH(KK)                                                  \
  ed_wave_kernel<KK, kFinite><<<N, kWarp, 0, st>>>(                         \
      ref, hyp, ref_lens, hyp_lens, R, H, N, ins, del, sub, off, out);      \
  break
  switch (K) {
    case 1: PYDT_ED_LAUNCH(1);
    case 2: PYDT_ED_LAUNCH(2);
    case 4: PYDT_ED_LAUNCH(4);
    case 8: PYDT_ED_LAUNCH(8);
    case 16: PYDT_ED_LAUNCH(16);
    case 32: PYDT_ED_LAUNCH(32);
    default: {
      int dev = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err != cudaSuccess) return (int)err;
      const size_t smem = smem_bytes(R);
      err = allow_smem<kFinite>(dev, smem);
      if (err != cudaSuccess) return (int)err;
      ed_wave_smem_kernel<kFinite><<<N, kWarp, smem, st>>>(
          ref, hyp, ref_lens, hyp_lens, R, H, N, ins, del, sub, off, K, out);
    }
  }
#undef PYDT_ED_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace pydt_ed

extern "C" {

// 4-byte words of shared memory one sequence's warp takes at reference
// length R; the wrapper checks it against pydt_max_warp_words() first.
int pydt_edit_distance_warp_words(int R) {
  return (int)(pydt_ed::smem_bytes(R) / 4);
}

// Columns of one lane's strip at reference length R (strip_of).
int pydt_edit_distance_strip(int R) { return pydt_ed::strip_of(R); }

int pydt_edit_distance(const int* ref, const int* hyp, const int* ref_lens,
                       const int* hyp_lens, int R, int H, int N, float ins,
                       float del, float sub, int exclude_last, float* out,
                       void* stream) {
  if (N == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const int off = exclude_last ? 0 : 1;
  return pydt_ed::finite_dp(R, H, ins, del, sub)
             ? pydt_ed::launch<true>(ref, hyp, ref_lens, hyp_lens, R, H, N,
                                     ins, del, sub, off, out, st)
             : pydt_ed::launch<false>(ref, hyp, ref_lens, hyp_lens, R, H, N,
                                      ins, del, sub, off, out, st);
}

}  // extern "C"
