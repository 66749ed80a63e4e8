// The whole no-LM CTC prefix beam search in one launch, for Hopper.
//
// Replaces pydrobert_tpu/ops/pallas.py:_ctc_beam_kernel (entry
// ctc_beam_search_pallas), whose step math is _ctc_beam_select,
// _ctc_beam_apply and the path-buffer update _ctc_beam_buf_step. Inputs are
// the exact top-M (M = min(V, 2W)) of the non-blank probabilities, tv/ti
// (T, N, M) f32/i32, the probabilities nonext (T, N, V) f32, the blank's
// blank (T, N) f32 and the valid frames lens (N,) i32. Outputs are the
// paths y (T, N, W), lengths y_lens (N, W) (both int64) and raw masses
// y_probs (N, W) f32 of the W beams, best first.
//
// Design: one block of 32*W threads per batch row runs the row's frame
// loop; beam state (masses nb/b, lengths, last tokens, the prefix matrix
// ip) and two (W, T) int32 path buffers that ping-pong live in shared
// memory for the whole loop. A row stops at its own length: frames past it
// change nothing (the TPU kernel masks them), so the block exits its loop
// there. Each frame, warp k scores beam k's S = M + 2 candidates (M shared
// tokens, its last token, its non-extension) and ranks them within the
// beam; lane r of warp k then finds the global rank of the beam's r-th
// candidate by a binary search in every other beam's sorted top W. Ranks
// follow _rank_top_w: value descending by float > and == (so -0.0 ties
// +0.0), ties to the lowest flat index k*S + s; they are unique, so each
// winner writes itself to slot `rank`. A frame reads only its tv/ti rows,
// the blank and the probabilities at the beams' next last tokens, and
// those are loaded one frame ahead: the next frame's last tokens are among
// this frame's M shared tokens and W last tokens, so M + W gathers cover
// them.
//
// Numerics match the plain PyTorch version bit for bit: every product and
// sum is rounded alone (__fmul_rn, __fadd_rn: no fused multiply-add), and
// subnormals are kept (no fast math, no flush to zero). Where the TPU
// kernel's one-hot sums turn a picked -0.0 into +0.0, this kernel adds
// 0.0f.
//
// Bound: the frames form a chain of T dependent steps, so the card's rates
// do not bound it; the bytes it must move (the tv/ti rows, the blank, W
// gathered probabilities a frame, and the outputs) take about 2 us at the
// headline shape (T=500, N=32, V=1024, W=16). Its time is the latency of T
// steps, each a few block-wide barriers, shared-memory passes and the rank
// searches; only N of the card's SMs are busy.
//
// Plain C interface for ctypes: the entry returns cudaGetLastError() after
// its launch, allocates nothing, and runs on the caller's stream.

#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

namespace pydt_beam {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxW = 32;
constexpr float kDummy = -1.0e30f;  // mass of the placeholder beams

// Shared memory of one block, in 4-byte words: two (W, T) path buffers, four
// (W, W) matrices, the (W, S) candidate grid, three M-rows, 20 W-rows and 4
// scalars. pydrobert_tpu_torch/ops/kernels.py:_beam_smem_bytes repeats it.
inline int64_t smem_words(int T, int W, int M) {
  return 2LL * W * T + 4LL * W * W + (int64_t)W * (M + 2) + 3LL * M +
         20LL * W + 4;
}

// whether candidate (va, ia) ranks above (vb, ib)
__device__ __forceinline__ bool beats(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// whether a beam j in the bit set `ext` (the beams that extend this one by
// a token) ends in `tok`: extending by `tok` would give beam j again
__device__ __forceinline__ bool absorbed_by(unsigned ext, int tok,
                                            const int* last) {
  while (ext) {
    const int j = __ffs(ext) - 1;
    if (last[j] == tok) return true;
    ext &= ext - 1;
  }
  return false;
}

__global__ void __launch_bounds__(kWarp * kMaxW)
    ctc_beam_kernel(const float* __restrict__ tv, const int* __restrict__ ti,
                    const float* __restrict__ nonext,
                    const float* __restrict__ blank,
                    const int* __restrict__ lens_in, int T, int N, int V,
                    int W, int M, int64_t* __restrict__ y,
                    int64_t* __restrict__ y_lens,
                    float* __restrict__ y_probs) {
  extern __shared__ int smem[];
  const int S = M + 2;
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int warp = tid / kWarp;  // the beam this warp scores (nthr = 32 W)
  const int lane = tid % kWarp;

  int* buf_a = smem;
  int* buf_b = buf_a + W * T;
  int* ip = buf_b + W * T;  // ip[k][j]: beam k's prefix is a prefix of j's
  int* ip_n = ip + W * W;
  float* lv = reinterpret_cast<float*>(ip_n + W * W);  // each beam's top W
  int* li = reinterpret_cast<int*>(lv + W * W);        // and flat indices
  float* scores = reinterpret_cast<float*>(li + W * W);
  float* tvs = scores + W * S;
  int* tis = reinterpret_cast<int*>(tvs + M);
  float* pf_shared = reinterpret_cast<float*>(tis + M);  // next frame's
  float* nb = pf_shared + M;                              // p at tis
  float* b = nb + W;
  int* lens = reinterpret_cast<int*>(b + W);
  int* last = lens + W;
  float* p_last = reinterpret_cast<float*>(last + W);
  float* pf_last = p_last + W;  // next frame's p at last
  float* nb_ne = pf_last + W;
  float* b_ne = nb_ne + W;
  float* sel_v = b_ne + W;
  int* sel_i = reinterpret_cast<int*>(sel_v + W);
  int* n_src = sel_i + W;  // n_*: the new beams, by rank
  int* n_ne = n_src + W;
  int* n_ext = n_ne + W;
  float* n_nb = reinterpret_cast<float*>(n_ext + W);
  float* n_b = n_nb + W;
  int* n_lens = reinterpret_cast<int*>(n_b + W);
  int* n_q = n_lens + W;
  int* n_p = n_q + W;
  int* n_pos = n_p + W;
  float* n_pl = reinterpret_cast<float*>(n_pos + W);
  float* blank_s = n_pl + W;

  const int len_n = lens_in[n];
  const int steps = min(max(len_n, 0), T);
  for (int i = tid; i < 2 * W * T; i += nthr) buf_a[i] = 0;
  for (int i = tid; i < W * W; i += nthr) ip[i] = (i / W) == (i % W);
  if (tid < W) {
    nb[tid] = tid == 0 ? 0.f : kDummy;
    b[tid] = tid == 0 ? 1.f : kDummy;
    lens[tid] = 0;
    last[tid] = 0;
  }
  if (steps > 0) {
    if (tid < M) {
      tvs[tid] = tv[(int64_t)n * M + tid];
      tis[tid] = ti[(int64_t)n * M + tid];
    }
    if (tid < W) p_last[tid] = nonext[(int64_t)n * V];  // every last is 0
    if (tid == 0) blank_s[0] = blank[n];
  }
  __syncthreads();

  int* cur = buf_a;
  int* nxt = buf_b;
  for (int t = 0; t < steps; ++t) {
    const bool more = t + 1 < steps;
    // (a) start the loads of frame t + 1; they land in (c) and (e)
    float r_f = 0.f, r_pf = 0.f;
    int r_i = 0;
    if (more) {
      const int64_t row1 = (int64_t)(t + 1) * N + n;
      const float* nx1 = nonext + row1 * V;
      if (tid < M) {
        r_f = tv[row1 * M + tid];
        r_i = ti[row1 * M + tid];
        r_pf = nx1[tis[tid]];
      } else if (tid < M + W) {
        r_pf = nx1[last[tid - M]];
      } else if (tid == M + W) {
        r_f = blank[row1];
      }
    }

    // (b) warp k scores beam k's candidates and ranks them within the beam
    {
      const int k = warp;
      const float nbk = nb[k], bk = b[k], plk = p_last[k];
      const int lastk = last[k], lensk = lens[k];
      const float tot_k = __fadd_rn(nbk, bk);
      // beams j that extend beam k by one token
      const unsigned ext_k = __ballot_sync(
          kFull, lane < W && lensk + 1 == lens[lane] && ip[k * W + lane]);
      // beams i that beam k extends: their extension by last[k] is beam k,
      // whose mass absorbs it (summed in i order from +0.0)
      const unsigned from_k = __ballot_sync(
          kFull, lane < W && lens[lane] + 1 == lensk && ip[lane * W + k]);
      float absorbed = 0.f;
      for (unsigned m = from_k; m; m &= m - 1) {
        const int i = __ffs(m) - 1;
        const float c = last[i] == lastk ? b[i] : __fadd_rn(nb[i], b[i]);
        absorbed = __fadd_rn(absorbed, __fmul_rn(c, plk));
      }
      const float nb_ne_k = __fadd_rn(__fmul_rn(nbk, plk), absorbed);
      const float b_ne_k = __fmul_rn(tot_k, blank_s[0]);
      bool mine = false;
      for (int s = lane; s < M; s += kWarp) mine |= tis[s] == lastk;
      const bool hit = __any_sync(kFull, mine);  // last[k] is a shared token
      for (int s = lane; s < S; s += kWarp) {
        float v;
        if (s < M) {
          const int tok = tis[s];
          v = __fmul_rn(tok == lastk ? bk : tot_k, tvs[s]);
          if (absorbed_by(ext_k, tok, last)) v = -INFINITY;
        } else if (s == M) {
          v = hit ? -INFINITY : __fmul_rn(bk, plk);
          if (absorbed_by(ext_k, lastk, last)) v = -INFINITY;
        } else {
          v = __fadd_rn(nb_ne_k, b_ne_k);
        }
        scores[k * S + s] = __fadd_rn(v, 0.f);
      }
      if (lane == 0) {
        nb_ne[k] = nb_ne_k;
        b_ne[k] = b_ne_k;
      }
      __syncwarp();
      for (int s = lane; s < S; s += kWarp) {
        const float v = scores[k * S + s];
        int r = 0;
        for (int s2 = 0; s2 < S; ++s2) r += beats(scores[k * S + s2], s2, v, s);
        if (r < W) {
          lv[k * W + r] = v;
          li[k * W + r] = k * S + s;
        }
      }
    }
    __syncthreads();

    // (c) the global rank of each beam's r-th candidate; the top W win
    if (lane < W) {
      const int k = warp;
      const float v = lv[k * W + lane];
      const int i = li[k * W + lane];
      int r = lane;
      for (int k2 = 0; k2 < W && r < W; ++k2) {
        if (k2 == k) continue;
        const float* v2 = lv + k2 * W;
        const int* i2 = li + k2 * W;
        int lo = 0, hi = W;  // how many of beam k2's top W beat (v, i)
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (beats(v2[mid], i2[mid], v, i))
            lo = mid + 1;
          else
            hi = mid;
        }
        r += lo;
      }
      if (r < W) {
        sel_v[r] = v;
        sel_i[r] = i;
      }
    }
    if (more) {
      if (tid < M)
        pf_shared[tid] = r_pf;
      else if (tid < M + W)
        pf_last[tid - M] = r_pf;
    }
    __syncthreads();

    // (d) the new beams' state
    if (tid < W) {
      const int idx = sel_i[tid];
      const int slot = idx % S, src = idx / S;
      const bool ne = slot == S - 1;
      const int q = lens[src];
      const int ln = q + (ne ? 0 : 1);
      n_src[tid] = src;
      n_ne[tid] = ne;
      n_ext[tid] = slot < M ? tis[slot] : last[src];
      n_nb[tid] = ne ? __fadd_rn(nb_ne[src], 0.f) : sel_v[tid];
      n_b[tid] = ne ? __fadd_rn(b_ne[src], 0.f) : 0.f;
      n_lens[tid] = ln;
      n_q[tid] = q;
      n_p[tid] = max(ln - 1, 0);
      n_pos[tid] = ne ? -1 : q;
      if (more) n_pl[tid] = slot < M ? pf_shared[slot] : pf_last[src];
    }
    __syncthreads();

    // (e) warp j writes new beam j's path; lane j' of warp k completes the
    // prefix matrix from the new buffer's token of beam j' at p[k]
    {
      const int j = warp;
      const int* from = cur + n_src[j] * T;
      int* to = nxt + j * T;
      const int pos = n_pos[j], ext = n_ext[j];
      for (int tau = lane; tau <= t; tau += kWarp)
        to[tau] = tau == pos ? ext : from[tau];
      if (lane < W) {
        const int k = warp, jj = lane;
        const int pk = n_p[k];
        const int old = pk == n_pos[jj] ? n_ext[jj] : cur[n_src[jj] * T + pk];
        const int tok = pk == n_q[jj] ? n_ext[jj] : old;
        ip_n[k * W + jj] = ip[n_src[k] * W + n_src[jj]] &&
                           n_lens[k] <= n_lens[jj] &&
                           (n_ne[k] || tok == n_ext[k]);
      }
      if (tid < W) {
        nb[tid] = n_nb[tid];
        b[tid] = n_b[tid];
        lens[tid] = n_lens[tid];
        last[tid] = n_ext[tid];
        if (more) p_last[tid] = n_pl[tid];
      }
      if (more) {
        if (tid < M) {
          tvs[tid] = r_f;
          tis[tid] = r_i;
        } else if (tid == M + W) {
          blank_s[0] = r_f;
        }
      }
    }
    __syncthreads();
    int* tmp = cur;
    cur = nxt;
    nxt = tmp;
    tmp = ip;
    ip = ip_n;
    ip_n = tmp;
  }

  for (int i = tid; i < T * W; i += nthr) {
    const int tau = i / W, j = i % W;
    y[((int64_t)tau * N + n) * W + j] = cur[j * T + tau];
  }
  if (tid < W) {
    y_lens[(int64_t)n * W + tid] = lens[tid];
    y_probs[(int64_t)n * W + tid] =
        (len_n == 0 && tid > 0) ? -INFINITY : __fadd_rn(nb[tid], b[tid]);
  }
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
      ctc_beam_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices)
    granted[dev].store(bytes, std::memory_order_relaxed);
  return err;
}

}  // namespace pydt_beam

extern "C" {

// M must lie in [W, min(V, 2W)]; the wrapper passes M = min(V, 2W).
int pydt_ctc_beam_search(const float* tv, const int* ti, const float* nonext,
                         const float* blank, const int* lens, int T, int N,
                         int V, int W, int M, int64_t* y, int64_t* y_lens,
                         float* y_probs, void* stream) {
  if (W < 1 || W > pydt_beam::kMaxW || M < W || M > V || M > 2 * W || T < 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)pydt_beam::smem_words(T, W, M) * 4;
  err = pydt_beam::allow_smem(dev, smem);
  if (err != cudaSuccess) return (int)err;
  pydt_beam::ctc_beam_kernel<<<N, pydt_beam::kWarp * W, smem,
                               (cudaStream_t)stream>>>(
      tv, ti, nonext, blank, lens, T, N, V, W, M, y, y_lens, y_probs);
  return (int)cudaGetLastError();
}

// The shared memory one block takes, for the wrapper's shape check.
int64_t pydt_ctc_beam_smem_bytes(int T, int W, int M) {
  return pydt_beam::smem_words(T, W, M) * 4;
}

}  // extern "C"
