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
// Bound: the frames of a row form a chain of dependent steps, and each
// row has its own block, so the kernel's time is the longest row's frames
// times the latency of one frame. The card's rates do not bound it: the
// bytes it must move (the tv/ti rows, the blank, W gathered probabilities
// a frame, and the outputs) take about 2 us at the headline shape (T=500,
// N=32, V=1024, W=16), and more SMs cannot help a chain. Within a frame
// the block's 32 W threads share one SM, whose integer and shuffle rates
// bound the ranking, so the design cuts the instructions a frame runs and
// the barriers between its phases.
//
// Design: one block of 32*W threads per batch row runs the row's frame
// loop and stops at the row's length (frames past it change nothing; the
// TPU kernel masks them). Beam state (masses nb/b, lengths, last tokens,
// the prefix matrix ip) and two (W, T) int32 path buffers that ping-pong
// live in shared memory for the whole loop; the buffers' rows are padded to
// whole 16-byte vectors and start the block's shared memory. A frame is three phases, each
// ended by the block's barrier, and what each does about its latency:
// (b) warp k scores beam k's S = M + 2 candidates (M shared tokens, its
//     last token, its non-extension) in registers, up to 3 a lane, as
//     int32 total-order keys, and ranks them within the beam without a
//     shared-memory round trip. The top-M values tv arrive sorted, so when
//     the beam's mass is not negative its shared tokens scored mass * tv
//     already rank among themselves in slot order: ballots give their
//     ranks, and only the few others (the slot of the beam's last token,
//     the last token's and the non-extension's slots, -inf slots) are
//     compared. Otherwise (the placeholder beams of the first frames, an
//     unsorted tv) an unrolled shuffle-broadcast count ranks all S. Only
//     each beam's top W reaches shared memory, sorted.
// (c) the global rank of beam k's r-th candidate is r plus, for every
//     other beam k2, how many of k2's sorted top W beat it: unrolled
//     branchless binary searches, all of a lane's beams in flight at once,
//     the other beams split over all 32 lanes and summed by shuffles. The
//     thread that finds rank g < W writes new beam g's state itself, from
//     the source beam and slot it holds, so no phase of its own and no
//     division by S is left.
// (e) warp j copies new beam j's path up to its length (not up to the
//     frame: a served model's beams hold far fewer tokens than frames),
//     in 16-byte vectors, lanes complete the prefix matrix, and the next
//     frame's inputs land.
// Ranks follow _rank_top_w: value descending by float > and ==, ties to
// the lowest flat index k*S + s. Every stored score is v + 0.0f, so no
// -0.0 is left and the int32 total-order key orders exactly as float >
// and ==; against beam k2 the tie rule becomes count(key2 > key) for
// k2 > k and count(key2 >= key) = count(key2 > key - 1) for k2 < k. Ranks
// are unique, so each winner writes itself to slot `rank`. A frame reads
// only its tv/ti rows, the blank and the probabilities at the beams' next
// last tokens, and those are loaded one frame ahead: the next frame's last
// tokens are among this frame's M shared tokens and W last tokens, so
// M + W gathers cover them. Path positions at or past a beam's length are
// never read where they decide a result and are written out as 0.
//
// Numerics match the plain PyTorch version bit for bit: every product and
// sum is rounded alone (__fmul_rn, __fadd_rn: no fused multiply-add), and
// subnormals are kept (no fast math, no flush to zero). Where the TPU
// kernel's one-hot sums turn a picked -0.0 into +0.0, this kernel adds
// 0.0f.
//
// The renormalizing variant (pydt_ctc_beam_search_renorm) extends the same
// TPU kernel to what the prefix search runs by default. The JAX package
// never sends a search with DECODE_RENORM on to its kernel
// (pydrobert_tpu/ops/decoding.py:1906-1919): raw masses underflow on long,
// diffuse rows, and the per-frame scan rescales them. This variant is that
// scan's frame loop (pydrobert_tpu_torch/ops/decoding.py, CTCPrefixSearch:
// the factored advance plus the rescale) in one launch, bit for bit. It
// takes what the scan's decode prologue gives (the top-M values and
// indices, the softmax max mx and denominator den of each frame, the
// blank's probability) and the logits (T, N, V + 1), f32 or bf16, in place
// of a (T, N, V) softmax: a token's probability is the scan's am_at,
// expf(max(lg, -1e30) - mx) / den, each step rounded alone. After every
// frame t >= 1 the block rescales its row by 2**-e, e the exponent of beam
// 0's total mass (clamped at -126), clamps both masses at -1e30 and adds e
// to the row's int32 exponent; frames past the row's length only rescale,
// and stop once e is 0 (a rescale by 1 changes nothing more). It returns
// the raw masses nb + b and the exponent; the wrapper folds them together
// as the scan does. Phases (b), (c) and (e) are one template, so the
// raw-mass kernel is the same code with the flag off. Its bound is the
// raw kernel's: the longest row's chain of frames, one block a row.
//
// Plain C interface for ctypes: each entry returns cudaGetLastError() after
// its launch, allocates nothing, and runs on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cmath>
#include <cstdint>

namespace pydt_beam {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxW = 32;
constexpr float kDummy = -1.0e30f;  // mass of the placeholder beams

// W rounded up to a power of two of at least 8: the row stride of the
// top-W lists, and the kernel's template parameter
__host__ __device__ constexpr int pad_w(int W) {
  return W <= 8 ? 8 : W <= 16 ? 16 : 32;
}

// T rounded up to whole 16-byte vectors: the path buffers' row stride
__host__ __device__ constexpr int path_stride(int T) { return (T + 3) & ~3; }

// Shared memory of one block, in 4-byte words: two (W, path_stride(T))
// path buffers, the (W, pad_w(W)) top-W keys, three (W, W) matrices (the
// top-W slots and two prefix matrices), three M-rows, 14 W-rows and the
// blank. pydrobert_tpu_torch/ops/kernels.py:_beam_smem_bytes repeats it.
inline int64_t smem_words(int T, int W, int M) {
  return 2LL * W * path_stride(T) + 3LL * W * W + (int64_t)W * pad_w(W) +
         3LL * M + 14LL * W + 1;
}

// Ascending total-order key of a float (see select.cuh); an involution
__device__ __forceinline__ int key_of(float x) {
  const int i = __float_as_int(x);
  return i >= 0 ? i : (i ^ 0x7FFFFFFF);
}

__device__ __forceinline__ float float_of(int k) {
  return __int_as_float(k >= 0 ? k : (k ^ 0x7FFFFFFF));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The scan's am_at: exp(max(lg, -1e30) - mx) / den, each step rounded as
// ATen rounds it (clamp_min keeps a NaN)
__device__ __forceinline__ float am_at(float lg, float mx, float den) {
  const float x = lg != lg ? lg : fmaxf(lg, -1.0e30f);
  return __fdiv_rn(expf(__fsub_rn(x, mx)), den);
}

// The scan's rescale exponent: e with best = m * 2**e, m in [0.5, 1) (1
// when best is not positive), at least -126
__device__ __forceinline__ int renorm_exp(float best) {
  int e;
  frexpf(best > 0.f ? best : 1.f, &e);
  return max(e, -126);
}

// x * 2**-e rounded once (the power is exact), clamped at the placeholder
// mass as the scan clamps it
__device__ __forceinline__ float rescale(float x, int e) {
  const float y = __fmul_rn(x, ldexpf(1.f, -e));
  return y != y ? y : fmaxf(y, kDummy);
}

// how many of the WP keys at `row`, sorted descending, exceed th: an
// unrolled branchless binary search, log2(WP) + 1 loads
template <int WP>
__device__ __forceinline__ int count_above(const int* row, int th) {
  int c = 0;
#pragma unroll
  for (int step = WP / 2; step > 0; step >>= 1)
    if (row[c + step - 1] > th) c += step;
  return c + (row[c] > th);
}

// WP = pad_w(W); NS = candidate slots a lane holds, ceil((2 WP + 2) / 32).
// One block runs on an SM, so the registers of the whole SM are its own.
// RENORM off: probs is nonext (T, N, V) f32 and mx, den and y_ls are
// unused. On: probs is the logits (T, N, V + 1) of type L, mx and den the
// softmax's (T, N) stats, and y_ls (N,) receives each row's exponent.
template <int WP, bool RENORM, typename L>
__global__ void __launch_bounds__(kWarp * WP, 1)
    ctc_beam_kernel(const float* __restrict__ tv, const int* __restrict__ ti,
                    const L* __restrict__ probs,
                    const float* __restrict__ mx,
                    const float* __restrict__ den,
                    const float* __restrict__ blank,
                    const int* __restrict__ lens_in, int T, int N, int V,
                    int W, int M, int64_t* __restrict__ y,
                    int64_t* __restrict__ y_lens,
                    float* __restrict__ y_probs, int* __restrict__ y_ls) {
  constexpr int NS = WP == 32 ? 3 : WP == 16 ? 2 : 1;
  constexpr int P = kWarp / WP;  // lanes that share one candidate in (c)
  extern __shared__ __align__(16) int smem[];
  const int S = M + 2;
  const int PV = RENORM ? V + 1 : V;  // a frame row of probs
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int warp = tid / kWarp;  // the beam this warp scores (nthr = 32 W)
  const int lane = tid % kWarp;

  const int TP = path_stride(T);
  int* buf_a = smem;  // every row of both buffers is 16-byte aligned
  int* buf_b = buf_a + W * TP;
  int* lv = buf_b + W * TP;  // lv[k][r]: key of beam k's r-th candidate
  int* ls = lv + W * WP;     // ls[k][r]: and its slot
  int* ip = ls + W * W;  // ip[k][j]: beam k's prefix is a prefix of j's
  int* ip_n = ip + W * W;
  float* tvs = reinterpret_cast<float*>(ip_n + W * W);
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
  int* n_src = reinterpret_cast<int*>(b_ne + W);  // n_*: the new beams,
  int* n_slot = n_src + W;                         // by rank
  int* n_ext = n_slot + W;
  float* n_nb = reinterpret_cast<float*>(n_ext + W);
  float* n_b = n_nb + W;
  int* n_lens = reinterpret_cast<int*>(n_b + W);
  float* blank_s = reinterpret_cast<float*>(n_lens + W);

  const int len_n = lens_in[n];
  const int steps = min(max(len_n, 0), T);
  for (int i = tid; i < W * WP; i += nthr) lv[i] = INT_MIN;  // pads lose
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
    if (tid < W) {  // every last is 0
      const float p0 = to_f32(probs[(int64_t)n * PV]);
      p_last[tid] = RENORM ? am_at(p0, mx[n], den[n]) : p0;
    }
    if (tid == 0) blank_s[0] = blank[n];
  }
  __syncthreads();
  int shift = 0;  // the rescales' exponents (RENORM), alike in each thread

  int* cur = buf_a;
  int* nxt = buf_b;
  for (int t = 0; t < steps; ++t) {
    const bool more = t + 1 < steps;
    // (a) start the loads of frame t + 1; they land in (c) and (e)
    float r_f = 0.f, r_pf = 0.f, r_mx = 0.f, r_den = 1.f;
    int r_i = 0;
    if (more) {
      const int64_t row1 = (int64_t)(t + 1) * N + n;
      const L* nx1 = probs + row1 * PV;
      if (RENORM && tid < M + W) {
        r_mx = mx[row1];
        r_den = den[row1];
      }
      if (tid < M) {
        r_f = tv[row1 * M + tid];
        r_i = ti[row1 * M + tid];
        r_pf = to_f32(nx1[tis[tid]]);
      } else if (tid < M + W) {
        r_pf = to_f32(nx1[last[tid - M]]);
      } else if (tid == M + W) {
        r_f = blank[row1];
      }
    }

    // (b) warp k scores beam k's candidates (slot lane + 32 i in register
    // i) and ranks them within the beam
    {
      const int k = warp;
      const float nbk = nb[k], bk = b[k], plk = p_last[k];
      const int lastk = last[k], lensk = lens[k];
      const int last_lane = lane < W ? last[lane] : 0;
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
      int tok[NS];
      bool mine = false, gone[NS];  // gone: extending by it gives beam j
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int s = lane + kWarp * i;
        tok[i] = s < M ? tis[s] : lastk;
        mine |= s < M && tok[i] == lastk;
        gone[i] = false;
      }
      const bool hit = __any_sync(kFull, mine);  // last[k] is a shared token
      for (unsigned m = ext_k; m; m &= m - 1) {  // the same for the warp
        const int lj = __shfl_sync(kFull, last_lane, __ffs(m) - 1);
#pragma unroll
        for (int i = 0; i < NS; ++i) gone[i] |= tok[i] == lj;
      }
      int key[NS], r[NS];
      float tvv[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int s = lane + kWarp * i;
        tvv[i] = s < M ? tvs[s] : 0.f;
        float v;
        if (s < M) {
          v = gone[i] ? -INFINITY
                      : __fmul_rn(tok[i] == lastk ? bk : tot_k, tvv[i]);
        } else if (s == M) {
          v = hit || gone[i] ? -INFINITY : __fmul_rn(bk, plk);
        } else {
          v = __fadd_rn(nb_ne_k, b_ne_k);
        }
        key[i] = s < S ? key_of(__fadd_rn(v, 0.f)) : INT_MIN;
        r[i] = 0;
      }
      // rank: how many of the beam's candidates (key desc, slot asc) beat
      // each of this lane's. tv is sorted by value, so with tot_k >= 0 the
      // finite shared tokens other than last[k] ("plain" slots, scored
      // tot_k * tv) already rank among themselves in slot order; only the
      // slot of last[k], the last token's and the non-extension's ("odd"
      // slots, at most 3) are compared, and -inf slots rank last by slot.
      bool in_order = !(tot_k < 0.f);
#pragma unroll
      for (int i = 0; i < NS; ++i) {  // tv[s] >= tv[s + 1] for s + 1 < M
        float nx = __shfl_sync(kFull, tvv[i], (lane + 1) % kWarp);
        const float wrap = __shfl_sync(kFull, tvv[i + 1 < NS ? i + 1 : i], 0);
        if (lane == kWarp - 1) nx = wrap;
        in_order &= lane + kWarp * i + 1 >= M || tvv[i] >= nx;
      }
      const unsigned lower = (1u << lane) - 1u;
      if (__all_sync(kFull, in_order)) {
        constexpr int kNegInf = (int)0x807FFFFF;  // key_of(-INFINITY)
        bool plain[NS];
        unsigned b_plain[NS], b_odd[NS], b_inf[NS];
        int n_fin = 0, n_plain = 0, n_inf = 0, before[NS], odd_beats[NS];
        int plain_beats[NS];  // of an odd slot: the plain ones that beat it
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int s = lane + kWarp * i;
          const bool fin = s < S && key[i] != kNegInf;
          plain[i] = fin && s < M && tok[i] != lastk;
          b_plain[i] = __ballot_sync(kFull, plain[i]);
          b_odd[i] = __ballot_sync(kFull, fin && !plain[i]);
          b_inf[i] = __ballot_sync(kFull, s < S && !fin);
          before[i] = plain[i] ? n_plain + __popc(b_plain[i] & lower)
                               : n_inf + __popc(b_inf[i] & lower);
          n_plain += __popc(b_plain[i]);
          n_inf += __popc(b_inf[i]);
          n_fin += __popc(b_plain[i]) + __popc(b_odd[i]);
          odd_beats[i] = 0;
          plain_beats[i] = 0;
        }
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          for (unsigned m = b_odd[j]; m; m &= m - 1) {  // the same for the warp
            const int src = __ffs(m) - 1;
            const int ky = __shfl_sync(kFull, key[j], src);
            const int sy = kWarp * j + src;
            int n_beat = 0;
#pragma unroll
            for (int i = 0; i < NS; ++i) {
              const int s = lane + kWarp * i;
              odd_beats[i] += ky > key[i] || (ky == key[i] && sy < s);
              const bool beat =
                  plain[i] && (key[i] > ky || (key[i] == ky && s < sy));
              n_beat += __popc(__ballot_sync(kFull, beat));
            }
            if (lane == src) plain_beats[j] = n_beat;
          }
        }
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int s = lane + kWarp * i;
          const bool inf = s < S && key[i] == kNegInf;
          r[i] = inf ? n_fin + before[i]
                     : (plain[i] ? before[i] : plain_beats[i]) + odd_beats[i];
        }
      } else {  // every lane's keys in turn
        int lo[NS];  // key - 1 without overflow: pads never rank anyway
#pragma unroll
        for (int i = 0; i < NS; ++i) lo[i] = (int)((unsigned)key[i] - 1u);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
          for (int src = 0; src < kWarp; ++src) {
            if (kWarp * j + src >= S) break;  // the same for the whole warp
            const int u = __shfl_sync(kFull, key[j], src);
#pragma unroll
            for (int i = 0; i < NS; ++i) {
              // slot 32 j + src is below slot 32 i + lane: ties go to it
              const bool below = j < i || (j == i && src < lane);
              r[i] += u > (below ? lo[i] : key[i]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int s = lane + kWarp * i;
        if (s < S && r[i] < W) {
          lv[k * WP + r[i]] = key[i];
          ls[k * W + r[i]] = s;
        }
      }
      if (lane == 0) {
        nb_ne[k] = nb_ne_k;
        b_ne[k] = b_ne_k;
      }
    }
    __syncthreads();

    // (c) the global rank of beam k's r-th candidate (lanes r + WP g, g <
    // P, share it: each counts every P-th other beam); the top W win and
    // write the new beams' state
    {
      const int k = warp;
      const int r = lane % WP, g = lane / WP;
      const int key = lv[k * WP + r];
      const int lo = (int)((unsigned)key - 1u);
      int cnt = 0;
#pragma unroll 8
      for (int k2 = g; k2 < W; k2 += P) {
        const int c = count_above<WP>(lv + k2 * WP, k2 < k ? lo : key);
        cnt += k2 == k ? 0 : c;
      }
#pragma unroll
      for (int off = WP; off < kWarp; off <<= 1)
        cnt += __shfl_xor_sync(kFull, cnt, off);
      const int rank = r + cnt;
      if (g == 0 && r < W && rank < W) {
        const int slot = ls[k * W + r];
        const bool ne = slot == S - 1;
        n_src[rank] = k;
        n_slot[rank] = slot;
        n_ext[rank] = slot < M ? tis[slot] : last[k];
        n_nb[rank] = ne ? __fadd_rn(nb_ne[k], 0.f) : float_of(key);
        n_b[rank] = ne ? __fadd_rn(b_ne[k], 0.f) : 0.f;
        n_lens[rank] = lens[k] + (ne ? 0 : 1);
      }
    }
    if (more) {
      if (RENORM) r_pf = am_at(r_pf, r_mx, r_den);
      if (tid < M)
        pf_shared[tid] = r_pf;
      else if (tid < M + W)
        pf_last[tid - M] = r_pf;
    }
    __syncthreads();

    // (e) warp j writes new beam j's path up to its length; lane j' of
    // warp k completes the prefix matrix from the new buffer's token of
    // beam j' at p[k]
    {
      const int j = warp;
      const int ln = n_lens[j], ext = n_ext[j];
      // an extension puts its token at the source's length, ln - 1
      const int pos = n_slot[j] == S - 1 ? -1 : ln - 1;
      // 16-byte copies (the last may carry up to 3 positions past the
      // length, inside the padded row), then the new token on top
      const int4* from = reinterpret_cast<const int4*>(cur + n_src[j] * TP);
      int4* to = reinterpret_cast<int4*>(nxt + j * TP);
      for (int q = lane; 4 * q < ln; q += kWarp) to[q] = from[q];
      __syncwarp();
      if (lane == 0 && pos >= 0) nxt[j * TP + pos] = ext;
      if (lane < W) {
        const int k = warp, jj = lane;
        const bool ne_jj = n_slot[jj] == S - 1;
        const int ln_k = n_lens[k], ln_jj = n_lens[jj];
        const int pk = max(ln_k - 1, 0);
        const int q_jj = ne_jj ? ln_jj : ln_jj - 1;  // source's length
        const int pos_jj = ne_jj ? -1 : q_jj;
        // ln_k <= ln_jj puts pk below the source's length or at it, so
        // only a position the source holds is read
        bool in = ip[n_src[k] * W + n_src[jj]] && ln_k <= ln_jj;
        if (in) {
          const int old =
              pk == pos_jj ? n_ext[jj] : cur[n_src[jj] * TP + pk];
          const int tok = pk == q_jj ? n_ext[jj] : old;
          in = n_slot[k] == S - 1 || tok == n_ext[k];
        }
        ip_n[k * W + jj] = in;
      }
      if (tid < W) {
        float nbv = n_nb[tid], bv = n_b[tid];
        if (RENORM && t > 0) {  // the scan rescales after frames 1 on
          const int e = renorm_exp(__fadd_rn(n_nb[0], n_b[0]));
          nbv = rescale(nbv, e);
          bv = rescale(bv, e);
          shift += e;
        }
        nb[tid] = nbv;
        b[tid] = bv;
        lens[tid] = n_lens[tid];
        last[tid] = n_ext[tid];
        if (more) {
          const int slot = n_slot[tid];
          p_last[tid] = slot < M ? pf_shared[slot] : pf_last[n_src[tid]];
        }
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
    y[((int64_t)tau * N + n) * W + j] = tau < lens[j] ? cur[j * TP + tau] : 0;
  }
  if (tid < W) y_lens[(int64_t)n * W + tid] = lens[tid];
  if (!RENORM) {
    if (tid < W)
      y_probs[(int64_t)n * W + tid] =
          (len_n == 0 && tid > 0) ? -INFINITY : __fadd_rn(nb[tid], b[tid]);
  } else if (warp == 0) {
    // frames max(steps, 1) .. T - 1 only rescale the row
    float nbv = lane < W ? nb[lane] : 0.f, bv = lane < W ? b[lane] : 0.f;
    for (int t = max(steps, 1); t < T; ++t) {
      const int e = renorm_exp(__shfl_sync(kFull, __fadd_rn(nbv, bv), 0));
      nbv = rescale(nbv, e);
      bv = rescale(bv, e);
      shift += e;
      if (e == 0) break;  // a rescale by 1 changes nothing more
    }
    if (lane < W) y_probs[(int64_t)n * W + lane] = __fadd_rn(nbv, bv);
    if (lane == 0) y_ls[n] = shift;
  }
}

constexpr int kMaxDevices = 64;

// Let the kernel take up to `bytes` of dynamic shared memory, once per
// device for the largest size asked so far.
template <int WP, bool RENORM, typename L>
cudaError_t allow_smem(int dev, size_t bytes) {
  static std::atomic<size_t> granted[kMaxDevices];
  if (bytes <= 48 * 1024) return cudaSuccess;
  if (dev < kMaxDevices &&
      granted[dev].load(std::memory_order_relaxed) >= bytes)
    return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      ctc_beam_kernel<WP, RENORM, L>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices)
    granted[dev].store(bytes, std::memory_order_relaxed);
  return err;
}

template <int WP, bool RENORM, typename L>
cudaError_t launch(const float* tv, const int* ti, const L* probs,
                   const float* mx, const float* den, const float* blank,
                   const int* lens, int T, int N, int V, int W, int M,
                   int64_t* y, int64_t* y_lens, float* y_probs, int* y_ls,
                   int dev, cudaStream_t stream) {
  const size_t smem = (size_t)smem_words(T, W, M) * 4;
  const cudaError_t err = allow_smem<WP, RENORM, L>(dev, smem);
  if (err != cudaSuccess) return err;
  ctc_beam_kernel<WP, RENORM, L><<<N, kWarp * W, smem, stream>>>(
      tv, ti, probs, mx, den, blank, lens, T, N, V, W, M, y, y_lens, y_probs,
      y_ls);
  return cudaGetLastError();
}

template <bool RENORM, typename L>
cudaError_t dispatch(const float* tv, const int* ti, const L* probs,
                     const float* mx, const float* den, const float* blank,
                     const int* lens, int T, int N, int V, int W, int M,
                     int64_t* y, int64_t* y_lens, float* y_probs, int* y_ls,
                     void* stream) {
  if (W < 1 || W > kMaxW || M < W || M > V || M > 2 * W || T < 0)
    return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (pad_w(W)) {
    case 8:
      return launch<8, RENORM, L>(tv, ti, probs, mx, den, blank, lens, T, N,
                                  V, W, M, y, y_lens, y_probs, y_ls, dev, s);
    case 16:
      return launch<16, RENORM, L>(tv, ti, probs, mx, den, blank, lens, T, N,
                                   V, W, M, y, y_lens, y_probs, y_ls, dev, s);
    default:
      return launch<32, RENORM, L>(tv, ti, probs, mx, den, blank, lens, T, N,
                                   V, W, M, y, y_lens, y_probs, y_ls, dev, s);
  }
}

}  // namespace pydt_beam

extern "C" {

// M must lie in [W, min(V, 2W)]; the wrapper passes M = min(V, 2W).
int pydt_ctc_beam_search(const float* tv, const int* ti, const float* nonext,
                         const float* blank, const int* lens, int T, int N,
                         int V, int W, int M, int64_t* y, int64_t* y_lens,
                         float* y_probs, void* stream) {
  return (int)pydt_beam::dispatch<false, float>(
      tv, ti, nonext, nullptr, nullptr, blank, lens, T, N, V, W, M, y, y_lens,
      y_probs, nullptr, stream);
}

// The renormalizing variant: logits (T, N, V + 1) of dtype 0 (f32) or 1
// (bf16), the prologue's mx and den (T, N); y_mass (N, W) gets the raw
// masses nb + b and y_ls (N,) each row's exponent.
int pydt_ctc_beam_search_renorm(const float* tv, const int* ti,
                                const void* logits, int dtype,
                                const float* mx, const float* den,
                                const float* blank, const int* lens, int T,
                                int N, int V, int W, int M, int64_t* y,
                                int64_t* y_lens, float* y_mass, int* y_ls,
                                void* stream) {
  if (dtype == 0)
    return (int)pydt_beam::dispatch<true, float>(
        tv, ti, static_cast<const float*>(logits), mx, den, blank, lens, T, N,
        V, W, M, y, y_lens, y_mass, y_ls, stream);
  if (dtype == 1)
    return (int)pydt_beam::dispatch<true, __nv_bfloat16>(
        tv, ti, static_cast<const __nv_bfloat16*>(logits), mx, den, blank,
        lens, T, N, V, W, M, y, y_lens, y_mass, y_ls, stream);
  return (int)cudaErrorInvalidValue;
}

// The shared memory one block takes, for the wrapper's shape check.
int64_t pydt_ctc_beam_smem_bytes(int T, int W, int M) {
  return pydt_beam::smem_words(T, W, M) * 4;
}

}  // extern "C"
