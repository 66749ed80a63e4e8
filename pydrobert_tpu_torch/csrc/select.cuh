// Exact top-M selection for one row held in a warp's shared memory.
//
// Replaces the selection logic of pydrobert_tpu/ops/pallas.py
// (_total_order_key and _select_rounds_to_refs): M rounds of a masked
// argmax over int32 IEEE total-order keys. The result matches
// jax.lax.top_k bit for bit: values descending in the IEEE total order
// (+0.0 above -0.0), equal keys lowest index first.
//
// Design: a radix select in place of M dependent argmax rounds. Passes
// over the row's unsigned keys, one byte a pass from the top, count the
// keys that share the prefix found so far into a 256-bin histogram in the
// warp's shared memory; a warp scan of the bins finds the byte of the M-th
// largest key. The search starts below the bits that the M-th key is
// known to share with the row's maximum (for M <= 32, from the least and
// the largest of the lanes' maxima), and a bin that holds exactly the keys
// still needed ends it early, so most rows take one or two passes, not
// four, even where a row's keys crowd into a few exponents. One more pass
// takes the keys above that key and, by a ballot prefix count in index
// order, the first keys equal to it (one predicate when no tie is split),
// and a bitonic network sorts the M winners by (key desc, index asc): in
// shuffles for M <= 32, in the warp's shared memory above. Any M in
// [1, n] takes a few hundred instructions a row, where M argmax rounds
// took thousands.
#pragma once

#include <climits>
#include <cstdint>

namespace pydt {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kKeyFlip = 0x7FFFFFFF;
constexpr int kBins = 256;

// Ascending total-order key of a float: bigger key <=> bigger float, with
// -0.0 below +0.0. The map is an involution, so it also decodes.
__device__ __forceinline__ int32_t total_order_key(float x) {
  const int32_t i = __float_as_int(x);
  return i >= 0 ? i : (i ^ kKeyFlip);
}

__device__ __forceinline__ float key_to_float(int32_t k) {
  return __int_as_float(k >= 0 ? k : (k ^ kKeyFlip));
}

// The same order on unsigned keys, which the radix digits read.
__device__ __forceinline__ uint32_t radix_key(float x) {
  return (uint32_t)total_order_key(x) ^ 0x80000000u;
}

__device__ __forceinline__ float radix_to_float(uint32_t u) {
  return key_to_float((int32_t)(u ^ 0x80000000u));
}

// (key desc, index asc): does candidate a beat candidate b?
__device__ __forceinline__ bool beats(uint32_t ka, int ia, uint32_t kb,
                                      int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

// Words of shared memory select_top_m needs beside the keys.
__host__ __device__ inline int select_words(int M) {
  int mp = 1;
  while (mp < M) mp <<= 1;
  return 2 * mp > kBins ? 2 * mp : kBins;
}

// The top M of keys[0, n) (radix keys in this warp's shared memory),
// written as decoded floats and indices to vals_out[0, M) and idx_out[0, M)
// in device memory. `lane_max` is the largest of this lane's keys (0 if it
// holds none). `work` is this warp's select_words(M) words of shared
// memory: the histogram, then the winners (M keys, then M indices, padded
// to a power of two).
__device__ __forceinline__ void select_top_m(const uint32_t* keys, int n,
                                             int M, int lane,
                                             uint32_t lane_max,
                                             uint32_t* work, float* vals_out,
                                             int* idx_out) {
  // For M <= 32 the M-th largest key lies between the least and the
  // largest of the lanes' maxima (32 distinct keys reach the least), so
  // only keys from the least up are counted, the M-th shares the bits on
  // which those two agree, and the search starts below them; then one
  // byte a pass. A digit that holds exactly the keys still needed ends
  // the search there.
  const uint32_t top = __reduce_max_sync(kFull, lane_max);
  const uint32_t low = M <= kWarp ? __reduce_min_sync(kFull, lane_max) : 0u;
  const int agree = low == top ? 32 : __clz(low ^ top);
  uint32_t mask = agree == 0 ? 0u : ~0u << (32 - agree);
  uint32_t prefix = top & mask;  // no key shares it and lies above it
  int need = M;  // keys still to take among those that share the prefix
  bool whole = false;  // the keys >= prefix are exactly the M winners
#pragma unroll 1
  for (int shift = 24 - agree; agree < 32 && !whole; shift -= 8) {
    const int sh = shift > 0 ? shift : 0;  // a last digit may overlap
    for (int i = lane; i < kBins; i += kWarp) work[i] = 0;
    __syncwarp();
    for (int j0 = 0; j0 < n; j0 += 4 * kWarp) {
      uint32_t k[4];  // the loads before any atomic: they may not alias
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u * kWarp + lane;
        k[u] = j < n ? keys[j] : 0u;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (k[u] >= low && (k[u] & mask) == prefix)
          atomicAdd(&work[(k[u] >> sh) & 255u], 1u);
      }
    }
    __syncwarp();
    // lane l holds bins 255 - 8 l - i, i < 8: all bins in descending order
    int c[8], tot = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      c[i] = (int)work[255 - 8 * lane - i];
      tot += c[i];
    }
    int incl = tot;
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += o;
    }
    int above = incl - tot, found = -1, found_above = 0, found_count = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (found < 0 && above < need && need <= above + c[i]) {
        found = i;
        found_above = above;
        found_count = c[i];
      }
      above += c[i];
    }
    const int src = __ffs(__ballot_sync(kFull, found >= 0)) - 1;
    const int bin = 255 - 8 * src - __shfl_sync(kFull, found, src);
    need -= __shfl_sync(kFull, found_above, src);
    whole = need == __shfl_sync(kFull, found_count, src);
    prefix |= (uint32_t)bin << sh;
    mask |= 255u << sh;
    __syncwarp();
    if (sh == 0) break;
  }

  // the winners in index order: every key >= prefix when those are exactly
  // M; else every key above the M-th, then the first `need` keys equal to it
  int mp = 1;
  while (mp < M) mp <<= 1;
  uint32_t* wk = work;
  int* wi = reinterpret_cast<int*>(work + mp);
  const unsigned lower = (1u << lane) - 1u;
  if (whole) {
    const uint32_t from = prefix > low ? prefix : low;
    int taken = 0;
    for (int j0 = 0; j0 < n && taken < M; j0 += 4 * kWarp) {
      uint32_t k[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u * kWarp + lane;
        k[u] = j < n ? keys[j] : 0u;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u * kWarp + lane;
        const bool in = j < n && k[u] >= from;
        const unsigned bi = __ballot_sync(kFull, in);
        if (in) {
          const int p = taken + __popc(bi & lower);
          wk[p] = k[u];
          wi[p] = j;
        }
        taken += __popc(bi);
      }
    }
  } else {
    const int above = M - need;
    int n_gt = 0, n_eq = 0;
    for (int j0 = 0; j0 < n && (n_gt < above || n_eq < need); j0 += kWarp) {
      const int j = j0 + lane;
      const uint32_t k = j < n ? keys[j] : 0u;
      const bool gt = j < n && k > prefix, eq = j < n && k == prefix;
      const unsigned bg = __ballot_sync(kFull, gt);
      const unsigned be = __ballot_sync(kFull, eq);
      if (gt) {
        const int p = n_gt + __popc(bg & lower);
        wk[p] = k;
        wi[p] = j;
      }
      if (eq) {
        const int p = n_eq + __popc(be & lower);
        if (p < need) {
          wk[above + p] = k;
          wi[above + p] = j;
        }
      }
      n_gt += __popc(bg);
      n_eq += __popc(be);
    }
  }
  __syncwarp();

  if (M <= kWarp) {
    // lane l ends with the l-th best; lanes past M hold losers
    uint32_t k = lane < M ? wk[lane] : 0u;
    int i = lane < M ? wi[lane] : INT_MAX;
#pragma unroll
    for (int size = 2; size <= kWarp; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const uint32_t ok = __shfl_xor_sync(kFull, k, stride);
        const int oi = __shfl_xor_sync(kFull, i, stride);
        const bool desc = (lane & size) == 0, low = (lane & stride) == 0;
        // in a descending run the lower lane keeps the better one
        if (beats(ok, oi, k, i) == (low == desc)) {
          k = ok;
          i = oi;
        }
      }
    }
    if (lane < M) {
      vals_out[lane] = radix_to_float(k);
      idx_out[lane] = i;
    }
    return;
  }
  for (int e = M + lane; e < mp; e += kWarp) {
    wk[e] = 0u;
    wi[e] = INT_MAX;
  }
  __syncwarp();
  for (int size = 2; size <= mp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int q = lane; q < mp / 2; q += kWarp) {
        const int a = 2 * q - (q & (stride - 1)), b = a + stride;
        const uint32_t ka = wk[a], kb = wk[b];
        const int ia = wi[a], ib = wi[b];
        // in a descending run position a keeps the better one
        if (beats(kb, ib, ka, ia) == ((a & size) == 0)) {
          wk[a] = kb;
          wk[b] = ka;
          wi[a] = ib;
          wi[b] = ia;
        }
      }
      __syncwarp();
    }
  }
  for (int e = lane; e < M; e += kWarp) {
    vals_out[e] = radix_to_float(wk[e]);
    idx_out[e] = wi[e];
  }
}

}  // namespace pydt
