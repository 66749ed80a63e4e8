// Exact top-M selection for one row held in a warp's shared memory.
//
// Replaces the selection logic of pydrobert_tpu/ops/pallas.py
// (_total_order_key and _select_rounds_to_refs): M rounds of a masked
// argmax over int32 IEEE total-order keys, each winner retired before the
// next round. The result matches jax.lax.top_k bit for bit: values
// descending in the IEEE total order (+0.0 above -0.0), equal keys lowest
// index first.
#pragma once

#include <cstdint>

namespace pydt {

constexpr int kWarp = 32;
constexpr int32_t kKeyMin = INT32_MIN;  // retired or padding lane
constexpr int32_t kKeyFlip = 0x7FFFFFFF;

// Ascending total-order key of a float: bigger key <=> bigger float, with
// -0.0 below +0.0. The map is an involution, so it also decodes.
__device__ __forceinline__ int32_t total_order_key(float x) {
  const int32_t i = __float_as_int(x);
  return i >= 0 ? i : (i ^ kKeyFlip);
}

__device__ __forceinline__ float key_to_float(int32_t k) {
  return __int_as_float(k >= 0 ? k : (k ^ kKeyFlip));
}

// (key desc, index asc): does candidate a beat candidate b?
__device__ __forceinline__ bool beats(int32_t ka, int ia, int32_t kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

// Best (key, index) of this lane's strip keys[lane], keys[lane + 32], ...
// Scanning in index order with a strict compare keeps the lowest index
// among equal keys.
__device__ __forceinline__ void strip_best(
    const int32_t* keys, int n, int lane, int32_t& bk, int& bi) {
  bk = kKeyMin;
  bi = n;  // past the row: loses every tie with a real lane
  for (int j = lane; j < n; j += kWarp) {
    const int32_t k = keys[j];
    if (k > bk || (k == bk && j < bi)) {
      bk = k;
      bi = j;
    }
  }
}

// M selection rounds over keys[0, n) in shared memory (this warp's row),
// writing values (decoded floats) and indices to vals_out[0, M) and
// idx_out[0, M) in device memory. Each lane caches the best of its strip,
// so a round costs one warp argmax plus a rescan of the winner's strip.
// Results are held one per lane and stored 32 at a time, coalesced.
__device__ __forceinline__ void select_top_m(
    int32_t* keys, int n, int M, int lane, float* vals_out, int* idx_out) {
  int32_t lk;
  int li;
  strip_best(keys, n, lane, lk, li);
  int32_t held_k = kKeyMin;
  int held_i = 0;
  for (int r = 0; r < M; ++r) {
    int32_t bk = lk;
    int bi = li;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const int32_t ok = __shfl_xor_sync(0xffffffffu, bk, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (beats(ok, oi, bk, bi)) {
        bk = ok;
        bi = oi;
      }
    }
    if (lane == (r & (kWarp - 1))) {
      held_k = bk;
      held_i = bi;
    }
    if ((r & (kWarp - 1)) == kWarp - 1 || r == M - 1) {
      const int base = r & ~(kWarp - 1);
      if (base + lane <= r) {
        vals_out[base + lane] = key_to_float(held_k);
        idx_out[base + lane] = held_i;
      }
    }
    if (li == bi) {  // this lane owned the winner: retire it, rescan
      keys[bi] = kKeyMin;
      strip_best(keys, n, lane, lk, li);
    }
    __syncwarp();
  }
}

}  // namespace pydt
