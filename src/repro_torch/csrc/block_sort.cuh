// A block-wide ascending sort of P = 2^m 64-bit keys in shared memory
// (bitonic), for the score-store kernels: they sort (id, position) or
// (stamp, slot) pairs packed into unique keys, so the sort is the stable
// one. The stages whose partners are fewer than 32 elements apart run in
// registers with warp shuffles, several stages per shared-memory round
// trip; only the wider stages go through shared memory, one barrier each.
// At P = 1,024 that is 21 barriers instead of the plain network's 55.
//
// Every thread of the block must call it (blockDim.x a multiple of 32);
// it returns after a barrier, with keys[0, P) sorted.

#pragma once

#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ unsigned long long key_min(unsigned long long a,
                                                      unsigned long long b) {
  return a < b ? a : b;
}

__device__ __forceinline__ unsigned long long key_max(unsigned long long a,
                                                      unsigned long long b) {
  return a < b ? b : a;
}

// Stages j = j_top, j_top / 2, ..., 1 of merge level k on the key v of
// element e, all partners (e ^ j, j < 32) in the same warp.
__device__ __forceinline__ unsigned long long warp_stages(unsigned long long v,
                                                          int e, int k,
                                                          int j_top) {
  const bool up = (e & k) == 0;           // an ascending run at this level
  for (int j = j_top; j > 0; j >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, j);
    const bool low = (e & j) == 0;        // the lower element of its pair
    v = (low == up) ? key_min(v, o) : key_max(v, o);
  }
  return v;
}

// One pass of warp stages over keys[0, P): levels k_lo..k_hi with all of
// their stages below 32 apart (k_lo == k_hi past the first pass). Warps
// past P sit it out; lanes past P in the last warp hold a dummy key that
// no stored element compares with.
__device__ __forceinline__ void warp_pass(unsigned long long* keys, int P,
                                          int k_lo, int k_hi) {
  for (int base = 0; base < P; base += blockDim.x) {
    if (base + (threadIdx.x & ~31) >= P) break;    // a warp with no element
    const int e = base + threadIdx.x;
    unsigned long long v = e < P ? keys[e] : ~0ull;
    for (int k = k_lo; k <= k_hi; k <<= 1)
      v = warp_stages(v, e, k, (k >> 1) < 16 ? (k >> 1) : 16);
    if (e < P) keys[e] = v;
  }
  __syncthreads();
}

__device__ __forceinline__ void block_sort(unsigned long long* keys, int P) {
  warp_pass(keys, P, 2, P < 32 ? P : 32);
  for (int k = 64; k <= P; k <<= 1) {
    for (int j = k >> 1; j >= 32; j >>= 1) {
      for (int t = threadIdx.x; t < (P >> 1); t += blockDim.x) {
        const int a = 2 * t - (t & (j - 1));
        const int b = a + j;
        const unsigned long long ka = keys[a];
        const unsigned long long kb = keys[b];
        if ((ka > kb) == ((a & k) == 0)) {
          keys[a] = kb;
          keys[b] = ka;
        }
      }
      __syncthreads();
    }
    warp_pass(keys, P, k, k);
  }
}

}  // namespace repro
