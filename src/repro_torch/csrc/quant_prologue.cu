// The int8 score store's update prologue on the device: the scale grow and
// re-code, and the ring-slot assignment. With the apply kernel
// (csrc/quant_score_update.cu) they make one QuantizedStore.update three
// launches and no host sync.
//
// Replace the XLA prologue of the reference's quantized update
// (src/repro/core/scores.py:_q_update_local), which feeds the Pallas
// kernel src/repro/kernels/score_update/score_update.py:
// fused_quant_score_update:
//
// quant_grow_kernel, for _q_grow_scales. From the PRE-batch store, each
// in-range id's s_prev = code * scale + newest ring residual of its gid
// (the largest stamp with that row, the lowest index on a tie), w_new and
// s_new of Eq. (3.1), and its block's need max(|v|) / 127 over the batch;
// the block's scale becomes max(scale, need) (grow-only), and the stored
// codes of a block whose scale grew are re-coded onto the new grid,
// round(q * (old / new)). A block whose scale did not grow has ratio
// exactly 1 and would re-code to the same codes, so it is neither read nor
// written: that is why the reference may skip the pass under lax.cond
// when nothing grew, and why this kernel costs O(B * block) on a growth
// step and O(B) otherwise, never O(n).
// Design: one block (256 threads) per batch position. A position whose
// store block already appears at an earlier in-range position exits after
// one parallel scan; the first one owns the store block: its warps take
// the batch's positions in that store block, each scanning the (R,) ring
// for its residual, and fold the needs with atomicMax on the bits of the
// non-negative floats (which order like the floats, so the max is
// bitwise the plain version's scatter_reduce "amax"); then it re-codes the
// block's rows if a scale grew and writes both scales. Blocks own disjoint
// rows and scales, so no block waits for another.
//
// quant_ring_slots_kernel, for _q_ring_slots. The batch's ring slots and
// stamps: the k = min(B, R) oldest slots by (stamp, index), a stable
// ascending argsort, are recycled; masked positions take the front ranks
// (the dropped sentinel R, then the newer candidates), owned positions
// the oldest slots in batch order, and stamps are max(err_seq) + 1 + rank.
// Design: one block; a block-wide sort (block_sort.cuh) of the (stamp,
// index) pairs packed into 64-bit keys (unique, so the sort is the stable
// one), then each position's rank from a block-wide prefix count of the
// masked positions.
//
// What bounds both on the H100: latency. The bytes are the ring (8 KB at
// R = 1,024), B ids, and block rows of the blocks that grew; the least
// time from bytes is nanoseconds.
//
// The arithmetic is the plain version's exactly: round-to-nearest
// intrinsics (no FMA contraction), IEEE division, rintf (half to even).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "block_sort.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kGrowThreads = 256;
constexpr int kGrowWarps = kGrowThreads / 32;
constexpr int kSlotThreads = 1024;
constexpr int kMaxRing = 8192;        // ops.py QUANT_MAX_RING

__device__ __forceinline__ bool in_range(int idx, int n) {
  return idx >= 0 && idx < n;
}

__global__ void __launch_bounds__(kGrowThreads) quant_grow_kernel(
    int8_t* __restrict__ s_q, int8_t* __restrict__ w_q,
    float* __restrict__ s_scale, float* __restrict__ w_scale,
    const int32_t* __restrict__ err_rows, const int32_t* __restrict__ err_seq,
    const float* __restrict__ err_s, const int32_t* __restrict__ ids,
    const int32_t* __restrict__ gids, const float* __restrict__ losses,
    int n, int B, int R, int block, float b1, float omb1, float b2,
    float omb2) {
  __shared__ unsigned need_s_bits, need_w_bits;
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int idx = ids[i];
  if (!in_range(idx, n)) return;                  // the same for the block
  const int blk = idx / block;
  if (tid == 0) {
    need_s_bits = 0u;
    need_w_bits = 0u;
  }
  bool earlier = false;
  for (int j = tid; j < i; j += kGrowThreads) {
    const int o = ids[j];
    earlier |= in_range(o, n) && o / block == blk;
  }
  if (__syncthreads_or(earlier)) return;

  // read before the barrier that orders them before thread 0's write
  const float old_s = s_scale[blk];
  const float old_w = w_scale[blk];
  for (int j = i + warp; j < B; j += kGrowWarps) {
    const int o = ids[j];
    if (!in_range(o, n) || o / block != blk) continue;   // warp-uniform
    const int gid = gids[j];
    int stamp = 0;            // 0: no hit (ring stamps start at 1)
    int at = INT_MAX;
#pragma unroll 8
    for (int r = lane; r < R; r += 32) {       // L2-resident: keep loads in flight
      const int row = err_rows[r];
      const int seq = err_seq[r];
      const int st = row == gid ? seq : 0;
      if (st > stamp) {
        stamp = st;
        at = r;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int o_stamp = __shfl_xor_sync(kFull, stamp, off);
      const int o_at = __shfl_xor_sync(kFull, at, off);
      if (o_stamp > stamp || (o_stamp == stamp && o_at < at)) {
        stamp = o_stamp;
        at = o_at;
      }
    }
    if (lane == 0) {
      const float loss = losses[j];
      const float deq = __fmul_rn(static_cast<float>(s_q[o]), old_s);
      const float s_prev = __fadd_rn(deq, stamp > 0 ? err_s[at] : 0.f);
      const float w_new =
          __fadd_rn(__fmul_rn(b1, s_prev), __fmul_rn(omb1, loss));
      const float s_new =
          __fadd_rn(__fmul_rn(b2, s_prev), __fmul_rn(omb2, loss));
      atomicMax(&need_s_bits, __float_as_uint(__fdiv_rn(fabsf(s_new), 127.f)));
      atomicMax(&need_w_bits, __float_as_uint(__fdiv_rn(fabsf(w_new), 127.f)));
    }
  }
  __syncthreads();
  const float new_s = fmaxf(old_s, __uint_as_float(need_s_bits));
  const float new_w = fmaxf(old_w, __uint_as_float(need_w_bits));
  const int row0 = blk * block;
  const int row1 = min(n, row0 + block);
  if (new_s > old_s) {
    const float ratio = __fdiv_rn(old_s, new_s);      // < 1: no clipping
    for (int r = row0 + tid; r < row1; r += kGrowThreads)
      s_q[r] = static_cast<int8_t>(static_cast<int>(
          rintf(__fmul_rn(static_cast<float>(s_q[r]), ratio))));
  }
  if (new_w > old_w) {
    const float ratio = __fdiv_rn(old_w, new_w);
    for (int r = row0 + tid; r < row1; r += kGrowThreads)
      w_q[r] = static_cast<int8_t>(static_cast<int>(
          rintf(__fmul_rn(static_cast<float>(w_q[r]), ratio))));
  }
  if (tid == 0) {
    s_scale[blk] = new_s;
    w_scale[blk] = new_w;
  }
}

__global__ void __launch_bounds__(kSlotThreads) quant_ring_slots_kernel(
    const int32_t* __restrict__ err_seq, const int32_t* __restrict__ ids,
    int32_t* __restrict__ slots, int32_t* __restrict__ seqs, int n, int B,
    int R, int P) {
  extern __shared__ unsigned long long keys[];   // (P,), P = 2^m >= R
  __shared__ int part[kSlotThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kWarps = kSlotThreads / 32;

  int mx = INT_MIN;
  for (int r = tid; r < P; r += kSlotThreads) {
    if (r < R) {
      const int st = err_seq[r];
      mx = max(mx, st);
      keys[r] = (static_cast<unsigned long long>(static_cast<uint32_t>(st))
                 << 32) | static_cast<unsigned>(r);
    } else {
      keys[r] = ~0ull;                              // sorts last
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = max(mx, __shfl_xor_sync(kFull, mx, off));
  if (lane == 0) part[warp] = mx;
  __syncthreads();
  mx = part[0];
  for (int w = 1; w < kWarps; ++w) mx = max(mx, part[w]);
  const int base = mx + 1;

  repro::block_sort(keys, P);

  const int k_rec = min(B, R);
  int n_masked = 0;
  for (int t0 = 0; t0 < B; t0 += kSlotThreads) {
    const int i = t0 + tid;
    n_masked += __syncthreads_count(i < B && !in_range(ids[i], n));
  }
  int carry = 0;                                 // masked before the tile
  for (int t0 = 0; t0 < B; t0 += kSlotThreads) {
    const int i = t0 + tid;
    const bool masked = i < B && !in_range(ids[i], n);
    const unsigned bal = __ballot_sync(kFull, masked);
    if (lane == 0) part[warp] = __popc(bal);
    __syncthreads();
    int before = carry + __popc(bal & ((1u << lane) - 1u));
    int total = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += part[w];
      total += part[w];
    }
    if (i < B) {
      const int rank = masked ? before : n_masked + (i - before);
      slots[i] = rank < B - k_rec
                     ? R
                     : static_cast<int>(keys[B - 1 - rank] & 0xffffffffull);
      seqs[i] = base + rank;
    }
    carry += total;
    __syncthreads();                             // part is rewritten next
  }
}

}  // namespace

extern "C" int repro_quant_grow_scales(
    void* s_q, void* w_q, void* s_scale, void* w_scale, const void* err_rows,
    const void* err_seq, const void* err_s, const void* ids, const void* gids,
    const void* losses, int n, int B, int R, int block, float b1, float omb1,
    float b2, float omb2, void* stream) {
  if (B <= 0 || R <= 0 || block <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  quant_grow_kernel<<<B, kGrowThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(s_q), static_cast<int8_t*>(w_q),
      static_cast<float*>(s_scale), static_cast<float*>(w_scale),
      static_cast<const int32_t*>(err_rows),
      static_cast<const int32_t*>(err_seq), static_cast<const float*>(err_s),
      static_cast<const int32_t*>(ids), static_cast<const int32_t*>(gids),
      static_cast<const float*>(losses), n, B, R, block, b1, omb1, b2, omb2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_quant_ring_slots(const void* err_seq, const void* ids,
                                      void* slots, void* seqs, int n, int B,
                                      int R, void* stream) {
  if (B <= 0 || R <= 0 || R > kMaxRing)
    return static_cast<int>(cudaErrorInvalidValue);
  int P = 1;
  while (P < R) P <<= 1;
  const size_t smem = static_cast<size_t>(P) * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        quant_ring_slots_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  quant_ring_slots_kernel<<<1, kSlotThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(err_seq), static_cast<const int32_t*>(ids),
      static_cast<int32_t*>(slots), static_cast<int32_t*>(seqs), n, B, R, P);
  return static_cast<int>(cudaGetLastError());
}
