// Quantized ES score update: int8 codes with per-block scales and an
// error-feedback residual ring, paper Eq. (3.1), in place on the device.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/score_update/score_update.py:fused_quant_score_update
// Its contract, for each (id, loss) pair IN SEQUENCE (ids < 0 or >= n are
// skipped):
//
//   s_prev = s_q[id] * s_scale[id / block] + newest ring residual of gid
//   w = b1 * s_prev + (1 - b1) * loss,   s = b2 * s_prev + (1 - b2) * loss
//   s_q[id], w_q[id] = clip(round_half_even(value / scale), -127, 127)
//   seen_q[id] = min(seen_q[id] + 1, 127)
//   ring[slot] = (gid, seq, s - q_s * scale, w - q_w * scale) if slot < R
//
// so a duplicate id sees the earlier occurrence's codes and ring entry.
// "Newest" is the largest stamp with row == gid (stamp 0 is empty), the
// lowest index among equal stamps. The scales are fixed here: the grow
// kernel (csrc/quant_prologue.cu) runs before, and so does the ring-slot
// kernel, whose slots and stamps this kernel takes.
//
// Why positions can run in parallel. The slots and stamps of one batch
// come from core/scores.py:_q_ring_slots (or its kernel), which gives:
//   1. the slots of owned (in-range) positions are DISTINCT: the k oldest
//      slots, or the dropped sentinel R; masked positions never write;
//   2. every stamp written is newer than every stamp before the batch, and
//      the stamps grow with batch position;
// and the store passes gids that are a function of the id. So for
// position i with global id g:
//   - if an earlier occurrence of g wrote a slot < R, the newest residual
//     of g is the LATEST such occurrence's (2.), which the thread walking
//     g's occurrences has just computed, and no other position overwrites
//     that slot in this batch (1.);
//   - otherwise it is the newest entry of the PRE-batch ring with row g
//     among the slots that no position before i writes: a table of the
//     first position writing each slot marks entry r valid for i when that
//     position is >= i;
//   - the code read for i is the one the previous occurrence wrote, and
//     seen saturates at 127 per occurrence.
// Nothing else couples positions.
//
// What bounds it on the H100: latency. The work is B read-modify-writes of
// a few bytes plus ring lookups (8 KB of ring at R = 1,024, L2 resident);
// the least time from bytes is nanoseconds. Design: one block takes a
// chunk of up to kChunk = 4,096 ids (the wrapper launches longer batches
// chunk by chunk on one stream; a chunk's pre-chunk ring holds the earlier
// chunks' entries, and 1. and 2. hold within a chunk). The block snapshots
// the ring (rows, stamps, s residuals) into shared memory, so that no
// lookup sees a write of this batch, builds the first-writer table, and
// sorts the (id, position) keys (block_sort.cuh) so that each id's
// occurrences form one run in batch order. Each warp takes run heads: it
// walks the run, scanning the ring snapshot 32 entries a step for the
// occurrences that need a pre-batch residual, every lane computing the
// arithmetic and lane 0 writing.
//
// The codes depend on every rounding, so the arithmetic is the plain
// version's exactly: round-to-nearest intrinsics (no FMA contraction),
// IEEE division, rintf (half to even, as jnp.round and torch.round).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "block_sort.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4096;          // ids per launch; ops.py CHUNK
constexpr int kMaxRing = 8192;        // ops.py QUANT_MAX_RING
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNoKey = ~0ull;

// (stamp, index) order: the larger stamp wins, the lower index on a tie.
__device__ __forceinline__ void take_newer(int& stamp, int& at, int o_stamp,
                                           int o_at) {
  if (o_stamp > stamp || (o_stamp == stamp && o_at < at)) {
    stamp = o_stamp;
    at = o_at;
  }
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

__device__ __forceinline__ float quantize(float v, float scale) {
  return fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
}

// dynamic shared memory: P (id, position) keys (P = 2^m >= B), the ring
// snapshot (rows, stamps, s residuals), the first-writer table, and the
// chunk's gids, losses, slots and stamps
__global__ void __launch_bounds__(kThreads) quant_score_update_kernel(
    int8_t* __restrict__ s_q, int8_t* __restrict__ w_q,
    int8_t* __restrict__ seen_q, const float* __restrict__ s_scale,
    const float* __restrict__ w_scale, int32_t* __restrict__ err_rows,
    int32_t* __restrict__ err_seq, float* __restrict__ err_s,
    float* __restrict__ err_w, const int32_t* __restrict__ ids,
    const int32_t* __restrict__ gids, const float* __restrict__ losses,
    const int32_t* __restrict__ slots, const int32_t* __restrict__ seqs,
    int n, int B, int P, int R, int block, float b1, float omb1, float b2,
    float omb2) {
  extern __shared__ unsigned long long keys[];           // (P,)
  int* r_rows = reinterpret_cast<int*>(keys + P);        // (R,)
  int* r_seq = r_rows + R;                               // (R,)
  float* r_es = reinterpret_cast<float*>(r_seq + R);     // (R,)
  int* first_w = reinterpret_cast<int*>(r_es + R);       // (R,)
  int* c_gid = first_w + R;                              // (B,)
  float* c_loss = reinterpret_cast<float*>(c_gid + B);   // (B,)
  int* c_slot = reinterpret_cast<int*>(c_loss + B);      // (B,)
  int* c_seq = c_slot + B;                               // (B,)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int r = tid; r < R; r += kThreads) {
    r_rows[r] = err_rows[r];
    r_seq[r] = err_seq[r];
    r_es[r] = err_s[r];
    first_w[r] = INT_MAX;
  }
  for (int i = tid; i < P; i += kThreads) {
    unsigned long long key = kNoKey;
    if (i < B) {
      const int idx = ids[i];
      c_gid[i] = gids[i];
      c_loss[i] = losses[i];
      c_slot[i] = slots[i];
      c_seq[i] = seqs[i];
      if (idx >= 0 && idx < n) {
        key = (static_cast<unsigned long long>(idx) << 32) |
              static_cast<unsigned>(i);
        prefetch_l2(s_q + idx);
        prefetch_l2(seen_q + idx);
      }
    }
    keys[i] = key;
  }
  __syncthreads();
  for (int i = tid; i < B; i += kThreads) {
    const int slot = c_slot[i];
    if (keys[i] != kNoKey && slot >= 0 && slot < R)
      atomicMin(&first_w[slot], i);
  }
  repro::block_sort(keys, P);                  // ends with a barrier

  for (int k = warp; k < P; k += kWarps) {
    const unsigned long long key = keys[k];
    if (key == kNoKey) break;                  // the rest are out of range
    const int idx = static_cast<int>(key >> 32);
    if (k > 0 && static_cast<int>(keys[k - 1] >> 32) == idx) continue;

    const int blk = idx / block;
    const float ssc = s_scale[blk];
    const float wsc = w_scale[blk];
    int code_s = s_q[idx];
    int code_w = 0;         // every run applies at least one occurrence
    int seen = seen_q[idx];
    bool wrote = false;     // an earlier occurrence wrote a slot < R
    float last_es = 0.f;    // ... and this is the latest one's residual
    for (int m = k; m < P && static_cast<int>(keys[m] >> 32) == idx; ++m) {
      const int p = static_cast<int>(static_cast<unsigned>(keys[m]));
      const int gid = c_gid[p];
      float resid = 0.f;
      if (wrote) {
        resid = last_es;
      } else {
        int stamp = 0;      // 0: no hit (ring stamps start at 1)
        int at = INT_MAX;
        for (int r = lane; r < R; r += 32) {
          const int st = r_seq[r];
          if (r_rows[r] == gid && first_w[r] >= p && st > stamp) {
            stamp = st;
            at = r;
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const int o_stamp = __shfl_xor_sync(kFull, stamp, off);
          const int o_at = __shfl_xor_sync(kFull, at, off);
          take_newer(stamp, at, o_stamp, o_at);
        }
        if (stamp > 0) resid = r_es[at];
      }
      const float loss = c_loss[p];
      const float deq = __fmul_rn(static_cast<float>(code_s), ssc);
      const float s_prev = __fadd_rn(deq, resid);
      const float w_new =
          __fadd_rn(__fmul_rn(b1, s_prev), __fmul_rn(omb1, loss));
      const float s_new =
          __fadd_rn(__fmul_rn(b2, s_prev), __fmul_rn(omb2, loss));
      const float q_s = quantize(s_new, ssc);
      const float q_w = quantize(w_new, wsc);
      code_s = static_cast<int>(q_s);
      code_w = static_cast<int>(q_w);
      seen = min(seen + 1, 127);
      const int slot = c_slot[p];
      if (slot >= 0 && slot < R) {
        const float e_s = __fsub_rn(s_new, __fmul_rn(q_s, ssc));
        const float e_w = __fsub_rn(w_new, __fmul_rn(q_w, wsc));
        if (lane == 0) {
          err_rows[slot] = gid;
          err_seq[slot] = c_seq[p];
          err_s[slot] = e_s;
          err_w[slot] = e_w;
        }
        wrote = true;
        last_es = e_s;
      }
    }
    if (lane == 0) {
      s_q[idx] = static_cast<int8_t>(code_s);
      w_q[idx] = static_cast<int8_t>(code_w);
      seen_q[idx] = static_cast<int8_t>(seen);
    }
  }
}

}  // namespace

extern "C" int repro_quant_score_update(
    void* s_q, void* w_q, void* seen_q, const void* s_scale,
    const void* w_scale, void* err_rows, void* err_seq, void* err_s,
    void* err_w, const void* ids, const void* gids, const void* losses,
    const void* slots, const void* seqs, int n, int B, int R, int block,
    float b1, float omb1, float b2, float omb2, void* stream) {
  if (B <= 0 || B > kChunk || R <= 0 || R > kMaxRing || block <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int P = 2;
  while (P < B) P <<= 1;
  const size_t smem = P * sizeof(unsigned long long) +
                      4 * static_cast<size_t>(R + B) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        quant_score_update_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  quant_score_update_kernel<<<1, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(s_q), static_cast<int8_t*>(w_q),
      static_cast<int8_t*>(seen_q), static_cast<const float*>(s_scale),
      static_cast<const float*>(w_scale), static_cast<int32_t*>(err_rows),
      static_cast<int32_t*>(err_seq), static_cast<float*>(err_s),
      static_cast<float*>(err_w), static_cast<const int32_t*>(ids),
      static_cast<const int32_t*>(gids), static_cast<const float*>(losses),
      static_cast<const int32_t*>(slots), static_cast<const int32_t*>(seqs),
      n, B, P, R, block, b1, omb1, b2, omb2);
  return static_cast<int>(cudaGetLastError());
}
