// Quantized ES score update: int8 codes with per-block scales and an
// error-feedback residual ring, paper Eq. (3.1), in place on the device.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/score_update/score_update.py:fused_quant_score_update
// For each (id, loss) pair IN SEQUENCE (ids < 0 or >= n are skipped):
//
//   s_prev = s_q[id] * s_scale[id / block] + newest ring residual of gid
//   w = b1 * s_prev + (1 - b1) * loss,   s = b2 * s_prev + (1 - b2) * loss
//   s_q[id], w_q[id] = clip(round_half_even(value / scale), -127, 127)
//   seen_q[id] = min(seen_q[id] + 1, 127)
//   ring[slot] = (gid, seq, s - q_s * scale, w - q_w * scale) if slot < R
//
// so a duplicate id sees the earlier occurrence's codes and ring entry.
// The scales are fixed here: the grow/recode prologue and the ring-slot
// assignment run before the launch, in PyTorch (XLA in the reference).
//
// What bounds it on the H100: latency. The work is B dependent
// read-modify-writes of a few bytes each plus a scan of the (R,) ring per
// id (8 KB at R = 1024, L1/L2 resident); the least time from bytes is
// nanoseconds. Design: one block walks the ids in order. For each id the
// block scans the ring in parallel for the newest stamp whose row equals
// gid (lowest index among equal stamps, as jnp.argmax), one thread then
// dequantises, applies Eq. (3.1), requantises and writes the ring, and a
// barrier orders it before the next id reads the ring.
//
// The codes depend on every rounding, so the arithmetic is the plain
// version's exactly: round-to-nearest intrinsics (no FMA contraction),
// IEEE division, rintf (half to even, as jnp.round and torch.round).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// (stamp, index) order: the larger stamp wins, the lower index on a tie.
__device__ __forceinline__ void take_newer(int& stamp, int& at, int o_stamp,
                                           int o_at) {
  if (o_stamp > stamp || (o_stamp == stamp && o_at < at)) {
    stamp = o_stamp;
    at = o_at;
  }
}

__device__ __forceinline__ float quantize(float v, float scale) {
  return fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
}

__global__ void __launch_bounds__(kThreads) quant_score_update_kernel(
    int8_t* s_q, int8_t* w_q, int8_t* seen_q,
    const float* __restrict__ s_scale, const float* __restrict__ w_scale,
    int32_t* err_rows, int32_t* err_seq, float* err_s, float* err_w,
    const int32_t* __restrict__ ids, const int32_t* __restrict__ gids,
    const float* __restrict__ losses, const int32_t* __restrict__ slots,
    const int32_t* __restrict__ seqs, int n, int B, int R, int block,
    float b1, float omb1, float b2, float omb2) {
  __shared__ int red_stamp[kWarps];
  __shared__ int red_at[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = 0; i < B; ++i) {
    const int idx = ids[i];
    if (idx < 0 || idx >= n) continue;  // the same for every thread
    const int gid = gids[i];
    // stamp 0 marks "no hit": ring stamps start at 1
    int stamp = 0;
    int at = 0x7fffffff;
    for (int r = tid; r < R; r += kThreads) {
      const int st = err_rows[r] == gid ? err_seq[r] : 0;
      if (st > stamp) {
        stamp = st;
        at = r;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int o_stamp = __shfl_down_sync(0xffffffffu, stamp, off);
      const int o_at = __shfl_down_sync(0xffffffffu, at, off);
      take_newer(stamp, at, o_stamp, o_at);
    }
    if (lane == 0) {
      red_stamp[warp] = stamp;
      red_at[warp] = at;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kWarps; ++w) take_newer(stamp, at, red_stamp[w],
                                                  red_at[w]);
      const int blk = idx / block;
      const float ssc = s_scale[blk];
      const float wsc = w_scale[blk];
      const float loss = losses[i];
      const float deq = __fmul_rn(static_cast<float>(s_q[idx]), ssc);
      const float s_prev = __fadd_rn(deq, stamp > 0 ? err_s[at] : 0.f);
      const float w_new = __fadd_rn(__fmul_rn(b1, s_prev), __fmul_rn(omb1, loss));
      const float s_new = __fadd_rn(__fmul_rn(b2, s_prev), __fmul_rn(omb2, loss));
      const float q_s = quantize(s_new, ssc);
      const float q_w = quantize(w_new, wsc);
      s_q[idx] = static_cast<int8_t>(static_cast<int>(q_s));
      w_q[idx] = static_cast<int8_t>(static_cast<int>(q_w));
      seen_q[idx] = static_cast<int8_t>(min(static_cast<int>(seen_q[idx]) + 1, 127));
      const int slot = slots[i];
      if (slot >= 0 && slot < R) {
        err_rows[slot] = gid;
        err_seq[slot] = seqs[i];
        err_s[slot] = __fsub_rn(s_new, __fmul_rn(q_s, ssc));
        err_w[slot] = __fsub_rn(w_new, __fmul_rn(q_w, wsc));
      }
    }
    __syncthreads();  // the next id reads the ring this one wrote
  }
}

}  // namespace

extern "C" int repro_quant_score_update(
    void* s_q, void* w_q, void* seen_q, const void* s_scale,
    const void* w_scale, void* err_rows, void* err_seq, void* err_s,
    void* err_w, const void* ids, const void* gids, const void* losses,
    const void* slots, const void* seqs, int n, int B, int R, int block,
    float b1, float omb1, float b2, float omb2, void* stream) {
  quant_score_update_kernel<<<1, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(s_q), static_cast<int8_t*>(w_q),
      static_cast<int8_t*>(seen_q), static_cast<const float*>(s_scale),
      static_cast<const float*>(w_scale), static_cast<int32_t*>(err_rows),
      static_cast<int32_t*>(err_seq), static_cast<float*>(err_s),
      static_cast<float*>(err_w), static_cast<const int32_t*>(ids),
      static_cast<const int32_t*>(gids), static_cast<const float*>(losses),
      static_cast<const int32_t*>(slots), static_cast<const int32_t*>(seqs),
      n, B, R, block, b1, omb1, b2, omb2);
  return static_cast<int>(cudaGetLastError());
}
