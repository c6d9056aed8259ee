// Masked segment sum of packed rows: per-token NLL (B, S) -> per-slot sums
// and live-token counts (B, M), M <= 8.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/segsum/segsum.py:fused_segment_sum
// Token s of row b adds nll[b, s] to slot seg[b, s] - 1 when mask[b, s] is
// set and 1 <= seg[b, s] <= M; padding (seg 0) and masked tokens add
// nothing. The TPU kernel reduced a (block_b, S) tile with the S axis
// padded to 128 lanes and the outputs to 128 columns; here the ragged B
// and S edges are handled in the kernel, so nothing is padded.
//
// What bounds it on the H100: bytes. It reads 9 bytes a token (nll, seg,
// mask) once and writes 8 bytes a slot: 74 KB at B = 16, S = 512, about
// 22 ns at 3.35 TB/s, so in practice the launch (a few microseconds) is
// the cost. Design: one warp per row. Lanes stride over the row (coalesced
// loads), each lane keeps its M partial sums and counts in registers, and
// a shuffle tree folds the 32 lanes into lane 0 in a fixed order. No
// atomics, so a run is bitwise repeatable; the order differs from the
// plain version's, so sums agree to float32 rounding and counts exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSlots = 8;
constexpr int kWarps = 4;  // rows per block

__global__ void segsum_kernel(const float* __restrict__ nll,
                              const int32_t* __restrict__ seg,
                              const uint8_t* __restrict__ mask,
                              float* __restrict__ sums,
                              float* __restrict__ counts, int B, int S,
                              int M) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= B) return;
  const size_t base = static_cast<size_t>(row) * S;
  float acc[kMaxSlots];
  int cnt[kMaxSlots];
#pragma unroll
  for (int m = 0; m < kMaxSlots; ++m) {
    acc[m] = 0.f;
    cnt[m] = 0;
  }
  for (int s = lane; s < S; s += 32) {
    const int k = seg[base + s];
    if (!mask[base + s] || k < 1 || k > M) continue;
    const float x = nll[base + s];
#pragma unroll
    for (int m = 0; m < kMaxSlots; ++m) {
      if (k == m + 1) {
        acc[m] += x;
        cnt[m] += 1;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kMaxSlots; ++m) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc[m] += __shfl_down_sync(0xffffffffu, acc[m], off);
      cnt[m] += __shfl_down_sync(0xffffffffu, cnt[m], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < kMaxSlots; ++m) {
      if (m < M) {
        sums[static_cast<size_t>(row) * M + m] = acc[m];
        counts[static_cast<size_t>(row) * M + m] = static_cast<float>(cnt[m]);
      }
    }
  }
}

}  // namespace

extern "C" int repro_segment_sum(const void* nll, const void* seg,
                                 const void* mask, void* sums, void* counts,
                                 int B, int S, int M, void* stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  segsum_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(nll), static_cast<const int32_t*>(seg),
      static_cast<const uint8_t*>(mask), static_cast<float*>(sums),
      static_cast<float*>(counts), B, S, M);
  return static_cast<int>(cudaGetLastError());
}
