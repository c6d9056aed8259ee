// Fused ES score/weight update, paper Eq. (3.1), in place on the device.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/score_update/score_update.py:fused_score_update
// (masked mode, as core/scores.py ReplicatedStore.update dispatches it):
//
//   w[i] = b1 * s[i] + (1 - b1) * l
//   s[i] = b2 * s[i] + (1 - b2) * l
//   seen[i] += 1
//
// applied SEQUENTIALLY over the (id, loss) pairs, so a duplicate id sees
// the earlier occurrence's update (s ends at 2.75, not the scatter's 2.5,
// in the duplicate-id pin). Ids outside [0, n) are dropped.
//
// What bounds it on the H100: latency. The work is B <= a few hundred
// dependent read-modify-writes of single words (a few KB in all); the
// least time from bytes is nanoseconds, the launch alone costs microseconds.
// Design: one thread walks the ids in order. That keeps the recursion's
// semantics without sorting or atomics (a thread per id would race on
// duplicates) and costs a few microseconds at B = 32.
//
// Products use the round-to-nearest intrinsics so that no multiply-add is
// contracted into an FMA: the result is bitwise the plain PyTorch version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void score_update_kernel(float* __restrict__ s, float* __restrict__ w,
                                    int32_t* __restrict__ seen,
                                    const int32_t* __restrict__ ids,
                                    const float* __restrict__ losses,
                                    int n, int B, float b1, float omb1,
                                    float b2, float omb2) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  for (int i = 0; i < B; ++i) {
    const int idx = ids[i];
    if (idx < 0 || idx >= n) continue;
    const float loss = losses[i];
    const float s_prev = s[idx];
    w[idx] = __fadd_rn(__fmul_rn(b1, s_prev), __fmul_rn(omb1, loss));
    s[idx] = __fadd_rn(__fmul_rn(b2, s_prev), __fmul_rn(omb2, loss));
    seen[idx] += 1;
  }
}

}  // namespace

extern "C" int repro_score_update(void* s, void* w, void* seen, const void* ids,
                                  const void* losses, int n, int B, float b1,
                                  float omb1, float b2, float omb2,
                                  void* stream) {
  score_update_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(s), static_cast<float*>(w),
      static_cast<int32_t*>(seen), static_cast<const int32_t*>(ids),
      static_cast<const float*>(losses), n, B, b1, omb1, b2, omb2);
  return static_cast<int>(cudaGetLastError());
}
