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
// What bounds it on the H100: latency. The work is B read-modify-writes of
// single words (a few KB in all); the least time from bytes is
// nanoseconds, a launch alone costs microseconds. Design: a launch takes
// a chunk of up to kChunk = 4,096 ids (the wrapper launches longer batches
// chunk by chunk on one stream, so stream order keeps the recursion
// sequential across chunks). Each block loads the chunk's ids and losses
// in one round of coalesced loads, the ids as 64-bit keys (id, position)
// in shared memory (out-of-range ids as the largest key), and asks L2 for
// its share of the rows of s and seen. A block-wide sort of the keys
// (block_sort.cuh) makes each id's occurrences one run, in batch order,
// since the keys are unique and carry the position. The thread at the head
// of a run reads s[idx] and seen[idx] once, applies the run's losses in
// order in registers, and writes w, s and seen once. Grouping one id's
// occurrences in one thread, walked in batch order, is what keeps Eq.
// (3.1) sequential: distinct ids touch distinct words and do not depend on
// each other, so they run in parallel. The sort costs O(log^2 B) stages; a
// scan for an earlier equal id instead costs O(B) a thread (0.026 ms at
// B = 512 on the H100, PERF.md). Above kRunsPerBlock ids the chunk is
// spread over several blocks: each sorts the whole chunk (the same
// latency, in parallel) and walks the runs whose heads fall in its share
// of the sorted keys, so the scattered row accesses come from several SMs.
// A row belongs to the one run that holds its id, so no two blocks write
// the same word.
//
// Products use the round-to-nearest intrinsics so that no multiply-add is
// contracted into an FMA: the result is bitwise the plain PyTorch version's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sort.cuh"

namespace {

constexpr int kChunk = 4096;        // ids per launch; ops.py CHUNK
constexpr int kMaxThreads = 1024;
constexpr int kRunsPerBlock = 256;  // sorted keys a block walks
constexpr unsigned long long kNoKey = ~0ull;

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// dynamic shared memory: P keys, then B losses (P = 2^m >= B)
__global__ void __launch_bounds__(kMaxThreads) score_update_kernel(
    float* __restrict__ s, float* __restrict__ w, int32_t* __restrict__ seen,
    const int32_t* __restrict__ ids, const float* __restrict__ losses, int n,
    int B, int P, float b1, float omb1, float b2, float omb2) {
  extern __shared__ unsigned long long keys[];
  float* c_loss = reinterpret_cast<float*>(keys + P);
  // this block's share of the sorted keys (and of the rows to prefetch)
  const int k0 = blockIdx.x * kRunsPerBlock;
  const int k1 = min(P, k0 + kRunsPerBlock);
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    unsigned long long key = kNoKey;
    if (i < B) {
      const int idx = ids[i];
      c_loss[i] = losses[i];
      if (idx >= 0 && idx < n) {
        key = (static_cast<unsigned long long>(idx) << 32) |
              static_cast<unsigned>(i);
        if (i >= k0 && i < k1) {
          prefetch_l2(s + idx);
          prefetch_l2(seen + idx);
        }
      }
    }
    keys[i] = key;
  }
  __syncthreads();
  repro::block_sort(keys, P);
  for (int k = k0 + threadIdx.x; k < k1; k += blockDim.x) {
    const unsigned long long key = keys[k];
    const unsigned idx = static_cast<unsigned>(key >> 32);
    if (key == kNoKey || (k > 0 && (keys[k - 1] >> 32) == idx)) continue;
    float sv = s[idx];
    float wv = 0.f;
    int count = seen[idx];
    int m = k;
    do {
      const float loss = c_loss[static_cast<unsigned>(keys[m])];
      wv = __fadd_rn(__fmul_rn(b1, sv), __fmul_rn(omb1, loss));
      sv = __fadd_rn(__fmul_rn(b2, sv), __fmul_rn(omb2, loss));
      ++count;
    } while (++m < P && (keys[m] >> 32) == idx);
    w[idx] = wv;
    s[idx] = sv;
    seen[idx] = count;
  }
}

// An empty kernel: its device time is the card's floor for any launch.
__global__ void empty_kernel() {}

}  // namespace

extern "C" int repro_score_update(void* s, void* w, void* seen, const void* ids,
                                  const void* losses, int n, int B, float b1,
                                  float omb1, float b2, float omb2,
                                  void* stream) {
  if (B <= 0 || B > kChunk) return static_cast<int>(cudaErrorInvalidValue);
  int P = 2;
  while (P < B) P <<= 1;
  const int threads = P < 32 ? 32 : (P < kMaxThreads ? P : kMaxThreads);
  const int blocks = (P + kRunsPerBlock - 1) / kRunsPerBlock;
  const size_t smem = P * sizeof(unsigned long long) + B * sizeof(float);
  score_update_kernel<<<blocks, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(s), static_cast<float*>(w),
      static_cast<int32_t*>(seen), static_cast<const int32_t*>(ids),
      static_cast<const float*>(losses), n, B, P, b1, omb1, b2, omb2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
