// Masked segment sum of packed rows and its gradient.
//
// Forward (segsum_kernel, entry repro_segment_sum): per-token NLL (B, S)
// -> per-slot sums and live-token counts (B, M), any M >= 1. Replaces the
// Pallas TPU kernel
//   src/repro/kernels/segsum/segsum.py:fused_segment_sum
// Token s of row b adds nll[b, s] to slot seg[b, s] - 1 when mask[b, s] is
// set and 1 <= seg[b, s] <= M; every other token adds nothing. Ids may come
// in any order. The TPU kernel reduced a (block_b, S) tile with S padded to
// 128 lanes and a static loop over the M slots; here the ragged B and S
// edges are handled in the kernel and M is a runtime value.
//
// Backward (segsum_grad_kernel, entry repro_segment_sum_grad):
// grad_nll[b, s] = grad_sums[b, seg[b, s] - 1] where the token is live and
// in a slot, 0 elsewhere. It replaces the port's plain-autograd backward
// (about ten PyTorch launches), whose reference is XLA's gradient of the
// one-hot einsum in src/repro/models/losses.py:89-111; the TPU has no
// Pallas backward for this kernel.
//
// What bounds both on the H100: bytes, 9 a token (nll 4, ids 4, mask 1)
// read by the forward, 5 read and 4 written by the backward: 74 KB at
// 8,192 tokens, 22 ns at 3.35 TB/s. In practice the launch bounds them (an
// empty kernel takes 0.00087 ms of device time on an H100 80GB HBM3 at
// 700 W), so the design keeps every load of a thread in flight at once and
// the work after it short:
// - Forward: a row is spread over a block of 128 threads. Each thread
//   reads 16-byte vectors (float4 of nll, int4 of ids, 4 mask bytes as one
//   word), four of them issued together; a ragged or unaligned row's edge
//   tokens are read one by one. A thread keeps the run it is adding to in
//   registers and flushes it to its own column of its warp's [slot][lane]
//   table in shared memory when the slot changes, so lanes never collide
//   and the table needs no atomics for any id order. After a barrier each
//   (warp, slot) row of lanes is folded by a tree in a fixed order, then
//   the warps in order. Slots come 64 at a time; a larger M loops over
//   slot tiles, reading the row again. No float atomics: a run is bitwise
//   repeatable. The order differs from the plain version's, so sums agree
//   to float32 rounding and counts exactly. A batch of few long rows
//   leaves most SMs idle; a draft that split a row over a cluster of
//   blocks paid only at B = 1, a shape no training path sends, so a
//   launch is one block a row.
// - Backward: one elementwise pass, a thread per 4 tokens (int4 ids, one
//   mask word, a float4 store), the gradient gathered from the (B, M)
//   rows in L1/L2; any strides of grad_sums, so an expanded gradient
//   needs no copy. Exact: each live token takes exactly one term.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;         // slots a pass holds in shared memory
constexpr int kUnroll = 4;        // 16-byte vectors a thread has in flight
constexpr int kGradThreads = 256;

// The slot a lane is adding to (-1: none) and its partial sum and count.
struct Run {
  int slot;
  float sum;
  int cnt;
};

struct Table {
  float* sum;  // [kWarps * mt][32]: (warp, slot) rows, a column per lane
  int* cnt;
  int row0;    // warp * mt
  int lane;
};

__device__ __forceinline__ void flush(const Run& r, const Table& t) {
  if (r.slot >= 0) {
    const int at = (t.row0 + r.slot) * 32 + t.lane;
    t.sum[at] += r.sum;
    t.cnt[at] += r.cnt;
  }
}

// Token with id k (any int), live flag and nll x, against slots
// [m0, m0 + mt) of this pass.
__device__ __forceinline__ void add(Run& r, const Table& t, int k,
                                    unsigned live, float x, unsigned m0,
                                    unsigned mt) {
  const unsigned ls = static_cast<unsigned>(k) - 1u - m0;
  if (live && ls < mt) {
    if (static_cast<int>(ls) == r.slot) {
      r.sum += x;
      ++r.cnt;
    } else {
      flush(r, t);
      r.slot = static_cast<int>(ls);
      r.sum = x;
      r.cnt = 1;
    }
  }
}

// s[j] += s[j + H], c[j] += c[j + H] for j < H: one level of the fixed
// fold tree, unrolled so the 32 values stay in registers
template <int H>
__device__ __forceinline__ void fold_half(float (&s)[32], int (&c)[32]) {
#pragma unroll
  for (int j = 0; j < H; ++j) {
    s[j] += s[j + H];
    c[j] += c[j + H];
  }
}

__global__ void __launch_bounds__(kThreads)
    segsum_kernel(const float* __restrict__ nll,
                  const int32_t* __restrict__ seg,
                  const uint8_t* __restrict__ mask, float* __restrict__ sums,
                  float* __restrict__ counts, int S, int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  const int mmax = min(M, kTile);
  float* tab_s = reinterpret_cast<float*>(smem);
  int* tab_c = reinterpret_cast<int*>(tab_s + kWarps * mmax * 32);
  float* wsum = reinterpret_cast<float*>(tab_c + kWarps * mmax * 32);
  int* wcnt = reinterpret_cast<int*>(wsum + kWarps * mmax);

  // The row's tokens [g0, g1) of the flat arrays: whole vectors [va, vb)
  // when the pointers allow 16-byte loads, single tokens around them
  // (all of them single tokens otherwise).
  const size_t g0 = static_cast<size_t>(row) * S;
  const size_t g1 = g0 + S;
  const bool vec = ((reinterpret_cast<uintptr_t>(nll) |
                     reinterpret_cast<uintptr_t>(seg)) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(mask) & 3) == 0;
  size_t va = g1, vb = g1;
  if (vec) {
    va = min((g0 + 3) & ~static_cast<size_t>(3), g1);
    vb = max(g1 & ~static_cast<size_t>(3), va);
  }
  const size_t v0 = va / 4, v1 = vb / 4;
  const float4* x4 = reinterpret_cast<const float4*>(nll);
  const int4* k4 = reinterpret_cast<const int4*>(seg);
  const uint32_t* m4 = reinterpret_cast<const uint32_t*>(mask);

  for (int m0 = 0; m0 < M; m0 += kTile) {
    const int mt = min(kTile, M - m0);
    const Table t{tab_s, tab_c, warp * mt, tid & 31};
    for (int i = tid; i < kWarps * mt * 8; i += kThreads) {
      reinterpret_cast<float4*>(tab_s)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<int4*>(tab_c)[i] = make_int4(0, 0, 0, 0);
    }
    __syncthreads();

    Run r{-1, 0.f, 0};
    for (size_t v = v0 + tid; v < v1; v += kUnroll * kThreads) {
      float4 x[kUnroll];
      int4 k[kUnroll];
      uint32_t mk[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const size_t w = v + static_cast<size_t>(u) * kThreads;
        mk[u] = 0u;
        if (w < v1) {
          x[u] = __ldg(x4 + w);
          k[u] = __ldg(k4 + w);
          mk[u] = __ldg(m4 + w);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!mk[u]) continue;
        add(r, t, k[u].x, mk[u] & 0xffu, x[u].x, m0, mt);
        add(r, t, k[u].y, mk[u] & 0xff00u, x[u].y, m0, mt);
        add(r, t, k[u].z, mk[u] & 0xff0000u, x[u].z, m0, mt);
        add(r, t, k[u].w, mk[u] & 0xff000000u, x[u].w, m0, mt);
      }
    }
    for (size_t s = g0 + tid; s < va; s += kThreads)
      add(r, t, __ldg(seg + s), __ldg(mask + s), __ldg(nll + s), m0, mt);
    for (size_t s = vb + tid; s < g1; s += kThreads)
      add(r, t, __ldg(seg + s), __ldg(mask + s), __ldg(nll + s), m0, mt);
    flush(r, t);
    __syncthreads();

    // (warp, slot) row p: its 32 lanes as a tree, read rotated by p so
    // the 32 rows a warp folds sit in 32 banks
    for (int p = tid; p < kWarps * mt; p += kThreads) {
      float s[32];
      int c[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        s[j] = tab_s[p * 32 + ((j + p) & 31)];
        c[j] = tab_c[p * 32 + ((j + p) & 31)];
      }
      fold_half<16>(s, c);
      fold_half<8>(s, c);
      fold_half<4>(s, c);
      fold_half<2>(s, c);
      fold_half<1>(s, c);
      wsum[p] = s[0];
      wcnt[p] = c[0];
    }
    __syncthreads();
    if (tid < mt) {
      float s = wsum[tid];
      int c = wcnt[tid];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        s += wsum[w * mt + tid];
        c += wcnt[w * mt + tid];
      }
      const size_t o = static_cast<size_t>(row) * M + m0 + tid;
      sums[o] = s;
      counts[o] = static_cast<float>(c);
    }
    __syncthreads();  // the tables may be reused
  }
}

__device__ __forceinline__ float grad_at(const float* __restrict__ gs,
                                         long long gs_row, long long gs_col,
                                         size_t b, int k, unsigned live,
                                         int M) {
  const unsigned ls = static_cast<unsigned>(k) - 1u;
  return live && ls < static_cast<unsigned>(M)
             ? __ldg(gs + static_cast<long long>(b) * gs_row +
                     static_cast<long long>(ls) * gs_col)
             : 0.f;
}

__global__ void __launch_bounds__(kGradThreads)
    segsum_grad_kernel(const float* __restrict__ gs, long long gs_row,
                       long long gs_col, const int32_t* __restrict__ seg,
                       const uint8_t* __restrict__ mask,
                       float* __restrict__ out, size_t n, int S, int M) {
  const bool vec = ((reinterpret_cast<uintptr_t>(seg) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(mask) & 3) == 0;
  const size_t nv = vec ? n / 4 : 0;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t first = static_cast<size_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  const int4* k4 = reinterpret_cast<const int4*>(seg);
  const uint32_t* m4 = reinterpret_cast<const uint32_t*>(mask);
  for (size_t v = first; v < nv; v += stride) {
    const int4 k = __ldg(k4 + v);
    const uint32_t mk = __ldg(m4 + v);
    const int kk[4] = {k.x, k.y, k.z, k.w};
    float o[4];
    size_t b = 4 * v / S;
    int s = static_cast<int>(4 * v - b * S);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      while (s >= S) {  // the vector crosses into the next row(s)
        s -= S;
        ++b;
      }
      o[j] = grad_at(gs, gs_row, gs_col, b, kk[j], (mk >> (8 * j)) & 0xffu,
                     M);
      ++s;
    }
    reinterpret_cast<float4*>(out)[v] = make_float4(o[0], o[1], o[2], o[3]);
  }
  for (size_t i = 4 * nv + first; i < n; i += stride)
    out[i] = grad_at(gs, gs_row, gs_col, i / S, __ldg(seg + i),
                     __ldg(mask + i), M);
}

}  // namespace

// out: sums (B, M) then counts (B, M), float32.
extern "C" int repro_segment_sum(const void* nll, const void* seg,
                                 const void* mask, void* out, int B, int S,
                                 int M, void* stream) {
  if (B <= 0 || S <= 0 || M <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int mmax = M < kTile ? M : kTile;
  const size_t smem = static_cast<size_t>(mmax) *
                      (2 * kWarps * 32 + 2 * kWarps) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        segsum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  float* sums = static_cast<float*>(out);
  segsum_kernel<<<static_cast<unsigned>(B), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(nll), static_cast<const int32_t*>(seg),
      static_cast<const uint8_t*>(mask), sums,
      sums + static_cast<size_t>(B) * M, S, M);
  return static_cast<int>(cudaGetLastError());
}

// grad_sums (B, M) float32 at element strides (gs_row, gs_col); out (B, S).
extern "C" int repro_segment_sum_grad(const void* grad_sums, long long gs_row,
                                      long long gs_col, const void* seg,
                                      const void* mask, void* out, int B,
                                      int S, int M, void* stream) {
  if (B <= 0 || S <= 0 || M <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(B) * S;
  const size_t work = (n + 3) / 4;
  size_t blocks = (work + kGradThreads - 1) / kGradThreads;
  if (blocks > 65535) blocks = 65535;
  segsum_grad_kernel<<<static_cast<unsigned>(blocks), kGradThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grad_sums), gs_row, gs_col,
      static_cast<const int32_t*>(seg), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), n, S, M);
  return static_cast<int>(cudaGetLastError());
}
