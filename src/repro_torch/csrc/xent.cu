// Fused per-token cross-entropy over a large vocabulary, without logits in
// device memory:
//
//   nll[i] = logsumexp_v(h[i] . W[v]) - h[i] . W[labels[i]]
//
// Replaces the Pallas TPU kernel src/repro/kernels/xent/xent.py:fused_xent.
// There the grid walked vocab tiles in order and carried (max, sumexp,
// correct logit) in VMEM scratch from one grid step to the next. Blocks on
// the H100 run in parallel and carry nothing between them, so the vocab is
// cut into splits: one block owns a tile of 128 rows and one split, walks
// the split's vocab tiles itself and writes float32 partials (max, sumexp,
// correct logit) per (row, split); a second, small kernel folds the splits
// of each row in a fixed order (no atomics: repeatable run to run).
//
// Inputs: h (M, d) bf16 and the (V, d) bf16 embedding table as stored (no
// transpose: row v of the table is column v of the unembedding), labels (M,)
// int32. Output (M,) float32. A product of two bf16 values is exact in
// float32, so the logits are the float32 logits of the TPU kernel up to the
// order of the sums.
//
// What bounds it on the H100: operations. 2*M*V*d = 5.1 TFLOP at the
// slice's shape (M = 16384, V = 151936, d = 1024), 5.2 ms at the 989 TFLOP/s
// bf16 peak, against 0.35 GB of compulsory traffic (0.1 ms). Design for
// that:
// - wgmma m64n256k16 from shared memory: a 128 x 256 logits tile per block,
//   two consumer warpgroups of 64 rows, A and B 128-byte swizzled.
// - One producer thread keeps a 4-stage ring of 64-deep k slices full with
//   TMA loads (h and W tensor maps, zeros past M, V and d), each stage
//   guarded by a full and an empty mbarrier; setmaxnreg gives the
//   producer's registers to the consumers.
// - The grid is row tiles x vocab splits, row tiles fastest: the blocks
//   resident at one time walk the same vocab tiles, so W crosses HBM about
//   once and h stays in L2. The wrapper picks the split count from M, V and
//   the SM count (kernels/xent/ops.py:vocab_split) to fill every SM.
// - Each thread folds an online (max, sumexp, correct logit) for its 2 rows
//   over its own columns straight from the accumulator registers (one
//   ex2.approx per logit, log2(e) folded in); the 4 threads of a quad
//   combine once, at the end. Columns >= V in the ragged last tile are
//   masked in the fold.
// Not done yet: the fold is not overlapped with the next tile's products
// (no registers left for a second accumulator), no thread-block clusters
// or TMA multicast of the shared W tile.

#include "hopper.cuh"

namespace {

constexpr int BM = 128;  // rows per block: two consumer warpgroups of 64
constexpr int BN = 256;  // vocab columns per tile
constexpr int BK = 64;   // one k slice: 128 bytes of bf16, one swizzle row
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int A_BYTES = BM * BK * 2;  // 16 KB
constexpr int B_BYTES = BN * BK * 2;  // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
constexpr float M_INIT = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

using namespace repro;

// Fold one 128 x 256 tile's logits into this thread's running statistics
// for its rows r0 (acc[4j], acc[4j+1]) and r0 + 8 (acc[4j+2], acc[4j+3]),
// at columns v0 + 8j + {0, 1}, j < 32 (v0 holds the thread's 2t offset):
// the wgmma accumulator layout, 16 rows a warp, 8-column blocks.
template <bool RAGGED>
__device__ __forceinline__ void fold_tile(const float (&acc)[128], int v0,
                                          int V, int vt0, int lab0, int lab1,
                                          float& m0, float& l0, float& c0,
                                          float& m1, float& l1, float& c1) {
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (!RAGGED || v0 + 8 * j + e < V) {
        mx0 = fmaxf(mx0, acc[4 * j + e]);
        mx1 = fmaxf(mx1, acc[4 * j + 2 + e]);
      }
  const float n0 = -mx0 * LOG2E;
  const float n1 = -mx1 * LOG2E;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (!RAGGED || v0 + 8 * j + e < V) {
        s0 += exp2_approx(fmaf(acc[4 * j + e], LOG2E, n0));
        s1 += exp2_approx(fmaf(acc[4 * j + 2 + e], LOG2E, n1));
      }
  // (m - mx) is exactly 0 while no column of the row has been live
  l0 = l0 * exp2_approx((m0 - mx0) * LOG2E) + s0;
  l1 = l1 * exp2_approx((m1 - mx1) * LOG2E) + s1;
  m0 = mx0;
  m1 = mx1;
  // the correct logit: only rows whose label falls in this tile look
  if (static_cast<unsigned>(lab0 - vt0) < static_cast<unsigned>(BN)) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (v0 + 8 * j + e == lab0) c0 = acc[4 * j + e];
  }
  if (static_cast<unsigned>(lab1 - vt0) < static_cast<unsigned>(BN)) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (v0 + 8 * j + e == lab1) c1 = acc[4 * j + 2 + e];
  }
}

// One block: rows [m0, m0 + 128) against vocab tiles [vt_begin, vt_end) of
// its split; writes part[(row * n_split + split) * 3 + {0, 1, 2}] =
// (max, sumexp relative to max, correct logit or 0).
__global__ void __launch_bounds__(THREADS, 1)
    xent_partials_kernel(__grid_constant__ const CUtensorMap tm_h,
                         __grid_constant__ const CUtensorMap tm_w,
                         const int32_t* __restrict__ labels,
                         float* __restrict__ part, int M, int V, int d,
                         int tiles_per_split) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t tiles = (raw + 1023u) & ~1023u;  // swizzle atoms: 1 KB
  const uint32_t bars = tiles + STAGES * STAGE_BYTES;
  // stage s: A at tiles + s * STAGE_BYTES, B A_BYTES after it;
  // full[s] at bars + 8 s, empty[s] at bars + 8 (STAGES + s)

  const int m0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int vt_begin = split * tiles_per_split;
  const int vt_end = min(vt_begin + tiles_per_split, (V + BN - 1) / BN);
  const int n_kt = (d + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == CONSUMERS * 128) {
      int it = 0;
      for (int vt = vt_begin; vt < vt_end; ++vt) {
        for (int kt = 0; kt < n_kt; ++kt, ++it) {
          const int s = it % STAGES;
          const uint32_t phase = (it / STAGES) & 1;
          mbar_wait(bars + 8 * (STAGES + s), phase ^ 1);
          const uint32_t full = bars + 8 * s;
          const uint32_t a = tiles + s * STAGE_BYTES;
          mbar_expect_tx(full, STAGE_BYTES);
          tma_load_2d(a, &tm_h, full, kt * BK, m0);
          tma_load_2d(a + A_BYTES, &tm_w, full, kt * BK, vt * BN);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int lane = tid & 31;
    const int t = lane & 3;
    const int r0 = m0 + wg * 64 + (tid >> 5) * 16 + (lane >> 2);
    // a label outside [0, V) (a vocabulary slice's other columns) matches
    // no column, a padded one past V included: its correct logit stays 0
    const int lab0 = r0 < M && labels[r0] < V ? labels[r0] : -1;
    const int lab1 = r0 + 8 < M && labels[r0 + 8] < V ? labels[r0 + 8] : -1;
    float m_0 = M_INIT, l_0 = 0.f, c_0 = 0.f;
    float m_1 = M_INIT, l_1 = 0.f, c_1 = 0.f;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;

    int it = 0;
    for (int vt = vt_begin; vt < vt_end; ++vt) {
      for (int kt = 0; kt < n_kt; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(bars + 8 * s, (it / STAGES) & 1);
        const uint32_t a = tiles + s * STAGE_BYTES + wg * (64 * 128);
        const uint32_t b = tiles + s * STAGE_BYTES + A_BYTES;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)
          wgmma_ss_m64n256k16(acc, smem_desc(a + ks * 32, 128, 16, 1024),
                              smem_desc(b + ks * 32, 128, 16, 1024),
                              (kt | ks) != 0);
        wgmma_commit();
        // wait for this slice's products, then free its slot: the other
        // warpgroup's products keep the tensor cores busy meanwhile
        wgmma_wait<0>();
        fence_regs(acc);
        if (tid == 0) mbar_arrive(bars + 8 * (STAGES + s));
      }
      const int v0 = vt * BN + 2 * t;
      if (vt * BN + BN > V)
        fold_tile<true>(acc, v0, V, vt * BN, lab0, lab1, m_0, l_0, c_0, m_1,
                        l_1, c_1);
      else
        fold_tile<false>(acc, v0, V, vt * BN, lab0, lab1, m_0, l_0, c_0, m_1,
                         l_1, c_1);
    }

    // combine the 4 threads of each quad (same rows, other columns)
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float om0 = __shfl_xor_sync(0xffffffffu, m_0, off);
      const float ol0 = __shfl_xor_sync(0xffffffffu, l_0, off);
      const float oc0 = __shfl_xor_sync(0xffffffffu, c_0, off);
      const float om1 = __shfl_xor_sync(0xffffffffu, m_1, off);
      const float ol1 = __shfl_xor_sync(0xffffffffu, l_1, off);
      const float oc1 = __shfl_xor_sync(0xffffffffu, c_1, off);
      const float mm0 = fmaxf(m_0, om0);
      const float mm1 = fmaxf(m_1, om1);
      l_0 = l_0 * exp2f((m_0 - mm0) * LOG2E) + ol0 * exp2f((om0 - mm0) * LOG2E);
      l_1 = l_1 * exp2f((m_1 - mm1) * LOG2E) + ol1 * exp2f((om1 - mm1) * LOG2E);
      m_0 = mm0;
      m_1 = mm1;
      c_0 += oc0;
      c_1 += oc1;
    }
    if (t == 0) {
      if (r0 < M) {
        float* p = part + ((size_t)r0 * n_split + split) * 3;
        p[0] = m_0;
        p[1] = l_0;
        p[2] = c_0;
      }
      if (r0 + 8 < M) {
        float* p = part + ((size_t)(r0 + 8) * n_split + split) * 3;
        p[0] = m_1;
        p[1] = l_1;
        p[2] = c_1;
      }
    }
  }
}

// nll[row] from the row's n_split partials, folded in split order.
__global__ void xent_combine_kernel(const float* __restrict__ part,
                                    float* __restrict__ nll, int M,
                                    int n_split) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= M) return;
  const float* p = part + (size_t)row * n_split * 3;
  float m = p[0];
  for (int s = 1; s < n_split; ++s) m = fmaxf(m, p[3 * s]);
  float l = 0.f, c = 0.f;
  for (int s = 0; s < n_split; ++s) {
    l += p[3 * s + 1] * expf(p[3 * s] - m);
    c += p[3 * s + 2];
  }
  nll[row] = m + logf(l) - c;
}

// Tensor map of a row-major (rows, cols) bf16 matrix, read in boxes of
// box_rows x 64 with the 128-byte swizzle; zeros past either edge.
bool matrix_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BK),
                             static_cast<cuuint32_t>(box_rows)};
  return make_map(map, ptr, 2, dims, strides, box, 128);
}

}  // namespace

// Partials (M, n_split, 3) float32: split s covers vocab tiles
// [s * tiles_per_split, (s + 1) * tiles_per_split) of 256 columns.
extern "C" int repro_xent_partials_bf16(const void* h, const void* w,
                                        const void* labels, void* part, int M,
                                        int V, int d, int n_split,
                                        int tiles_per_split, void* stream) {
  CUtensorMap tm_h, tm_w;
  if (!matrix_map(&tm_h, h, M, d, BM) || !matrix_map(&tm_w, w, V, d, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      xent_partials_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + BM - 1) / BM, n_split);
  xent_partials_kernel<<<grid, THREADS, SMEM_BYTES,
                         static_cast<cudaStream_t>(stream)>>>(
      tm_h, tm_w, static_cast<const int32_t*>(labels),
      static_cast<float*>(part), M, V, d, tiles_per_split);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_xent_combine(const void* part, void* nll, int M,
                                  int n_split, void* stream) {
  xent_combine_kernel<<<(M + 255) / 256, 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(nll), M, n_split);
  return static_cast<int>(cudaGetLastError());
}
