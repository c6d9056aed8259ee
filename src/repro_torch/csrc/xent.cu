// Fused per-token cross-entropy over a large vocabulary, without logits in
// device memory:
//
//   nll[i] = logsumexp_v(h[i] . W[v]) - h[i] . W[labels[i]]
//
// Replaces the Pallas TPU kernel src/repro/kernels/xent/xent.py:fused_xent.
// There the grid walked vocab tiles in order and carried (max, sumexp,
// correct logit) in VMEM scratch from one grid step to the next. Blocks on
// the H100 run in parallel and carry nothing between them, so here each
// block owns a tile of BM rows and loops over the whole vocabulary inside
// the block.
//
// Inputs: h (M, d) bf16 and the (V, d) bf16 embedding table as stored (no
// transpose: row v of the table is column v of the unembedding), labels (M,)
// int32. Output (M,) float32. Products run on the tensor cores (mma.sync
// m16n8k16, bf16 in, float32 sums): a product of two bf16 values is exact
// in float32, so the logits are the float32 logits of the TPU kernel up to
// the order of the sums.
//
// What bounds it on the H100: operations. 2*M*V*d = 5.1 TFLOP at the
// slice's shape (M = 16384, V = 151936, d = 1024), about 5.2 ms at the
// 989 TFLOP/s bf16 peak, against 0.35 GB of compulsory traffic (0.1 ms).
// Design for that: a 128 x 128 output tile per step, 8 warps of 64 x 32,
// a two-stage cp.async ring over 32-wide slices of d, padded shared rows
// (no bank conflicts on fragment loads). Each thread keeps an online
// (max, sumexp, correct logit) for its own 8 rows over the columns it owns,
// for the whole vocabulary loop: the online logsumexp is associative, so
// the 4 threads of a quad and the 4 warps that share a row combine only
// once, at the end. The ragged vocab edge (V % 128) and row edge (M % 128)
// are masked inside the kernel; zeros fill the loads past either edge.
// Not done yet (later work): wgmma and TMA, which the full tensor-core
// rate needs.

#include "common.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int LDS = BK + 8;  // 80-byte rows: fragment loads hit 32 banks
constexpr int THREADS = 256;
constexpr float M_INIT = -1e30f;

__global__ void __launch_bounds__(THREADS)
    xent_kernel(const __nv_bfloat16* __restrict__ h,
                const __nv_bfloat16* __restrict__ w,
                const int32_t* __restrict__ labels, float* __restrict__ nll,
                int M, int V, int d) {
  __shared__ __align__(16) __nv_bfloat16 sA[2][BM][LDS];
  __shared__ __align__(16) __nv_bfloat16 sB[2][BN][LDS];
  __shared__ float red[3][4][BM];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp >> 2;  // 0..1: rows wm*64 .. +64
  const int wn = warp & 3;   // 0..3: cols wn*32 .. +32 of the vocab tile
  const int m0 = blockIdx.x * BM;

  // this thread's 8 rows: ri = mi * 2 + half -> wm*64 + mi*16 + half*8 + g
  int lab[8];
  float run_m[8], run_l[8], run_c[8];
#pragma unroll
  for (int ri = 0; ri < 8; ++ri) {
    const int row = m0 + wm * 64 + (ri >> 1) * 16 + (ri & 1) * 8 + g;
    lab[ri] = row < M ? labels[row] : -1;
    run_m[ri] = M_INIT;
    run_l[ri] = 0.f;
    run_c[ri] = 0.f;
  }

  const int n_vt = (V + BN - 1) / BN;
  const int n_kt = (d + BK - 1) / BK;
  const int total = n_vt * n_kt;

  auto load_tile = [&](int it, int stage) {
    const int vt = it / n_kt;
    const int k0 = (it % n_kt) * BK;
    const int v0 = vt * BN;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + i * THREADS;  // 0..511: 128 rows x 4 vectors
      const int r = id >> 2;
      const int cv = (id & 3) * 8;
      const int kc = k0 + cv;
      const bool pa = (m0 + r < M) && (kc < d);
      const bool pb = (v0 + r < V) && (kc < d);
      const __nv_bfloat16* ga = pa ? h + (size_t)(m0 + r) * d + kc : h;
      const __nv_bfloat16* gb = pb ? w + (size_t)(v0 + r) * d + kc : w;
      repro::cp_async16(&sA[stage][r][cv], ga, pa);
      repro::cp_async16(&sB[stage][r][cv], gb, pb);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  load_tile(0, 0);
  repro::cp_async_commit();

  for (int it = 0; it < total; ++it) {
    const int stage = it & 1;
    if (it + 1 < total) {
      load_tile(it + 1, stage ^ 1);
      repro::cp_async_commit();
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const int kc = ks * 16 + t * 2;
      uint32_t a[4][4];
      uint32_t b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + g;
        a[mi][0] = repro::ld_pair(&sA[stage][r][kc]);
        a[mi][1] = repro::ld_pair(&sA[stage][r + 8][kc]);
        a[mi][2] = repro::ld_pair(&sA[stage][r][kc + 8]);
        a[mi][3] = repro::ld_pair(&sA[stage][r + 8][kc + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = wn * 32 + ni * 8 + g;
        b[ni][0] = repro::ld_pair(&sB[stage][c][kc]);
        b[ni][1] = repro::ld_pair(&sB[stage][c][kc + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          repro::mma_bf16_16816(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();  // the stage is refilled by the next iteration's load

    if ((it % n_kt) == n_kt - 1) {
      // vocab tile finished: fold its logits into the running statistics
      const int v0 = (it / n_kt) * BN + wn * 32 + t * 2;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int ri = mi * 2 + half;
          float m_new = run_m[ri];
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              if (v0 + ni * 8 + j < V)
                m_new = fmaxf(m_new, acc[mi][ni][half * 2 + j]);
          float sum = 0.f;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int col = v0 + ni * 8 + j;
              const float x = acc[mi][ni][half * 2 + j];
              if (col < V) sum += __expf(x - m_new);
              if (col == lab[ri]) run_c[ri] = x;
            }
          run_l[ri] = run_l[ri] * __expf(run_m[ri] - m_new) + sum;
          run_m[ri] = m_new;
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;
      }
    }
  }

  // combine the 4 threads of each quad (same rows, different columns)
#pragma unroll
  for (int ri = 0; ri < 8; ++ri) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, run_m[ri], off);
      const float ol = __shfl_xor_sync(0xffffffffu, run_l[ri], off);
      const float oc = __shfl_xor_sync(0xffffffffu, run_c[ri], off);
      const float mm = fmaxf(run_m[ri], om);
      run_l[ri] = run_l[ri] * __expf(run_m[ri] - mm) + ol * __expf(om - mm);
      run_m[ri] = mm;
      run_c[ri] += oc;
    }
  }
  if (t == 0) {
#pragma unroll
    for (int ri = 0; ri < 8; ++ri) {
      const int r = wm * 64 + (ri >> 1) * 16 + (ri & 1) * 8 + g;
      red[0][wn][r] = run_m[ri];
      red[1][wn][r] = run_l[ri];
      red[2][wn][r] = run_c[ri];
    }
  }
  __syncthreads();
  // combine the 4 warps that share each row
  if (tid < BM && m0 + tid < M) {
    float mm = red[0][0][tid];
#pragma unroll
    for (int q = 1; q < 4; ++q) mm = fmaxf(mm, red[0][q][tid]);
    float l = 0.f, c = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      l += red[1][q][tid] * __expf(red[0][q][tid] - mm);
      c += red[2][q][tid];
    }
    nll[m0 + tid] = mm + logf(l) - c;
  }
}

}  // namespace

extern "C" int repro_xent_bf16(const void* h, const void* w, const void* labels,
                               void* nll, int M, int V, int d, void* stream) {
  const dim3 grid((M + BM - 1) / BM);
  xent_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(w),
      static_cast<const int32_t*>(labels), static_cast<float*>(nll), M, V, d);
  return static_cast<int>(cudaGetLastError());
}
