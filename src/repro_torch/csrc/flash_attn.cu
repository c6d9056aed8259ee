// Forward flash attention with an online softmax, causal or not, GQA-aware.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attn/flash_attn.py:flash_attention
// (with its GQA wrapper kernels/flash_attn/ops.py:gqa_flash_attention).
// The TPU grid walked kv tiles in order and carried (max, sum, acc) in VMEM
// scratch between grid steps. Here one block owns one (batch*head, 64-query
// tile) and loops over the kv tiles itself, up to the diagonal when causal
// (tiles above it are skipped, as on the TPU). Query head h reads kv head
// h / G straight from the (B, S, K, hd) tensors: K and V are never repeated
// in memory. Layouts stay those of the JAX wrapper: q, o (B, S, H, hd),
// k, v (B, S, K, hd), bf16.
//
// Numerics: scores q.k in float32 on the tensor cores (bf16 products are
// exact in float32), times 1/sqrt(hd), masked with -1e30, online max and
// sum in float32, denominator clamped at 1e-30, as on the TPU. One
// difference: the probabilities enter the PV product as bf16 (the tensor
// cores take bf16), where the TPU kernel kept them in float32; the sum
// that divides is taken over the float32 probabilities.
//
// What bounds it on the H100: bytes. At the slice's shape (B = 32, H = 16,
// S = 512, hd = 64) a launch does 17 GFLOP of causal work (17 us at the
// bf16 peak) but must move q, k, v and o, 134 MB (40 us at 3.35 TB/s).
// Design: 4 warps, 16 query rows each; q fragments stay in registers for
// the whole kv loop; each 64-key tile of K (row-major) and V (transposed)
// goes through shared memory once per block; S = QK^T and O += PV are
// mma.sync m16n8k16 products, and the S accumulators become the PV
// operand in registers without a trip through shared memory.
// Not done yet (later work): cp.async or TMA double buffering of the kv
// tiles, and wgmma.

#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

template <int HD>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int S, int H, int KH,
                     int causal, float scale) {
  constexpr int LDK = HD + 8;   // 16-byte aligned rows for vector stores
  constexpr int LDV = BKV + 8;  // transposed V: fragment loads hit 32 banks
  constexpr int VEC = HD / 8;   // 16-byte vectors per row
  __shared__ __align__(16) __nv_bfloat16 sK[BKV][LDK];
  __shared__ __align__(16) __nv_bfloat16 sVt[HD][LDV];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H;
  const int hh = blockIdx.y % H;
  const int kvh = hh / (H / KH);

  const size_t q_row = (size_t)H * HD;    // elements between positions
  const size_t kv_row = (size_t)KH * HD;
  const __nv_bfloat16* qb = q + (size_t)b * S * q_row + (size_t)hh * HD;
  const __nv_bfloat16* kb = k + (size_t)b * S * kv_row + (size_t)kvh * HD;
  const __nv_bfloat16* vb = v + (size_t)b * S * kv_row + (size_t)kvh * HD;
  __nv_bfloat16* ob = o + (size_t)b * S * q_row + (size_t)hh * HD;

  const int r0 = q0 + warp * 16 + g;  // this thread's two query rows
  const int r1 = r0 + 8;

  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const int c = ks * 16 + t * 2;
    qf[ks][0] = r0 < S ? repro::ld_pair(qb + r0 * q_row + c) : 0u;
    qf[ks][1] = r1 < S ? repro::ld_pair(qb + r1 * q_row + c) : 0u;
    qf[ks][2] = r0 < S ? repro::ld_pair(qb + r0 * q_row + c + 8) : 0u;
    qf[ks][3] = r1 < S ? repro::ld_pair(qb + r1 * q_row + c + 8) : 0u;
  }

  float oacc[HD / 8][4];
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn)
#pragma unroll
    for (int j = 0; j < 4; ++j) oacc[dn][j] = 0.f;
  float m_0 = NEG_INF, m_1 = NEG_INF, l_0 = 0.f, l_1 = 0.f;

  int n_tiles = (S + BKV - 1) / BKV;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BKV + 1);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BKV;
    __syncthreads();  // the previous tile's readers are done
    for (int id = tid; id < BKV * VEC; id += THREADS) {
      const int r = id / VEC;
      const int cv = (id % VEC) * 8;
      uint4 kk = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < S) {
        kk = *reinterpret_cast<const uint4*>(kb + (k0 + r) * kv_row + cv);
        vv = *reinterpret_cast<const uint4*>(vb + (k0 + r) * kv_row + cv);
      }
      *reinterpret_cast<uint4*>(&sK[r][cv]) = kk;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int i = 0; i < 8; ++i) sVt[cv + i][r] = ve[i];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float sacc[BKV / 8][4];
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sacc[ni][jj] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni) {
        uint32_t bf[2];
        bf[0] = repro::ld_pair(&sK[ni * 8 + g][ks * 16 + t * 2]);
        bf[1] = repro::ld_pair(&sK[ni * 8 + g][ks * 16 + t * 2 + 8]);
        repro::mma_bf16_16816(sacc[ni], qf[ks], bf);
      }
    }

    // scale, mask, online softmax (rows r0: sacc[.][0..1], r1: [.][2..3])
    float mx0 = m_0, mx1 = m_1;
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = k0 + ni * 8 + t * 2 + jj;
        float x0 = sacc[ni][jj] * scale;
        float x1 = sacc[ni][2 + jj] * scale;
        if (col >= S || (causal && col > r0)) x0 = NEG_INF;
        if (col >= S || (causal && col > r1)) x1 = NEG_INF;
        sacc[ni][jj] = x0;
        sacc[ni][2 + jj] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float corr0 = __expf(m_0 - mx0);
    const float corr1 = __expf(m_1 - mx1);
    m_0 = mx0;
    m_1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float p0 = __expf(sacc[ni][jj] - mx0);
        const float p1 = __expf(sacc[ni][2 + jj] - mx1);
        sacc[ni][jj] = p0;
        sacc[ni][2 + jj] = p1;
        sum0 += p0;
        sum1 += p1;
      }
    }
    l_0 = l_0 * corr0 + sum0;  // partial over this thread's columns
    l_1 = l_1 * corr1 + sum1;
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn) {
      oacc[dn][0] *= corr0;
      oacc[dn][1] *= corr0;
      oacc[dn][2] *= corr1;
      oacc[dn][3] *= corr1;
    }

    // O += P V: the S accumulator layout is the A-fragment layout
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t a[4];
      a[0] = repro::pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]);
      a[1] = repro::pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]);
      a[2] = repro::pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]);
      a[3] = repro::pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < HD / 8; ++dn) {
        uint32_t bf[2];
        bf[0] = repro::ld_pair(&sVt[dn * 8 + g][kk * 16 + t * 2]);
        bf[1] = repro::ld_pair(&sVt[dn * 8 + g][kk * 16 + t * 2 + 8]);
        repro::mma_bf16_16816(oacc[dn], a, bf);
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_0 += __shfl_xor_sync(0xffffffffu, l_0, off);
    l_1 += __shfl_xor_sync(0xffffffffu, l_1, off);
  }
  const float d0 = fmaxf(l_0, 1e-30f);
  const float d1 = fmaxf(l_1, 1e-30f);
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn) {
    const int c = dn * 8 + t * 2;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * q_row + c) =
          __floats2bfloat162_rn(oacc[dn][0] / d0, oacc[dn][1] / d0);
    if (r1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * q_row + c) =
          __floats2bfloat162_rn(oacc[dn][2] / d1, oacc[dn][3] / d1);
  }
}

template <int HD>
void launch(const void* q, const void* k, const void* v, void* o, int B, int S,
            int H, int KH, int causal, float scale, cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<HD><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      H, KH, causal, scale);
}

}  // namespace

extern "C" int repro_flash_attn_bf16(const void* q, const void* k, const void* v,
                                     void* o, int B, int S, int H, int KH,
                                     int hd, int causal, float scale,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: launch<16>(q, k, v, o, B, S, H, KH, causal, scale, st); break;
    case 32: launch<32>(q, k, v, o, B, S, H, KH, causal, scale, st); break;
    case 64: launch<64>(q, k, v, o, B, S, H, KH, causal, scale, st); break;
    case 128: launch<128>(q, k, v, o, B, S, H, KH, causal, scale, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
