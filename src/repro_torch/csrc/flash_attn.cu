// Forward flash attention with an online softmax, causal or not, GQA-aware.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attn/flash_attn.py:flash_attention
// (with its GQA wrapper kernels/flash_attn/ops.py:gqa_flash_attention).
// The TPU grid walked kv tiles in order and carried (max, sum, acc) in VMEM
// scratch between grid steps. Here one block owns one (batch*head, 128-query
// tile) and loops over the kv tiles itself, up to the diagonal when causal
// (tiles above it are skipped, as on the TPU). Query head h reads kv head
// h / G straight from the (B, S, K, hd) tensors: K and V are never repeated
// in memory. Layouts stay those of the JAX wrapper: q, o (B, S, H, hd),
// k, v (B, S, K, hd), bf16.
//
// Numerics: scores q.k in float32 on the tensor cores (bf16 products are
// exact in float32), times 1/sqrt(hd), masked with -1e30, online max and
// sum in float32, denominator clamped at 1e-30, as on the TPU. The softmax
// runs in base 2 (log2(e) folded into the scale, one ex2.approx per
// probability), which is the same function up to float32 rounding. The
// probabilities enter the PV product as bf16 (the tensor cores take bf16),
// where the TPU kernel kept them in float32; the sum that divides is taken
// over the float32 probabilities.
//
// What bounds it on the H100: bytes. At the slice's shape (B = 32, H = 16,
// S = 512, hd = 64) a launch does 17 GFLOP of causal work (17 us at the
// bf16 peak) but must move q, k, v and o, 134 MB (40 us at 3.35 TB/s).
// Design for that:
// - 128 queries a block, two warpgroups of 64 rows, so each K/V tile
//   fetched from L2 serves 128 queries. The query tiles of one head are
//   issued next to each other, so the head's K and V come from device
//   memory about once and from L2 for the other tiles (K and V together
//   exceed L2 at the slice's shape); a head's causal tiles go heaviest
//   first.
// - TMA loads over the 4-D (B, S, heads, hd) views, zeros past S: Q once,
//   then K and V through a ring of 64-key stages guarded by full/empty
//   mbarriers, kept STAGES - 1 tiles ahead of the products by one thread.
//   The tiles land swizzled (32, 64 or 128 bytes: one row of hd, or of a
//   64-wide panel at hd = 128), which is the layout wgmma reads.
// - S = Q K^T is wgmma m64n64k16 with both operands from shared memory;
//   O += P V is wgmma m64n{hd}k16 with P from registers (the accumulator
//   layout, converted to bf16, is the A-fragment layout) and V read
//   MN-major as it arrived: no transposition anywhere.
// - Only tiles that cross a warpgroup's diagonal (or the ragged end of S)
//   take the compares; tiles wholly above its rows are skipped by it.
// - The output is staged in the block's own (swizzled) Q tile and leaves
//   in one TMA store.
// Not done yet: overlap of one warpgroup's softmax with the other's
// products by explicit scheduling (here the two interleave as the warp
// schedulers let them; issuing the next tile's QK^T before this tile's
// softmax inside a warpgroup measured slower, at the register cap), a
// producer warp of its own, and a persistent grid that loads the next
// tile's Q during the current one (each block's Q load and output store
// now sit outside its K/V pipeline).

#include "hopper.cuh"

namespace {

using namespace repro;

constexpr int BQ = 128;  // queries per block: two warpgroups of 64 rows
constexpr int BKV = 64;  // keys per tile
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Tile {
  static constexpr int W = HD < 64 ? HD : 64;  // panel width, elements
  static constexpr int SWZ = W * 2;            // swizzle: one panel row, bytes
  static constexpr int PANELS = HD / W;
  static constexpr int STAGES = HD <= 64 ? 4 : 3;
  static constexpr int Q_PANEL = BQ * SWZ;  // bytes
  static constexpr int KV_PANEL = BKV * SWZ;
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BKV * HD * 2;  // one K or one V tile
  static constexpr int SMEM =
      1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 8 * (1 + 2 * STAGES);
};

// O += P V for one 16-key step, by the width of O
__device__ __forceinline__ void pv_mma(float (&d)[8], const uint32_t (&a)[4],
                                       uint64_t b) {
  wgmma_rs_m64n16k16(d, a, b, 1);
}
__device__ __forceinline__ void pv_mma(float (&d)[16], const uint32_t (&a)[4],
                                       uint64_t b) {
  wgmma_rs_m64n32k16(d, a, b, 1);
}
__device__ __forceinline__ void pv_mma(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b) {
  wgmma_rs_m64n64k16(d, a, b, 1);
}
__device__ __forceinline__ void pv_mma(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t b) {
  wgmma_rs_m64n128k16(d, a, b, 1);
}

// Mask, online softmax in base 2 and the bf16 P fragments for one 64 x 64
// score tile of a warpgroup. Thread values: s[4j + 2h + e] is row r0 + 8h,
// column k0 + 8j + 2t + e. The running max m is kept scaled (times scale *
// log2(e)); the scale is positive, so the tile's max is taken on the raw
// scores and each probability is one FMA and one ex2. Tile 0 holds a live
// key for every row, so m is finite from the first tile on.
template <int HD, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[32],
                                             float (&o)[HD / 2], float (&m)[2],
                                             float (&l)[2],
                                             uint32_t (&p)[4][4], int k0,
                                             int r0, int t, int S, int causal,
                                             float scale_log2) {
  float rm[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    if (MASK) {
      const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      if (col >= S || (causal && col > r0 + 8 * h)) s[i] = NEG_INF;
    }
    rm[h] = fmaxf(rm[h], s[i]);
  }
  float corr[2], nm[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rm[h] = fmaxf(rm[h], __shfl_xor_sync(0xffffffffu, rm[h], 1));
    rm[h] = fmaxf(rm[h], __shfl_xor_sync(0xffffffffu, rm[h], 2));
    const float mx = fmaxf(m[h], rm[h] * scale_log2);
    corr[h] = exp2_approx(m[h] - mx);
    m[h] = mx;
    nm[h] = -mx;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    s[i] = exp2_approx(fmaf(s[i], scale_log2, nm[h]));
    sum[h] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];
  // keys 16kk..16kk+15 as the A fragment of one k16 step
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, HD <= 64 ? 2 : 1)
    flash_fwd_kernel(__grid_constant__ const CUtensorMap tm_q,
                     __grid_constant__ const CUtensorMap tm_k,
                     __grid_constant__ const CUtensorMap tm_v,
                     __grid_constant__ const CUtensorMap tm_o, int S, int H,
                     int KH, int causal, float scale_log2) {
  using T = Tile<HD>;
  constexpr int STAGES = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;  // swizzle atoms need 1 KB
  const uint32_t skv = sq + T::Q_BYTES;  // stage s: K, then V
  const uint32_t q_bar = skv + STAGES * 2 * T::KV_BYTES;
  auto full = [&](int s) { return q_bar + 8 * (1 + s); };
  auto empty = [&](int s) { return q_bar + 8 * (1 + STAGES + s); };

  // one block per (batch*head, query tile), the tiles of a head adjacent,
  // heaviest causal tile first
  const int n_qt = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_qt;
  const int b = bh / H;
  const int hh = bh % H;
  const int kvh = hh / (H / KH);
  const int qt = causal ? n_qt - 1 - blockIdx.x % n_qt : blockIdx.x % n_qt;
  const int q0 = qt * BQ;
  int n_tiles = (S + BKV - 1) / BKV;
  if (causal) n_tiles = min(n_tiles, (min(q0 + BQ, S) - 1) / BKV + 1);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);  // one arrival per warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  // K/V tile j into stage j % STAGES, once both warpgroups freed it
  auto issue = [&](int j) {
    const int s = j % STAGES;
    if (j >= STAGES) mbar_wait(empty(s), (j / STAGES - 1) & 1);
    mbar_expect_tx(full(s), 2 * T::KV_BYTES);
    const uint32_t dst = skv + s * 2 * T::KV_BYTES;
#pragma unroll
    for (int p = 0; p < T::PANELS; ++p) {
      tma_load_4d(dst + p * T::KV_PANEL, &tm_k, full(s), p * T::W, kvh,
                  j * BKV, b);
      tma_load_4d(dst + T::KV_BYTES + p * T::KV_PANEL, &tm_v, full(s),
                  p * T::W, kvh, j * BKV, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(q_bar, T::Q_BYTES);
#pragma unroll
    for (int p = 0; p < T::PANELS; ++p)
      tma_load_4d(sq + p * T::Q_PANEL, &tm_q, q_bar, p * T::W, hh, q0, b);
    for (int j = 0; j < min(n_tiles, STAGES - 1); ++j) issue(j);
  }

  const int wg = tid / 128;
  const int lane = tid & 31;
  const int t = lane & 3;
  const int w_first = q0 + wg * 64;  // this warpgroup's rows
  const int r0 = w_first + ((tid % 128) >> 5) * 16 + (lane >> 2);
  float sacc[32], oacc[HD / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  mbar_wait(q_bar, 0);

  for (int j = 0; j < n_tiles; ++j) {
    if (tid == 0 && j + STAGES - 1 < n_tiles) issue(j + STAGES - 1);
    const int s = j % STAGES;
    mbar_wait(full(s), (j / STAGES) & 1);
    __syncwarp();
    const int k0 = j * BKV;
    if (!(causal && k0 > w_first + 63)) {  // else wholly above its rows
      const uint32_t sk = skv + s * 2 * T::KV_BYTES;
      const uint32_t sv = sk + T::KV_BYTES;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const int p = ks * 16 / T::W;                 // panel
        const uint32_t off = ((ks * 16) % T::W) * 2;  // bytes into its row
        wgmma_ss_m64n64k16(
            sacc,
            smem_desc(sq + p * T::Q_PANEL + wg * 64 * T::SWZ + off, T::SWZ,
                      16, 8 * T::SWZ),
            smem_desc(sk + p * T::KV_PANEL + off, T::SWZ, 16, 8 * T::SWZ),
            ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      uint32_t pf[4][4];
      if (k0 + BKV > S || (causal && k0 + BKV - 1 > w_first))
        softmax_tile<HD, true>(sacc, oacc, m, l, pf, k0, r0, t, S, causal,
                               scale_log2);
      else
        softmax_tile<HD, false>(sacc, oacc, m, l, pf, k0, r0, t, S, causal,
                                scale_log2);
      fence_regs(oacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // 16 keys a step: 16 rows of V
        pv_mma(oacc, pf[kk],
               smem_desc(sv + kk * 16 * T::SWZ, T::SWZ, T::KV_PANEL,
                         8 * T::SWZ));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(oacc);
    }
    if ((tid & 127) == 0) mbar_arrive(empty(s));
  }

  // normalise, stage the rows in this warpgroup's own (swizzled) Q rows and
  // leave in one TMA store of the tile: row r0 + 8h, columns 8j + 2t + e
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[h] = 1.f / fmaxf(sum, 1e-30f);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t row = sq + (r0 + 8 * h - q0) * T::SWZ;
#pragma unroll
    for (int jc = 0; jc < HD / 8; ++jc) {
      const int c = 8 * jc + 2 * t;
      const uint32_t addr = swizzle(
          row + (c / T::W) * T::Q_PANEL + (c % T::W) * 2, T::SWZ);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
                   "r"(pack_bf16(oacc[4 * jc + 2 * h] * inv[h],
                                 oacc[4 * jc + 2 * h + 1] * inv[h]))
                   : "memory");
    }
  }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int p = 0; p < T::PANELS; ++p)
      tma_store_4d(&tm_o, sq + p * T::Q_PANEL, p * T::W, hh, q0, b);
    tma_store_drain();
  }
}

// 4-D tensor map of a (B, S, heads, hd) bf16 tensor, boxes of `rows`
// positions of one head, one panel of hd wide.
template <int HD>
bool head_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
              int rows) {
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {HD * 2ull, HD * 2ull * heads,
                                 HD * 2ull * heads * S};
  const cuuint32_t box[4] = {Tile<HD>::W, 1, static_cast<cuuint32_t>(rows), 1};
  return make_map(map, ptr, 4, dims, strides, box, Tile<HD>::SWZ);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KH, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!head_map<HD>(&tm_q, q, B, S, H, BQ) ||
      !head_map<HD>(&tm_k, k, B, S, KH, BKV) ||
      !head_map<HD>(&tm_v, v, B, S, KH, BKV) ||
      !head_map<HD>(&tm_o, o, B, S, H, BQ))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = Tile<HD>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(  // for the current device
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = B * H * ((S + BQ - 1) / BQ);
  flash_fwd_kernel<HD><<<grid, THREADS, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_o, S, H, KH, causal, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_flash_attn_bf16(const void* q, const void* k, const void* v,
                                     void* o, int B, int S, int H, int KH,
                                     int hd, int causal, float scale,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(q, k, v, o, B, S, H, KH, causal, scale, st);
    case 32: return launch<32>(q, k, v, o, B, S, H, KH, causal, scale, st);
    case 64: return launch<64>(q, k, v, o, B, S, H, KH, causal, scale, st);
    case 128: return launch<128>(q, k, v, o, B, S, H, KH, causal, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
