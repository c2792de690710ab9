// flash_dq_sm90.cu: the query gradient of attention on Hopper's tensor cores
// (wgmma, TMA, mbarriers; sm_90a only).
//
// Replaces horovod_tpu/ops/flash_attention.py:_dq_kernel (pl.pallas_call in
// _flash_bwd) for q/k/v in bf16, fp16 or fp32 with any head_dim the port
// takes (in steps of 8: 8..512 for bf16 or fp16 q with dO in q's dtype,
// else 8..256; the wrappers pad other head_dims with zero columns);
// flash_dq.cu
// stays built and checked as the SIMT
// design, on no route. Same function:
//   p = exp(scale q k^T - lse) with the causal fill, keys past S weigh 0,
//   dp = dO v^T, ds = p (dp - delta), dq = sum over keys of ds k * scale,
// with delta = rowsum(dO o) - dlse passed in precomputed.
//
// Numerics. With bf16 q they differ from _dq_kernel in one place: it takes
// ds k on fp32 ds (:189-192); on the tensor cores ds is rounded to bf16
// first, as in FlashAttention-2/3. dO v^T keeps dO as _dq_kernel reads it
// (:165): a bf16 dO is exact, and an fp32 dO (the sequence ring writes an
// fp32 o) is split, once per query tile in shared memory, into two bf16
// terms, hi = bf16(dO) and lo = bf16(dO - hi), so dP = dO_hi v^T +
// dO_lo v^T carries 16 bits of dO's mantissa; products of bf16 values are
// exact in fp32. The plain version with split_dout and round_ds
// (ops/_kernels.py) rounds at the same points. With fp32 q every product
// runs as 3xTF32 (sm90.cuh) on fp32 operands, within about 2^-21 of fp32
// products: the plain version rounds nothing. fp16 q takes the bf16 design
// with .f16 operands (11 significant bits where bf16 has 8), and dO scaled
// by 2^e (sm90.cuh, "fp16's range"): dP and delta scaled in fp32, an fp32
// dO scaled before its split into two fp16 terms, so dS is rounded to fp16
// near 1 whatever dO's magnitude; dq is multiplied by 2^-e as it is
// written. The plain version (split_dout, round_ds on fp16 q) models the
// scale.
//
// Head dims. A kernel is instantiated per padded width DP (64, 128, 192,
// 256, 384 or 512 in bf16 and fp16; 32, 64, 96, 128, 192 or 256 in fp32):
// TMA zero-fills the columns past D, which add nothing to any product, and
// only D columns of dq are written. The bf16 and fp16 instances at D 64,
// 128, 192, 256, 384 and 512 with dO in q's dtype and the fp32 ones at D
// 192 and 256 fix D at compile time; every other
// head_dim comes at run time.
//
// Design, bf16. The TPU kernel carries dq in VMEM scratch across the grid's
// sequential last axis. Here one block of 256 threads owns a 128-row query
// tile of one (b, h): two warpgroups of 64 rows each, with Q and dO (its two
// terms) resident in shared memory and dq in fp32 registers for the whole
// K/V loop. Thread 0 issues every TMA load: Q and dO once, then 64-key K/V
// tiles through a ring of kStages stages behind "full" (TMA bytes) and
// "empty" (256 consumers) mbarriers. An fp32 dO lands in the K/V ring (its
// kBM x DP x 4 bytes are the ring's size), the block splits it into the two
// bf16 tiles, and only then are the first K/V tiles loaded. Each thread
// keeps lse * log2(e) and delta of its two rows in registers. Per K/V tile, each warpgroup runs
//   S  = Q K^T      wgmma m64n64k16, Q and K K-major from shared memory;
//   dP = dO V^T     the same with dO (and dO lo) and V, in the same commit
//                   group;
//   P  = exp2(S scale log2(e) - lse log2(e)),  dS = P (dP - delta)
//                   on the accumulator fragments;
//   dQ += dS K      wgmma m64nDPk16, dS as bf16 register A operand (the
//                   accumulator fragment is the A fragment), K MN-major.
// Only tiles that meet the ragged end or the causal diagonal pay for masks.
// Causal tiles wholly above the block's diagonal are never loaded, and a
// warpgroup skips the products of tiles wholly above its own. GQA reads K/V
// head h / (H / H_kv) through the tensor map's coordinates; TMA zero-fills
// rows past S, and rows past S are not written.
//
// Design, fp32 (3xTF32). The same loop with tf32 products: each operand is
// split into hi and lo (sm90.cuh, split_tile) and a product is three
// wgmma m64nNk8 a k-step (a_lo b_hi, a_hi b_lo, a_hi b_hi). Q and dO are
// split once, hi in place and lo beside it. Each K/V tile is split when it
// lands: V into hi and lo, K into hi and lo and also written transposed
// (hi and lo, keys permuted by permute8), because tf32 wgmma reads shared
// memory K-major only and K is the MN-major operand of dS K; dS's
// accumulator fragment is then the tf32 A fragment as it stands. dq sums
// over every key tile of the sequence, the longest accumulation of the
// three kernels, and the tensor cores truncate as they accumulate: each
// key tile's dS K is summed in a fresh accumulator and added to dq in fp32
// (as flash_dkv_sm90 does). Shared memory: Q, dO and their lo, 4 * kBM *
// DP * 4 B, and one stage of K, K lo, V, V lo (kBN * DP * 4 B each) and
// K^T hi and lo (DP rows of 128 B per 32 keys): two warpgroups and 64-key
// tiles at DP 64 (224 KB), one warpgroup with 64-key tiles at DP 32
// (80 KB, two blocks an SM) and 32-key tiles at DP 96 and 128 (168 KB and
// 224 KB).
//
// Why a kernel of its own. dq could instead be summed inside flash_dkv_sm90,
// which has dS^T in registers, with fp32 atomics (or cp.reduce.async.bulk)
// into a scratch buffer and a conversion pass after it. This kernel
// recomputes Q K^T and dO V^T instead, and in exchange needs no atomics (dq
// is the same bits from run to run), no scratch and no second pass. If it
// stalls well above its bound, that fused design is the next lever
// (ROADMAP).
//
// Occupancy, bf16. A thread holds 32 + 32 + DP / 2 fp32 accumulators. At
// DP 64 the kernel is held to 128 registers, so two blocks (66 KB of shared
// memory each, 82 KB with an fp32 dO's two terms) share an SM and one
// block's exp2 runs under the other's products; at DP 128 one block per SM.
// On the card, 128-key tiles (one block per SM) and a third stage were both
// slower than this layout (PERF.md).
//
// Wide heads, bf16 DP 192 and 256. Q and dO stay resident: 2 * 128 * DP *
// 2 B, 96 KB at DP 192 and 128 KB at DP 256, and dq takes DP / 2
// registers a thread. At DP 192 two stages of 64-key K/V tiles (48 KB
// each) fit beside them (192 KB); at DP 256 a 64-key stage is 64 KB, so
// the K/V tiles are 32 keys (two stages, 64 KB in all, 192 KB with Q and
// dO), S and dP run as m64n32k16 and dS K as two k-steps of m64n256k16 a
// tile: 128 + 16 + 16 accumulator registers a thread. One block per SM.
// dq keeps its one owner: no atomics, the same bits every run. With the
// sequence ring's fp32 dO a block of two warpgroups would hold Q and dO's
// two terms for 128 rows, 3 * 128 * DP * 2 B (192 KB at DP 256), beside
// the K/V stages: that does not fit. So that route's block is one
// warpgroup of 64 query rows, as the 3xTF32 design's at DP 32: Q, dO hi and
// dO lo take 72 KB at DP 192 and 96 KB at DP 256, and the fp32 dO tile
// (48 KB, 64 KB) lands in the K/V ring (96 KB, 64 KB) as on the route up
// to 128: 168 KB and 160 KB in all. The grid has twice the blocks, and a
// block's softmax no longer runs beside another warpgroup's products.
//
// Widest heads, bf16 and fp16 DP 384 and 512 with dO in q's dtype (head_dim
// 264..512; D fixed at 384 and 512, at run time between). dq would be DP /
// 2 = 256 registers a thread and Q and dO for 128 rows 256 KB. So the
// block's two warpgroups share one 64-row Q/dO tile (2 * 64 * DP * 2 B: 96
// / 128 KB) and each owns one column half of dq (96 / 128 registers). Each
// forms S = Q K^T and dP = dO V^T over the whole head itself (m64n32k16)
// and so P and dS, the same bits in both, and adds dS K_half (m64nNk16, N =
// DP / 2, K's column half MN-major from its panel, sm90.cuh panel_offset):
// 1.67 times the products of one S, dP and dS K, and no tile through shared
// memory and no barrier beyond the K/V ring's. K/V tiles are 32 keys, two
// stages at DP 384 (96 KB, 193 KB in all) and one at DP 512 (64 KB, 193
// KB), where the next tile loads once this one's products are done. A
// thread holds its dq half, S and dP (16 + 16) and dS's two A fragments
// (8). dq keeps its one owner: no atomics, the same bits every run.
//
// Wide heads, fp32 DP 192 and 256 (flash_dq_sm90_tf32_wide_kernel). The
// fp32 design above keeps Q, dO and their lo resident (4 * 64 * DP * 4 B,
// 192 / 256 KB) and holds dq plus a fresh tile sum (192 / 256 registers a
// thread): neither fits. Here a block of two warpgroups owns 64 query rows;
// Q and dO stay raw (2 * 64 * DP * 4 B, 96 / 128 KB) and are register A
// operands split a fragment at a time (sm90.cuh, mma_rows_tf32); K/V tiles
// are 16 keys, split in place with their lo beside them (4 * 16 * DP * 4
// B a stage, two stages at DP 192, one at 256). Per K/V tile:
//   S  = Q K^T     warpgroup 0, and dP = dO V^T warpgroup 1: m64n16k8,
//                  three a k-step, a fresh sum every two k-steps;
//   P              warpgroup 0, into shared memory as fp32 in fragment
//                  order; dS = P (dP - delta) warpgroup 1, written split
//                  into tf32 hi and lo as the K-major tiles of 64 query
//                  rows (store_frag_tf32);
//   dQ^T += K^T dS^T  the transposed product, so that K needs no
//                  transposed copy: M = 64 head-dim rows a slab (three or
//                  four slabs, two a warpgroup, one at DP 192's second),
//                  A = K^T read from the split K tiles (mma_cols_tf32_add),
//                  B = dS, m64n64k8, each slab's tile summed in a fresh
//                  accumulator and added in fp32.
// Shared memory: 96 + 96 + 16 + 4 KB at DP 192, 128 + 64 + 16 + 4 KB at
// DP 256 (213 KB either way). A thread holds two slabs of dQ^T (64
// registers), S or dP with two fresh sums (24), two buffers of two
// k-steps' fragments (32) and a slab's fresh sum (32): 157-168 registers
// (ptxas -v), no spill. dq leaves the kernel once, from its one owner: the
// same bits every run. At the wide_head attention (B 8, S 1024, H 8, H_kv 1,
// D 256, causal) the 51.5 GFLOP of products take 104 us at TF32's rate and
// 313 us as 3xTF32 (the bound), beside 65 us of HBM time.
//
// Bound. At the main path's shape (B 8, H 12, S 1024, D 64, bf16, causal)
// the work is 19.3 GFLOP of bf16 products and 63.7 MB: 20 us of tensor-core
// time, 19 us of HBM time. Every head_dim at d_model 768 does the same
// 19.3 GFLOP; padded ones issue more (at bf16 D 32 twice as many). In fp32
// the 127 MB take 38 us, the products 39 us at TF32's rate and 117 us as
// 3xTF32: the three products bound every fp32 instance.
#include "flash_attention.cuh"
#include "sm90.cuh"

namespace hvt {
namespace {

constexpr float kLog2e = 1.4426950408889634f;

// kDoTerms: the 2-byte terms dO comes in (1: dO in q's dtype, bf16 or
// fp16; 2: an fp32 dO as hi and lo).
template <int DP, int kDoTerms>
struct DqSmem {
  static_assert(DP % 64 == 0 && DP <= (kDoTerms == 1 ? 512 : 256), "DP: whole panels");
  // DP 384 and 512: both warpgroups on one 64-row Q/dO tile, each owning
  // one column half of dq (see Widest heads)
  static constexpr bool kHalves = DP > 256;
  // warpgroups, 64 query rows each: two, but one where an fp32 dO's two
  // terms sit beside Q at the wide heads (see Wide heads)
  static constexpr int kWG = kDoTerms == 2 && DP > 128 ? 1 : 2;
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kBM = kHalves ? 64 : 64 * kWG;  // query rows per block
  static constexpr int kQCols = kHalves ? DP / 2 : DP;  // columns of dq a warpgroup owns
  static constexpr int kBN = DP <= 192 ? 64 : 32;  // bf16: keys per K/V tile (see Wide heads)
  static constexpr int kStages = DP == 512 ? 1 : 2;  // K/V stages; at DP 512 one fits
  static constexpr int kQ = kBM * DP * 2;   // bytes of the Q (or a dO) tile
  static constexpr int kKV = kBN * DP * 2;  // bytes of one K (or V) tile
  static constexpr int kBarriers = (1 + 2 * kStages) * 8;
  static constexpr int kBytes =
      (1 + kDoTerms) * kQ + 2 * kStages * kKV + kBarriers + sm90::kAtomBytes;
  // an fp32 dO tile lands in the K/V ring before its first tiles
  static_assert(kDoTerms == 1 || 2 * kStages * kKV >= 2 * kQ, "fp32 dO fits the ring");
  static_assert(kBytes <= 232448, "a block's shared memory");
};

// kD: the head_dim where it is fixed at compile time (kD == DP), else 0 and
// d_rt gives it. T: bf16 or fp16. kDoTerms 2: tdo maps an fp32 dO.
// dout_amax: dO's largest magnitude, read by the fp16 instances only.
template <int DP, int kD, typename T, int kDoTerms>
__global__ void __launch_bounds__(DqSmem<DP, kDoTerms>::kThreads, DP == 64 ? 2 : 1)
    flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const float* __restrict__ dout_amax, T* __restrict__ dq, int S, int H,
                         int Hkv, int d_rt, float scale, float scale_log2, int causal) {
  using namespace sm90;
  using L = DqSmem<DP, kDoTerms>;
  constexpr int kBM = L::kBM, kBN = L::kBN, kThreads = L::kThreads, kStages = L::kStages;
  const int D = kD ? kD : d_rt;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1k(smem_raw);
  uint8_t* q_s = smem;
  uint8_t* do_s = smem + L::kQ;                 // dO lo, if any, right after it
  uint8_t* kv_s = smem + (1 + kDoTerms) * L::kQ;  // stage s: K at kv_s + 2 s kKV, V after it
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(kv_s + 2 * kStages * L::kKV);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + kStages;

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows start first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);
  const int q0 = qt * kBM;
  int n_kt = (S + kBN - 1) / kBN;
  if (causal) n_kt = min(n_kt, (q0 + kBM - 1) / kBN + 1);
  const int tid = threadIdx.x, warp = (tid % 128) / 32, lane = tid % 32;
  // the warpgroup, through a shuffle so that the compiler knows it is warp-uniform
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  // this warpgroup's first row of the tile, and its first column of dq
  const int wg_row = L::kHalves ? 0 : 64 * wg;
  const int col0 = L::kHalves ? wg * L::kQCols : 0;
  const int wg_row0 = q0 + wg_row;
  // tiles past this warpgroup's last row hold no key that it can see
  const int n_mine = causal ? min(n_kt, (wg_row0 + 63) / kBN + 1) : n_kt;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();

  auto load_kv = [&](int j, int s) {
    uint8_t* dst = kv_s + 2 * s * L::kKV;
    mbar_expect_tx(&full[s], 2 * L::kKV);
    tma_load_rows<DP, T>(dst, &tk, &full[s], kBN, j * kBN, hk, b);
    tma_load_rows<DP, T>(dst + L::kKV, &tv, &full[s], kBN, j * kBN, hk, b);
  };
  if (tid == 0) {
    if constexpr (kDoTerms == 1) {
      mbar_expect_tx(bar_q, 2 * L::kQ);
      tma_load_rows<DP, T>(q_s, &tq, bar_q, kBM, q0, h, b);
      tma_load_rows<DP, T>(do_s, &tdo, bar_q, kBM, q0, h, b);
      for (int j = 0; j < kStages && j < n_kt; ++j) load_kv(j, j);
    } else {  // the fp32 dO into the K/V ring; K/V once it is split
      mbar_expect_tx(bar_q, 3 * L::kQ);
      tma_load_rows<DP, T>(q_s, &tq, bar_q, kBM, q0, h, b);
      tma_load_rows<DP, float>(kv_s, &tdo, bar_q, kBM, q0, h, b);
    }
  }
  // This thread is done with tile j: once all 256 are, thread 0 refills its
  // stage with tile j + kStages.
  auto release = [&](int j) {
    const int s = j % kStages;
    mbar_arrive(&empty[s]);
    if (tid == 0 && j + kStages < n_kt) {
      mbar_wait(&empty[s], (j / kStages) & 1);
      load_kv(j + kStages, s);
    }
  };

  // fp16: dO's scale 2^e (dP's too where dO comes in fp16) and 2^-e
  float do_scale = 1.f, unscale = 1.f;
  if constexpr (is_f16<T>()) dout_scale(dout_amax, do_scale, unscale);
  const float dp_scale = kDoTerms == 1 ? do_scale : 1.f;  // two terms: scaled in the split
  const int row_lo = wg_row0 + 16 * warp + lane / 4;  // rows row_lo and row_lo + 8
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    const long long off = ((long long)b * H + h) * S + row;
    lse2[r] = row < S ? lse[off] * kLog2e : 0.f;
    dlt[r] = row < S ? delta[off] : 0.f;
    if constexpr (is_f16<T>()) dlt[r] *= do_scale;
  }
  const uint32_t q_addr = smem_u32(q_s), do_addr = smem_u32(do_s), kv_addr = smem_u32(kv_s);
  float acc[L::kQCols / 2];
#pragma unroll
  for (int i = 0; i < L::kQCols / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar_q, 0);
  if constexpr (kDoTerms == 2) {
    split_terms<DP, kBM, T>(kv_s, do_s, do_s + L::kQ, tid, kThreads, do_scale);
    // the split's writes before wgmma reads them, and its reads before
    // TMA refills the ring (both async proxy)
    fence_proxy_async();
    __syncthreads();
    if (tid == 0)
      for (int j = 0; j < kStages && j < n_kt; ++j) load_kv(j, j);
  }
  int j = 0;
  for (; j < n_mine; ++j) {
    const int s = j % kStages, k0 = j * kBN;
    const uint32_t k_addr = kv_addr + 2 * s * L::kKV, v_addr = k_addr + L::kKV;
    mbar_wait(&full[s], (j / kStages) & 1);

    float sc[kBN / 2], dp[kBN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss<0, T>(sc, desc_kmajor(q_addr, kBM, wg_row, kk), desc_kmajor(k_addr, kBN, 0, kk),
                     kk > 0);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss<0, T>(dp, desc_kmajor(do_addr, kBM, wg_row, kk), desc_kmajor(v_addr, kBN, 0, kk),
                     kk > 0);
    if constexpr (kDoTerms == 2) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss<0, T>(dp, desc_kmajor(do_addr + L::kQ, kBM, wg_row, kk),
                       desc_kmajor(v_addr, kBN, 0, kk), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    const bool edge = k0 + kBN > S || (causal && k0 + kBN - 1 > wg_row0);
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const int r = (i / 2) % 2;
      float p = exp2f(fmaf(sc[i], scale_log2, -lse2[r]));
      if (edge) {
        const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        if (key >= S || (causal && key > row_lo + 8 * r)) p = 0.f;  // the -1e30 fill: weight 0
      }
      if constexpr (is_f16<T>())
        dp[i] = p * fmaf(dp[i], dp_scale, -dlt[r]);  // dS, scaled
      else
        dp[i] = p * (dp[i] - dlt[r]);  // dS
    }

    // all of dS packed before the fence: a register written between the
    // fence and its product makes ptxas serialise the products (C7520)
    uint32_t a[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) a_fragment<T>(a[kk], dp, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_rs<1, T>(acc, a[kk], desc_mnmajor(k_addr + panel_offset(col0, kBN), kBN, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    release(j);
  }
  for (; j < n_kt; ++j) {  // tiles the other warpgroup still multiplies
    mbar_wait(&full[j % kStages], (j / kStages) & 1);
    release(j);
  }

  const long long qstride = (long long)H * D;
  const float mult = scale * unscale;  // fp16: dS was scaled by 2^e
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (row >= S) continue;
    T* drow = dq + ((long long)b * S + row) * qstride + (long long)h * D + col0;
#pragma unroll
    for (int c = 0; c < L::kQCols / 8; ++c) {
      if (col0 + 8 * c >= D) continue;  // the padded columns are not written
      const int i = 4 * c + 2 * r;
      store2(drow + 8 * c + 2 * (lane % 4), acc[i] * mult, acc[i + 1] * mult);
    }
  }
}

// Tile sizes and the shared-memory layout of the fp32 (3xTF32) kernel at
// padded width DP (see Design, fp32).
template <int DP>
struct DqTf32Cfg {
  static_assert(DP % 32 == 0 && DP <= 128, "DP: whole panels");
  static constexpr int kWG = DP == 64 ? 2 : 1;  // warpgroups, 64 query rows each
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kBM = 64 * kWG;                // query rows per block
  static constexpr int kBN = DP <= 64 ? 64 : 32;      // keys per K/V tile
  static constexpr int kQ = kBM * DP * 4;             // bytes of Q, Q lo, dO or dO lo
  static constexpr int kKV = kBN * DP * 4;            // of K, K lo, V or V lo
  static constexpr int kT = DP * sm90::kRowBytes * (kBN / 32);  // of K^T hi or lo
  static constexpr int kStage = 4 * kKV + 2 * kT;
  static constexpr int kBarriers = 3 * 8;
  static constexpr int kBytes = 4 * kQ + kStage + kBarriers + sm90::kAtomBytes;
};

template <int DP>
__global__ void __launch_bounds__(DqTf32Cfg<DP>::kThreads, 1)
    flash_dq_sm90_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float* __restrict__ dq, int S, int H, int Hkv, int D, float scale,
                              float scale_log2, int causal) {
  using namespace sm90;
  using C = DqTf32Cfg<DP>;
  constexpr int kBM = C::kBM, kBN = C::kBN, kQ = C::kQ, kKV = C::kKV, kT = C::kT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1k(smem_raw);
  uint8_t* q_s = smem;          // Q, Q lo, dO, dO lo at q_s + i kQ
  uint8_t* st = smem + 4 * kQ;  // K, K lo, V, V lo at st + i kKV; then K^T hi, K^T lo
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(st + C::kStage);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = bar_q + 2;

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows start first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);
  const int q0 = qt * kBM;
  int n_kt = (S + kBN - 1) / kBN;
  if (causal) n_kt = min(n_kt, (q0 + kBM - 1) / kBN + 1);
  const int tid = threadIdx.x, warp = (tid % 128) / 32, lane = tid % 32;
  const int wg = C::kWG == 1 ? 0 : tid / 128;
  const int wg_row0 = q0 + 64 * wg;
  const int n_mine = causal ? min(n_kt, (wg_row0 + 63) / kBN + 1) : n_kt;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(full, 1);
    mbar_init(empty, C::kThreads);
    mbar_init_fence();
  }
  __syncthreads();

  auto load_kv = [&](int j) {
    mbar_expect_tx(full, 2 * kKV);
    tma_load_rows<DP, float>(st, &tk, full, kBN, j * kBN, hk, b);
    tma_load_rows<DP, float>(st + 2 * kKV, &tv, full, kBN, j * kBN, hk, b);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * kQ);
    tma_load_rows<DP, float>(q_s, &tq, bar_q, kBM, q0, h, b);
    tma_load_rows<DP, float>(q_s + 2 * kQ, &tdo, bar_q, kBM, q0, h, b);
    load_kv(0);
  }

  const int row_lo = wg_row0 + 16 * warp + lane / 4;  // rows row_lo and row_lo + 8
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    const long long off = ((long long)b * H + h) * S + row;
    lse2[r] = row < S ? lse[off] * kLog2e : 0.f;
    dlt[r] = row < S ? delta[off] : 0.f;
  }
  const uint32_t q_addr = smem_u32(q_s), st_addr = smem_u32(st);
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar_q, 0);
  // Q and dO: hi in place, lo beside (the first tile's fence and barrier
  // publish these writes too)
  split_tile<DP, kBM, true, false>(q_s, q_s + kQ, nullptr, nullptr, tid, C::kThreads);
  split_tile<DP, kBM, true, false>(q_s + 2 * kQ, q_s + 3 * kQ, nullptr, nullptr, tid,
                                   C::kThreads);
  for (int j = 0; j < n_kt; ++j) {
    mbar_wait(full, j & 1);
    // every thread splits, also those of a warpgroup that has no product left
    split_tile<DP, kBN, true, true>(st, st + kKV, st + 4 * kKV, st + 4 * kKV + kT, tid,
                                    C::kThreads);
    split_tile<DP, kBN, true, false>(st + 2 * kKV, st + 3 * kKV, nullptr, nullptr, tid,
                                     C::kThreads);
    fence_proxy_async();
    __syncthreads();

    if (j < n_mine) {
      const int k0 = j * kBN;
      float sc[kBN / 2], dp[kBN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        const uint64_t qh = desc_kmajor(q_addr, kBM, 64 * wg, kk),
                       ql = desc_kmajor(q_addr + kQ, kBM, 64 * wg, kk);
        const uint64_t kh = desc_kmajor(st_addr, kBN, 0, kk),
                       kl = desc_kmajor(st_addr + kKV, kBN, 0, kk);
        wgmma_ss_tf32(sc, ql, kh, kk > 0);
        wgmma_ss_tf32(sc, qh, kl, 1);
        wgmma_ss_tf32(sc, qh, kh, 1);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        const uint64_t gh = desc_kmajor(q_addr + 2 * kQ, kBM, 64 * wg, kk),
                       gl = desc_kmajor(q_addr + 3 * kQ, kBM, 64 * wg, kk);
        const uint64_t vh = desc_kmajor(st_addr + 2 * kKV, kBN, 0, kk),
                       vl = desc_kmajor(st_addr + 3 * kKV, kBN, 0, kk);
        wgmma_ss_tf32(dp, gl, vh, kk > 0);
        wgmma_ss_tf32(dp, gh, vl, 1);
        wgmma_ss_tf32(dp, gh, vh, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      const bool edge = k0 + kBN > S || (causal && k0 + kBN - 1 > wg_row0);
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        const int r = (i / 2) % 2;
        float p = exp2f(fmaf(sc[i], scale_log2, -lse2[r]));
        if (edge) {
          const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
          if (key >= S || (causal && key > row_lo + 8 * r)) p = 0.f;
        }
        dp[i] = p * (dp[i] - dlt[r]);  // dS
      }

      uint32_t sh[kBN / 8][4], sl[kBN / 8][4];
#pragma unroll
      for (int kk = 0; kk < kBN / 8; ++kk) a_fragment_tf32(sh[kk], sl[kk], dp, kk);
      // this tile's dS K sums in a fresh accumulator, then adds to dq in
      // fp32: the tensor cores truncate as they accumulate
      float tile[DP / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 8; ++kk) {
        const uint64_t th = desc_kmajor(st_addr + 4 * kKV, DP, 0, kk),
                       tl = desc_kmajor(st_addr + 4 * kKV + kT, DP, 0, kk);
        wgmma_rs_tf32(tile, sl[kk], th, kk > 0);
        wgmma_rs_tf32(tile, sh[kk], tl, 1);
        wgmma_rs_tf32(tile, sh[kk], th, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(tile);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] += tile[i];
    }

    mbar_arrive(empty);
    if (tid == 0 && j + 1 < n_kt) {
      mbar_wait(empty, j & 1);  // every thread is done with the stage
      load_kv(j + 1);
    }
  }

  const long long qstride = (long long)H * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (row >= S) continue;
    float* drow = dq + ((long long)b * S + row) * qstride + (long long)h * D;
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
      if (8 * c >= D) continue;  // the padded columns are not written
      const int i = 4 * c + 2 * r;
      store2(drow + 8 * c + 2 * (lane % 4), acc[i] * scale, acc[i + 1] * scale);
    }
  }
}

template <int DP, int kD, typename T, int kDoTerms>
int launch_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* dout_amax, void* dq, int B,
                   int S, int H, int Hkv, int D, float scale, int causal, cudaStream_t stream) {
  using L = DqSmem<DP, kDoTerms>;
  using TDo = std::conditional_t<kDoTerms == 2, float, T>;
  CUtensorMap tq, tk, tv, tdo;
  int err = make_bshd_map<T>(&tq, q, B, S, H, D, L::kBM);
  if (err == 0) err = make_bshd_map<TDo>(&tdo, dout, B, S, H, D, L::kBM);
  if (err == 0) err = make_bshd_map<T>(&tk, k, B, S, Hkv, D, L::kBN);
  if (err == 0) err = make_bshd_map<T>(&tv, v, B, S, Hkv, D, L::kBN);
  if (err != 0) return err;
  const dim3 grid((S + L::kBM - 1) / L::kBM, H, B);
  return launch_n(flash_dq_sm90_kernel<DP, kD, T, kDoTerms>, grid, L::kThreads, L::kBytes,
                  stream, tq, tk, tv, tdo, (const float*)lse, (const float*)delta,
                  (const float*)dout_amax, (T*)dq, S, H, Hkv, D, scale, scale * kLog2e, causal);
}

// bf16 and fp16: D 64, 128, 192, 256, 384 and 512 with dO in q's dtype at
// D fixed, every other case (an fp32 dO at every D) at its padded width
// with D at run time; above 256 dO in q's dtype only.
template <typename T, int kDoTerms>
int launch_dq_sm90_d(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, const void* amax, void* dq, int B, int S,
                     int H, int Hkv, int D, float scale, int causal, cudaStream_t st) {
  if constexpr (kDoTerms == 1) {
    if (D == 512)
      return launch_dq_sm90<512, 512, T, 1>(q, k, v, dout, lse, delta, amax, dq, B, S, H, Hkv, D,
                                            scale, causal, st);
    if (D == 384)
      return launch_dq_sm90<384, 384, T, 1>(q, k, v, dout, lse, delta, amax, dq, B, S, H, Hkv, D,
                                            scale, causal, st);
    if (D > 384)
      return launch_dq_sm90<512, 0, T, 1>(q, k, v, dout, lse, delta, amax, dq, B, S, H, Hkv, D,
                                          scale, causal, st);
    if (D > 256)
      return launch_dq_sm90<384, 0, T, 1>(q, k, v, dout, lse, delta, amax, dq, B, S, H, Hkv, D,
                                          scale, causal, st);
    if (D == 64)
      return launch_dq_sm90<64, 64, T, 1>(q, k, v, dout, lse, delta, amax, dq, B, S, H, Hkv, D,
                                          scale, causal, st);
    if (D == 128)
      return launch_dq_sm90<128, 128, T, 1>(q, k, v, dout, lse, delta, amax, dq, B, S, H, Hkv, D,
                                            scale, causal, st);
    if (D == 192)
      return launch_dq_sm90<192, 192, T, 1>(q, k, v, dout, lse, delta, amax, dq, B, S, H, Hkv, D,
                                            scale, causal, st);
    if (D == 256)
      return launch_dq_sm90<256, 256, T, 1>(q, k, v, dout, lse, delta, amax, dq, B, S, H, Hkv, D,
                                            scale, causal, st);
    if (D > 192)
      return launch_dq_sm90<256, 0, T, 1>(q, k, v, dout, lse, delta, amax, dq, B, S, H, Hkv, D,
                                          scale, causal, st);
    if (D > 128)
      return launch_dq_sm90<192, 0, T, 1>(q, k, v, dout, lse, delta, amax, dq, B, S, H, Hkv, D,
                                          scale, causal, st);
  } else {
    if (D > 256) return (int)cudaErrorInvalidValue;
    if (D > 192)
      return launch_dq_sm90<256, 0, T, 2>(q, k, v, dout, lse, delta, amax, dq, B, S, H, Hkv, D,
                                          scale, causal, st);
    if (D > 128)
      return launch_dq_sm90<192, 0, T, 2>(q, k, v, dout, lse, delta, amax, dq, B, S, H, Hkv, D,
                                          scale, causal, st);
  }
  return D <= 64 ? launch_dq_sm90<64, 0, T, kDoTerms>(q, k, v, dout, lse, delta, amax, dq, B, S,
                                                      H, Hkv, D, scale, causal, st)
                 : launch_dq_sm90<128, 0, T, kDoTerms>(q, k, v, dout, lse, delta, amax, dq, B, S,
                                                       H, Hkv, D, scale, causal, st);
}

template <int DP>
int launch_dq_sm90_tf32(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int B, int S, int H,
                        int Hkv, int D, float scale, int causal, cudaStream_t stream) {
  using C = DqTf32Cfg<DP>;
  CUtensorMap tq, tk, tv, tdo;
  int err = make_bshd_map<float>(&tq, q, B, S, H, D, C::kBM);
  if (err == 0) err = make_bshd_map<float>(&tdo, dout, B, S, H, D, C::kBM);
  if (err == 0) err = make_bshd_map<float>(&tk, k, B, S, Hkv, D, C::kBN);
  if (err == 0) err = make_bshd_map<float>(&tv, v, B, S, Hkv, D, C::kBN);
  if (err != 0) return err;
  const dim3 grid((S + C::kBM - 1) / C::kBM, H, B);
  return launch_n(flash_dq_sm90_tf32_kernel<DP>, grid, C::kThreads, C::kBytes, stream, tq, tk,
                  tv, tdo, (const float*)lse, (const float*)delta, (float*)dq, S, H, Hkv, D,
                  scale, scale * kLog2e, causal);
}

// Tile sizes and the shared-memory layout of the fp32 kernel at padded
// width 192 or 256 (see Wide heads, fp32).
template <int DP>
struct DqTf32WideCfg {
  static_assert(DP == 192 || DP == 256, "DP: six or eight fp32 panels");
  static constexpr int kThreads = 256;  // two warpgroups
  static constexpr int kBM = 64;        // query rows per block, shared
  static constexpr int kBN = 16;        // keys per K/V tile
  static constexpr int kStages = DP == 192 ? 2 : 1;
  static constexpr int kSlabs = DP / 64;            // 64-row slabs of dQ^T
  static constexpr int kMySlabs = (kSlabs + 1) / 2;  // a warpgroup's, at most
  static constexpr int kQ = kBM * DP * 4;           // bytes of Q or dO, raw
  static constexpr int kKV = kBN * DP * 4;          // of K, K lo, V or V lo
  static constexpr int kStage = 4 * kKV;
  static constexpr int kA = kBM * sm90::kRowBytes;  // dS hi or lo: a row a query
  static constexpr int kP = kBM * kBN * 4;          // P, fp32, in fragment order
  static constexpr int kBarriers = (1 + 2 * kStages) * 8;
  static constexpr int kBytes =
      2 * kQ + kStages * kStage + 2 * kA + kP + kBarriers + sm90::kAtomBytes;
  static_assert(kBytes <= 232448, "a block's shared memory");
};

// kD: the head_dim where it is fixed at compile time (kD == DP), else 0 and
// d_rt gives it.
template <int DP, int kD>
__global__ void __launch_bounds__(256, 1)
    flash_dq_sm90_tf32_wide_kernel(const __grid_constant__ CUtensorMap tq,
                                   const __grid_constant__ CUtensorMap tk,
                                   const __grid_constant__ CUtensorMap tv,
                                   const __grid_constant__ CUtensorMap tdo,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta, float* __restrict__ dq,
                                   int S, int H, int Hkv, int d_rt, float scale, float scale_log2,
                                   int causal) {
  using namespace sm90;
  using C = DqTf32WideCfg<DP>;
  constexpr int kBM = C::kBM, kBN = C::kBN, kStages = C::kStages, kKV = C::kKV;
  const int D = kD ? kD : d_rt;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1k(smem_raw);
  uint8_t* q_s = smem;                 // Q, then dO, raw
  uint8_t* do_s = smem + C::kQ;
  uint8_t* st = smem + 2 * C::kQ;      // stage s at st + s kStage: K, K lo, V, V lo
  uint8_t* ds_s = st + kStages * C::kStage;  // dS hi, then dS lo
  float* p_s = reinterpret_cast<float*>(ds_s + 2 * C::kA);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(ds_s + 2 * C::kA + C::kP);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + kStages;

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows start first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);
  const int q0 = qt * kBM;
  int n_kt = (S + kBN - 1) / kBN;
  if (causal) n_kt = min(n_kt, (q0 + kBM - 1) / kBN + 1);
  const int tid = threadIdx.x, warp = (tid % 128) / 32, lane = tid % 32;
  // the warpgroup, through a shuffle so that the compiler knows it is warp-uniform
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::kThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();

  auto load_kv = [&](int j, int s) {
    uint8_t* dst = st + s * C::kStage;
    mbar_expect_tx(&full[s], 2 * kKV);
    tma_load_rows<DP, float>(dst, &tk, &full[s], kBN, j * kBN, hk, b);
    tma_load_rows<DP, float>(dst + 2 * kKV, &tv, &full[s], kBN, j * kBN, hk, b);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * C::kQ);
    tma_load_rows<DP, float>(q_s, &tq, bar_q, kBM, q0, h, b);
    tma_load_rows<DP, float>(do_s, &tdo, bar_q, kBM, q0, h, b);
    for (int j = 0; j < kStages && j < n_kt; ++j) load_kv(j, j);
  }

  // this thread's two rows of S and dP: row_lo and row_lo + 8
  const int row_lo = q0 + 16 * warp + lane / 4;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    const long long off = ((long long)b * H + h) * S + row;
    lse2[r] = row < S ? lse[off] * kLog2e : 0.f;
    dlt[r] = row < S ? delta[off] : 0.f;
  }
  // dQ^T, 64 head-dim rows a slab: warpgroup 0 owns slabs 0.., 1 the rest
  const int slab0 = wg * C::kMySlabs;
  float acc[C::kMySlabs][32];
#pragma unroll
  for (int m = 0; m < C::kMySlabs; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;

  const uint32_t st_addr = smem_u32(st), ds_addr = smem_u32(ds_s);
  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_kt; ++j) {
    const int s = j % kStages, k0 = j * kBN;
    uint8_t* k_s = st + s * C::kStage;
    const uint32_t k_addr = st_addr + s * C::kStage;
    mbar_wait(&full[s], (j / kStages) & 1);
    // this thread's indices, opaque: the shared addresses of the split and of
    // the dS tiles are recomputed each tile, not held across the loop
    const int tid_t = opaque(tid), warp_t = opaque(warp), lane_t = opaque(lane);
    // K and V: hi in place, lo beside
    split_tile<DP, kBN, true, false>(k_s, k_s + kKV, nullptr, nullptr, tid_t, C::kThreads);
    split_tile<DP, kBN, true, false>(k_s + 2 * kKV, k_s + 3 * kKV, nullptr, nullptr, tid_t,
                                     C::kThreads);
    fence_proxy_async();
    __syncthreads();

    // warpgroup 0: S = Q K^T; warpgroup 1: dP = dO V^T (Q and dO split in
    // registers)
    float x[8];
    const uint32_t b_addr = k_addr + 2 * wg * kKV;
    mma_rows_tf32<DP>(x, wg == 0 ? q_s : do_s, kBM, 0, b_addr, b_addr + kKV, kBN, warp, lane);

    const bool edge = k0 + kBN > S || (causal && k0 + kBN - 1 > q0);
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = (i / 2) % 2;
        float p = exp2f(fmaf(x[i], scale_log2, -lse2[r]));
        if (edge) {
          const int key = k0 + frag_col(i, lane);
          if (key >= S || (causal && key > row_lo + 8 * r)) p = 0.f;  // the -1e30 fill
        }
        p_s[i * 128 + tid] = p;
      }
    }
    __syncthreads();  // P; and the previous tile's products have read dS
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = p_s[i * 128 + tid - 128] * (x[i] - dlt[(i / 2) % 2]);
      store_frag_tf32(x, ds_s, ds_s + C::kA, warp_t, lane_t);
      fence_proxy_async();
    }
    __syncthreads();

    // dQ^T += K^T dS^T: K^T from the K tiles, dS from shared memory, a
    // fresh sum a slab
#pragma unroll
    for (int m = 0; m < C::kMySlabs; ++m)
      if (slab0 + m < C::kSlabs)
        mma_cols_tf32_add<kBN / 8>(acc[m], k_addr, k_addr + kKV, kBN, 64 * (slab0 + m), ds_addr,
                                   ds_addr + C::kA, kBM, warp, lane);

    fence_proxy_async();  // the reads of this stage before TMA refills it
    mbar_arrive(&empty[s]);
    if (tid == 0 && j + kStages < n_kt) {
      mbar_wait(&empty[s], (j / kStages) & 1);
      load_kv(j + kStages, s);
    }
  }

  // dQ^T's fragment: head-dim row 64 slab + 16 warp + lane / 4 (+ 8), query
  // column q0 + 8 (i / 4) + 2 (lane % 4) + i % 2
  const long long qstride = (long long)H * D;
#pragma unroll
  for (int m = 0; m < C::kMySlabs; ++m) {
    if (slab0 + m >= C::kSlabs) continue;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int d = 64 * (slab0 + m) + 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
      const int row = q0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
      if (d < D && row < S)  // the padded columns are not written
        dq[((long long)b * S + row) * qstride + (long long)h * D + d] = acc[m][i] * scale;
    }
  }
}

template <int DP, int kD>
int launch_dq_sm90_tf32_wide(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dq, int B, int S, int H,
                             int Hkv, int D, float scale, int causal, cudaStream_t stream) {
  using C = DqTf32WideCfg<DP>;
  CUtensorMap tq, tk, tv, tdo;
  int err = make_bshd_map<float>(&tq, q, B, S, H, D, C::kBM);
  if (err == 0) err = make_bshd_map<float>(&tdo, dout, B, S, H, D, C::kBM);
  if (err == 0) err = make_bshd_map<float>(&tk, k, B, S, Hkv, D, C::kBN);
  if (err == 0) err = make_bshd_map<float>(&tv, v, B, S, Hkv, D, C::kBN);
  if (err != 0) return err;
  const dim3 grid((S + C::kBM - 1) / C::kBM, H, B);
  return launch_n(flash_dq_sm90_tf32_wide_kernel<DP, kD>, grid, C::kThreads, C::kBytes, stream,
                  tq, tk, tv, tdo, (const float*)lse, (const float*)delta, (float*)dq, S, H, Hkv,
                  D, scale, scale * kLog2e, causal);
}

}  // namespace
}  // namespace hvt

// Returns 0 or the CUDA error of the launch. The port's head_dims (in steps
// of 8) and dtypes: q, k, v and dO fp32 (dtype and dout_dtype 0), dq fp32,
// D 8..256; q, k, v bf16 (dtype 1) or fp16 (2) with dO in q's dtype (D
// 8..512) or fp32 (0; D 8..256), dq in q's dtype. dout_amax: a device fp32 scalar, dO's largest
// magnitude, which fp16 q needs (sm90.cuh, dout_scale) and the others do
// not read. The signature is hvt_flash_dq's with dout_amax after delta.
extern "C" int hvt_flash_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, const void* dout_amax,
                                 void* dq, int B, int S, int H, int Hkv, int D, float scale,
                                 int causal, int dtype, int dout_dtype, void* stream) {
  using namespace hvt;
  if (!valid_shape(B, S, H, Hkv, D, sm90_max_d(dtype, dout_dtype)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const void* amax = dout_amax;
  if (dtype == kBF16 && dout_dtype == kBF16)
    return launch_dq_sm90_d<__nv_bfloat16, 1>(q, k, v, dout, lse, delta, amax, dq, B, S, H, Hkv,
                                              D, scale, causal, st);
  if (dtype == kBF16 && dout_dtype == kF32)
    return launch_dq_sm90_d<__nv_bfloat16, 2>(q, k, v, dout, lse, delta, amax, dq, B, S, H, Hkv,
                                              D, scale, causal, st);
  if (dtype == kF16 && amax == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == kF16 && dout_dtype == kF16)
    return launch_dq_sm90_d<__half, 1>(q, k, v, dout, lse, delta, amax, dq, B, S, H, Hkv, D,
                                       scale, causal, st);
  if (dtype == kF16 && dout_dtype == kF32)
    return launch_dq_sm90_d<__half, 2>(q, k, v, dout, lse, delta, amax, dq, B, S, H, Hkv, D,
                                       scale, causal, st);
  if (dtype != kF32 || dout_dtype != kF32) return (int)cudaErrorInvalidValue;
  if (D == 192)
    return launch_dq_sm90_tf32_wide<192, 192>(q, k, v, dout, lse, delta, dq, B, S, H, Hkv, D,
                                              scale, causal, st);
  if (D == 256)
    return launch_dq_sm90_tf32_wide<256, 256>(q, k, v, dout, lse, delta, dq, B, S, H, Hkv, D,
                                              scale, causal, st);
  if (D > 192)
    return launch_dq_sm90_tf32_wide<256, 0>(q, k, v, dout, lse, delta, dq, B, S, H, Hkv, D,
                                            scale, causal, st);
  if (D > 128)
    return launch_dq_sm90_tf32_wide<192, 0>(q, k, v, dout, lse, delta, dq, B, S, H, Hkv, D,
                                            scale, causal, st);
  switch (sm90::padded_width<float>(D)) {
    case 32:
      return launch_dq_sm90_tf32<32>(q, k, v, dout, lse, delta, dq, B, S, H, Hkv, D, scale,
                                     causal, st);
    case 64:
      return launch_dq_sm90_tf32<64>(q, k, v, dout, lse, delta, dq, B, S, H, Hkv, D, scale,
                                     causal, st);
    case 96:
      return launch_dq_sm90_tf32<96>(q, k, v, dout, lse, delta, dq, B, S, H, Hkv, D, scale,
                                     causal, st);
    case 128:
      return launch_dq_sm90_tf32<128>(q, k, v, dout, lse, delta, dq, B, S, H, Hkv, D, scale,
                                      causal, st);
  }
  return (int)cudaErrorInvalidValue;
}
