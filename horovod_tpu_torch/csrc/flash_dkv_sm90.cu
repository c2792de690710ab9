// flash_dkv_sm90.cu: the key and value gradients of attention on Hopper's
// tensor cores (wgmma, TMA, mbarriers; sm_90a only).
//
// Replaces horovod_tpu/ops/flash_attention.py:_dkv_kernel (pl.pallas_call in
// _flash_bwd) for q/k/v in bf16, fp16 or fp32 with any head_dim the port
// takes (in steps of 8: 8..512 for bf16 or fp16 q with dO in q's dtype,
// else 8..256; above 128 bf16 or fp16 q in flash_dkv_sm90_wide_kernel,
// fp32 q in flash_dkv_sm90_tf32_wide_kernel; the wrappers pad other
// head_dims with zero columns); flash_dkv.cu stays
// built and checked as the SIMT
// design, on no route. For each key tile:
//   p = exp(scale q k^T - lse) with the causal fill, dv += p^T dO,
//   dp = dO v^T, ds = p (dp - delta), dk += ds^T q * scale,
// with query tiles before the first one that can see the key tile skipped
// (the TPU kernel's `start`).
//
// Numerics. With bf16 q they differ from _dkv_kernel in one place: it takes
// p^T dO and ds^T q on fp32 operands (:244-253); on the tensor cores p and ds
// are rounded to bf16 first, as in FlashAttention-2/3. dO is taken as
// _dkv_kernel reads it (:231-232): a bf16 dO is exact, and an fp32 dO (the
// sequence ring writes an fp32 o) is split, once per query tile in shared
// memory, into two bf16 terms, hi = bf16(dO) and lo = bf16(dO - hi), so
// that dP^T = V dO_hi^T + V dO_lo^T and dV += P^T dO_hi + P^T dO_lo carry
// 16 bits of dO's mantissa; products of bf16 values are exact in fp32.
// Everything else matches: the scores, p and ds are fp32, every product sums
// in fp32. The plain version with split_dout and round_operands
// (ops/_kernels.py) rounds at the same points. With fp32 q every product,
// p^T dO and ds^T q included, runs as 3xTF32 (sm90.cuh) on fp32 operands,
// within about 2^-21 of fp32 products: the plain version rounds nothing.
// fp16 q takes the bf16 designs with .f16 operands (11 significant bits
// where bf16 has 8), p and dS rounded to fp16, and dO scaled by 2^e
// (sm90.cuh, "fp16's range"): delta scaled on load, dP^T scaled in fp32
// where dO comes in fp16 and an fp32 dO scaled before its split into two
// fp16 terms, so dS^T is rounded to fp16 near 1 whatever dO's magnitude; dk
// (and dv where it was formed from the scaled terms) is multiplied by 2^-e
// as it is written. The plain version (split_dout, round_operands on fp16
// q) models the scale.
//
// Head dims. A kernel is instantiated per padded width DP (64, 128, 192,
// 256, 384 or 512 in bf16 and fp16; 32, 64, 96, 128, 192 or 256 in fp32):
// TMA zero-fills the columns past D, which
// add nothing to any product, and only D columns of dk and dv are written.
// At D 32, 64, 96 and 128 with dO in q's dtype D is fixed at compile time;
// every other head_dim, and bf16 q with an fp32 dO, comes at run time.
//
// Design, bf16. One block of 256 threads owns a 128-key tile of one
// (b, h_kv): two warpgroups of 64 keys each, with K and V resident in shared
// memory. Thread 0 issues every TMA load: K and V once, then 64-row Q/dO
// tiles of each query head of the group through a ring of kStages stages
// behind "full" and "empty" mbarriers. Each warpgroup computes the transposed
// products, so that every intermediate stays in registers:
//   S^T  = K Q^T     wgmma m64n64k16, K and Q K-major from shared memory;
//   dP^T = V dO^T    the same with V and dO (and V dO_lo^T);
//   P^T  = exp2(S^T scale log2(e) - lse log2(e)),  dS^T = P^T (dP^T - delta)
//                    on the accumulator fragments;
//   dV  += P^T dO    wgmma m64nDPk16, P^T as bf16 register A operand, dO
//                    MN-major (and the same A against dO lo);
//   dK  += dS^T Q    the same with dS^T and Q.
// dK and dV stay in fp32 registers across the whole loop, so the GQA group
// sum happens in the kernel and each is written once, in k's dtype. lse and
// delta of a query tile come with plain loads into the warpgroup's shared
// memory: their rows of S floats need not meet TMA's 16-byte stride rule.
// An fp32 dO streams with Q, one tile a stage: TMA lands it past the
// stage's Q, dO hi and dO lo tiles, and the block splits it into them
// (split_terms) before the tile's products. Its stage is 5 * 64 * DP *
// 2 B; at DP 128 two stages and K, V take 226 KB of the 227 KB a block may
// have.
//
// Design, fp32 (3xTF32). Two warpgroups own a 128-key tile at DP 64, one
// warpgroup a 64-key tile at DP 32 (three such blocks fit an SM's
// registers, which won on the card) and at DP 96 and 128 (K, V and their lo
// would not fit twice); Q/dO tiles are kBQ rows (32 at DP 32 and 64, 16 at
// DP 96 and 128), one stage. K and V are split once (hi in place, lo
// beside); each Q and dO tile is split into hi/lo and also written
// transposed (hi and lo), since dV += P^T dO and dK += dS^T Q need them
// K-major. Each product is three wgmmas a k-step of 8 (a_lo b_hi, a_hi b_lo,
// a_hi b_hi), P^T and dS^T split in registers; a Q tile's dV and dK are
// summed in a fresh accumulator, then added to dV and dK in fp32 (the tensor
// cores truncate as they accumulate). Shared memory: K, V and their lo 4 *
// kBKV * DP * 4 B, a stage four kBQ * DP * 4 B tiles and four transposed
// ones of DP * 128 B: 224 KB at DP 128, 168 KB at DP 96, 192 KB at DP 64,
// 64 KB at DP 32.
//
// Bound. At B 8, S 1024, causal, d_model 768 (H = 768 / D) every head_dim
// does the same 25.8 GFLOP of products. bf16 moves 76.3 MB (23 us) against
// 26 us of tensor-core time (operations bound); padded widths issue more
// products (at bf16 D 32 twice as many). fp32 moves 152 MB (45 us) against
// 52 us at TF32's 495 TFLOP/s, and its 3xTF32 products take 156 us: the
// three products bound every fp32 instance; the transposed splits and the
// 16-query products at DP 96/128 come on top. An fp32 dO adds a third of
// the bf16 products (V dO_lo^T, P^T dO_lo) and its split.
//
// Wide heads, bf16 q and dO at DP 192 and 256 (head_dim 136..256; D fixed
// at 192 and 256, at run time between). The design above does not fit: a
// warpgroup's dK and dV accumulators are 2 * DP / 2 fp32 registers a
// thread, 256 at DP 256, over the 255 a thread may have before anything
// else, and K, V resident for 128 keys are 128 KB. So the two warpgroups
// of a 256-thread block share one 64-key tile and split the work by
// product instead of by keys:
//   S^T, dP^T      each warpgroup its own 32 queries of the 64-row Q/dO
//                  tile: wgmma m64n32k16, K (V) and Q (dO) K-major;
//   P^T, dS^T      on those fragments, rounded to bf16 and written into two
//                  64 x 64 tiles in shared memory (the K-major A operand of
//                  the next products), which both warpgroups then read;
//   dV += P^T dO   warpgroup 0, wgmma m64nDPk16, P^T from shared memory,
//                  dO MN-major over three or four panels;
//   dK += dS^T Q   warpgroup 1, the same with dS^T and Q.
// A thread holds one DP / 2 accumulator (128 registers at DP 256) and 16 +
// 16 for S^T and dP^T; the products are split evenly, S^T and dP^T are
// formed once, and the cost is two block barriers a Q tile (the A tiles are
// rewritten only once both warpgroups' products have read them). Shared
// memory: K and V 2 * 64 * DP * 2 B, two stages of Q and dO (as much
// again), the two A tiles (16 KB): 160 KB at DP 192, 208 KB at DP 256;
// one block per SM. Two passes over D's halves would recompute S^T and dP^T
// (1.5 times the products); 32-key warpgroups do not exist (wgmma's M is
// 64).
//   With the sequence ring's fp32 dO, the route up to 128 lands each fp32
// tile beside its stage's Q, dO hi and dO lo; here that stage would be 160
// KB at DP 256, and K, V and the A tiles take 80 KB more. So the fp32 tile
// lands where dO's two terms will lie and the block splits it in place
// (split_terms_in_place): bf16 panel p of dO hi takes the bytes of
// fp32 panels 2 p and lo those of 2 p + 1, and the descriptors step over
// the other term's panels (a panel stride of 128 rows). A stage is then 3 *
// 64 * DP * 2 B: two stages, 208 KB in all, at DP 192; one, 176 KB, at DP
// 256, where the next Q/dO tile loads only once this one's products are
// done. dP^T takes V dO_lo^T in the same commit group, and warpgroup 0 adds
// P^T dO_lo to dV, a third more products than warpgroup 1's dK.
//
// Widest heads, bf16 and fp16 q and dO at DP 384 and 512 (head_dim
// 264..512; D fixed at 384 and 512, at run time between), the wide kernel
// again. One warpgroup's dV or dK would be DP / 2 = 256 registers a thread,
// and wgmma's N stops at 256. So the grid's z takes the batch times D's
// two column halves: a block owns one 64-key tile and one half of dK and
// dV (96 / 128 registers a thread), its warpgroups split by product as
// above (warpgroup 0 dV_half += P^T dO_half, 1 dK_half += dS^T Q_half,
// m64nNk16 with N = DP / 2, the B tile's column half MN-major from its
// panel, sm90.cuh panel_offset). Each block forms S^T and dP^T over the
// whole head, so the two halves' blocks compute them twice: 1.5 times the
// products. K and V for 64 keys take 96 / 128 KB, so Q/dO tiles are 32
// rows, 16 a warpgroup for S^T and dP^T (m64n16k16), and the two dV, dK
// products two k-steps each; a stage (Q, dO) is 48 / 64 KB, two stages at
// DP 384 and one at 512, beside the A tiles (16 KB): 210 KB in all either
// way. A thread holds its half's accumulator, S^T and dP^T (8 + 8). The
// query group is still summed in the kernel; dk, dv are written once.
//
// Wide heads, fp32 q at DP 192 and 256 (flash_dkv_sm90_tf32_wide_kernel,
// 3xTF32). The fp32 design above holds K, V and their lo for 64 keys (4 *
// 64 * DP * 4 B, 256 KB at DP 256) and dK, dV with their fresh sums (2 *
// DP registers a thread): neither fits. Here two warpgroups share a 64-key
// tile. K and V stay raw (2 * 64 * DP * 4 B, 96 / 128 KB) and are register
// A operands split a fragment at a time (sm90.cuh, mma_rows_tf32); Q/dO
// tiles are 16 rows, split in place with their lo beside them (4 * 16 * DP
// * 4 B a stage: two stages at DP 192, one at 256). Per Q/dO tile:
//   S^T = K Q^T     warpgroup 0, and dP^T = V dO^T warpgroup 1: m64n16k8,
//                   three a k-step, a fresh sum every two k-steps;
//   P^T             warpgroup 0, written split into tf32 hi and lo as
//                   K-major tiles of 64 key rows (store_frag_tf32); dS^T
//                   = P^T (dP^T - delta) warpgroup 1, P^T read back as hi +
//                   lo, written the same way;
//   dV^T += dO^T P  warpgroup 0, and dK^T += Q^T dS warpgroup 1: the
//                   transposed products, so that no operand needs a
//                   transposed copy: M = 64 head-dim rows a slab (three or
//                   four), A = dO^T (Q^T) read from the split tile
//                   (mma_cols_tf32_add), B = P^T (dS^T), m64n64k8, each
//                   slab's tile summed in a fresh accumulator and added in
//                   fp32.
// The A tiles hold 16 of a 128-byte row's 32 columns (4 * 8 KB). Shared
// memory: 96 + 96 + 32 KB at DP 192 (225 KB), 128 + 64 + 32 at DP 256 (225
// KB). A thread holds its warpgroup's dV^T or dK^T, three or four slabs
// (96 / 128 registers), beside S^T or dP^T with two fresh sums (24) and its
// fragments, and writes them out key by key (16 row addresses held at once
// beside the 128 accumulators spilled at DP 256): 195 registers at DP 192,
// 223 at 256 (ptxas -v), no spill; the query group is summed in the
// kernel, and dk, dv leave it once. At the wide_head
// attention (B 8, S 1024, H 8, H_kv 1, D 256, causal) the 68.7 GFLOP of
// products take 139 us at TF32's rate and 417 us as 3xTF32 (the bound);
// 128 blocks of one 64-key tile each, each walking 8 heads of 16-query
// tiles with its stage's loads exposed, leave it far above that (PERF.md).
#include "flash_attention.cuh"
#include "sm90.cuh"

namespace hvt {
namespace {

constexpr float kLog2e = 1.4426950408889634f;

// Tile sizes and the shared-memory layout of one instance at padded width DP.
// kDoTerms: the 2-byte terms dO comes in (1: dO in q's dtype; 2: bf16 or
// fp16 q with an fp32 dO, as hi and lo).
template <int DP, typename T, int kDoTerms>
struct DkvCfg {
  static constexpr bool kTf32 = std::is_same<T, float>::value;
  static_assert(DP == sm90::padded_width<T>(DP) && DP <= 128, "DP: whole panels");
  static_assert(kDoTerms == 1 || !kTf32, "fp32 q takes its fp32 dO as it is");
  // warpgroups, 64 keys each; fp32 at DP 32, 96, 128: one (see Design, fp32)
  static constexpr int kWG = kTf32 && DP != 64 ? 1 : 2;
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kBKV = 64 * kWG;        // keys per block
  static constexpr int kBQ = !kTf32 ? 64 : DP <= 64 ? 32 : 16;  // query rows a tile
  static constexpr int kStages = kTf32 ? 1 : 2;
  static constexpr int kKV = kBKV * DP * (int)sizeof(T);  // bytes of the K (or V) tile
  static constexpr int kQ = kBQ * DP * (int)sizeof(T);    // of one Q (or dO) tile
  // a transposed Q or dO tile: DP rows of 128 B per 32 queries
  static constexpr int kT = kTf32 ? DP * sm90::kRowBytes * ((kBQ + 31) / 32) : 0;
  static constexpr int kResident = (kTf32 ? 4 : 2) * kKV;  // K, V (, K lo, V lo)
  // a stage: Q, dO (, Q lo, dO lo, Q^T hi, Q^T lo, dO^T hi, dO^T lo); with
  // two terms Q, dO hi, dO lo and the fp32 dO as TMA lands it (2 kQ)
  static constexpr int kStage = kTf32 ? 4 * kQ + 4 * kT : kDoTerms == 1 ? 2 * kQ : 5 * kQ;
  static constexpr int kVec = kWG * 2 * kBQ * 4;  // per warpgroup: lse, delta of kBQ rows
  static constexpr int kBarriers = (1 + 2 * kStages) * 8;
  static constexpr int kBytes =
      kResident + kStages * kStage + kVec + kBarriers + sm90::kAtomBytes;
  static_assert(kBytes <= 232448, "a block's shared memory");
};

// kD: the head_dim where it is fixed at compile time, else 0 and d_rt
// gives it. dout_amax: dO's largest magnitude, read by fp16 instances only.
template <int DP, int kD, typename T, int kDoTerms>
__global__ void __launch_bounds__(DkvCfg<DP, T, kDoTerms>::kThreads, 1)
    flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const float* __restrict__ dout_amax, T* __restrict__ dk,
                          T* __restrict__ dv, int S, int H, int Hkv, int d_rt, float scale,
                          float scale_log2, int causal) {
  using namespace sm90;
  using L = DkvCfg<DP, T, kDoTerms>;
  constexpr int kBKV = L::kBKV, kBQ = L::kBQ, kStages = L::kStages;
  const int D = kD ? kD : d_rt;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1k(smem_raw);
  uint8_t* k_s = smem;
  uint8_t* v_s = smem + L::kKV;          // fp32: K lo, V lo follow V
  uint8_t* qdo_s = smem + L::kResident;  // stage s at qdo_s + s kStage: Q, dO (, ...)
  float* vec = reinterpret_cast<float*>(qdo_s + kStages * L::kStage);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(vec) + L::kVec);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + kStages;

  const int kt = blockIdx.x;  // low key tiles see the most queries: start them first
  const int hk = blockIdx.y, b = blockIdx.z, group = H / Hkv;
  const int k0 = kt * kBKV;
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int qt_start = causal ? k0 / kBQ : 0;  // earlier query tiles see none of these keys
  const int per_head = n_qt - qt_start;
  const int n_iter = group * per_head;
  const int tid = threadIdx.x, warp = (tid % 128) / 32, lane = tid % 32;
  const int wg = L::kWG == 1 ? 0 : tid / 128;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], L::kThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();

  auto load_q = [&](int t, int s) {
    const int h = hk * group + t / per_head, q0 = (qt_start + t % per_head) * kBQ;
    uint8_t* dst = qdo_s + s * L::kStage;
    if constexpr (kDoTerms == 1) {
      mbar_expect_tx(&full[s], 2 * L::kQ);
      tma_load_rows<DP, T>(dst, &tq, &full[s], kBQ, q0, h, b);
      tma_load_rows<DP, T>(dst + L::kQ, &tdo, &full[s], kBQ, q0, h, b);
    } else {  // the fp32 dO lands past Q, dO hi and dO lo
      mbar_expect_tx(&full[s], 3 * L::kQ);
      tma_load_rows<DP, T>(dst, &tq, &full[s], kBQ, q0, h, b);
      tma_load_rows<DP, float>(dst + 3 * L::kQ, &tdo, &full[s], kBQ, q0, h, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * L::kKV);
    tma_load_rows<DP, T>(k_s, &tk, bar_kv, kBKV, k0, hk, b);
    tma_load_rows<DP, T>(v_s, &tv, bar_kv, kBKV, k0, hk, b);
    for (int t = 0; t < kStages && t < n_iter; ++t) load_q(t, t);
  }

  const uint32_t k_addr = smem_u32(k_s), v_addr = smem_u32(v_s), qdo_addr = smem_u32(qdo_s);
  const int key_lo = k0 + 64 * wg + 16 * warp + lane / 4;  // keys key_lo and key_lo + 8
  float* lse_s = vec + wg * 2 * kBQ;                         // this warpgroup's lse * log2(e)
  float* delta_s = lse_s + kBQ;
  // fp16: dO's scale 2^e (dP^T's too where dO comes in fp16) and 2^-e
  float do_scale = 1.f, unscale = 1.f;
  if constexpr (is_f16<T>()) dout_scale(dout_amax, do_scale, unscale);
  const float dp_scale = kDoTerms == 1 ? do_scale : 1.f;  // two terms: scaled in the split
  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(bar_kv, 0);
  if constexpr (L::kTf32) {
    split_tile<DP, kBKV, true, false>(k_s, k_s + 2 * L::kKV, nullptr, nullptr, tid, L::kThreads);
    split_tile<DP, kBKV, true, false>(v_s, v_s + 2 * L::kKV, nullptr, nullptr, tid, L::kThreads);
  }
  for (int t = 0; t < n_iter; ++t) {
    const int s = t % kStages;
    const int h = hk * group + t / per_head, q0 = (qt_start + t % per_head) * kBQ;
    const uint32_t q_addr = qdo_addr + s * L::kStage, do_addr = q_addr + L::kQ;

    warpgroup_sync(wg);  // the previous tile's readers of lse_s, delta_s are done
    {
      const int r = tid % kBQ, qp = q0 + r;
      const long long off = ((long long)b * H + h) * S + qp;
      if (tid % 128 < kBQ)
        lse_s[r] = qp < S ? lse[off] * kLog2e : 0.f;
      else
        delta_s[r] = qp < S ? delta[off] * do_scale : 0.f;  // fp16: scaled
    }
    warpgroup_sync(wg);
    mbar_wait(&full[s], (t / kStages) & 1);

    float sc[kBQ / 2], dp[kBQ / 2];
    if constexpr (L::kTf32) {
      uint8_t* q_p = qdo_s + s * L::kStage;
      uint8_t* t_p = q_p + 4 * L::kQ;  // Q^T hi, Q^T lo, dO^T hi, dO^T lo
      split_tile<DP, kBQ, true, true>(q_p, q_p + 2 * L::kQ, t_p, t_p + L::kT, tid, L::kThreads);
      split_tile<DP, kBQ, true, true>(q_p + L::kQ, q_p + 3 * L::kQ, t_p + 2 * L::kT,
                                      t_p + 3 * L::kT, tid, L::kThreads);
      fence_proxy_async();
      __syncthreads();
      const uint32_t klo = k_addr + 2 * L::kKV, vlo = v_addr + 2 * L::kKV;
      const uint32_t qlo = q_addr + 2 * L::kQ, dolo = q_addr + 3 * L::kQ;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        const uint64_t ah = desc_kmajor(k_addr, kBKV, 64 * wg, kk),
                       al = desc_kmajor(klo, kBKV, 64 * wg, kk);
        const uint64_t bh = desc_kmajor(q_addr, kBQ, 0, kk), bl = desc_kmajor(qlo, kBQ, 0, kk);
        wgmma_ss_tf32(sc, al, bh, kk > 0);
        wgmma_ss_tf32(sc, ah, bl, 1);
        wgmma_ss_tf32(sc, ah, bh, 1);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        const uint64_t ah = desc_kmajor(v_addr, kBKV, 64 * wg, kk),
                       al = desc_kmajor(vlo, kBKV, 64 * wg, kk);
        const uint64_t bh = desc_kmajor(do_addr, kBQ, 0, kk), bl = desc_kmajor(dolo, kBQ, 0, kk);
        wgmma_ss_tf32(dp, al, bh, kk > 0);
        wgmma_ss_tf32(dp, ah, bl, 1);
        wgmma_ss_tf32(dp, ah, bh, 1);
      }
    } else {
      if constexpr (kDoTerms == 2) {
        // the fp32 dO into its two terms; every thread splits, and both
        // warpgroups read the whole tile
        uint8_t* st = qdo_s + s * L::kStage;
        split_terms<DP, kBQ, T>(st + 3 * L::kQ, st + L::kQ, st + 2 * L::kQ, tid, L::kThreads,
                                do_scale);
        fence_proxy_async();
        __syncthreads();
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss<0, T>(sc, desc_kmajor(k_addr, kBKV, 64 * wg, kk),
                       desc_kmajor(q_addr, kBQ, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss<0, T>(dp, desc_kmajor(v_addr, kBKV, 64 * wg, kk),
                       desc_kmajor(do_addr, kBQ, 0, kk), kk > 0);
      if constexpr (kDoTerms == 2) {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss<0, T>(dp, desc_kmajor(v_addr, kBKV, 64 * wg, kk),
                         desc_kmajor(do_addr + L::kQ, kBQ, 0, kk), 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    const bool edge = q0 + kBQ > S || k0 + 64 * wg + 64 > S ||
                      (causal && k0 + 64 * wg + 63 > q0);
#pragma unroll
    for (int i = 0; i < kBQ / 2; ++i) {
      const int c = 8 * (i / 4) + 2 * (lane % 4) + i % 2;  // query row within the tile
      float p = exp2f(fmaf(sc[i], scale_log2, -lse_s[c]));
      if (edge) {
        const int key = key_lo + 8 * ((i / 2) % 2), qp = q0 + c;
        if (qp >= S || key >= S || (causal && key > qp)) p = 0.f;
      }
      sc[i] = p;  // P^T
      if constexpr (is_f16<T>())
        dp[i] = p * fmaf(dp[i], dp_scale, -delta_s[c]);  // dS^T, scaled
      else
        dp[i] = p * (dp[i] - delta_s[c]);  // dS^T
    }

    if constexpr (L::kTf32) {
      const uint32_t t_addr = q_addr + 4 * L::kQ;  // Q^T hi, Q^T lo, dO^T hi, dO^T lo
      uint32_t ph[kBQ / 8][4], pl[kBQ / 8][4], sh[kBQ / 8][4], sl[kBQ / 8][4];
#pragma unroll
      for (int kk = 0; kk < kBQ / 8; ++kk) {
        a_fragment_tf32(ph[kk], pl[kk], sc, kk);
        a_fragment_tf32(sh[kk], sl[kk], dp, kk);
      }
      // each tile's dV and dK sum in a fresh accumulator that is then added
      // to dv_acc, dk_acc in fp32: the tensor cores' accumulation truncates,
      // and over a whole key tile's loop (hundreds of wgmmas into one
      // register) that drifted 7e-5 from fp32 sums on the card
      float tile[DP / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 8; ++kk) {
        const uint64_t bh = desc_kmajor(t_addr + 2 * L::kT, DP, 0, kk),
                       bl = desc_kmajor(t_addr + 3 * L::kT, DP, 0, kk);
        wgmma_rs_tf32(tile, pl[kk], bh, kk > 0);
        wgmma_rs_tf32(tile, ph[kk], bl, 1);
        wgmma_rs_tf32(tile, ph[kk], bh, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(tile);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dv_acc[i] += tile[i];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 8; ++kk) {
        const uint64_t bh = desc_kmajor(t_addr, DP, 0, kk),
                       bl = desc_kmajor(t_addr + L::kT, DP, 0, kk);
        wgmma_rs_tf32(tile, sl[kk], bh, kk > 0);
        wgmma_rs_tf32(tile, sh[kk], bl, 1);
        wgmma_rs_tf32(tile, sh[kk], bh, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(tile);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dk_acc[i] += tile[i];
    } else {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        uint32_t a[4];
        a_fragment<T>(a, sc, kk);
        wgmma_rs<1, T>(dv_acc, a, desc_mnmajor(do_addr, kBQ, kk), 1);
        if constexpr (kDoTerms == 2)
          wgmma_rs<1, T>(dv_acc, a, desc_mnmajor(do_addr + L::kQ, kBQ, kk), 1);
      }
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        uint32_t a[4];
        a_fragment<T>(a, dp, kk);
        wgmma_rs<1, T>(dk_acc, a, desc_mnmajor(q_addr, kBQ, kk), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    }

    mbar_arrive(&empty[s]);
    if (tid == 0 && t + kStages < n_iter) {
      mbar_wait(&empty[s], (t / kStages) & 1);  // every warpgroup is done with stage s
      load_q(t + kStages, s);
    }
  }

  const long long kstride = (long long)Hkv * D;
  // fp16: dS^T was scaled by 2^e, and with dO's two terms P^T dO too
  const float dk_mult = scale * unscale, dv_mult = kDoTerms == 2 ? unscale : 1.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_lo + 8 * r;
    if (key >= S) continue;
    const long long off = ((long long)b * S + key) * kstride + (long long)hk * D;
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
      if (8 * c >= D) continue;  // the padded columns are not written
      const int col = 8 * c + 2 * (lane % 4), i = 4 * c + 2 * r;
      store2(dk + off + col, dk_acc[i] * dk_mult, dk_acc[i + 1] * dk_mult);
      if constexpr (is_f16<T>())
        store2(dv + off + col, dv_acc[i] * dv_mult, dv_acc[i + 1] * dv_mult);
      else
        store2(dv + off + col, dv_acc[i], dv_acc[i + 1]);
    }
  }
}

// Tile sizes and the shared-memory layout of the wide-head kernel (see Wide
// heads): bf16 or fp16 q at padded width DP 192 or 256, dO in q's dtype
// (kDoTerms 1) or fp32 (2: its two 2-byte terms).
template <int DP, int kDoTerms>
struct DkvWideCfg {
  static_assert(DP == 192 || DP == 256 || (kDoTerms == 1 && (DP == 384 || DP == 512)),
                "DP: three, four, six or eight 2-byte panels");
  // DP 384 and 512: each block owns one column half of dK and dV (see
  // Widest heads)
  static constexpr int kHalves = DP > 256 ? 2 : 1;
  static constexpr int kCols = DP / kHalves;  // columns of dK and dV a block owns
  static constexpr int kThreads = 256;  // two warpgroups
  static constexpr int kBKV = 64;       // keys per block, shared by both warpgroups
  // query rows a tile, kQW a warpgroup for S^T, dP^T: 64 (32) up to DP 256,
  // 32 (16) above
  static constexpr int kBQ = DP > 256 ? 32 : 64;
  static constexpr int kQW = kBQ / 2;
  // an fp32 dO's stage: two fit at DP 192, one at DP 256; at DP 512 one
  static constexpr int kStages = (kDoTerms == 2 && DP == 256) || DP == 512 ? 1 : 2;
  static constexpr int kKV = kBKV * DP * 2;  // bytes of the K (or V) tile
  static constexpr int kQ = kBQ * DP * 2;    // of one Q (or bf16 dO) tile
  // a stage: Q, then dO; an fp32 dO (2 kQ) is split in place into its hi
  // and lo, whose panels alternate, so they are read with a panel stride
  // of kDoRows rows
  static constexpr int kStage = (1 + kDoTerms) * kQ;
  static constexpr int kDoRows = kDoTerms * kBQ;
  static constexpr int kA = kBKV * sm90::kRowBytes;  // P^T or dS^T, 2-byte, a 128-byte row a key
  static constexpr int kBarriers = (1 + 2 * kStages) * 8;
  static constexpr int kBytes =
      2 * kKV + kStages * kStage + 2 * kA + kBarriers + sm90::kAtomBytes;
  static_assert(kBytes <= 232448, "a block's shared memory");
};

// kD: the head_dim where it is fixed at compile time, else 0 and d_rt
// gives it. T: bf16 or fp16; dout_amax: dO's largest magnitude, read by
// fp16 instances only.
template <int DP, int kD, typename T, int kDoTerms>
__global__ void __launch_bounds__(256, 1)
    flash_dkv_sm90_wide_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               const float* __restrict__ dout_amax, T* __restrict__ dk,
                               T* __restrict__ dv, int S, int H, int Hkv, int d_rt, float scale,
                               float scale_log2, int causal) {
  using namespace sm90;
  using L = DkvWideCfg<DP, kDoTerms>;
  constexpr int kBKV = L::kBKV, kBQ = L::kBQ, kStages = L::kStages, kDoRows = L::kDoRows;
  constexpr int kQW = L::kQW;
  const int D = kD ? kD : d_rt;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1k(smem_raw);
  uint8_t* k_s = smem;
  uint8_t* v_s = smem + L::kKV;
  uint8_t* qdo_s = smem + 2 * L::kKV;  // stage s at qdo_s + s kStage: Q, dO
  uint8_t* pt_s = qdo_s + kStages * L::kStage;  // P^T, then dS^T at pt_s + kA
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(pt_s + 2 * L::kA);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + kStages;

  const int kt = blockIdx.x;  // low key tiles see the most queries: start them first
  // z: the batch, and with column halves the half of dK, dV this block owns
  const int hk = blockIdx.y, b = blockIdx.z / L::kHalves, group = H / Hkv;
  const int col0 = (blockIdx.z % L::kHalves) * L::kCols;
  const int k0 = kt * kBKV;
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int qt_start = causal ? k0 / kBQ : 0;  // earlier query tiles see none of these keys
  const int per_head = n_qt - qt_start;
  const int n_iter = group * per_head;
  const int tid = threadIdx.x, warp = (tid % 128) / 32, lane = tid % 32;
  // the warpgroup, through a shuffle so that the compiler knows it is warp-uniform
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], L::kThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();

  auto load_q = [&](int t, int s) {
    const int h = hk * group + t / per_head, q0 = (qt_start + t % per_head) * kBQ;
    uint8_t* dst = qdo_s + s * L::kStage;
    mbar_expect_tx(&full[s], L::kStage);
    tma_load_rows<DP, T>(dst, &tq, &full[s], kBQ, q0, h, b);
    if constexpr (kDoTerms == 1)
      tma_load_rows<DP, T>(dst + L::kQ, &tdo, &full[s], kBQ, q0, h, b);
    else
      tma_load_rows<DP, float>(dst + L::kQ, &tdo, &full[s], kBQ, q0, h, b);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * L::kKV);
    tma_load_rows<DP, T>(k_s, &tk, bar_kv, kBKV, k0, hk, b);
    tma_load_rows<DP, T>(v_s, &tv, bar_kv, kBKV, k0, hk, b);
    for (int t = 0; t < kStages && t < n_iter; ++t) load_q(t, t);
  }

  const uint32_t k_addr = smem_u32(k_s), v_addr = smem_u32(v_s), qdo_addr = smem_u32(qdo_s);
  const uint32_t pt_addr = smem_u32(pt_s), dst_addr = pt_addr + L::kA;
  const int key_lo = k0 + 16 * warp + lane / 4;  // keys key_lo and key_lo + 8
  // this warpgroup's product: dV += P^T dO (0) or dK += dS^T Q (1)
  const uint32_t a_addr = wg == 0 ? pt_addr : dst_addr;
  // fp16: dO's scale 2^e (dP^T's too where dO comes in fp16) and 2^-e
  float do_scale = 1.f, unscale = 1.f;
  if constexpr (is_f16<T>()) dout_scale(dout_amax, do_scale, unscale);
  const float dp_scale = kDoTerms == 1 ? do_scale : 1.f;  // two terms: scaled in the split
  float acc[L::kCols / 2];
#pragma unroll
  for (int i = 0; i < L::kCols / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int t = 0; t < n_iter; ++t) {
    const int s = t % kStages;
    const int h = hk * group + t / per_head, q0 = (qt_start + t % per_head) * kBQ;
    const int qw = q0 + kQW * wg;  // this warpgroup's first query of S^T, dP^T
    const uint32_t q_addr = qdo_addr + s * L::kStage, do_addr = q_addr + L::kQ;

    // lse and delta of this thread's kQW / 4 queries, read while the
    // products run
    float lse2[kQW / 4], dlt[kQW / 4];
#pragma unroll
    for (int j = 0; j < kQW / 4; ++j) {
      const int qp = qw + 8 * (j / 2) + 2 * (lane % 4) + j % 2;
      const long long off = ((long long)b * H + h) * S + qp;
      lse2[j] = qp < S ? lse[off] * kLog2e : 0.f;
      dlt[j] = qp < S ? delta[off] * do_scale : 0.f;  // fp16: scaled
    }
    mbar_wait(&full[s], (t / kStages) & 1);
    if constexpr (kDoTerms == 2) {
      // the fp32 dO into its two terms, in place; both warpgroups read all
      // of them
      split_terms_in_place<DP, kBQ, T>(qdo_s + s * L::kStage + L::kQ, tid, L::kThreads,
                                       do_scale);
      fence_proxy_async();
      __syncthreads();
    }

    float sc[kQW / 2], dp[kQW / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss<0, T>(sc, desc_kmajor(k_addr, kBKV, 0, kk),
                     desc_kmajor(q_addr, kBQ, kQW * wg, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss<0, T>(dp, desc_kmajor(v_addr, kBKV, 0, kk),
                     desc_kmajor(do_addr, kDoRows, kQW * wg, kk), kk > 0);
    if constexpr (kDoTerms == 2) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss<0, T>(dp, desc_kmajor(v_addr, kBKV, 0, kk),
                       desc_kmajor(do_addr + kBQ * kRowBytes, kDoRows, kQW * wg, kk), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    const bool edge = qw + kQW > S || k0 + kBKV > S || (causal && k0 + kBKV - 1 > qw);
#pragma unroll
    for (int i = 0; i < kQW / 2; ++i) {
      const int j = 2 * (i / 4) + i % 2;  // the query's slot in lse2, dlt
      float p = exp2f(fmaf(sc[i], scale_log2, -lse2[j]));
      if (edge) {
        const int key = key_lo + 8 * ((i / 2) % 2), qp = qw + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        if (qp >= S || key >= S || (causal && key > qp)) p = 0.f;
      }
      sc[i] = p;  // P^T
      if constexpr (is_f16<T>())
        dp[i] = p * fmaf(dp[i], dp_scale, -dlt[j]);  // dS^T, scaled
      else
        dp[i] = p * (dp[i] - dlt[j]);  // dS^T
    }

    // both warpgroups' products of the previous tile have read the A tiles
    __syncthreads();
    // this warpgroup's kQW columns of P^T and dS^T, in T, as the K-major A
    // operand: row = key (64 rows of one 128-byte panel), column = query
    // kQW wg + c, swizzled by 16-byte chunk
#pragma unroll
    for (int i = 0; i < kQW / 2; i += 2) {
      const int row = 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
      const int col = kQW * wg + 8 * (i / 4) + 2 * (lane % 4);
      const int off = row * kRowBytes + (((col / 8) ^ (row % 8)) * 16) + (col % 8) * 2;
      *reinterpret_cast<uint32_t*>(pt_s + off) = pack2<T>(sc[i], sc[i + 1]);
      *reinterpret_cast<uint32_t*>(pt_s + L::kA + off) = pack2<T>(dp[i], dp[i + 1]);
    }
    fence_proxy_async();
    __syncthreads();

    // dV += P^T dO (warpgroup 0; with dO's two terms, P^T dO_lo too) or
    // dK += dS^T Q (warpgroup 1), over this block's columns of dO or Q
    const int b_rows = wg == 0 ? kDoRows : kBQ;
    const uint32_t b_addr = (wg == 0 ? do_addr : q_addr) + panel_offset(col0, b_rows);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      wgmma_ss<1, T>(acc, desc_kmajor(a_addr, kBKV, 0, kk), desc_mnmajor(b_addr, b_rows, kk),
                     1);
    if constexpr (kDoTerms == 2) {
      if (wg == 0) {
#pragma unroll
        for (int kk = 0; kk < kBQ / 16; ++kk)
          wgmma_ss<1, T>(acc, desc_kmajor(pt_addr, kBKV, 0, kk),
                         desc_mnmajor(do_addr + kBQ * kRowBytes, kDoRows, kk), 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);

    mbar_arrive(&empty[s]);
    if (tid == 0 && t + kStages < n_iter) {
      mbar_wait(&empty[s], (t / kStages) & 1);  // every warpgroup is done with stage s
      load_q(t + kStages, s);
    }
  }

  // warpgroup 0 writes dV, warpgroup 1 dK (with the softmax scale; fp16: and
  // 2^-e for dS^T's scale, and for dV with dO's two scaled terms)
  T* out = wg == 0 ? dv : dk;
  const float mult = wg == 0 ? (kDoTerms == 2 ? unscale : 1.f) : scale * unscale;
  const long long kstride = (long long)Hkv * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_lo + 8 * r;
    if (key >= S) continue;
    const long long off = ((long long)b * S + key) * kstride + (long long)hk * D + col0;
#pragma unroll
    for (int c = 0; c < L::kCols / 8; ++c) {
      if (col0 + 8 * c >= D) continue;  // the padded columns are not written
      const int i = 4 * c + 2 * r;
      store2(out + off + 8 * c + 2 * (lane % 4), acc[i] * mult, acc[i + 1] * mult);
    }
  }
}

template <int DP, int kD, typename T, int kDoTerms>
int launch_dkv_sm90_wide(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, const void* dout_amax, void* dk,
                         void* dv, int B, int S, int H, int Hkv, int D, float scale, int causal,
                         cudaStream_t stream) {
  using L = DkvWideCfg<DP, kDoTerms>;
  using TDo = std::conditional_t<kDoTerms == 2, float, T>;
  CUtensorMap tq, tk, tv, tdo;
  int err = make_bshd_map<T>(&tq, q, B, S, H, D, L::kBQ);
  if (err == 0) err = make_bshd_map<TDo>(&tdo, dout, B, S, H, D, L::kBQ);
  if (err == 0) err = make_bshd_map<T>(&tk, k, B, S, Hkv, D, L::kBKV);
  if (err == 0) err = make_bshd_map<T>(&tv, v, B, S, Hkv, D, L::kBKV);
  if (err != 0) return err;
  const dim3 grid((S + L::kBKV - 1) / L::kBKV, Hkv, B * L::kHalves);
  return launch_n(flash_dkv_sm90_wide_kernel<DP, kD, T, kDoTerms>, grid, L::kThreads, L::kBytes,
                  stream, tq, tk, tv, tdo, (const float*)lse, (const float*)delta,
                  (const float*)dout_amax, (T*)dk, (T*)dv, S, H, Hkv, D, scale, scale * kLog2e,
                  causal);
}

// Tile sizes and the shared-memory layout of the fp32 kernel at padded
// width 192 or 256 (see Wide heads, fp32).
template <int DP>
struct DkvTf32WideCfg {
  static_assert(DP == 192 || DP == 256, "DP: six or eight fp32 panels");
  static constexpr int kThreads = 256;  // two warpgroups
  static constexpr int kBKV = 64;       // keys per block, shared
  static constexpr int kBQ = 16;        // query rows a tile
  static constexpr int kStages = DP == 192 ? 2 : 1;
  static constexpr int kSlabs = DP / 64;  // 64-row slabs of dV^T or dK^T
  static constexpr int kKV = kBKV * DP * 4;  // bytes of K or V, raw
  static constexpr int kQ = kBQ * DP * 4;    // of Q, Q lo, dO or dO lo
  static constexpr int kStage = 4 * kQ;
  static constexpr int kA = kBKV * sm90::kRowBytes;  // P^T or dS^T, hi or lo: a row a key
  static constexpr int kBarriers = (1 + 2 * kStages) * 8;
  static constexpr int kBytes =
      2 * kKV + kStages * kStage + 4 * kA + kBarriers + sm90::kAtomBytes;
  static_assert(kBytes <= 232448, "a block's shared memory");
};

// kD: the head_dim where it is fixed at compile time, else 0 and d_rt
// gives it.
template <int DP, int kD>
__global__ void __launch_bounds__(256, 1)
    flash_dkv_sm90_tf32_wide_kernel(const __grid_constant__ CUtensorMap tq,
                                    const __grid_constant__ CUtensorMap tk,
                                    const __grid_constant__ CUtensorMap tv,
                                    const __grid_constant__ CUtensorMap tdo,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ delta, float* __restrict__ dk,
                                    float* __restrict__ dv, int S, int H, int Hkv, int d_rt,
                                    float scale, float scale_log2, int causal) {
  using namespace sm90;
  using C = DkvTf32WideCfg<DP>;
  constexpr int kBKV = C::kBKV, kBQ = C::kBQ, kStages = C::kStages, kQ = C::kQ, kA = C::kA;
  const int D = kD ? kD : d_rt;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1k(smem_raw);
  uint8_t* k_s = smem;  // K, then V, raw
  uint8_t* v_s = smem + C::kKV;
  uint8_t* st = smem + 2 * C::kKV;  // stage s at st + s kStage: Q, Q lo, dO, dO lo
  uint8_t* a_s = st + kStages * C::kStage;  // P^T hi, P^T lo, dS^T hi, dS^T lo
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(a_s + 4 * kA);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + kStages;

  const int kt = blockIdx.x;  // low key tiles see the most queries: start them first
  const int hk = blockIdx.y, b = blockIdx.z, group = H / Hkv;
  const int k0 = kt * kBKV;
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int qt_start = causal ? k0 / kBQ : 0;  // earlier query tiles see none of these keys
  const int per_head = n_qt - qt_start;
  const int n_iter = group * per_head;
  const int tid = threadIdx.x, warp = (tid % 128) / 32, lane = tid % 32;
  // the warpgroup, through a shuffle so that the compiler knows it is warp-uniform
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::kThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();

  auto load_q = [&](int t, int s) {
    const int h = hk * group + t / per_head, q0 = (qt_start + t % per_head) * kBQ;
    uint8_t* dst = st + s * C::kStage;
    mbar_expect_tx(&full[s], 2 * kQ);
    tma_load_rows<DP, float>(dst, &tq, &full[s], kBQ, q0, h, b);
    tma_load_rows<DP, float>(dst + 2 * kQ, &tdo, &full[s], kBQ, q0, h, b);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * C::kKV);
    tma_load_rows<DP, float>(k_s, &tk, bar_kv, kBKV, k0, hk, b);
    tma_load_rows<DP, float>(v_s, &tv, bar_kv, kBKV, k0, hk, b);
    for (int t = 0; t < kStages && t < n_iter; ++t) load_q(t, t);
  }

  const uint32_t st_addr = smem_u32(st), a_addr = smem_u32(a_s);
  // this warpgroup's product: dV^T += dO^T P (0) or dK^T += Q^T dS (1)
  float acc[C::kSlabs][32];
#pragma unroll
  for (int m = 0; m < C::kSlabs; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int t = 0; t < n_iter; ++t) {
    const int s = t % kStages;
    const int h = hk * group + t / per_head, q0 = (qt_start + t % per_head) * kBQ;
    uint8_t* q_s = st + s * C::kStage;  // Q, Q lo, dO, dO lo
    const uint32_t q_addr = st_addr + s * C::kStage;

    // lse (warpgroup 0) or delta (1) of this thread's four queries, read
    // while the tile lands: column 8 (j / 2) + 2 (lane % 4) + j % 2
    float vec[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qp = q0 + 8 * (j / 2) + 2 * (lane % 4) + j % 2;
      const long long off = ((long long)b * H + h) * S + qp;
      vec[j] = qp >= S ? 0.f : wg == 0 ? lse[off] * kLog2e : delta[off];
    }
    mbar_wait(&full[s], (t / kStages) & 1);
    // this thread's indices, opaque: the shared addresses of the split and of
    // the A tiles are recomputed each tile, not held across the loop
    const int tid_t = opaque(tid), warp_t = opaque(warp), lane_t = opaque(lane);
    // Q and dO: hi in place, lo beside
    split_tile<DP, kBQ, true, false>(q_s, q_s + kQ, nullptr, nullptr, tid_t, C::kThreads);
    split_tile<DP, kBQ, true, false>(q_s + 2 * kQ, q_s + 3 * kQ, nullptr, nullptr, tid_t,
                                     C::kThreads);
    fence_proxy_async();
    __syncthreads();

    // warpgroup 0: S^T = K Q^T; warpgroup 1: dP^T = V dO^T (K and V split in
    // registers)
    float x[8];
    const uint32_t b_addr = q_addr + 2 * wg * kQ;
    mma_rows_tf32<DP>(x, wg == 0 ? k_s : v_s, kBKV, 0, b_addr, b_addr + kQ, kBQ, warp, lane);

    const bool edge = q0 + kBQ > S || k0 + kBKV > S || (causal && k0 + kBKV - 1 > q0);
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float p = exp2f(fmaf(x[i], scale_log2, -vec[2 * (i / 4) + i % 2]));
        if (edge) {
          const int key = k0 + frag_row(i, warp, lane), qp = q0 + frag_col(i, lane);
          if (qp >= S || key >= S || (causal && key > qp)) p = 0.f;
        }
        x[i] = p;
      }
      store_frag_tf32(x, a_s, a_s + kA, warp_t, lane_t);  // P^T
      fence_proxy_async();
    }
    __syncthreads();  // P^T; and the previous tile's products have read dS^T
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < 8; i += 2) {
        const int off = f32_offset(kBKV, frag_row(i, warp_t, lane_t), frag_col(i, lane_t));
        const float2 ph = *reinterpret_cast<const float2*>(a_s + off);
        const float2 pl = *reinterpret_cast<const float2*>(a_s + kA + off);
        x[i] = (ph.x + pl.x) * (x[i] - vec[2 * (i / 4)]);
        x[i + 1] = (ph.y + pl.y) * (x[i + 1] - vec[2 * (i / 4) + 1]);
      }
      store_frag_tf32(x, a_s + 2 * kA, a_s + 3 * kA, warp_t, lane_t);  // dS^T
      fence_proxy_async();
    }
    __syncthreads();

    // dV^T += dO^T P (warpgroup 0) or dK^T += Q^T dS (1): the A fragments
    // from the split dO or Q tile, a fresh sum a slab
    const uint32_t x_addr = q_addr + 2 * (1 - wg) * kQ, bt = a_addr + 2 * wg * kA;
#pragma unroll
    for (int m = 0; m < C::kSlabs; ++m)
      mma_cols_tf32_add<kBQ / 8>(acc[m], x_addr, x_addr + kQ, kBQ, 64 * m, bt, bt + kA, kBKV,
                                 warp, lane);

    fence_proxy_async();  // the reads of this stage before TMA refills it
    mbar_arrive(&empty[s]);
    if (tid == 0 && t + kStages < n_iter) {
      mbar_wait(&empty[s], (t / kStages) & 1);
      load_q(t + kStages, s);
    }
  }

  // warpgroup 0 writes dV, warpgroup 1 dK (with the softmax scale): element
  // i of slab m of dV^T's fragment is head-dim row 64 m + 16 warp + lane / 4
  // + 8 ((i / 2) % 2), key column k0 + 8 (i / 4) + 2 (lane % 4) + i % 2. Key
  // by key, its row's address opaque, so that the compiler does not hold 16
  // row addresses beside the 128 accumulators (at DP 256 that spilled)
  float* out = wg == 0 ? dv : dk;
  const float mult = wg == 0 ? 1.f : scale;
  const long long kstride = (long long)Hkv * D;
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = opaque(k0 + 8 * c + 2 * (lane % 4) + e);
      if (key >= S) continue;
      float* row = out + ((long long)b * S + key) * kstride + (long long)hk * D;
#pragma unroll
      for (int m = 0; m < C::kSlabs; ++m)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int d = 64 * m + 16 * warp + lane / 4 + 8 * hh;
          if (d < D) row[d] = acc[m][4 * c + 2 * hh + e] * mult;  // not the padded columns
        }
    }
}

template <int DP, int kD>
int launch_dkv_sm90_tf32_wide(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, void* dk, void* dv, int B,
                              int S, int H, int Hkv, int D, float scale, int causal,
                              cudaStream_t stream) {
  using C = DkvTf32WideCfg<DP>;
  CUtensorMap tq, tk, tv, tdo;
  int err = make_bshd_map<float>(&tq, q, B, S, H, D, C::kBQ);
  if (err == 0) err = make_bshd_map<float>(&tdo, dout, B, S, H, D, C::kBQ);
  if (err == 0) err = make_bshd_map<float>(&tk, k, B, S, Hkv, D, C::kBKV);
  if (err == 0) err = make_bshd_map<float>(&tv, v, B, S, Hkv, D, C::kBKV);
  if (err != 0) return err;
  const dim3 grid((S + C::kBKV - 1) / C::kBKV, Hkv, B);
  return launch_n(flash_dkv_sm90_tf32_wide_kernel<DP, kD>, grid, C::kThreads, C::kBytes, stream,
                  tq, tk, tv, tdo, (const float*)lse, (const float*)delta, (float*)dk,
                  (float*)dv, S, H, Hkv, D, scale, scale * kLog2e, causal);
}

template <int DP, int kD, typename T, int kDoTerms>
int launch_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, const void* dout_amax, void* dk, void* dv,
                    int B, int S, int H, int Hkv, int D, float scale, int causal,
                    cudaStream_t stream) {
  using L = DkvCfg<DP, T, kDoTerms>;
  using TDo = std::conditional_t<kDoTerms == 2, float, T>;
  CUtensorMap tq, tk, tv, tdo;
  int err = make_bshd_map<T>(&tq, q, B, S, H, D, L::kBQ);
  if (err == 0) err = make_bshd_map<TDo>(&tdo, dout, B, S, H, D, L::kBQ);
  if (err == 0) err = make_bshd_map<T>(&tk, k, B, S, Hkv, D, L::kBKV);
  if (err == 0) err = make_bshd_map<T>(&tv, v, B, S, Hkv, D, L::kBKV);
  if (err != 0) return err;
  const dim3 grid((S + L::kBKV - 1) / L::kBKV, Hkv, B);
  return launch_n(flash_dkv_sm90_kernel<DP, kD, T, kDoTerms>, grid, L::kThreads, L::kBytes,
                  stream, tq, tk, tv, tdo, (const float*)lse, (const float*)delta,
                  (const float*)dout_amax, (T*)dk, (T*)dv, S, H, Hkv, D, scale, scale * kLog2e,
                  causal);
}

// dO in q's dtype at D 32, 64, 96 and 128 (and bf16 or fp16 at 192, 256,
// 384 and 512, the wide kernel): D fixed at compile time; every other case
// at its padded width with D at run time. D above 128 takes bf16 or fp16 q
// in the wide kernel (with dO in q's dtype or fp32; above 256 in q's dtype
// only) and fp32 q in the 3xTF32 wide one.
template <typename T, int kDoTerms>
int launch_dkv_sm90_d(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* amax, void* dk, void* dv,
                      int B, int S, int H, int Hkv, int D, float scale, int causal,
                      cudaStream_t st) {
  using sm90::padded_width;
  constexpr bool kTwoByte = !std::is_same<T, float>::value;  // bf16 or fp16
  if constexpr (kDoTerms == 1) {
    switch (D) {
      case 32:
        return launch_dkv_sm90<padded_width<T>(32), 32, T, 1>(
            q, k, v, dout, lse, delta, amax, dk, dv, B, S, H, Hkv, D, scale, causal, st);
      case 64:
        return launch_dkv_sm90<64, 64, T, 1>(q, k, v, dout, lse, delta, amax, dk, dv, B, S, H,
                                             Hkv, D, scale, causal, st);
      case 96:
        return launch_dkv_sm90<padded_width<T>(96), 96, T, 1>(
            q, k, v, dout, lse, delta, amax, dk, dv, B, S, H, Hkv, D, scale, causal, st);
      case 128:
        return launch_dkv_sm90<128, 128, T, 1>(q, k, v, dout, lse, delta, amax, dk, dv, B, S, H,
                                               Hkv, D, scale, causal, st);
    }
    if constexpr (kTwoByte) {
      if (D == 512)
        return launch_dkv_sm90_wide<512, 512, T, 1>(q, k, v, dout, lse, delta, amax, dk, dv, B,
                                                    S, H, Hkv, D, scale, causal, st);
      if (D == 384)
        return launch_dkv_sm90_wide<384, 384, T, 1>(q, k, v, dout, lse, delta, amax, dk, dv, B,
                                                    S, H, Hkv, D, scale, causal, st);
      if (D > 384)
        return launch_dkv_sm90_wide<512, 0, T, 1>(q, k, v, dout, lse, delta, amax, dk, dv, B, S,
                                                  H, Hkv, D, scale, causal, st);
      if (D > 256)
        return launch_dkv_sm90_wide<384, 0, T, 1>(q, k, v, dout, lse, delta, amax, dk, dv, B, S,
                                                  H, Hkv, D, scale, causal, st);
      if (D == 192)
        return launch_dkv_sm90_wide<192, 192, T, 1>(q, k, v, dout, lse, delta, amax, dk, dv, B,
                                                    S, H, Hkv, D, scale, causal, st);
      if (D == 256)
        return launch_dkv_sm90_wide<256, 256, T, 1>(q, k, v, dout, lse, delta, amax, dk, dv, B,
                                                    S, H, Hkv, D, scale, causal, st);
    }
  }
  if (D > 256) return (int)cudaErrorInvalidValue;
  if constexpr (kTwoByte) {
    if (D > 192)
      return launch_dkv_sm90_wide<256, 0, T, kDoTerms>(q, k, v, dout, lse, delta, amax, dk, dv,
                                                       B, S, H, Hkv, D, scale, causal, st);
    if (D > 128)
      return launch_dkv_sm90_wide<192, 0, T, kDoTerms>(q, k, v, dout, lse, delta, amax, dk, dv,
                                                       B, S, H, Hkv, D, scale, causal, st);
    return D <= 64 ? launch_dkv_sm90<64, 0, T, kDoTerms>(q, k, v, dout, lse, delta, amax, dk, dv,
                                                         B, S, H, Hkv, D, scale, causal, st)
                   : launch_dkv_sm90<128, 0, T, kDoTerms>(q, k, v, dout, lse, delta, amax, dk,
                                                          dv, B, S, H, Hkv, D, scale, causal, st);
  } else {
    if (D == 192)
      return launch_dkv_sm90_tf32_wide<192, 192>(q, k, v, dout, lse, delta, dk, dv, B, S, H, Hkv,
                                                 D, scale, causal, st);
    if (D == 256)
      return launch_dkv_sm90_tf32_wide<256, 256>(q, k, v, dout, lse, delta, dk, dv, B, S, H, Hkv,
                                                 D, scale, causal, st);
    if (D > 192)
      return launch_dkv_sm90_tf32_wide<256, 0>(q, k, v, dout, lse, delta, dk, dv, B, S, H, Hkv,
                                               D, scale, causal, st);
    if (D > 128)
      return launch_dkv_sm90_tf32_wide<192, 0>(q, k, v, dout, lse, delta, dk, dv, B, S, H, Hkv,
                                               D, scale, causal, st);
    switch (padded_width<float>(D)) {
      case 32:
        return launch_dkv_sm90<32, 0, float, 1>(q, k, v, dout, lse, delta, amax, dk, dv, B, S, H,
                                                Hkv, D, scale, causal, st);
      case 64:
        return launch_dkv_sm90<64, 0, float, 1>(q, k, v, dout, lse, delta, amax, dk, dv, B, S, H,
                                                Hkv, D, scale, causal, st);
      case 96:
        return launch_dkv_sm90<96, 0, float, 1>(q, k, v, dout, lse, delta, amax, dk, dv, B, S, H,
                                                Hkv, D, scale, causal, st);
      case 128:
        return launch_dkv_sm90<128, 0, float, 1>(q, k, v, dout, lse, delta, amax, dk, dv, B, S,
                                                 H, Hkv, D, scale, causal, st);
    }
    return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace hvt

// Returns 0 or the CUDA error of the launch. The port's head_dims (in steps
// of 8) and dtypes: q, k, v and dO fp32 (dtype and dout_dtype 0), dk, dv
// fp32, D 8..256; q, k, v bf16 (dtype 1) or fp16 (2) with dO in q's dtype
// (D 8..512) or fp32 (0; D 8..256), dk, dv in q's dtype. dk, dv are [B, S, H_kv, D]. dout_amax: a device
// fp32 scalar, dO's largest magnitude, which fp16 q needs (sm90.cuh,
// dout_scale) and the others do not read. The signature is hvt_flash_dkv's
// with dout_amax after delta.
extern "C" int hvt_flash_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, const void* dout_amax,
                                  void* dk, void* dv, int B, int S, int H, int Hkv, int D,
                                  float scale, int causal, int dtype, int dout_dtype,
                                  void* stream) {
  using namespace hvt;
  if (!valid_shape(B, S, H, Hkv, D, sm90_max_d(dtype, dout_dtype)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const void* amax = dout_amax;
  if (dtype == kBF16 && dout_dtype == kBF16)
    return launch_dkv_sm90_d<__nv_bfloat16, 1>(q, k, v, dout, lse, delta, amax, dk, dv, B, S, H,
                                               Hkv, D, scale, causal, st);
  if (dtype == kBF16 && dout_dtype == kF32)
    return launch_dkv_sm90_d<__nv_bfloat16, 2>(q, k, v, dout, lse, delta, amax, dk, dv, B, S, H,
                                               Hkv, D, scale, causal, st);
  if (dtype == kF16 && amax == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == kF16 && dout_dtype == kF16)
    return launch_dkv_sm90_d<__half, 1>(q, k, v, dout, lse, delta, amax, dk, dv, B, S, H, Hkv, D,
                                        scale, causal, st);
  if (dtype == kF16 && dout_dtype == kF32)
    return launch_dkv_sm90_d<__half, 2>(q, k, v, dout, lse, delta, amax, dk, dv, B, S, H, Hkv, D,
                                        scale, causal, st);
  if (dtype == kF32 && dout_dtype == kF32)
    return launch_dkv_sm90_d<float, 1>(q, k, v, dout, lse, delta, amax, dk, dv, B, S, H, Hkv, D,
                                       scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
