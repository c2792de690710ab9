// flash_dq_sm90.cu: the query gradient of attention on Hopper's tensor cores
// (wgmma, TMA, mbarriers; sm_90a only).
//
// Replaces horovod_tpu/ops/flash_attention.py:_dq_kernel (pl.pallas_call in
// _flash_bwd) for bf16 q/k/v/dO with head_dim 64 or 128; flash_dq.cu stays
// the route for fp32 and other head dims. Same function:
//   p = exp(scale q k^T - lse) with the causal fill, keys past S weigh 0,
//   dp = dO v^T, ds = p (dp - delta), dq = sum over keys of ds k * scale,
// with delta = rowsum(dO o) - dlse passed in precomputed.
//
// Numerics differ from _dq_kernel in one place. It takes ds k on fp32 ds
// (:189-192); on the tensor cores ds is rounded to bf16 first, as in
// FlashAttention-2/3. dO v^T is unchanged: products of bf16 values are exact
// in fp32. The plain version with round_operands=True (ops/_kernels.py)
// rounds at the same point.
//
// Design. The TPU kernel carries dq in VMEM scratch across the grid's
// sequential last axis. Here one block of 256 threads owns a 128-row query
// tile of one (b, h): two warpgroups of 64 rows each, with Q and dO resident
// in shared memory and dq in fp32 registers for the whole K/V loop. Thread 0
// issues every TMA load: Q and dO once, then 64-key K/V tiles through a ring
// of kStages stages behind "full" (TMA bytes) and "empty" (256 consumers)
// mbarriers. Each thread keeps lse * log2(e) and delta of its two rows in
// registers. Per K/V tile, each warpgroup runs
//   S  = Q K^T      wgmma m64n64k16, Q and K K-major from shared memory;
//   dP = dO V^T     the same with dO and V, in the same commit group;
//   P  = exp2(S scale log2(e) - lse log2(e)),  dS = P (dP - delta)
//                   on the accumulator fragments;
//   dQ += dS K      wgmma m64nDk16, dS as bf16 register A operand (the
//                   accumulator fragment is the A fragment), K MN-major.
// Only tiles that meet the ragged end or the causal diagonal pay for masks.
// Causal tiles wholly above the block's diagonal are never loaded, and a
// warpgroup skips the products of tiles wholly above its own. GQA reads K/V
// head h / (H / H_kv) through the tensor map's coordinates; TMA zero-fills
// rows past S, and rows past S are not written.
//
// Why a kernel of its own. dq could instead be summed inside flash_dkv_sm90,
// which has dS^T in registers, with fp32 atomics (or cp.reduce.async.bulk)
// into a scratch buffer and a conversion pass after it. This kernel
// recomputes Q K^T and dO V^T instead, and in exchange needs no atomics (dq
// is the same bits from run to run), no scratch and no second pass. If it
// stalls well above its bound, that fused design is the next lever
// (ROADMAP).
//
// Occupancy. A thread holds 32 + 32 + D / 2 fp32 accumulators. At D 64 the
// kernel is held to 128 registers, so two blocks (66 KB of shared memory
// each) share an SM and one block's exp2 runs under the other's products;
// at D 128 one block per SM. On the card, 128-key tiles (one block per SM)
// and a third stage were both slower than this layout (PERF.md).
//
// Bound. At the main path's shape (B 8, H 12, S 1024, D 64, bf16, causal)
// the work is 19.3 GFLOP of bf16 products and 63.7 MB: 20 us of tensor-core
// time, 19 us of HBM time.
#include "flash_attention.cuh"
#include "sm90.cuh"

namespace hvt {
namespace {

constexpr int kBM = 128;  // query rows per block (two warpgroups of 64)
constexpr int kBN = 64;   // keys per K/V tile
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct DqSmem {
  static constexpr int kQ = kBM * D * 2;   // bytes of the Q (or dO) tile
  static constexpr int kKV = kBN * D * 2;  // bytes of one K (or V) tile
  static constexpr int kBarriers = (1 + 2 * kStages) * 8;
  static constexpr int kBytes = 2 * kQ + 2 * kStages * kKV + kBarriers + sm90::kAtomBytes;
};

template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
    flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int S, int H, int Hkv, float scale,
                         float scale_log2, int causal) {
  using namespace sm90;
  using L = DqSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1k(smem_raw);
  uint8_t* q_s = smem;
  uint8_t* do_s = smem + L::kQ;
  uint8_t* kv_s = smem + 2 * L::kQ;  // stage s: K at kv_s + 2 s kKV, V right after it
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
  const int wg_row0 = q0 + 64 * wg;  // this warpgroup's first row
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
    tma_load_rows<D>(dst, &tk, &full[s], kBN, j * kBN, hk, b);
    tma_load_rows<D>(dst + L::kKV, &tv, &full[s], kBN, j * kBN, hk, b);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * L::kQ);
    tma_load_rows<D>(q_s, &tq, bar_q, kBM, q0, h, b);
    tma_load_rows<D>(do_s, &tdo, bar_q, kBM, q0, h, b);
    for (int j = 0; j < kStages && j < n_kt; ++j) load_kv(j, j);
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

  const int row_lo = wg_row0 + 16 * warp + lane / 4;  // rows row_lo and row_lo + 8
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    const long long off = ((long long)b * H + h) * S + row;
    lse2[r] = row < S ? lse[off] * kLog2e : 0.f;
    dlt[r] = row < S ? delta[off] : 0.f;
  }
  const uint32_t q_addr = smem_u32(q_s), do_addr = smem_u32(do_s), kv_addr = smem_u32(kv_s);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar_q, 0);
  int j = 0;
  for (; j < n_mine; ++j) {
    const int s = j % kStages, k0 = j * kBN;
    const uint32_t k_addr = kv_addr + 2 * s * L::kKV, v_addr = k_addr + L::kKV;
    mbar_wait(&full[s], (j / kStages) & 1);

    float sc[kBN / 2], dp[kBN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0>(sc, desc_kmajor(q_addr, kBM, 64 * wg, kk), desc_kmajor(k_addr, kBN, 0, kk),
                  kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0>(dp, desc_kmajor(do_addr, kBM, 64 * wg, kk), desc_kmajor(v_addr, kBN, 0, kk),
                  kk > 0);
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
      dp[i] = p * (dp[i] - dlt[r]);  // dS
    }

    // all of dS packed before the fence: a register written between the
    // fence and its product makes ptxas serialise the products (C7520)
    uint32_t a[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) a_fragment(a[kk], dp, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_rs<1>(acc, a[kk], desc_mnmajor(k_addr, kBN, kk), 1);
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
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* drow = dq + ((long long)b * S + row) * qstride + (long long)h * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int i = 4 * c + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(drow + 8 * c + 2 * (lane % 4)) =
          __floats2bfloat162_rn(acc[i] * scale, acc[i + 1] * scale);
    }
  }
}

template <int D>
int launch_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int B, int S, int H, int Hkv,
                   float scale, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = make_bshd_map(&tq, q, B, S, H, D, kBM);
  if (err == 0) err = make_bshd_map(&tdo, dout, B, S, H, D, kBM);
  if (err == 0) err = make_bshd_map(&tk, k, B, S, Hkv, D, kBN);
  if (err == 0) err = make_bshd_map(&tv, v, B, S, Hkv, D, kBN);
  if (err != 0) return err;
  const dim3 grid((S + kBM - 1) / kBM, H, B);
  return launch(flash_dq_sm90_kernel<D>, grid, DqSmem<D>::kBytes, stream, tq, tk, tv, tdo,
                (const float*)lse, (const float*)delta, (__nv_bfloat16*)dq, S, H, Hkv, scale,
                scale * kLog2e, causal);
}

}  // namespace
}  // namespace hvt

// Returns 0 or the CUDA error of the launch. q, k, v, dO bf16 (dtype and
// dout_dtype 1) with D 64 or 128; dq [B, S, H, D] bf16. The signature is
// hvt_flash_dq's.
extern "C" int hvt_flash_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, int B, int S,
                                 int H, int Hkv, int D, float scale, int causal, int dtype,
                                 int dout_dtype, void* stream) {
  using namespace hvt;
  if (!valid_shape(B, S, H, Hkv, D) || dtype != kBF16 || dout_dtype != kBF16 ||
      (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return D == 64 ? launch_dq_sm90<64>(q, k, v, dout, lse, delta, dq, B, S, H, Hkv, scale, causal,
                                      st)
                 : launch_dq_sm90<128>(q, k, v, dout, lse, delta, dq, B, S, H, Hkv, scale,
                                       causal, st);
}
