// flash_dkv_sm90.cu: the key and value gradients of attention on Hopper's
// tensor cores (wgmma, TMA, mbarriers; sm_90a only).
//
// Replaces horovod_tpu/ops/flash_attention.py:_dkv_kernel (pl.pallas_call in
// _flash_bwd) for bf16 q/k/v/dO with head_dim 64 or 128; flash_dkv.cu stays
// the route for fp32 and other head dims. For each key tile:
//   p = exp(scale q k^T - lse) with the causal fill, dv += p^T dO,
//   dp = dO v^T, ds = p (dp - delta), dk += ds^T q * scale,
// with query tiles before the first one that can see the key tile skipped
// (the TPU kernel's `start`).
//
// Numerics differ from _dkv_kernel in one place. It takes p^T dO and ds^T q
// on fp32 operands (:244-253); on the tensor cores p and ds are rounded to
// bf16 first, as in FlashAttention-2/3. Everything else matches: the scores,
// p and ds are fp32, every product sums in fp32. The plain version with
// round_operands=True (ops/_kernels.py) rounds at the same two points.
//
// Design. One block of 256 threads owns a 128-key tile of one (b, h_kv): two
// warpgroups of 64 keys each, with K and V resident in shared memory. Thread 0
// issues every TMA load: K and V once, then 64-row Q/dO tiles of each query
// head of the group through a ring of kStages stages behind "full" and
// "empty" mbarriers. Each warpgroup computes the transposed products, so that
// every intermediate stays in registers:
//   S^T  = K Q^T     wgmma m64n64k16, K and Q K-major from shared memory;
//   dP^T = V dO^T    the same with V and dO;
//   P^T  = exp2(S^T scale log2(e) - lse log2(e)),  dS^T = P^T (dP^T - delta)
//                    on the accumulator fragments;
//   dV  += P^T dO    wgmma m64nDk16, P^T as bf16 register A operand, dO MN-major;
//   dK  += dS^T Q    the same with dS^T and Q.
// dK and dV stay in fp32 registers across the whole loop, so the GQA group
// sum happens in the kernel and each is written once, in bf16. lse and delta
// of a query tile come with plain loads into the warpgroup's shared memory:
// their rows of S floats need not meet TMA's 16-byte stride rule.
//
// Bound. At the main path's shape (B 8, H 12, S 1024, D 64, bf16, causal)
// the work is 25.8 GFLOP of bf16 products and 76.3 MB: 26 us of tensor-core
// time, 23 us of HBM time.
#include "flash_attention.cuh"
#include "sm90.cuh"

namespace hvt {
namespace {

constexpr int kBKV = 128;  // keys per block (two warpgroups of 64)
constexpr int kBQ = 64;    // query rows per streamed tile
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct DkvSmem {
  static constexpr int kKV = kBKV * D * 2;  // bytes of the K (or V) tile
  static constexpr int kQ = kBQ * D * 2;    // bytes of one Q (or dO) tile
  static constexpr int kVec = 2 * 2 * kBQ * 4;  // per warpgroup: lse, delta of kBQ rows
  static constexpr int kBarriers = (1 + 2 * kStages) * 8;
  static constexpr int kBytes = 2 * kKV + 2 * kStages * kQ + kVec + kBarriers + sm90::kAtomBytes;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S,
                          int H, int Hkv, float scale, float scale_log2, int causal) {
  using namespace sm90;
  using L = DkvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1k(smem_raw);
  uint8_t* k_s = smem;
  uint8_t* v_s = smem + L::kKV;
  uint8_t* qdo_s = smem + 2 * L::kKV;  // stage s: Q at qdo_s + 2 s kQ, dO right after it
  float* vec = reinterpret_cast<float*>(qdo_s + 2 * kStages * L::kQ);
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
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();

  auto load_q = [&](int t, int s) {
    const int h = hk * group + t / per_head, q0 = (qt_start + t % per_head) * kBQ;
    uint8_t* dst = qdo_s + 2 * s * L::kQ;
    mbar_expect_tx(&full[s], 2 * L::kQ);
    tma_load_rows<D>(dst, &tq, &full[s], kBQ, q0, h, b);
    tma_load_rows<D>(dst + L::kQ, &tdo, &full[s], kBQ, q0, h, b);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * L::kKV);
    tma_load_rows<D>(k_s, &tk, bar_kv, kBKV, k0, hk, b);
    tma_load_rows<D>(v_s, &tv, bar_kv, kBKV, k0, hk, b);
    for (int t = 0; t < kStages && t < n_iter; ++t) load_q(t, t);
  }

  const uint32_t k_addr = smem_u32(k_s), v_addr = smem_u32(v_s), qdo_addr = smem_u32(qdo_s);
  const int key_lo = k0 + 64 * wg + 16 * warp + lane / 4;  // keys key_lo and key_lo + 8
  float* lse_s = vec + wg * 2 * kBQ;                         // this warpgroup's lse * log2(e)
  float* delta_s = lse_s + kBQ;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int t = 0; t < n_iter; ++t) {
    const int s = t % kStages;
    const int h = hk * group + t / per_head, q0 = (qt_start + t % per_head) * kBQ;
    const uint32_t q_addr = qdo_addr + 2 * s * L::kQ, do_addr = q_addr + L::kQ;

    warpgroup_sync(wg);  // the previous tile's readers of lse_s, delta_s are done
    {
      const int r = tid % kBQ, qp = q0 + r;
      const long long off = ((long long)b * H + h) * S + qp;
      if (tid % 128 < kBQ)
        lse_s[r] = qp < S ? lse[off] * kLog2e : 0.f;
      else
        delta_s[r] = qp < S ? delta[off] : 0.f;
    }
    warpgroup_sync(wg);
    mbar_wait(&full[s], (t / kStages) & 1);

    float sc[kBQ / 2], dp[kBQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0>(sc, desc_kmajor(k_addr, kBKV, 64 * wg, kk), desc_kmajor(q_addr, kBQ, 0, kk),
                  kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0>(dp, desc_kmajor(v_addr, kBKV, 64 * wg, kk), desc_kmajor(do_addr, kBQ, 0, kk),
                  kk > 0);
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
      sc[i] = p;                           // P^T
      dp[i] = p * (dp[i] - delta_s[c]);    // dS^T
    }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      uint32_t a[4];
      a_fragment(a, sc, kk);
      wgmma_rs<1>(dv_acc, a, desc_mnmajor(do_addr, kBQ, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      uint32_t a[4];
      a_fragment(a, dp, kk);
      wgmma_rs<1>(dk_acc, a, desc_mnmajor(q_addr, kBQ, kk), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);

    mbar_arrive(&empty[s]);
    if (tid == 0 && t + kStages < n_iter) {
      mbar_wait(&empty[s], (t / kStages) & 1);  // both warpgroups are done with stage s
      load_q(t + kStages, s);
    }
  }

  const long long kstride = (long long)Hkv * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_lo + 8 * r;
    if (key >= S) continue;
    const long long off = ((long long)b * S + key) * kstride + (long long)hk * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = 8 * c + 2 * (lane % 4), i = 4 * c + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(dk + off + col) =
          __floats2bfloat162_rn(dk_acc[i] * scale, dk_acc[i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + col) =
          __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

template <int D>
int launch_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, int B, int S, int H,
                    int Hkv, float scale, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = make_bshd_map(&tq, q, B, S, H, D, kBQ);
  if (err == 0) err = make_bshd_map(&tdo, dout, B, S, H, D, kBQ);
  if (err == 0) err = make_bshd_map(&tk, k, B, S, Hkv, D, kBKV);
  if (err == 0) err = make_bshd_map(&tv, v, B, S, Hkv, D, kBKV);
  if (err != 0) return err;
  const dim3 grid((S + kBKV - 1) / kBKV, Hkv, B);
  return launch(flash_dkv_sm90_kernel<D>, grid, DkvSmem<D>::kBytes, stream, tq, tk, tv, tdo,
                (const float*)lse, (const float*)delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
                S, H, Hkv, scale, scale * kLog2e, causal);
}

}  // namespace
}  // namespace hvt

// Returns 0 or the CUDA error of the launch. q, k, v, dO bf16 (dtype and
// dout_dtype 1) with D 64 or 128; dk, dv [B, S, H_kv, D] bf16.
extern "C" int hvt_flash_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv, int B,
                                  int S, int H, int Hkv, int D, float scale, int causal,
                                  int dtype, int dout_dtype, void* stream) {
  using namespace hvt;
  if (!valid_shape(B, S, H, Hkv, D) || dtype != kBF16 || dout_dtype != kBF16 ||
      (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return D == 64 ? launch_dkv_sm90<64>(q, k, v, dout, lse, delta, dk, dv, B, S, H, Hkv, scale,
                                       causal, st)
                 : launch_dkv_sm90<128>(q, k, v, dout, lse, delta, dk, dv, B, S, H, Hkv, scale,
                                        causal, st);
}
