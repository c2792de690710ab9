// flash_fwd_sm90.cu: attention forward with its log-sum-exp on Hopper's
// tensor cores (wgmma, TMA, mbarriers; sm_90a only).
//
// Replaces horovod_tpu/ops/flash_attention.py:_fwd_kernel (launched by
// _flash_fwd_impl through pl.pallas_call) for bf16 q/k/v with head_dim 64 or
// 128; flash_fwd.cu stays the route for fp32 and other head dims. Same
// arithmetic: scores scale * q k^T summed in fp32 (bf16 products are exact in
// fp32), causal fill -1e30 where k_pos > q_pos, keys past S weigh 0, an online
// softmax with a running max m and sum l, p rounded to bf16 before p v (where
// _fwd_kernel rounds it, :127-129), o = acc / max(l, 1e-30), lse = m + log l.
//
// Design. One block of 256 threads owns a 128-row query tile of one (b, h):
// two warpgroups of 64 rows each. Thread 0 issues every TMA load: Q once, then
// 128-key K/V tiles through a ring of kStages shared-memory stages, each
// behind a "full" mbarrier (TMA bytes arrive) and an "empty" one (all 256
// threads are done reading), so the next tile streams in while this one is
// multiplied. Per K/V tile, each warpgroup
//   S = Q K^T     wgmma m64n128k16, Q and K K-major from shared memory;
//   softmax       in registers on the accumulator fragment: a row lives on
//                 the 4 lanes of a quad, reduced with two shuffles; exp2 with
//                 scale * log2(e) folded into the scores;
//   O += P V      wgmma m64nDk16 with P as bf16 register A operand (the
//                 accumulator fragment is the A fragment) and V MN-major.
// Only tiles that meet the ragged end or the causal diagonal pay for masks;
// tiles wholly above the diagonal are never loaded. GQA reads K/V head
// h / (H / H_kv) through the tensor map's coordinates; TMA zero-fills rows
// past S, and rows past S are not written.
//
// Occupancy. At D 64 the kernel is held to 128 registers a thread, so two
// blocks share an SM and one block's softmax runs under the other's
// products; on the card that beat one block per SM with more registers. At
// D 128 the accumulators need about 200 registers: one block per SM.
//
// Bound. At the main path's shape (B 8, H 12, S 1024, D 64, bf16, causal) the
// work is 12.9 GFLOP of bf16 products and 50.7 MB: 13 us of tensor-core time,
// 15 us of HBM time. What this version still leaves on the table: no
// producer warp or register reallocation (setmaxnreg), and no overlap of a
// tile's softmax with the next tile's QK^T inside a warpgroup; both are
// queued in ROADMAP.
#include "flash_attention.cuh"
#include "sm90.cuh"

namespace hvt {
namespace {

constexpr int kBM = 128;  // query rows per block (two warpgroups of 64)
constexpr int kBN = 128;  // keys per K/V tile
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct FwdSmem {
  static constexpr int kTile = kBN * D * 2;  // bytes of one 128-row bf16 tile
  static constexpr int kBarriers = (1 + 2 * kStages) * 8;
  static constexpr int kBytes = (1 + 2 * kStages) * kTile + kBarriers + sm90::kAtomBytes;
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int D, typename TO>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, TO* __restrict__ o,
                          float* __restrict__ lse, int S, int H, int Hkv, float scale_log2,
                          int causal) {
  using namespace sm90;
  constexpr int kTile = FwdSmem<D>::kTile;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1k(smem_raw);
  uint8_t* q_s = smem;
  uint8_t* kv_s = smem + kTile;  // stage s: K at kv_s + 2 s kTile, V right after it
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + (1 + 2 * kStages) * kTile);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + kStages;

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows start first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);
  const int q0 = qt * kBM;
  int n_kt = (S + kBN - 1) / kBN;
  if (causal) n_kt = min(n_kt, (q0 + kBM - 1) / kBN + 1);
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;

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
    uint8_t* dst = kv_s + 2 * s * kTile;
    mbar_expect_tx(&full[s], 2 * kTile);
    tma_load_rows<D>(dst, &tk, &full[s], kBN, j * kBN, hk, b);
    tma_load_rows<D>(dst + kTile, &tv, &full[s], kBN, j * kBN, hk, b);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, kTile);
    tma_load_rows<D>(q_s, &tq, bar_q, kBM, q0, h, b);
    for (int j = 0; j < kStages && j < n_kt; ++j) load_kv(j, j);
  }

  const uint32_t q_addr = smem_u32(q_s), kv_addr = smem_u32(kv_s);
  const int row_lo = q0 + 64 * wg + 16 * warp + lane / 4;  // rows row_lo and row_lo + 8
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // per thread: partial l

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_kt; ++j) {
    const int s = j % kStages;
    const uint32_t k_addr = kv_addr + 2 * s * kTile, v_addr = k_addr + kTile;
    mbar_wait(&full[s], (j / kStages) & 1);

    float sc[kBN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0>(sc, desc_kmajor(q_addr, kBM, 64 * wg, kk), desc_kmajor(k_addr, kBN, 0, kk),
                  kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    const int k0 = j * kBN;
    const bool edge = k0 + kBN > S || (causal && k0 + kBN - 1 > q0 + 64 * wg);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      float x = sc[i] * scale_log2;
      if (edge) {
        const int col = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        const int row = row_lo + 8 * ((i / 2) % 2);
        if (col >= S) x = -INFINITY;  // no such key: weight exactly 0
        else if (causal && col > row) x = kMasked;
      }
      sc[i] = x;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);  // 0 on the first tile (m = -inf; key 0 is visible)
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const float p = exp2f(sc[i] - m[(i / 2) % 2]);
      l[(i / 2) % 2] += p;
      sc[i] = p;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i / 2) % 2];

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      uint32_t a[4];
      a_fragment(a, sc, kk);
      wgmma_rs<1>(acc, a, desc_mnmajor(v_addr, kBN, kk), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);

    mbar_arrive(&empty[s]);
    if (tid == 0 && j + kStages < n_kt) {
      mbar_wait(&empty[s], (j / kStages) & 1);  // both warpgroups are done with stage s
      load_kv(j + kStages, s);
    }
  }

  const long long qstride = (long long)H * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row_lo + 8 * r;
    if (row >= S) continue;
    const float li = fmaxf(l[r], 1e-30f);
    TO* orow = o + ((long long)b * S + row) * qstride + (long long)h * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      store2(orow + 8 * c + 2 * (lane % 4), acc[4 * c + 2 * r] / li, acc[4 * c + 2 * r + 1] / li);
    if (lane % 4 == 0) lse[((long long)b * H + h) * S + row] = m[r] * kLn2 + logf(li);
  }
}

template <int D, typename TO>
int launch_fwd_sm90(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                    int S, int H, int Hkv, float scale, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_bshd_map(&tq, q, B, S, H, D, kBM);
  if (err == 0) err = make_bshd_map(&tk, k, B, S, Hkv, D, kBN);
  if (err == 0) err = make_bshd_map(&tv, v, B, S, Hkv, D, kBN);
  if (err != 0) return err;
  const dim3 grid((S + kBM - 1) / kBM, H, B);
  return launch(flash_fwd_sm90_kernel<D, TO>, grid, FwdSmem<D>::kBytes, stream, tq, tk, tv,
                (TO*)o, (float*)lse, S, H, Hkv, scale * kLog2e, causal);
}

template <typename TO>
int launch_fwd_sm90_d(int D, const void* q, const void* k, const void* v, void* o, void* lse,
                      int B, int S, int H, int Hkv, float scale, int causal, cudaStream_t st) {
  return D == 64 ? launch_fwd_sm90<64, TO>(q, k, v, o, lse, B, S, H, Hkv, scale, causal, st)
                 : launch_fwd_sm90<128, TO>(q, k, v, o, lse, B, S, H, Hkv, scale, causal, st);
}

// One warpgroup checks the wgmma building blocks on a single 64 x 64 x 64
// product: c1 = a b^T (both operands K-major from shared memory), then
// c2 = bf16(c1) b (c1's fragment as the register A operand, b MN-major).
__global__ void __launch_bounds__(128, 1)
    wgmma_probe_kernel(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tb, float* c1, float* c2) {
  using namespace sm90;
  constexpr int kTile = 64 * 64 * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1k(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 2 * kTile);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 2 * kTile);
    tma_load_rows<64>(smem, &ta, bar, 64, 0, 0, 0);
    tma_load_rows<64>(smem + kTile, &tb, bar, 64, 0, 0, 0);
  }
  mbar_wait(bar, 0);
  const uint32_t a_addr = smem_u32(smem), b_addr = a_addr + kTile;
  float d[32], e[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<0>(d, desc_kmajor(a_addr, 64, 0, kk), desc_kmajor(b_addr, 64, 0, kk), kk > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a_fragment(a, d, kk);
    wgmma_rs<1>(e, a, desc_mnmajor(b_addr, 64, kk), kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(e);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
    c1[row * 64 + col] = d[i];
    c2[row * 64 + col] = e[i];
  }
}

}  // namespace
}  // namespace hvt

// Returns 0 or the CUDA error of the launch. q, k, v bf16 (dtype 1) with
// D 64 or 128; out_dtype: the dtype of o, bf16 (1) or fp32 (0).
extern "C" int hvt_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int B, int S, int H, int Hkv, int D, float scale,
                                  int causal, int dtype, int out_dtype, void* stream) {
  using namespace hvt;
  if (!valid_shape(B, S, H, Hkv, D) || dtype != kBF16 || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (out_dtype == kBF16)
    return launch_fwd_sm90_d<__nv_bfloat16>(D, q, k, v, o, lse, B, S, H, Hkv, scale, causal, st);
  if (out_dtype == kF32)
    return launch_fwd_sm90_d<float>(D, q, k, v, o, lse, B, S, H, Hkv, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

// a, b: bf16 [64, 64] row-major; c1, c2: fp32 [64, 64] (see wgmma_probe_kernel).
extern "C" int hvt_wgmma_probe(const void* a, const void* b, void* c1, void* c2, void* stream) {
  using namespace hvt;
  CUtensorMap ta, tb;
  int err = make_bshd_map(&ta, a, 1, 64, 1, 64, 64);
  if (err == 0) err = make_bshd_map(&tb, b, 1, 64, 1, 64, 64);
  if (err != 0) return err;
  wgmma_probe_kernel<<<1, 128, 2 * 64 * 64 * 2 + 8 + sm90::kAtomBytes, (cudaStream_t)stream>>>(
      ta, tb, (float*)c1, (float*)c2);
  return (int)cudaGetLastError();
}
