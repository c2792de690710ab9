// flash_fwd_sm90.cu: attention forward with its log-sum-exp on Hopper's
// tensor cores (wgmma, TMA, mbarriers; sm_90a only).
//
// Replaces horovod_tpu/ops/flash_attention.py:_fwd_kernel (launched by
// _flash_fwd_impl through pl.pallas_call) for q/k/v in bf16, fp16 or fp32
// with any head_dim the port takes (in steps of 8: bf16 or fp16 q at
// 8..512 with an o in q's dtype, at 8..256 with an fp32 o, fp32 q with an
// fp32 o at 8..256; the wrappers pad other head_dims with zero columns);
// flash_fwd.cu stays
// built and checked as the SIMT design, on no route. Same arithmetic:
// scores scale * q k^T summed in fp32, causal fill
// -1e30 where k_pos > q_pos, keys past S weigh 0, an online softmax with a
// running max m and sum l, p rounded to v's dtype before p v (where
// _fwd_kernel rounds it, :127-129), o = acc / max(l, 1e-30), lse = m + log l.
// bf16 and fp16 products are exact in fp32; fp32 products run as 3xTF32
// (sm90.cuh), within about 2^-21 of fp32 products. fp16 q runs the bf16
// design below as it stands, with .f16 wgmma operands and p rounded to fp16
// (a p below 2^-24 flushes to 0, where bf16 keeps it: the Pallas kernel's
// rounding of p to fp16 does the same).
//
// Head dims. A kernel is instantiated per padded width DP, the head_dim
// rounded up to whole 128-byte panels (64, 128, 192, 256, 384 or 512 in
// bf16 and fp16; 32, 64, 96 or 128 in fp32, and 192 or 256 above 128): TMA
// zero-fills the columns past D, which add nothing
// to any product, and only D columns are written. The instances at D 32,
// 64, 96, 128, 192, 256, 384 and 512 (bf16 D 32 and 96 padded) fix D at
// compile time; every other head_dim comes at run time, for the store mask and the
// row stride. A padded head_dim pays for the zero columns: at bf16 D 32
// half the products issued are of zeros, at D 80 three eighths.
//
// Design, bf16. One block of 256 threads owns a 128-row query tile of one
// (b, h): two warpgroups of 64 rows each. Thread 0 issues every TMA load: Q
// once, then 128-key K/V tiles through a ring of kStages shared-memory
// stages, each behind a "full" mbarrier (TMA bytes arrive) and an "empty" one
// (all threads are done reading), so the next tile streams in while this one
// is multiplied. Per K/V tile, each warpgroup
//   S = Q K^T     wgmma m64n128k16, Q and K K-major from shared memory;
//   softmax       in registers on the accumulator fragment: a row lives on
//                 the 4 lanes of a quad, reduced with two shuffles; exp2 with
//                 scale * log2(e) folded into the scores;
//   O += P V      wgmma m64nDPk16 with P as bf16 register A operand (the
//                 accumulator fragment is the A fragment) and V MN-major.
// Only tiles that meet the ragged end or the causal diagonal pay for masks;
// tiles wholly above the diagonal are never loaded. GQA reads K/V head
// h / (H / H_kv) through the tensor map's coordinates; TMA zero-fills rows
// past S, and rows past S are not written.
//
// Design, fp32 (3xTF32). The same two warpgroups and 128-row query tile
// (one warpgroup, 64 rows, at DP 32); K/V tiles are 64 keys (32 at DP 128).
// After TMA lands a tile the block's threads split it (sm90.cuh,
// split_tile): Q and K into hi in place and lo beside it, V into a
// transposed hi/lo pair (tf32 B operands are K-major only); the warpgroups
// share the split. Then each warpgroup
//   S = Q K^T     three wgmma m64nNk8 a k-step (q_lo k_hi, q_hi k_lo, q_hi k_hi);
//   O += P V      three wgmma m64nDPk8 with P's hi and lo as register A
//                 operands and V^T's hi and lo from shared memory.
// Shared memory: Q and its lo 2 * kBM * DP * 4 B, a stage five kBN * DP * 4 B
// tiles (K, K lo, V, V^T hi, V^T lo): one stage, 216 KB at DP 96 and 208 KB
// at DP 128 (kBN 32); two stages, 224 KB, at DP 64, whose block is its SM's
// only one either way; 56 KB at DP 32, where a second stage would cost one
// of three resident blocks (on the card that lost). 164-226 registers a
// thread. At DP 32 three one-warpgroup blocks fit an SM's registers where
// one two-warpgroup block would, and on the card that won; from DP 64
// shared memory allows at most two one-warpgroup blocks, and sharing the
// split and the K/V loads between two warpgroups won (PERF.md).
//
// Occupancy, bf16. At DP 64 the kernel is held to 128 registers a
// thread, so two blocks share an SM and one block's softmax runs under the
// other's products; on the card that beat one block per SM with more
// registers. At DP 128 the accumulators need about 200 registers: one
// block per SM.
//
// Wide heads, bf16 DP 192 and 256 (head_dim 136..256). The O accumulator
// is DP / 2 fp32 registers a thread (128 at DP 256), and a 128-key K/V
// stage would be 2 * 128 * DP * 2 B (128 KB at DP 256) beside a 64 KB Q
// tile: two such stages do not fit a block's 227 KB. So K/V tiles are 64
// keys: Q and two stages take 144 KB at DP 192 and 192 KB at DP 256, the
// scores 32 registers a thread, and P V runs as wgmma m64n192k16 or
// m64n256k16 with V MN-major over three or four panels. One block per SM.
// o goes from the accumulators straight to device memory, so the sequence
// ring's fp32 o takes the same instances: only the store differs.
//
// Widest heads, bf16 and fp16 DP 384 and 512 (head_dim 264..512, o in q's
// dtype; D fixed at 384 and 512, at run time between). wgmma's N stops at
// 256 and one warpgroup's O would be DP / 2 = 256 registers a thread. So
// the block's two warpgroups share one 64-row Q tile and each owns one
// column half of O (DP / 2 columns: 96 or 128 accumulator registers). Each
// forms S = Q K^T over the whole head itself (m64n32k16, DP / 16 k-steps):
// the two get the same bits, so the same m and l, and no P goes through
// shared memory; the price is S twice, 1.5 times the products of one S and
// one P V. Then O_half += P V_half, wgmma m64nNk16 (N = DP / 2) with P as
// the register A operand and V's column half MN-major from the panel at
// column DP / 2 (sm90.cuh, panel_offset). K/V tiles are 32 keys: Q takes 48
// / 64 KB, a stage (K and V) 48 / 64 KB, two stages 145 / 193 KB in all at
// DP 384 / 512. A thread holds its O half (96 / 128), S (16) and P's two
// A fragments (8). One block per SM; warpgroup 0 writes lse. o goes to
// device memory in q's dtype only: the ring's fp32 o stops at 256.
//
// Wide heads, fp32 DP 192 and 256 (head_dim 136..256, 3xTF32). The fp32
// layout above would keep Q and its lo for 64 rows (2 * 64 * DP * 4 B, 128
// KB at DP 256) beside a 32-key stage of five tiles (160 KB): 288 KB. So Q
// stays raw in shared memory and is the register A operand of S = Q K^T:
// each k-step's fragment is loaded and split into hi and lo in registers,
// and each k-step's three products sum in a fresh accumulator (two, in
// turn, so one k-step's products run while the last one's sum is added in
// fp32; sm90.cuh, mma_rows_tf32). One warpgroup of 64 query rows, 32-key
// K/V tiles, one stage: Q 48 / 64 KB and the stage (K, K lo, V, V^T hi,
// V^T lo) 120 / 160 KB, 169 / 225 KB in all at DP 192 / 256. P V runs as
// wgmma m64n192k8 / m64n256k8 with P's hi and lo as register A operands
// against V^T. A thread holds O (96 / 128 registers), S and its two fresh
// sums (48) and one k-step's fragments in each of two buffers (16): 194 /
// 224-225 registers (ptxas -v), no spill. At the wide_head attention (B 8,
// S 1024, H 8, H_kv 1, D 256, causal) the 34.4 GFLOP of products move 151
// MB (45 us): 70 us at TF32's rate, 208 us as 3xTF32 (PERF.md).
//
// Bound. At B 8, S 1024, causal, d_model 768 (H = 768 / D) every head_dim
// does the same 12.9 GFLOP of products. bf16 moves 50.7 MB: 15 us of HBM
// time against 13 us of tensor-core time (bytes bound); this kernel's
// padded products at D 32 and D 96 take 26 us and 17 us of it. fp32 moves
// 101 MB (30 us) against 26 us of TF32 time, but the 3xTF32 split makes it
// 38.7 GFLOP (78 us): the three products bound every fp32 instantiation.
// What this version still leaves on the table: no producer warp or
// register reallocation (setmaxnreg), no overlap of a tile's softmax with
// the next tile's QK^T inside a warpgroup, and for fp32 the split runs in
// line with the products and, but at DP 64, the one stage leaves each load
// exposed; all queued in ROADMAP.
#include "flash_attention.cuh"
#include "sm90.cuh"

namespace hvt {
namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Tile sizes and the shared-memory layout of one instantiation: q/k/v of T
// (bf16, fp16 or fp32) with head_dim padded to DP.
template <int DP, typename T>
struct FwdCfg {
  static constexpr bool kTf32 = std::is_same<T, float>::value;
  static_assert(DP % sm90::panel_cols<T>() == 0 && DP <= (kTf32 ? 256 : 512),
                "DP: whole panels");
  // fp32 at DP 192 and 256: Q stays raw, split in registers (see Wide heads, fp32)
  static constexpr bool kQRegs = kTf32 && DP > 128;
  // 2-byte DP 384 and 512: both warpgroups on one 64-row Q tile, each
  // owning one column half of O (see Widest heads)
  static constexpr bool kHalves = DP > 256;
  // warpgroups, 64 query rows each; fp32 at DP 32 and the wide heads: one
  // (see Design, fp32)
  static constexpr int kWG = kTf32 && (DP == 32 || kQRegs) ? 1 : 2;
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kBM = kHalves ? 64 : 64 * kWG;  // query rows per block
  static constexpr int kOCols = kHalves ? DP / 2 : DP;  // columns of O a warpgroup owns
  // keys per K/V tile; bf16 wide heads: 64 (see Wide heads), widest: 32
  static constexpr int kBN = !kTf32 ? (DP <= 128 ? 128 : DP <= 256 ? 64 : 32)
                                    : DP <= 96 ? 64 : 32;
  // fp32: one stage but at DP 64 (see Design, fp32)
  static constexpr int kStages = kTf32 && DP != 64 ? 1 : 2;
  static constexpr int kQ = kBM * DP * (int)sizeof(T);   // bytes of the Q tile
  static constexpr int kKV = kBN * DP * (int)sizeof(T);  // of one K or V tile (or V^T)
  // a stage: K, V; for fp32 also K lo, V^T hi, V^T lo
  static constexpr int kStage = (kTf32 ? 5 : 2) * kKV;
  static constexpr int kQAll = (kTf32 && !kQRegs ? 2 : 1) * kQ;  // Q (and its lo)
  static constexpr int kBarriers = (1 + 2 * kStages) * 8;
  static constexpr int kBytes = kQAll + kStages * kStage + kBarriers + sm90::kAtomBytes;
  static constexpr int kMinBlocks = !kTf32 && DP == 64 ? 2 : 1;
  static_assert(kBytes <= 232448, "a block's shared memory");
};

// kD: the head_dim where it is fixed at compile time, else 0 and d_rt gives
// it.
template <int DP, int kD, typename T, typename TO>
__global__ void __launch_bounds__(FwdCfg<DP, T>::kThreads, FwdCfg<DP, T>::kMinBlocks)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, TO* __restrict__ o,
                          float* __restrict__ lse, int S, int H, int Hkv, int d_rt,
                          float scale_log2, int causal) {
  using namespace sm90;
  using C = FwdCfg<DP, T>;
  constexpr int kBM = C::kBM, kBN = C::kBN, kStages = C::kStages;
  const int D = kD ? kD : d_rt;
  constexpr int kKV = C::kKV;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1k(smem_raw);
  uint8_t* q_s = smem;                // fp32: Q's lo at q_s + kQ
  uint8_t* kv_s = smem + C::kQAll;    // stage s at kv_s + s kStage: K, V (, K lo, V^T hi, lo)
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(kv_s + kStages * C::kStage);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + kStages;

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows start first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);
  const int q0 = qt * kBM;
  int n_kt = (S + kBN - 1) / kBN;
  if (causal) n_kt = min(n_kt, (q0 + kBM - 1) / kBN + 1);
  const int tid = threadIdx.x, warp = (tid % 128) / 32, lane = tid % 32;
  const int wg = C::kWG == 1 ? 0 : tid / 128;
  // this warpgroup's first row of the Q tile, and its first column of O
  const int wg_row = C::kHalves ? 0 : 64 * wg;
  const int col0 = C::kHalves ? wg * C::kOCols : 0;

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
    uint8_t* dst = kv_s + s * C::kStage;
    mbar_expect_tx(&full[s], 2 * kKV);
    tma_load_rows<DP, T>(dst, &tk, &full[s], kBN, j * kBN, hk, b);
    tma_load_rows<DP, T>(dst + kKV, &tv, &full[s], kBN, j * kBN, hk, b);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, C::kQ);
    tma_load_rows<DP, T>(q_s, &tq, bar_q, kBM, q0, h, b);
    for (int j = 0; j < kStages && j < n_kt; ++j) load_kv(j, j);
  }

  const uint32_t q_addr = smem_u32(q_s), kv_addr = smem_u32(kv_s);
  const int row_lo = q0 + wg_row + 16 * warp + lane / 4;  // rows row_lo and row_lo + 8
  float acc[C::kOCols / 2];
#pragma unroll
  for (int i = 0; i < C::kOCols / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // per thread: partial l

  mbar_wait(bar_q, 0);
  if constexpr (C::kTf32 && !C::kQRegs) {
    split_tile<DP, kBM, true, false>(q_s, q_s + C::kQ, nullptr, nullptr, tid, C::kThreads);
    fence_proxy_async();
    __syncthreads();
  }
  for (int j = 0; j < n_kt; ++j) {
    const int s = j % kStages;
    const uint32_t k_addr = kv_addr + s * C::kStage, v_addr = k_addr + kKV;
    mbar_wait(&full[s], (j / kStages) & 1);

    float sc[kBN / 2];
    if constexpr (C::kTf32) {
      uint8_t* k_s = kv_s + s * C::kStage;
      split_tile<DP, kBN, true, false>(k_s, k_s + 2 * kKV, nullptr, nullptr, tid, C::kThreads);
      split_tile<DP, kBN, false, true>(k_s + kKV, nullptr, k_s + 3 * kKV, k_s + 4 * kKV, tid,
                                       C::kThreads);
      fence_proxy_async();
      __syncthreads();
      const uint32_t qlo_addr = q_addr + C::kQ, klo_addr = k_addr + 2 * kKV;
      if constexpr (C::kQRegs) {
        mma_rows_tf32<DP>(sc, q_s, kBM, 0, k_addr, klo_addr, kBN, warp, lane);
      } else {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 8; ++kk) {
          const uint64_t qh = desc_kmajor(q_addr, kBM, wg_row, kk),
                         ql = desc_kmajor(qlo_addr, kBM, wg_row, kk);
          const uint64_t kh = desc_kmajor(k_addr, kBN, 0, kk),
                         kl = desc_kmajor(klo_addr, kBN, 0, kk);
          wgmma_ss_tf32(sc, ql, kh, kk > 0);
          wgmma_ss_tf32(sc, qh, kl, 1);
          wgmma_ss_tf32(sc, qh, kh, 1);
        }
      }
    } else {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss<0, T>(sc, desc_kmajor(q_addr, kBM, wg_row, kk),
                       desc_kmajor(k_addr, kBN, 0, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    const int k0 = j * kBN;
    const bool edge = k0 + kBN > S || (causal && k0 + kBN - 1 > q0 + wg_row);
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
    for (int i = 0; i < C::kOCols / 2; ++i) acc[i] *= corr[(i / 2) % 2];

    if constexpr (C::kTf32) {
      const uint32_t vt_addr = k_addr + 3 * kKV, vtlo_addr = k_addr + 4 * kKV;
      uint32_t ph[kBN / 8][4], pl[kBN / 8][4];
#pragma unroll
      for (int kk = 0; kk < kBN / 8; ++kk) a_fragment_tf32(ph[kk], pl[kk], sc, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 8; ++kk) {
        const uint64_t vh = desc_kmajor(vt_addr, DP, 0, kk), vl = desc_kmajor(vtlo_addr, DP, 0, kk);
        wgmma_rs_tf32(acc, pl[kk], vh, 1);
        wgmma_rs_tf32(acc, ph[kk], vl, 1);
        wgmma_rs_tf32(acc, ph[kk], vh, 1);
      }
    } else {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        uint32_t a[4];
        a_fragment<T>(a, sc, kk);
        wgmma_rs<1, T>(acc, a, desc_mnmajor(v_addr + panel_offset(col0, kBN), kBN, kk), 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);

    mbar_arrive(&empty[s]);
    if (tid == 0 && j + kStages < n_kt) {
      mbar_wait(&empty[s], (j / kStages) & 1);  // every warpgroup is done with stage s
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
    TO* orow = o + ((long long)b * S + row) * qstride + (long long)h * D + col0;
    // this warpgroup's columns of O (kD at most where D is fixed)
    constexpr int kCols = C::kHalves ? C::kOCols : kD ? kD : DP;
#pragma unroll
    for (int c = 0; c < kCols / 8; ++c)
      if (col0 + 8 * c < D)  // the padded columns are not written
        store2(orow + 8 * c + 2 * (lane % 4), acc[4 * c + 2 * r] / li,
               acc[4 * c + 2 * r + 1] / li);
    // with column halves both warpgroups hold the row's m and l: one writes
    if (lane % 4 == 0 && (!C::kHalves || wg == 0))
      lse[((long long)b * H + h) * S + row] = m[r] * kLn2 + logf(li);
  }
}

template <int DP, int kD, typename T, typename TO>
int launch_fwd_sm90(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                    int S, int H, int Hkv, int D, float scale, int causal, cudaStream_t stream) {
  using C = FwdCfg<DP, T>;
  CUtensorMap tq, tk, tv;
  int err = make_bshd_map<T>(&tq, q, B, S, H, D, C::kBM);
  if (err == 0) err = make_bshd_map<T>(&tk, k, B, S, Hkv, D, C::kBN);
  if (err == 0) err = make_bshd_map<T>(&tv, v, B, S, Hkv, D, C::kBN);
  if (err != 0) return err;
  const dim3 grid((S + C::kBM - 1) / C::kBM, H, B);
  return launch_n(flash_fwd_sm90_kernel<DP, kD, T, TO>, grid, C::kThreads, C::kBytes, stream, tq,
                  tk, tv, (TO*)o, (float*)lse, S, H, Hkv, D, scale * kLog2e, causal);
}

// The instance for head_dim D: D 32, 64, 96 and 128 with D fixed at
// compile time (the head_dims these instances took before every head_dim
// had a route, so their code stands), and the wide heads at D 192, 256, 384
// and 512; every other D at its padded width with D at run time. Wide heads
// (DP 192 for D 136..192, 256 above) take bf16 or fp16 q with an o in q's
// dtype or the sequence ring's fp32 one, and fp32 q with an fp32 o; the
// widest (DP 384 for D 264..384, 512 above) bf16 or fp16 q with an o in q's
// dtype only.
template <typename T, typename TO>
int launch_fwd_sm90_d(int D, const void* q, const void* k, const void* v, void* o, void* lse,
                      int B, int S, int H, int Hkv, float scale, int causal, cudaStream_t st) {
  using sm90::padded_width;
  if constexpr (std::is_same<T, TO>::value && !std::is_same<T, float>::value) {
    if (D == 512)
      return launch_fwd_sm90<512, 512, T, TO>(q, k, v, o, lse, B, S, H, Hkv, D, scale, causal, st);
    if (D == 384)
      return launch_fwd_sm90<384, 384, T, TO>(q, k, v, o, lse, B, S, H, Hkv, D, scale, causal, st);
    if (D > 384)
      return launch_fwd_sm90<512, 0, T, TO>(q, k, v, o, lse, B, S, H, Hkv, D, scale, causal, st);
    if (D > 256)
      return launch_fwd_sm90<384, 0, T, TO>(q, k, v, o, lse, B, S, H, Hkv, D, scale, causal, st);
  }
  if (D > 256) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32:
      return launch_fwd_sm90<padded_width<T>(32), 32, T, TO>(q, k, v, o, lse, B, S, H, Hkv, D,
                                                             scale, causal, st);
    case 64:
      return launch_fwd_sm90<64, 64, T, TO>(q, k, v, o, lse, B, S, H, Hkv, D, scale, causal, st);
    case 96:
      return launch_fwd_sm90<padded_width<T>(96), 96, T, TO>(q, k, v, o, lse, B, S, H, Hkv, D,
                                                             scale, causal, st);
    case 128:
      return launch_fwd_sm90<128, 128, T, TO>(q, k, v, o, lse, B, S, H, Hkv, D, scale, causal,
                                              st);
    case 192:
      return launch_fwd_sm90<192, 192, T, TO>(q, k, v, o, lse, B, S, H, Hkv, D, scale, causal, st);
    case 256:
      return launch_fwd_sm90<256, 256, T, TO>(q, k, v, o, lse, B, S, H, Hkv, D, scale, causal, st);
  }
  if (D > 192)
    return launch_fwd_sm90<256, 0, T, TO>(q, k, v, o, lse, B, S, H, Hkv, D, scale, causal, st);
  if (D > 128)
    return launch_fwd_sm90<192, 0, T, TO>(q, k, v, o, lse, B, S, H, Hkv, D, scale, causal, st);
  constexpr bool kTwoByte = !std::is_same<T, float>::value;  // bf16 or fp16
  switch (padded_width<T>(D)) {
    case 32:
      if constexpr (!kTwoByte)
        return launch_fwd_sm90<32, 0, T, TO>(q, k, v, o, lse, B, S, H, Hkv, D, scale, causal, st);
      break;
    case 64:
      return launch_fwd_sm90<64, 0, T, TO>(q, k, v, o, lse, B, S, H, Hkv, D, scale, causal, st);
    case 96:
      if constexpr (!kTwoByte)
        return launch_fwd_sm90<96, 0, T, TO>(q, k, v, o, lse, B, S, H, Hkv, D, scale, causal, st);
      break;
    case 128:
      return launch_fwd_sm90<128, 0, T, TO>(q, k, v, o, lse, B, S, H, Hkv, D, scale, causal, st);
  }
  return (int)cudaErrorInvalidValue;
}

// One warpgroup checks the wgmma building blocks on a single 64 x 64 x 64
// product of T (bf16 or fp16): c1 = a b^T (both operands K-major from shared
// memory), then c2 = T(c1) b (c1's fragment as the register A operand, b
// MN-major).
template <typename T>
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
    wgmma_ss<0, T>(d, desc_kmajor(a_addr, 64, 0, kk), desc_kmajor(b_addr, 64, 0, kk), kk > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a_fragment<T>(a, d, kk);
    wgmma_rs<1, T>(e, a, desc_mnmajor(b_addr, 64, kk), kk > 0);
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

// The wide heads' operands: w is [64, N] bf16 (N 192 or 256), MN-major over
// N / 64 panels, LBO (the bytes between panels) 64 * 128 B. One warpgroup
// computes c1 = d = a b^T as wgmma_probe_kernel does, then c2 = bf16(d) w
// (d's fragment as the register A operand, m64nNk16) and c3 = a w (a
// K-major from shared memory, m64nNk16): the instructions and the panel
// stride that P V (fwd), dS K (dq) and P^T dO, dS^T Q (dkv) use at DP 192
// and 256.
template <int N>
__global__ void __launch_bounds__(128, 1)
    wgmma_probe_wide_kernel(const __grid_constant__ CUtensorMap ta,
                            const __grid_constant__ CUtensorMap tb,
                            const __grid_constant__ CUtensorMap tw, float* c1, float* c2,
                            float* c3) {
  using namespace sm90;
  constexpr int kTile = 64 * 64 * 2, kW = 64 * N * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1k(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 2 * kTile + kW);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 2 * kTile + kW);
    tma_load_rows<64>(smem, &ta, bar, 64, 0, 0, 0);
    tma_load_rows<64>(smem + kTile, &tb, bar, 64, 0, 0, 0);
    tma_load_rows<N>(smem + 2 * kTile, &tw, bar, 64, 0, 0, 0);
  }
  mbar_wait(bar, 0);
  const uint32_t a_addr = smem_u32(smem), b_addr = a_addr + kTile, w_addr = b_addr + kTile;
  float d[32], e[N / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<0>(d, desc_kmajor(a_addr, 64, 0, kk), desc_kmajor(b_addr, 64, 0, kk), kk > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d);
#pragma unroll
  for (int i = 0; i < 32; ++i)
    c1[(16 * warp + lane / 4 + 8 * ((i / 2) % 2)) * 64 + 8 * (i / 4) + 2 * (lane % 4) + i % 2] =
        d[i];
  uint32_t af[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) a_fragment(af[kk], d, kk);
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (pass == 0)
        wgmma_rs<1>(e, af[kk], desc_mnmajor(w_addr, 64, kk), kk > 0);
      else
        wgmma_ss<1>(e, desc_kmajor(a_addr, 64, 0, kk), desc_mnmajor(w_addr, 64, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(e);
    float* c = pass == 0 ? c2 : c3;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int row = 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
      const int col = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
      c[row * N + col] = e[i];
    }
  }
}

template <int N>
int launch_probe_wide(const void* a, const void* b, const void* w, void* c1, void* c2,
                      void* c3, cudaStream_t stream) {
  CUtensorMap ta, tb, tw;
  int err = make_bshd_map(&ta, a, 1, 64, 1, 64, 64);
  if (err == 0) err = make_bshd_map(&tb, b, 1, 64, 1, 64, 64);
  if (err == 0) err = make_bshd_map(&tw, w, 1, 64, 1, N, 64);
  if (err != 0) return err;
  return launch_n(wgmma_probe_wide_kernel<N>, dim3(1), 128,
                  2 * 64 * 64 * 2 + 64 * N * 2 + 8 + sm90::kAtomBytes, stream, ta, tb, tw,
                  (float*)c1, (float*)c2, (float*)c3);
}

// The same product in fp32 through the 3xTF32 building blocks: a and b split
// in place with their lo beside them, b also transposed (split_tile);
// c1 = a b^T from shared memory, then c2 = c1 b with c1's fragment split into
// the hi and lo register A operands against b^T.
__global__ void __launch_bounds__(128, 1)
    wgmma_probe_tf32_kernel(const __grid_constant__ CUtensorMap ta,
                            const __grid_constant__ CUtensorMap tb, float* c1, float* c2) {
  using namespace sm90;
  constexpr int kTile = 64 * 64 * 4;  // a, a lo, b, b lo, b^T hi, b^T lo
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1k(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 6 * kTile);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 2 * kTile);
    tma_load_rows<64, float>(smem, &ta, bar, 64, 0, 0, 0);
    tma_load_rows<64, float>(smem + 2 * kTile, &tb, bar, 64, 0, 0, 0);
  }
  mbar_wait(bar, 0);
  split_tile<64, 64, true, false>(smem, smem + kTile, nullptr, nullptr, tid, 128);
  split_tile<64, 64, true, true>(smem + 2 * kTile, smem + 3 * kTile, smem + 4 * kTile,
                                 smem + 5 * kTile, tid, 128);
  fence_proxy_async();
  __syncthreads();
  const uint32_t a_addr = smem_u32(smem);
  float d[32], e[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t ah = desc_kmajor(a_addr, 64, 0, kk), al = desc_kmajor(a_addr + kTile, 64, 0, kk);
    const uint64_t bh = desc_kmajor(a_addr + 2 * kTile, 64, 0, kk),
                   bl = desc_kmajor(a_addr + 3 * kTile, 64, 0, kk);
    wgmma_ss_tf32(d, al, bh, kk > 0);
    wgmma_ss_tf32(d, ah, bl, 1);
    wgmma_ss_tf32(d, ah, bh, 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d);
  uint32_t hi[8][4], lo[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) a_fragment_tf32(hi[kk], lo[kk], d, kk);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t th = desc_kmajor(a_addr + 4 * kTile, 64, 0, kk),
                   tl = desc_kmajor(a_addr + 5 * kTile, 64, 0, kk);
    wgmma_rs_tf32(e, lo[kk], th, kk > 0);
    wgmma_rs_tf32(e, hi[kk], tl, 1);
    wgmma_rs_tf32(e, hi[kk], th, 1);
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

// The fp32 wide heads' building blocks on one product, for a [64, N] and b
// [R, N] fp32 (N 192 or 256; R 16 or 32): c1 = a b^T with a's A fragments
// loaded raw and split in registers and b split in place (mma_rows_tf32:
// m64nRk8 over N / 8 k-steps, as S = Q K^T and S^T = K Q^T take them at DP
// 192 and 256); c2 = c1 b with c1's fragment split into the register A
// operand against b's transposed, permuted split (m64nNk8, as P V takes
// it); c3 = (c1 b)^T with c1 written as K-major B tiles and b's split tiles
// read transposed as A, a fresh sum a 64-row slab (store_frag_tf32,
// mma_cols_tf32_add: m64n64k8, as dQ^T, dV^T and dK^T take them).
template <int N, int R>
__global__ void __launch_bounds__(128, 1)
    wgmma_probe_tf32_wide_kernel(const __grid_constant__ CUtensorMap ta,
                                 const __grid_constant__ CUtensorMap tb, float* c1, float* c2,
                                 float* c3) {
  using namespace sm90;
  constexpr int kA = 64 * N * 4, kB = R * N * 4, kT = N * kRowBytes, kC = 64 * kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1k(smem_raw);
  uint8_t* a_s = smem;
  uint8_t* b_s = a_s + kA;      // b (hi once split), then b lo
  uint8_t* t_s = b_s + 2 * kB;  // b^T hi, then b^T lo
  uint8_t* c_s = t_s + 2 * kT;  // c1 hi, then c1 lo
  uint64_t* bar = reinterpret_cast<uint64_t*>(c_s + 2 * kC);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, kA + kB);
    tma_load_rows<N, float>(a_s, &ta, bar, 64, 0, 0, 0);
    tma_load_rows<N, float>(b_s, &tb, bar, R, 0, 0, 0);
  }
  mbar_wait(bar, 0);
  split_tile<N, R, true, true>(b_s, b_s + kB, t_s, t_s + kT, tid, 128);
  fence_proxy_async();
  __syncthreads();
  const uint32_t b_addr = smem_u32(b_s), t_addr = smem_u32(t_s), c_addr = smem_u32(c_s);
  float d[R / 2];
  mma_rows_tf32<N>(d, a_s, 64, 0, b_addr, b_addr + kB, R, warp, lane);
#pragma unroll
  for (int i = 0; i < R / 2; ++i) c1[frag_row(i, warp, lane) * R + frag_col(i, lane)] = d[i];

  uint32_t hi[R / 8][4], lo[R / 8][4];
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk) a_fragment_tf32(hi[kk], lo[kk], d, kk);
  float e[N / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk) {
    const uint64_t th = desc_kmajor(t_addr, N, 0, kk), tl = desc_kmajor(t_addr + kT, N, 0, kk);
    wgmma_rs_tf32(e, lo[kk], th, kk > 0);
    wgmma_rs_tf32(e, hi[kk], tl, 1);
    wgmma_rs_tf32(e, hi[kk], th, 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(e);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) c2[frag_row(i, warp, lane) * N + frag_col(i, lane)] = e[i];

  store_frag_tf32(d, c_s, c_s + kC, warp, lane);
  fence_proxy_async();
  __syncthreads();
#pragma unroll
  for (int m = 0; m < N / 64; ++m) {
    float f[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) f[i] = 0.f;
    mma_cols_tf32_add<R / 8>(f, b_addr, b_addr + kB, R, 64 * m, c_addr, c_addr + kC, 64, warp,
                             lane);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      c3[(64 * m + frag_row(i, warp, lane)) * 64 + frag_col(i, lane)] = f[i];
  }
}

template <int N, int R>
int launch_probe_tf32_wide(const void* a, const void* b, void* c1, void* c2, void* c3,
                           cudaStream_t stream) {
  CUtensorMap ta, tb;
  int err = make_bshd_map<float>(&ta, a, 1, 64, 1, N, 64);
  if (err == 0) err = make_bshd_map<float>(&tb, b, 1, R, 1, N, R);
  if (err != 0) return err;
  return launch_n(wgmma_probe_tf32_wide_kernel<N, R>, dim3(1), 128,
                  64 * N * 4 + 2 * R * N * 4 + 2 * N * sm90::kRowBytes +
                      2 * 64 * sm90::kRowBytes + 8 + sm90::kAtomBytes,
                  stream, ta, tb, (float*)c1, (float*)c2, (float*)c3);
}

}  // namespace
}  // namespace hvt

// Returns 0 or the CUDA error of the launch. q, k, v bf16 (dtype 1), fp16
// (2) or fp32 (0) with any D the port takes in steps of 8 (8..512 for
// bf16 or fp16 q with o in q's dtype, else 8..256); out_dtype: the dtype of
// o, q's or fp32 (0).
extern "C" int hvt_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int B, int S, int H, int Hkv, int D, float scale,
                                  int causal, int dtype, int out_dtype, void* stream) {
  using namespace hvt;
  if (!valid_shape(B, S, H, Hkv, D, sm90_max_d(dtype, out_dtype)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kBF16 && out_dtype == kBF16)
    return launch_fwd_sm90_d<__nv_bfloat16, __nv_bfloat16>(D, q, k, v, o, lse, B, S, H, Hkv,
                                                           scale, causal, st);
  if (dtype == kBF16 && out_dtype == kF32)
    return launch_fwd_sm90_d<__nv_bfloat16, float>(D, q, k, v, o, lse, B, S, H, Hkv, scale,
                                                   causal, st);
  if (dtype == kF16 && out_dtype == kF16)
    return launch_fwd_sm90_d<__half, __half>(D, q, k, v, o, lse, B, S, H, Hkv, scale, causal, st);
  if (dtype == kF16 && out_dtype == kF32)
    return launch_fwd_sm90_d<__half, float>(D, q, k, v, o, lse, B, S, H, Hkv, scale, causal, st);
  if (dtype == kF32 && out_dtype == kF32)
    return launch_fwd_sm90_d<float, float>(D, q, k, v, o, lse, B, S, H, Hkv, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

// a, b: bf16 (dtype 1), fp16 (2) or fp32 (0) [64, 64] row-major; c1, c2:
// fp32 [64, 64] (see wgmma_probe_kernel and wgmma_probe_tf32_kernel).
extern "C" int hvt_wgmma_probe(const void* a, const void* b, void* c1, void* c2, int dtype,
                               void* stream) {
  using namespace hvt;
  CUtensorMap ta, tb;
  cudaStream_t st = (cudaStream_t)stream;
  int err;
  if (dtype == kF32) {
    err = make_bshd_map<float>(&ta, a, 1, 64, 1, 64, 64);
    if (err == 0) err = make_bshd_map<float>(&tb, b, 1, 64, 1, 64, 64);
    if (err != 0) return err;
    return launch_n(wgmma_probe_tf32_kernel, dim3(1), 128, 6 * 64 * 64 * 4 + 8 + sm90::kAtomBytes,
                    st, ta, tb, (float*)c1, (float*)c2);
  }
  const size_t smem = 2 * 64 * 64 * 2 + 8 + sm90::kAtomBytes;
  if (dtype == kF16) {
    err = make_bshd_map<__half>(&ta, a, 1, 64, 1, 64, 64);
    if (err == 0) err = make_bshd_map<__half>(&tb, b, 1, 64, 1, 64, 64);
    if (err != 0) return err;
    return launch_n(wgmma_probe_kernel<__half>, dim3(1), 128, smem, st, ta, tb, (float*)c1,
                    (float*)c2);
  }
  if (dtype != kBF16) return (int)cudaErrorInvalidValue;
  err = make_bshd_map(&ta, a, 1, 64, 1, 64, 64);
  if (err == 0) err = make_bshd_map(&tb, b, 1, 64, 1, 64, 64);
  if (err != 0) return err;
  return launch_n(wgmma_probe_kernel<__nv_bfloat16>, dim3(1), 128, smem, st, ta, tb, (float*)c1,
                  (float*)c2);
}

// a, b: bf16 [64, 64], w: bf16 [64, n] (n 192 or 256), all row-major; c1:
// fp32 [64, 64]; c2, c3: fp32 [64, n] (see wgmma_probe_wide_kernel).
extern "C" int hvt_wgmma_probe_wide(const void* a, const void* b, const void* w, void* c1,
                                    void* c2, void* c3, int n, void* stream) {
  using namespace hvt;
  if (n == 192) return launch_probe_wide<192>(a, b, w, c1, c2, c3, (cudaStream_t)stream);
  if (n == 256) return launch_probe_wide<256>(a, b, w, c1, c2, c3, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// a: fp32 [64, n], b: fp32 [r, n] (n 192 or 256, r 16 or 32), row-major;
// c1: fp32 [64, r], c2: fp32 [64, n], c3: fp32 [n, 64] (see
// wgmma_probe_tf32_wide_kernel).
extern "C" int hvt_wgmma_probe_wide_tf32(const void* a, const void* b, void* c1, void* c2,
                                         void* c3, int n, int r, void* stream) {
  using namespace hvt;
  cudaStream_t st = (cudaStream_t)stream;
  if (n == 192 && r == 16) return launch_probe_tf32_wide<192, 16>(a, b, c1, c2, c3, st);
  if (n == 192 && r == 32) return launch_probe_tf32_wide<192, 32>(a, b, c1, c2, c3, st);
  if (n == 256 && r == 16) return launch_probe_tf32_wide<256, 16>(a, b, c1, c2, c3, st);
  if (n == 256 && r == 32) return launch_probe_tf32_wide<256, 32>(a, b, c1, c2, c3, st);
  return (int)cudaErrorInvalidValue;
}
