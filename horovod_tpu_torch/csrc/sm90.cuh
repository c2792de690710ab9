// Hopper building blocks of the tensor-core flash kernels (flash_fwd_sm90.cu,
// flash_dq_sm90.cu, flash_dkv_sm90.cu): raw PTX for mbarriers, TMA loads,
// wgmma descriptors and wgmma products in bf16, fp16 and tf32, the 3xTF32
// split (of tiles in shared memory, and at the fp32 wide heads of A
// fragments in registers), the split of an fp32 tile into two bf16 or fp16
// terms (an fp32 dO with 2-byte q: beside the tile, or in place at the wide
// heads' dk/dv), fp16's scale of dO, plus the host code that encodes a TMA
// tensor map. sm_90a only: wgmma does not exist on plain sm_90. fp16 takes
// every path that bf16 takes, with the same tiles (T = __half where bf16 has
// __nv_bfloat16).
//
// Shared-memory tiles. Every tile is a stack of "panels" of 128 bytes a row:
// 64 bf16 or fp16 or 32 fp32 columns, one panel per 128 bytes of the head dimension
// (a head_dim that is not a whole number of panels, bf16 32 or 80 say, is
// padded to whole panels: TMA fills the columns past D with zeros, which add
// nothing to any product). TMA writes a
// panel with the 128-byte swizzle (the 16-byte chunk c of row r lands at
// chunk c ^ (r % 8)), so eight rows make one 1024-byte swizzle atom and every
// panel starts on a 1024-byte boundary. wgmma reads the same panels through a
// matrix descriptor with the 128-byte swizzle mode:
//   K-major operand (the reduced dimension is the contiguous one, e.g. q or k
//     in q k^T): SBO = 1024 B between 8-row groups, LBO unused (16 B); the
//     k-th step (16 bf16 or 8 tf32 columns, 32 bytes either way) starts
//     32 B further into the row.
//   MN-major operand (the contiguous dimension is the output's, e.g. v in
//     p v; 2-byte only): SBO = 1024 B between groups of 8 reduced rows, LBO =
//     the bytes between two 64-column panels; the k-th 16-row step starts
//     2048 B on.
//
// Accumulator fragment of wgmma.m64nNk16 (and m64nNk8) with fp32 d (PTX ISA,
// "wgmma register fragments"): thread t of the warpgroup (warp w = t / 32,
// lane l) holds d[i], i < N / 2, at
//   row = 16 w + l / 4 + 8 ((i / 2) % 2),   col = 8 (i / 4) + 2 (l % 4) + i % 2.
// The bf16 or fp16 A fragment of m64k16 taken from registers has the same map for
// its 16 columns, so columns 16 kk..16 kk + 15 of an accumulator, rounded to
// bf16 (fp16) and packed in pairs (d[8 kk + 2 j], d[8 kk + 2 j + 1]), j < 4, are the
// A operand of the next product as they stand: no shuffle.
//
// fp32 through 3xTF32. tf32 wgmma reads both shared-memory operands K-major
// only, and its products keep 11 bits of each operand. So each fp32 operand x
// is split into hi = tf32(x) and lo = tf32(x - hi) (round to nearest), and a
// product is a_lo b_hi + a_hi b_lo + a_hi b_hi in fp32 accumulators (CUTLASS's
// 3xTF32); a_lo b_lo, below 2^-22 of a b, is dropped. A tile that TMA brought
// is split by the consumer threads: hi in place, lo into a tile of the same
// layout (split_tile). An operand the product needs MN-major (v in p v; dO and
// q in dV and dK) is written transposed instead, reduced index contiguous.
// The tf32 A fragment of m64k8 taken from registers holds (row l / 4 [+ 8],
// col l % 4 [+ 4]) in a0..a3 (rows first), where the accumulator holds
// columns 2 (l % 4) and 2 (l % 4) + 1: the fragment is used as it stands and
// the reduced index of the B tile is permuted instead, within each group of 8:
// column 2 c + e of the accumulator is position c + 4 e of the k-step
// (permute8), which the transposed write applies.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hvt {
namespace sm90 {

constexpr int kRowBytes = 128;
constexpr int kAtomBytes = 1024;      // 8 rows of 128 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the barrier has completed the phase of the given parity. A
// phase that never completes is a bug (a lost TMA byte count, a wrong
// parity); after about 2^24 polls, seconds at the least, the kernel traps
// and the launch reports an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 24)) __trap();
  }
}

// ---- TMA ---------------------------------------------------------------------

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`. Rows outside the tensor
// arrive as zeros and still count.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// The 2-byte operand types: bf16 (__nv_bfloat16, wgmma's .bf16) and fp16
// (__half, .f16), with the same panels, rate and fragment layouts; they
// differ in range and in the conversions below.
template <typename T>
__host__ __device__ constexpr bool is_f16() {
  return std::is_same<T, __half>::value;
}

// Columns of one panel, and a head_dim padded to whole panels.
template <typename T>
__host__ __device__ constexpr int panel_cols() {
  return kRowBytes / (int)sizeof(T);
}
template <typename T>
__host__ __device__ constexpr int padded_width(int d) {
  return (d + panel_cols<T>() - 1) / panel_cols<T>() * panel_cols<T>();
}

// Loads rows [row0, row0 + rows) of head h, batch b of a [B, S, H, D] tensor
// of T as panels of `rows` x 128 bytes, panel p at dst + p * rows * 128 B; D
// is the padded head_dim (columns past the tensor's arrive as zeros).
template <int D, typename T = __nv_bfloat16>
__device__ __forceinline__ void tma_load_rows(uint8_t* dst, const CUtensorMap* map,
                                              uint64_t* bar, int rows, int row0, int h, int b) {
#pragma unroll
  for (int p = 0; p < D / panel_cols<T>(); ++p)
    tma_load_4d(dst + p * rows * kRowBytes, map, bar, p * panel_cols<T>(), h, row0, b);
}

// ---- wgmma -------------------------------------------------------------------

__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32) | (1ull << 62);  // layout 1: 128B swizzle
}

// K-major operand: rows [row0, row0 + 64 or N) of a panelled tile with
// `rows` rows, the kk-th 16-column step of its D columns.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int rows, int row0, int kk) {
  const uint32_t addr = tile + (kk / 4) * rows * kRowBytes + row0 * kRowBytes + (kk % 4) * 32;
  return desc_sw128(addr, 16, kAtomBytes);
}

// Byte offset of column col0 (a multiple of 64) in a panelled 2-byte tile
// of `rows` rows: where an MN-major operand over columns col0.. starts (the
// column halves of the head_dim-264..512 kernels).
__host__ __device__ constexpr int panel_offset(int col0, int rows) {
  return col0 / 64 * rows * kRowBytes;
}

// MN-major operand: the kk-th 16-row step of a panelled tile with `rows`
// rows; its columns (all panels from the start) are the product's N.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int rows, int kk) {
  return desc_sw128(tile + kk * 16 * kRowBytes, rows * kRowBytes, kAtomBytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous product that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// x rounded to the nearest T (bf16 or fp16), as fp32.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (is_f16<T>())
    return __half2float(__float2half_rn(x));
  else
    return __bfloat162float(__float2bfloat16_rn(x));
}

// (lo, hi) rounded to nearest T and packed, lo in the low half.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (is_f16<T>()) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// Columns 16 kk..16 kk + 15 of an accumulator as the A operand of T.
template <typename T = __nv_bfloat16, int N>
__device__ __forceinline__ void a_fragment(uint32_t (&a)[4], const float (&d)[N], int kk) {
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = pack2<T>(d[8 * kk + 2 * j], d[8 * kk + 2 * j + 1]);
}

// ---- fp16's range: the scale of dO ---------------------------------------------
//
// fp16 keeps 11 significant bits, 3 more than bf16, but only from 2^-14
// (6.1e-5; subnormals to 6e-8) to 65504. A mean loss's dO sits near 1e-5
// in a GPT, so the operands derived from it (dS, rounded to fp16 for the
// dS K and dS^T Q products, and the ring's fp32 dO split into two fp16
// terms) would lose their low bits or flush to zero. So the fp16 kernels
// take dO times one exact power of two 2^e a call, e from dO's largest
// magnitude (the wrapper's amax, a device scalar: no host sync):
// max |dO| 2^e lies in [0.5, 1). delta is scaled on load, so dP and dS
// come out scaled; dq, dk (and dv where it was formed from a scaled dO)
// are multiplied by 2^-e in the epilogue. Powers of two scale fp32 values
// exactly, so the result is the unscaled arithmetic's but where fp16
// rounds (ops/_kernels.py dout_scale, the plain versions, model it).

// (2^e, 2^-e) for dO's largest magnitude `amax`: e = -(frexp's exponent),
// within +-120; 1 for a zero or non-finite amax.
__device__ __forceinline__ void dout_scale(const float* amax, float& scale, float& unscale) {
  const float a = *amax;
  int e = 0;
  if (a > 0.f && a <= 3.402823466e38f) {  // not zero, inf or NaN
    frexpf(a, &e);
    e = min(max(e, -120), 120);
  }
  scale = __int_as_float((127 - e) << 23);
  unscale = __int_as_float((127 + e) << 23);
}

// ---- 3xTF32 ------------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + (below 2^-22 x), both tf32 bit patterns.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// Columns 8 kk..8 kk + 7 of an accumulator as the hi and lo tf32 A operands,
// the reduced index permuted by permute8.
template <int N>
__device__ __forceinline__ void a_fragment_tf32(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                                const float (&d)[N], int kk) {
  split_tf32(d[4 * kk], hi[0], lo[0]);
  split_tf32(d[4 * kk + 2], hi[1], lo[1]);
  split_tf32(d[4 * kk + 1], hi[2], lo[2]);
  split_tf32(d[4 * kk + 3], hi[3], lo[3]);
}

// Where the accumulator's column r of a k-step group of 8 sits in the B tile.
__device__ __forceinline__ int permute8(int r) {
  return (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
}

// Makes this thread's plain shared-memory writes visible to wgmma (the async
// proxy); a barrier must follow before another thread's wgmma reads them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Splits an fp32 tile that TMA brought: kRows rows of D columns in 32-column
// panels at `raw`. kKeep: hi replaces each value in place and lo goes to the
// same offset of `lo`. kTranspose: hi and lo also go to t_hi and t_lo as the
// transposed tile, D rows of kRows columns (32-column panels of D rows each),
// the columns permuted by permute8, i.e. the K-major B operand of a product
// that reduces over the tile's rows. The block's nthreads threads share it:
// consecutive threads take one 16-byte chunk of consecutive rows, so the
// 16-byte reads and writes and the transposed 4-byte writes (one row of the
// transposed tile for up to 32 threads) are free of bank conflicts.
template <int D, int kRows, bool kKeep, bool kTranspose>
__device__ __forceinline__ void split_tile(uint8_t* raw, uint8_t* lo, uint8_t* t_hi,
                                           uint8_t* t_lo, int tid, int nthreads) {
  constexpr int kChunks = kRows * D / 4;  // 16-byte chunks
  for (int i = tid; i < kChunks; i += nthreads) {
    // row r, chunk c (of 8 in the row's 128 bytes) of panel p
    const int r = i % kRows, c = (i / kRows) % 8, p = i / (kRows * 8);
    const int off = p * kRows * kRowBytes + r * kRowBytes + ((c ^ (r % 8)) * 16);
    const float4 x = *reinterpret_cast<const float4*>(raw + off);
    uint32_t h[4], l[4];
    split_tf32(x.x, h[0], l[0]);
    split_tf32(x.y, h[1], l[1]);
    split_tf32(x.z, h[2], l[2]);
    split_tf32(x.w, h[3], l[3]);
    if (kKeep) {
      *reinterpret_cast<uint4*>(raw + off) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
    }
    if (kTranspose) {
      const int d0 = 32 * p + 4 * c;
      const int pos = permute8(r);
      const int base = (pos / 32) * D * kRowBytes + (pos % 4) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = d0 + j;
        const int t_off = base + d * kRowBytes + ((((pos % 32) / 4) ^ (d % 8)) * 16);
        *reinterpret_cast<uint32_t*>(t_hi + t_off) = h[j];
        *reinterpret_cast<uint32_t*>(t_lo + t_off) = l[j];
      }
    }
  }
}

// Eight fp32 values x (times `mult` for fp16: the dO scale) as two terms
// of T packed in pairs: hi = T(x), lo = T(x - hi), both rounded to nearest,
// so that hi + lo carries 16 (bf16) or 22 (fp16) bits of x's mantissa.
template <typename T>
__device__ __forceinline__ void split_pairs(const float (&x)[8], float mult, uint32_t (&h)[4],
                                            uint32_t (&l)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float x0 = x[2 * j], x1 = x[2 * j + 1];
    if constexpr (is_f16<T>()) {
      x0 *= mult;
      x1 *= mult;
    }
    const float a = round_to<T>(x0), b = round_to<T>(x1);
    h[j] = pack2<T>(a, b);  // exact: a and b are values of T
    l[j] = pack2<T>(x0 - a, x1 - b);
  }
}

// Splits an fp32 tile as TMA lands it (kRows rows of D columns in 32-column
// panels at `f32`) into two tiles of T (bf16 or fp16) as TMA would land
// them (64-column panels): split_pairs, with fp16's dO scale `mult`. D: a
// whole number of 2-byte panels. Each step takes 8 columns of one row;
// consecutive threads take consecutive rows, so the swizzled 16-byte
// accesses of 8 threads fall in distinct banks.
template <int D, int kRows, typename T = __nv_bfloat16>
__device__ __forceinline__ void split_terms(const uint8_t* f32, uint8_t* hi, uint8_t* lo, int tid,
                                            int nthreads, float mult = 1.f) {
  for (int i = tid; i < kRows * D / 8; i += nthreads) {
    const int r = i % kRows, c8 = i / kRows;  // row r, columns 8 c8 .. 8 c8 + 7
    const uint8_t* src = f32 + (c8 / 4) * kRows * kRowBytes + r * kRowBytes;
    const int ch = 2 * (c8 % 4);  // the first of its two fp32 chunks
    const float4 x0 = *reinterpret_cast<const float4*>(src + ((ch ^ (r % 8)) * 16));
    const float4 x1 = *reinterpret_cast<const float4*>(src + (((ch + 1) ^ (r % 8)) * 16));
    const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    uint32_t h[4], l[4];
    split_pairs<T>(x, mult, h, l);
    const int off = (c8 / 8) * kRows * kRowBytes + r * kRowBytes + (((c8 % 8) ^ (r % 8)) * 16);
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// split_terms in place, where no room is left beside the fp32 tile: 2-byte
// panel p of hi takes the bytes of fp32 panels 2 p and lo those of 2 p + 1,
// so hi and lo are tiles of T whose 64-column panels lie 2 kRows * 128 B
// apart, lo kRows * 128 B after hi (descriptors with a panel stride of
// 2 kRows rows read them). Eight consecutive lanes take the eight 8-column
// steps of one row of one 2-byte panel: together they read the 256 bytes
// that their hi and lo chunks overwrite, so a warp barrier between the
// reads and the writes suffices. nthreads: a multiple of 32 that divides
// kRows * D / 8.
template <int D, int kRows, typename T = __nv_bfloat16>
__device__ __forceinline__ void split_terms_in_place(uint8_t* tile, int tid, int nthreads,
                                                     float mult = 1.f) {
  static_assert(D % 64 == 0, "D: whole 2-byte panels");
  for (int i = tid; i < kRows * D / 8; i += nthreads) {
    // 2-byte panel p, row r, columns 64 p + 8 c8 .. 64 p + 8 c8 + 7
    const int c8 = i % 8, r = (i / 8) % kRows, p = i / (8 * kRows);
    uint8_t* pair = tile + 2 * p * kRows * kRowBytes;  // fp32 panels 2 p and 2 p + 1
    const uint8_t* src = pair + (c8 / 4) * kRows * kRowBytes + r * kRowBytes;
    const int ch = 2 * (c8 % 4);  // the first of its two fp32 chunks
    const float4 x0 = *reinterpret_cast<const float4*>(src + ((ch ^ (r % 8)) * 16));
    const float4 x1 = *reinterpret_cast<const float4*>(src + (((ch + 1) ^ (r % 8)) * 16));
    const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    uint32_t h[4], l[4];
    split_pairs<T>(x, mult, h, l);
    __syncwarp();  // the row's eight lanes have read it
    const int off = r * kRowBytes + ((c8 ^ (r % 8)) * 16);
    *reinterpret_cast<uint4*>(pair + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(pair + kRows * kRowBytes + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// Synchronises the 128 threads of one warpgroup (barrier 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// The wrappers' operand lists: an accumulator of n fp32 registers as the asm
// operands %0..%(n - 1) (HVT_Rn) and their constraints (HVT_Dn).
#define HVT_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define HVT_D8 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
#define HVT_R16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define HVT_D16 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define HVT_R32 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define HVT_D32 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define HVT_R64 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define HVT_D64 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define HVT_R96 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define HVT_D96 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
  "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
  "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
  "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
#define HVT_R128 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define HVT_D128 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
  "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
  "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
  "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
  "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
  "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
  "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// Generated operand lists: m64nNk16 at N 16, 32, 64, 128, 192 and 256 (ss)
// and 64, 128, 192 and 256 (rs), T (bf16 or fp16) in, fp32 out. kTransB =
// 0: B is K-major; 1: B is MN-major. scale_d = 0 overwrites d.
// d[0:8] (+)= A[64 x 16] B[16 x 16]; A and B from shared memory.
template <int kTransB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
#define HVT_MMA(AB)                                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"                            \
               "wgmma.mma_async.sync.aligned.m64n16k16.f32." AB "." AB " {" HVT_R8 "}, " \
               "%8, %9, p, 1, 1, 0, %11;\n}\n"                                  \
               : HVT_D8                                                               \
               : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB))
  if constexpr (is_f16<T>())
    HVT_MMA("f16");
  else
    HVT_MMA("bf16");
#undef HVT_MMA
}

// d[0:16] (+)= A[64 x 16] B[16 x 32]; A and B from shared memory.
template <int kTransB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
#define HVT_MMA(AB)                                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                            \
               "wgmma.mma_async.sync.aligned.m64n32k16.f32." AB "." AB " {" HVT_R16 "}, " \
               "%16, %17, p, 1, 1, 0, %19;\n}\n"                                \
               : HVT_D16                                                              \
               : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB))
  if constexpr (is_f16<T>())
    HVT_MMA("f16");
  else
    HVT_MMA("bf16");
#undef HVT_MMA
}

// d[0:32] (+)= A[64 x 16] B[16 x 64]; A and B from shared memory.
template <int kTransB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
#define HVT_MMA(AB)                                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                            \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " {" HVT_R32 "}, " \
               "%32, %33, p, 1, 1, 0, %35;\n}\n"                                \
               : HVT_D32                                                              \
               : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB))
  if constexpr (is_f16<T>())
    HVT_MMA("f16");
  else
    HVT_MMA("bf16");
#undef HVT_MMA
}

// d[0:32] (+)= A[64 x 16] B[16 x 64]; A from registers (pairs of T), B from
// shared memory.
template <int kTransB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
#define HVT_MMA(AB)                                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                            \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " {" HVT_R32 "}, " \
               "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"             \
               : HVT_D32                                                              \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),  \
                 "n"(kTransB))
  if constexpr (is_f16<T>())
    HVT_MMA("f16");
  else
    HVT_MMA("bf16");
#undef HVT_MMA
}

// d[0:64] (+)= A[64 x 16] B[16 x 128]; A and B from shared memory.
template <int kTransB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
#define HVT_MMA(AB)                                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                            \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " {" HVT_R64 "}, " \
               "%64, %65, p, 1, 1, 0, %67;\n}\n"                                \
               : HVT_D64                                                              \
               : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB))
  if constexpr (is_f16<T>())
    HVT_MMA("f16");
  else
    HVT_MMA("bf16");
#undef HVT_MMA
}

// d[0:64] (+)= A[64 x 16] B[16 x 128]; A from registers (pairs of T), B from
// shared memory.
template <int kTransB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
#define HVT_MMA(AB)                                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                            \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " {" HVT_R64 "}, " \
               "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"             \
               : HVT_D64                                                              \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),  \
                 "n"(kTransB))
  if constexpr (is_f16<T>())
    HVT_MMA("f16");
  else
    HVT_MMA("bf16");
#undef HVT_MMA
}

// d[0:96] (+)= A[64 x 16] B[16 x 192]; A and B from shared memory.
template <int kTransB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float (&d)[96], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
#define HVT_MMA(AB)                                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"                            \
               "wgmma.mma_async.sync.aligned.m64n192k16.f32." AB "." AB " {" HVT_R96 "}, " \
               "%96, %97, p, 1, 1, 0, %99;\n}\n"                                \
               : HVT_D96                                                              \
               : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB))
  if constexpr (is_f16<T>())
    HVT_MMA("f16");
  else
    HVT_MMA("bf16");
#undef HVT_MMA
}

// d[0:96] (+)= A[64 x 16] B[16 x 192]; A from registers (pairs of T), B from
// shared memory.
template <int kTransB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[96], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
#define HVT_MMA(AB)                                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"                            \
               "wgmma.mma_async.sync.aligned.m64n192k16.f32." AB "." AB " {" HVT_R96 "}, " \
               "{%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"             \
               : HVT_D96                                                              \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),  \
                 "n"(kTransB))
  if constexpr (is_f16<T>())
    HVT_MMA("f16");
  else
    HVT_MMA("bf16");
#undef HVT_MMA
}

// d[0:128] (+)= A[64 x 16] B[16 x 256]; A and B from shared memory.
template <int kTransB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
#define HVT_MMA(AB)                                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                            \
               "wgmma.mma_async.sync.aligned.m64n256k16.f32." AB "." AB " {" HVT_R128 "}, " \
               "%128, %129, p, 1, 1, 0, %131;\n}\n"                                \
               : HVT_D128                                                              \
               : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB))
  if constexpr (is_f16<T>())
    HVT_MMA("f16");
  else
    HVT_MMA("bf16");
#undef HVT_MMA
}

// d[0:128] (+)= A[64 x 16] B[16 x 256]; A from registers (pairs of T), B from
// shared memory.
template <int kTransB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
#define HVT_MMA(AB)                                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                            \
               "wgmma.mma_async.sync.aligned.m64n256k16.f32." AB "." AB " {" HVT_R128 "}, " \
               "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"             \
               : HVT_D128                                                              \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),  \
                 "n"(kTransB))
  if constexpr (is_f16<T>())
    HVT_MMA("f16");
  else
    HVT_MMA("bf16");
#undef HVT_MMA
}

// Generated operand lists: m64nNk8, tf32 in, fp32 out; both operands
// K-major (tf32 takes no transpose). scale_d = 0 overwrites d.
// d[0:8] (+)= A[64 x 8] B[8 x 16]; A and B from shared memory.
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[8], uint64_t desc_a, uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[0:16] (+)= A[64 x 8] B[8 x 32]; A and B from shared memory.
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[0:32] (+)= A[64 x 8] B[8 x 64]; A and B from shared memory.
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[0:16] (+)= A[64 x 8] B[8 x 32]; A from registers (tf32), B from shared memory.
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d[0:32] (+)= A[64 x 8] B[8 x 64]; A from registers (tf32), B from shared memory.
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d[0:48] (+)= A[64 x 8] B[8 x 96]; A from registers (tf32), B from shared memory.
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[48], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d[0:64] (+)= A[64 x 8] B[8 x 128]; A from registers (tf32), B from shared memory.
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}
// d[0:8] (+)= A[64 x 8] B[8 x 16]; A from registers (tf32), B from shared memory.
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d[0:96] (+)= A[64 x 8] B[8 x 192]; A from registers (tf32), B from shared memory.
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[96], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d[0:128] (+)= A[64 x 8] B[8 x 256]; A from registers (tf32), B from shared memory.
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// ---- 3xTF32 with fp32 tiles read and written by the threads ------------------
//
// The fp32 kernels at padded widths 192 and 256 keep no split copy of an
// operand that is A (M = 64 rows): its tf32 A fragments are loaded from the
// raw tile that TMA landed and split in registers (mma_rows_tf32), or loaded
// hi and lo from split tiles with the tile's rows as the reduced index
// (A = the tile transposed: mma_cols_tf32_add). B tiles that the threads
// write (P^T, dS, dS^T) take an accumulator fragment's rows as their rows
// and its columns as the reduced index, unpermuted (store_frag_tf32).

// Byte offset of element (r, c) of an fp32 tile of `rows` rows in 32-column
// panels with the 128-byte swizzle, as TMA lands it.
__device__ __forceinline__ int f32_offset(int rows, int r, int c) {
  return (c / 32) * rows * kRowBytes + r * kRowBytes + ((((c % 32) / 4) ^ (r % 8)) * 16) +
         (c % 4) * 4;
}

__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// x, which the compiler cannot see through: the shared addresses computed
// from a thread's index are recomputed where they are used, instead of one
// register for each load being hoisted out of the caller's loop (on the
// card that spilled).
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// d = A B^T in 3xTF32 over DP columns: A = rows m0..m0 + 63 of the raw fp32
// tile a (arows rows), split in registers kG k-steps at a time (two for N
// 8, one above: the registers of two groups' fragments); B = the
// K-major tf32 tiles at shared-memory addresses b_hi and b_lo (brows rows,
// N = brows). The tf32 A fragment of m64k8 holds (row 16 warp + lane / 4
// [+ 8], col lane % 4 [+ 4]); the 32 lanes of a warp read 8 rows of 4
// words in 8 distinct swizzled chunks, no bank conflict. Each group's
// fragments are split before its wgmma_fence and summed in a fresh
// accumulator, added to d in fp32 once done (the tensor cores truncate as
// they accumulate); the next group's fragments and sum go to the other
// buffer (wgmma_wait<1>), so no register is written under a pending product.
template <int DP, int N>
__device__ __forceinline__ void mma_rows_tf32(float (&d)[N], const uint8_t* a, int arows, int m0,
                                              uint32_t b_hi, uint32_t b_lo, int brows, int warp,
                                              int lane) {
  constexpr int kG = N >= 16 ? 1 : 2, kGroups = DP / 8 / kG;
  lane = opaque(lane);
  const int r = m0 + 16 * opaque(warp) + lane / 4;
  // column lane % 4 of row r's eight 16-byte chunks, in the order before the
  // swizzle; row r + 8 lies 1024 bytes on, panel p p * arows * 128 bytes on
  const uint32_t row = smem_u32(a) + r * kRowBytes + (lane % 4) * 4;
  uint32_t chunk[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) chunk[c] = row + ((c ^ (r % 8)) << 4);
  uint32_t hi[2][kG][4], lo[2][kG][4];
  float fresh[2][N];
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
#pragma unroll
    for (int e = 0; e < kG; ++e) {
      const int kk = g * kG + e, c = 2 * (kk % 4);
      const uint32_t po = (kk / 4) * arows * kRowBytes;
      uint32_t(&h)[4] = hi[g % 2][e];
      uint32_t(&l)[4] = lo[g % 2][e];
      split_tf32(__uint_as_float(lds_u32(chunk[c] + po)), h[0], l[0]);
      split_tf32(__uint_as_float(lds_u32(chunk[c] + po + 8 * kRowBytes)), h[1], l[1]);
      split_tf32(__uint_as_float(lds_u32(chunk[c + 1] + po)), h[2], l[2]);
      split_tf32(__uint_as_float(lds_u32(chunk[c + 1] + po + 8 * kRowBytes)), h[3], l[3]);
    }
    wgmma_fence();
#pragma unroll
    for (int e = 0; e < kG; ++e) {
      const int kk = g * kG + e;
      const uint64_t bh = desc_kmajor(b_hi, brows, 0, kk), bl = desc_kmajor(b_lo, brows, 0, kk);
      wgmma_rs_tf32(fresh[g % 2], lo[g % 2][e], bh, e > 0);
      wgmma_rs_tf32(fresh[g % 2], hi[g % 2][e], bl, 1);
      wgmma_rs_tf32(fresh[g % 2], hi[g % 2][e], bh, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (g > 0) {
      fence_regs(fresh[(g - 1) % 2]);
#pragma unroll
      for (int i = 0; i < N; ++i) d[i] += fresh[(g - 1) % 2][i];
    }
  }
  wgmma_wait<0>();
  fence_regs(fresh[(kGroups - 1) % 2]);
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] += fresh[(kGroups - 1) % 2][i];
}

// acc += A B^T in 3xTF32 over kSteps k-steps, summed in a fresh accumulator
// and then added in fp32: A = columns m0..m0 + 63 (m0 a multiple of 64) of
// the split tf32 tiles at shared-memory addresses a_hi and a_lo (arows rows,
// the reduced index; A is the tiles transposed, their values as they
// stand); B = the K-major tf32 tiles at b_hi, b_lo (brows rows). Thread
// (warp, lane) loads A's (m, k) = the tiles' (row k, column m) for m = m0 +
// 16 warp + lane / 4 [+ 8], k = 8 kk + lane % 4 [+ 4]: four offsets at kk 0,
// each k-step 1024 bytes on.
template <int kSteps, int N>
__device__ __forceinline__ void mma_cols_tf32_add(float (&acc)[N], uint32_t a_hi, uint32_t a_lo,
                                                  int arows, int m0, uint32_t b_hi,
                                                  uint32_t b_lo, int brows, int warp, int lane) {
  lane = opaque(lane);
  warp = opaque(warp);
  uint32_t off[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    off[j] = f32_offset(arows, lane % 4 + 4 * (j / 2), m0 + 16 * warp + lane / 4 + 8 * (j % 2));
  uint32_t hi[kSteps][4], lo[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      hi[kk][j] = lds_u32(a_hi + off[j] + kk * 8 * kRowBytes);
      lo[kk][j] = lds_u32(a_lo + off[j] + kk * 8 * kRowBytes);
    }
  float fresh[N];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const uint64_t bh = desc_kmajor(b_hi, brows, 0, kk), bl = desc_kmajor(b_lo, brows, 0, kk);
    wgmma_rs_tf32(fresh, lo[kk], bh, kk > 0);
    wgmma_rs_tf32(fresh, hi[kk], bl, 1);
    wgmma_rs_tf32(fresh, hi[kk], bh, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(fresh);
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += fresh[i];
}

// Element i of an m64nN accumulator fragment: row 16 warp + lane / 4 + 8 ((i
// / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2.
__device__ __forceinline__ int frag_row(int i, int warp, int lane) {
  return 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int frag_col(int i, int lane) {
  return 8 * (i / 4) + 2 * (lane % 4) + i % 2;
}

// An accumulator fragment x of m64n16 or m64n32 (8 or 16 registers), split
// into tf32 hi and lo, written as the K-major B tiles t_hi and t_lo: its 64
// rows, one 128-byte panel row each (16 columns take half of it), the
// columns the reduced index.
// A warp's 8-byte stores fill each 16-byte chunk of 8 rows twice: two
// wavefronts, as few as 256 bytes take.
template <int N>
__device__ __forceinline__ void store_frag_tf32(const float (&x)[N], uint8_t* t_hi, uint8_t* t_lo,
                                                int warp, int lane) {
  static_assert(N <= 16, "one 32-column panel");
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const int off = f32_offset(64, frag_row(i, warp, lane), frag_col(i, lane));
    uint32_t h0, l0, h1, l1;
    split_tf32(x[i], h0, l0);
    split_tf32(x[i + 1], h1, l1);
    *reinterpret_cast<uint2*>(t_hi + off) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(t_lo + off) = make_uint2(l0, l1);
  }
}
}  // namespace sm90

// ---- host: TMA tensor maps -----------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda at link time.
static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A map of a contiguous [B, S, H, D] tensor of T (bf16, fp16 or fp32) whose
// box is one 128-byte panel of `rows` rows of one (b, h), with the 128-byte
// swizzle; a box past D (a padded head_dim) reads zeros. Returns 0 or a
// CUDA error code.
template <typename T = __nv_bfloat16>
static int make_bshd_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D,
                         int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t e = sizeof(T);
  const CUtensorMapDataType type = std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : sm90::is_f16<T>()          ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * e, (cuuint64_t)H * D * e,
                                 (cuuint64_t)S * H * D * e};
  const cuuint32_t box[4] = {(cuuint32_t)(sm90::kRowBytes / e), 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// 1024-byte aligned start of dynamic shared memory (the launch asks for
// 1 KB more than the kernel's tiles need).
__device__ __forceinline__ uint8_t* align_1k(uint8_t* p) {
  const uint32_t s = sm90::smem_u32(p);
  return p + ((sm90::kAtomBytes - (s & (sm90::kAtomBytes - 1))) & (sm90::kAtomBytes - 1));
}

}  // namespace hvt
