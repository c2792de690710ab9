// wire_codec.cu: the wire codecs of the compressed allreduce, for Hopper
// (sm_90a).
//
// Replaces the C++ codecs of horovod_tpu/csrc/codecs.cc (Bf16Codec,
// BlockCodec<Int8BlockCodec>, BlockCodec<Fp8BlockCodec>: Compress, Decompress,
// Roundtrip) and the engine's error-feedback pass over one tensor
// (horovod_tpu/csrc/engine.cc:3273-3279). The results are the same bits:
//
//   bf16   round-to-nearest-even truncation of each fp32, 2 wire bytes each.
//   int8   per block of 256 fp32 elements: scale = absmax / 127 (IEEE
//          division), then the block's 4 scale bytes and one code per element,
//          code = rint(clamp(x * (1 / scale), -127, 127)); NaN lands on +127.
//   fp8    the same block layout, scale = absmax / 448, codes OCP e4m3 of
//          x * (1 / scale): NaN and |v| >= 448 saturate to sign|0x7E, values
//          below 2^-10 flush to a signed zero, the mantissa rounds to even.
//
// A block's absmax ignores NaN (std::max keeps its first operand), a
// non-finite absmax becomes FLT_MAX / 2, an all-zero block has scale 0 and
// zero codes. A tail of rem < 256 elements costs 4 + rem wire bytes.
//
// Design. One warp owns one block of 256 elements: lane l takes elements
// l + 32 j (j < 8), so each of the eight loads and byte stores is coalesced
// across the warp, and the absmax is a shuffle reduction. The scale travels
// as four byte stores, since a stream may start at any byte. Products and
// sums use the _rn intrinsics, so nvcc contracts nothing into an FMA that the
// C++ codecs do not have; build without --use_fast_math.
//
//   encode             x -> wire stream
//   decode_accumulate  wire stream -> acc (acc = v, or acc = acc + v)
//   ef_roundtrip       seg += r; saved = seg; seg = decode(encode(seg));
//                      r = saved - seg, in one pass (r may be null: a plain
//                      roundtrip)
//
// Bound: each is a pass over memory. Encode reads 4n bytes and writes about
// n (int8, fp8) or 2n (bf16); decode_accumulate reads the stream and 4n (when
// accumulating) and writes 4n; ef_roundtrip reads and writes seg and r, 16n.
#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

namespace hvt {
namespace {

constexpr int kBlock = 256;             // fp32 elements per codec block
constexpr int kWireBlock = 4 + kBlock;  // in-band scale, then the codes
constexpr int kPerLane = kBlock / 32;
constexpr int kWarpsPerCta = 8;
constexpr int kBf16 = 1, kInt8 = 2, kFp8 = 3;

__device__ __forceinline__ uint16_t float_to_bf16(float v) {
  const uint32_t f = __float_as_uint(v);
  const uint32_t rounding = 0x7fffu + ((f >> 16) & 1u);
  return static_cast<uint16_t>((f + rounding) >> 16);
}

__device__ __forceinline__ float bf16_to_float(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

__device__ __forceinline__ uint8_t int8_encode(float v) {
  v = fmaxf(-127.f, fminf(127.f, v));  // fminf(127, NaN) is 127
  return static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(v)));
}

__device__ __forceinline__ float int8_decode(uint8_t b) {
  return static_cast<float>(static_cast<int8_t>(b));
}

// e4m3 of a = |p| with the sign byte given (fp8_sign below).
__device__ __forceinline__ uint8_t fp8_encode(float a, uint8_t sign) {
  if (isnan(a)) return sign | 0x7E;
  if (a >= 448.f) return sign | 0x7E;
  if (a < 0x1p-10f) return sign;
  // a is normal here: a = g 2^e with g in [1, 2)
  int e = static_cast<int>((__float_as_uint(a) >> 23) & 0xFF) - 127;
  if (e < -6) e = -6;  // the subnormal range: exponent field 0
  // a / 2^(e - 3), exact: a product with the power of two 2^(3 - e)
  const float inv_step = __uint_as_float(static_cast<uint32_t>(130 - e) << 23);
  float q = rintf(__fmul_rn(a, inv_step));
  if (q >= 16.f) {
    q = __fmul_rn(q, 0.5f);
    e += 1;
  }
  if (e > 8 || (e == 8 && q > 14.f)) return sign | 0x7E;
  const int iq = static_cast<int>(q);
  if (iq < 8) return sign | static_cast<uint8_t>(iq);
  return sign | static_cast<uint8_t>(((e + 7) << 3) | (iq - 8));
}

// The sign bit that p = x * inv has on x86, where the C++ codec runs: a NaN
// operand passes its own sign on, and 0 * inf gives the negative default NaN.
// The card's NaN results are positive, so the NaN cases are spelled out.
__device__ __forceinline__ uint8_t fp8_sign(float x, float p) {
  const uint32_t bits = !isnan(p) ? __float_as_uint(p)
                        : isnan(x) ? __float_as_uint(x)
                                   : 0x80000000u;
  return static_cast<uint8_t>((bits >> 24) & 0x80u);
}

__device__ __forceinline__ float fp8_decode(uint8_t b) {
  const float sign = (b & 0x80) ? -1.f : 1.f;
  const int exp = (b >> 3) & 0xF, man = b & 7;
  if (exp == 0xF && man == 7) return sign * 448.f;
  const float val = exp == 0
                        ? ldexpf(static_cast<float>(man), -9)
                        : ldexpf(1.0f + static_cast<float>(man) / 8.0f, exp - 7);
  return sign * val;
}

// The code of element x in a block whose scale has reciprocal inv.
template <int C>
__device__ __forceinline__ uint8_t block_encode(float x, float inv) {
  const float p = __fmul_rn(x, inv);
  if constexpr (C == kInt8) return int8_encode(p);
  else return fp8_encode(fabsf(p), fp8_sign(x, p));
}

template <int C>
__device__ __forceinline__ float block_decode(uint8_t b) {
  if constexpr (C == kInt8) return int8_decode(b);
  else return fp8_decode(b);
}

template <int C>
__device__ __forceinline__ float max_code() {
  return C == kInt8 ? 127.f : 448.f;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The scale of a block whose elements this lane holds in x (absmax over the
// warp; NaN ignored, as std::max(amax, NaN) keeps amax).
template <int C>
__device__ __forceinline__ float block_scale(const float (&x)[kPerLane], int lane,
                                             int m) {
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j)
    if (lane + 32 * j < m) amax = fmaxf(amax, fabsf(x[j]));
  amax = warp_max(amax);
  if (!isfinite(amax)) amax = FLT_MAX * 0.5f;
  return amax > 0.f ? __fdiv_rn(amax, max_code<C>()) : 0.f;
}

__device__ __forceinline__ void store_scale(uint8_t* dst, float scale) {
  const uint32_t s = __float_as_uint(scale);
#pragma unroll
  for (int b = 0; b < 4; ++b) dst[b] = static_cast<uint8_t>(s >> (8 * b));
}

__device__ __forceinline__ float load_scale(const uint8_t* src) {
  uint32_t s = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) s |= static_cast<uint32_t>(src[b]) << (8 * b);
  return __uint_as_float(s);
}

// The warp's block: its index, first element and element count (0 when the
// warp is past the end).
struct WarpBlock {
  long long blk, base;
  int m, lane;
};

__device__ __forceinline__ WarpBlock warp_block(long long n) {
  WarpBlock w;
  w.lane = threadIdx.x & 31;
  w.blk = static_cast<long long>(blockIdx.x) * kWarpsPerCta + (threadIdx.x >> 5);
  w.base = w.blk * kBlock;
  const long long left = n - w.base;
  w.m = left <= 0 ? 0 : (left < kBlock ? static_cast<int>(left) : kBlock);
  return w;
}

template <int C>
__global__ void __launch_bounds__(32 * kWarpsPerCta)
    encode_kernel(const float* __restrict__ x, uint8_t* __restrict__ out, long long n) {
  const WarpBlock w = warp_block(n);
  if (w.m == 0) return;
  if constexpr (C == kBf16) {
    uint16_t* o = reinterpret_cast<uint16_t*>(out) + w.base;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int i = w.lane + 32 * j;
      if (i < w.m) o[i] = float_to_bf16(x[w.base + i]);
    }
  } else {
    float v[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int i = w.lane + 32 * j;
      v[j] = i < w.m ? x[w.base + i] : 0.f;
    }
    const float scale = block_scale<C>(v, w.lane, w.m);
    uint8_t* dst = out + w.blk * kWireBlock;
    if (w.lane == 0) store_scale(dst, scale);
    const float inv = scale > 0.f ? __frcp_rn(scale) : 0.f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int i = w.lane + 32 * j;
      if (i < w.m) dst[4 + i] = scale > 0.f ? block_encode<C>(v[j], inv) : 0;
    }
  }
}

template <int C>
__global__ void __launch_bounds__(32 * kWarpsPerCta)
    decode_kernel(const uint8_t* __restrict__ in, float* __restrict__ acc, long long n,
                  int accumulate) {
  const WarpBlock w = warp_block(n);
  if (w.m == 0) return;
  float* a = acc + w.base;
  if constexpr (C == kBf16) {
    const uint16_t* s = reinterpret_cast<const uint16_t*>(in) + w.base;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int i = w.lane + 32 * j;
      if (i < w.m) {
        const float v = bf16_to_float(s[i]);
        a[i] = accumulate ? __fadd_rn(a[i], v) : v;
      }
    }
  } else {
    const uint8_t* src = in + w.blk * kWireBlock;
    const float scale = load_scale(src);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int i = w.lane + 32 * j;
      if (i < w.m) {
        const float v = __fmul_rn(block_decode<C>(src[4 + i]), scale);
        a[i] = accumulate ? __fadd_rn(a[i], v) : v;
      }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(32 * kWarpsPerCta)
    ef_kernel(float* __restrict__ seg, float* __restrict__ r, long long n) {
  const WarpBlock w = warp_block(n);
  if (w.m == 0) return;
  float* s = seg + w.base;
  float* res = r == nullptr ? nullptr : r + w.base;
  float v[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int i = w.lane + 32 * j;
    v[j] = 0.f;
    if (i < w.m) v[j] = res == nullptr ? s[i] : __fadd_rn(s[i], res[i]);
  }
  float out[kPerLane];
  if constexpr (C == kBf16) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) out[j] = bf16_to_float(float_to_bf16(v[j]));
  } else {
    const float scale = block_scale<C>(v, w.lane, w.m);
    const float inv = scale > 0.f ? __frcp_rn(scale) : 0.f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const uint8_t code = scale > 0.f ? block_encode<C>(v[j], inv) : 0;
      out[j] = __fmul_rn(block_decode<C>(code), scale);
    }
  }
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int i = w.lane + 32 * j;
    if (i < w.m) {
      s[i] = out[j];
      if (res != nullptr) res[i] = __fsub_rn(v[j], out[j]);
    }
  }
}

dim3 grid_for(long long n) {
  const long long blocks = (n + kBlock - 1) / kBlock;
  return dim3(static_cast<unsigned>((blocks + kWarpsPerCta - 1) / kWarpsPerCta));
}

constexpr int kThreads = 32 * kWarpsPerCta;

int finish() { return static_cast<int>(cudaGetLastError()); }

}  // namespace
}  // namespace hvt

using namespace hvt;

// codec: 1 bf16, 2 int8, 3 fp8 (the wire ids of horovod_tpu/csrc/codecs.h).
// Returns 0 or a cudaError_t; an unknown codec is cudaErrorInvalidValue.
extern "C" int hvt_wire_encode(const float* x, uint8_t* out, long long n, int codec,
                               cudaStream_t stream) {
  if (n <= 0) return 0;
  switch (codec) {
    case kBf16: encode_kernel<kBf16><<<grid_for(n), kThreads, 0, stream>>>(x, out, n); break;
    case kInt8: encode_kernel<kInt8><<<grid_for(n), kThreads, 0, stream>>>(x, out, n); break;
    case kFp8: encode_kernel<kFp8><<<grid_for(n), kThreads, 0, stream>>>(x, out, n); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return finish();
}

extern "C" int hvt_wire_decode_accumulate(const uint8_t* in, float* acc, long long n,
                                          int accumulate, int codec, cudaStream_t stream) {
  if (n <= 0) return 0;
  switch (codec) {
    case kBf16:
      decode_kernel<kBf16><<<grid_for(n), kThreads, 0, stream>>>(in, acc, n, accumulate);
      break;
    case kInt8:
      decode_kernel<kInt8><<<grid_for(n), kThreads, 0, stream>>>(in, acc, n, accumulate);
      break;
    case kFp8:
      decode_kernel<kFp8><<<grid_for(n), kThreads, 0, stream>>>(in, acc, n, accumulate);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return finish();
}

extern "C" int hvt_wire_ef_roundtrip(float* seg, float* r, long long n, int codec,
                                     cudaStream_t stream) {
  if (n <= 0) return 0;
  switch (codec) {
    case kBf16: ef_kernel<kBf16><<<grid_for(n), kThreads, 0, stream>>>(seg, r, n); break;
    case kInt8: ef_kernel<kInt8><<<grid_for(n), kThreads, 0, stream>>>(seg, r, n); break;
    case kFp8: ef_kernel<kFp8><<<grid_for(n), kThreads, 0, stream>>>(seg, r, n); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return finish();
}

extern "C" const char* hvt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
