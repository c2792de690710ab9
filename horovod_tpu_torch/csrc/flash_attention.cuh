// Shared pieces of the flash-attention kernels of horovod_tpu_torch, written
// for Hopper (sm_90a): the layout contract, constants and launch helper of
// all six, and the tile staging of the three SIMT kernels (flash_fwd.cu,
// flash_dq.cu, flash_dkv.cu). The tensor-core kernels' own pieces are in
// sm90.cuh.
//
// Layout contract, checked by the Python wrappers in ops/_kernels.py:
//   q, k, v, o, dO   [B, S, H, D] contiguous (k and v carry H_kv heads)
//   lse, delta       [B, H, S] fp32 contiguous
//   H % H_kv == 0, D % 8 == 0 (the wrappers pad other head_dims with zero
//   columns), any S; 0 < D <= 128 for the SIMT kernels (fp32 or bf16); on
//   the tensor cores 0 < D <= 512 for bf16 or fp16 q with o and dO in q's
//   dtype, 0 < D <= 256 for bf16 or fp16 q with an fp32 o and dO, and for
//   fp32 q with fp32 o and dO.
//
// Every SIMT kernel works on 64 x 64 tiles with 256 threads laid out 16 x 16:
// thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j (i, j < 4) of a
// score tile, and columns tx + 16 j (j < DJ) of a head-dim row. Tiles are
// staged in shared memory as fp32 with a row stride of D + 1 (odd), so the
// 16 threads of a half-warp that read 16 different rows of one column hit
// 16 different banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace hvt {

constexpr int kTile = 64;         // query rows and key rows per tile
constexpr int kThreads = 256;     // 16 x 16
constexpr int kPadS = kTile + 1;  // row stride of a 64 x 64 score tile in shared memory
constexpr int kMaxD = 128;       // the SIMT kernels' widest head
constexpr int kMaxDSm90 = 512;   // the tensor-core kernels': 2-byte q, o/dO in q's dtype
constexpr int kMaxDSm90F32 = 256;  // theirs with fp32 q, or with an fp32 o/dO
constexpr float kMasked = -1e30f;  // the reference's fill for causally masked scores

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// The widest head_dim a tensor-core kernel takes with q of `dtype` and o (dO)
// of `second`: a C caller past it gets cudaErrorInvalidValue at the entry
// point, never a launch.
inline int sm90_max_d(int dtype, int second) {
  return dtype != kF32 && second == dtype ? kMaxDSm90 : kMaxDSm90F32;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copies rows [row0, row0 + kTile) of one head of a [B, S, H, D] tensor into
// a [kTile][ld] fp32 tile in shared memory; rows at or past S read as zeros.
// `src` points at (b, 0, h, 0); consecutive threads read consecutive d.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, int row0,
                                          int S, long long row_stride, int D, int ld) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int s = row0 + r;
    dst[r * ld + d] = s < S ? to_f32(src[(long long)s * row_stride + d]) : 0.f;
  }
}

// Reductions over the 16 lanes (tx = 0..15) that share one ty: lanes 0-15 and
// 16-31 of a warp hold two different ty, and xor offsets below 16 never mix them.
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

inline bool valid_shape(int B, int S, int H, int Hkv, int D, int max_d = kMaxD) {
  return B >= 0 && S >= 0 && H > 0 && Hkv > 0 && H % Hkv == 0 && D > 0 && D <= max_d &&
         D % 8 == 0;
}

// The kernel instance that this library's last launch_n launched
// (hvt_last_launch_attributes reads its registers and shared memory).
inline const void*& last_kernel() {
  static const void* kernel = nullptr;
  return kernel;
}

// Raises the kernel's dynamic shared-memory limit (needed above 48 KB), then
// launches it with `threads` threads a block and reports the launch's error,
// if any.
template <typename Kernel, typename... Args>
inline int launch_n(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                    Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  last_kernel() = reinterpret_cast<const void*>(kernel);
  return (int)cudaGetLastError();
}

template <typename Kernel, typename... Args>
inline int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, Args... args) {
  return launch_n(kernel, grid, kThreads, smem, stream, args...);
}

}  // namespace hvt

extern "C" const char* hvt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Registers a thread and shared memory a block (dynamic, as launched, plus
// static) of the kernel instance this library launched last. Returns 0 or a
// CUDA error code.
extern "C" int hvt_last_launch_attributes(int* regs, int* smem) {
  const void* kernel = hvt::last_kernel();
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *smem = attr.maxDynamicSharedSizeBytes + (int)attr.sharedSizeBytes;
  return 0;
}
