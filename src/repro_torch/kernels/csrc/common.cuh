// Device helpers shared by the port's hand-written Hopper kernels:
// element conversion, 16-byte vector unpacking, warp reductions, and a
// register-tiled product over operands staged in shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16-byte vector of elements: 4 fp32 or 8 bf16
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int n = 4;
  __device__ static void unpack(const uint4& u, float* o) {
    o[0] = __uint_as_float(u.x);
    o[1] = __uint_as_float(u.y);
    o[2] = __uint_as_float(u.z);
    o[3] = __uint_as_float(u.w);
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void unpack(const uint4& u, float* o) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      o[2 * k] = f.x;
      o[2 * k + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Reductions over the 16 lanes that share a row in the 16 x 16 thread
// layout of tile_fma (thread id = 16 * ty + tx: lanes 0-15 and 16-31 of
// a warp are two rows).
__device__ __forceinline__ float row16_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float row16_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One fp32 product over operands in shared memory, for a block of 256
// threads laid out 16 x 16 (ty = tid / 16, tx = tid % 16). Thread
// (ty, tx) owns the outputs at rows ty + 16 i (i < TM) and columns
// tx + 16 j (j < TN):
//   acc[i][j] += sum_{k < K} At[k * lda + row] * Bk[k * ldb + col]
// Both operands are k-major, so a warp reads two addresses of At
// (broadcast) and 16 consecutive ones of Bk (no bank conflict). Rows and
// columns past the caller's extent are read too: the caller keeps them
// finite (zero-filled) and does not store their outputs.
template <int TM, int TN>
__device__ __forceinline__ void tile_fma(const float* At, int lda,
                                         const float* Bk, int ldb, int K,
                                         int ty, int tx,
                                         float (&acc)[TM][TN]) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = At[k * lda + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = Bk[k * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Raise the dynamic shared-memory limit of `kernel` to `bytes` where that
// is above the limit already set, which the caller records in `*allowed`
// (a static of its launch function, starting at the default 48 KB).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes, size_t* allowed) {
  if (bytes <= *allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

}  // namespace repro
