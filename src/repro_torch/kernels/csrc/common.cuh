// Device helpers shared by the port's hand-written Hopper kernels:
// element conversion, 16-byte vector unpacking, warp reductions, a
// register-tiled fp32 product over operands staged in shared memory,
// cp.async staging, the wgmma (Hopper tensor-core) building blocks, and
// the split-K decode attention walk (partials, split and combine kernels)
// shared by dense and paged decode.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
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

// 16-byte vector of 8 bf16 elements
template <typename T> struct Vec16;
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

// ---------------------------------------------------------------- cp.async
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; `src_bytes` < 16 zero-fills the rest (0
// gives a zero vector; `src` must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------------- wgmma
// Tiles for wgmma live in shared memory in the 128-byte swizzled layout: a
// [rows][cols] bf16 tile is cut into 64-column (128-byte) blocks stored
// one after another, each [rows][64]; row r of a block is 128 bytes at
// r * 128, and its 16-byte chunk c sits at chunk c ^ (r % 8). Blocks start
// on 1024-byte boundaries, so this is the layout the descriptor's
// swizzle mode 1 (128B) reads.
__device__ __forceinline__ uint32_t sw128_offset(int row, int chunk) {
  return (uint32_t)row * 128u + ((uint32_t)(chunk ^ (row & 7)) << 4);
}

// Matrix descriptor of a 128B-swizzled operand at shared address `addr`:
// `lbo` and `sbo` in bytes (leading and stride byte offsets).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Writes through the generic proxy (cp.async, st.shared) made visible to
// the async proxy that wgmma reads shared memory through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 2^x by the SFU (ex2.approx.ftz: relative error about 2^-22, results
// below 2^-126 flushed to 0; -inf gives 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// D[64 x N] (+)= A[64 x 16] * B[16 x N], bf16 in, fp32 accumulate, for
// one warpgroup. wgmma_ss_nN (N 64, 128): A and B from shared memory
// through descriptors, both K-major. wgmma_rs_nN (N 64, 80, 96, 112, 128,
// 160, 192, 256: flash attention's kernel widths): A from registers (the
// accumulator layout of a previous product, packed to bf16x2), B through
// a descriptor, MN-major (transposed). The accumulator layout: warp w of
// the warpgroup, lane l holds d[4j + e] at row 16 w + l / 4 + 8 (e / 2),
// column 8 j + 2 (l % 4) + e % 2. scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n112(float (&d)[56],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n160(float (&d)[80],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}



// ------------------------------------------------------- split-K decode
// One query token per (batch, query head) row against K/V rows that a
// position maps to, cut into `n_split` ranges of `span` positions: the
// walk shared by dense decode (decode_attention.cu: a strided row per
// position) and paged decode (paged_decode.cu: a block-table lookup).
// Each .cu file supplies that mapping as a `Rows` type and its own C
// entry point; the split kernel, the combine kernel and their launch are
// here.
//
// Partials of a split-K decode call, fp32, in a workspace of
// rows * n_split * (D + 2) floats that the caller allocates. For each of
// the `rows` (batch, query head) rows and each split:
//   acc [rows][n_split][D]  sum over the split's keys of p * v (not
//                           normalised)
//   m   [rows][n_split]     the scores' max over the split (-inf: empty)
//   l   [rows][n_split]     sum of p = exp(score - m) (0: empty)
struct SplitPartials {
  float* acc;
  float* m;
  float* l;
  int n_split, D;

  __host__ __device__ SplitPartials(float* ws, size_t rows, int n_split_,
                                    int D_)
      : acc(ws),
        m(ws + rows * n_split_ * D_),
        l(ws + rows * n_split_ * (D_ + 1)),
        n_split(n_split_),
        D(D_) {}
  __device__ size_t at(size_t row, int split) const {
    return row * n_split + split;
  }
};

// An empty split (no key below the row's length): m = -inf, l = 0,
// acc = 0, written by threads `tid` of `nthreads` for `n_rows` rows.
__device__ __forceinline__ void write_empty_partials(const SplitPartials& p,
                                                     size_t row0, int n_rows,
                                                     int split, int tid,
                                                     int nthreads) {
  for (int i = tid; i < n_rows * p.D; i += nthreads) {
    const int r = i / p.D;
    p.acc[p.at(row0 + r, split) * p.D + (i - r * p.D)] = 0.f;
  }
  for (int r = tid; r < n_rows; r += nthreads) {
    p.m[p.at(row0 + r, split)] = -INFINITY;
    p.l[p.at(row0 + r, split)] = 0.f;
  }
}

// One output row from its splits: with M the largest split max and
// w_i = exp(m_i - M) (0 for an empty split),
//   out = sum_i w_i acc_i / sum_i w_i l_i,
// the guards of the single-pass kernels kept: a row whose splits are all
// empty (length 0) has every w_i = 0 and acc_i = 0, so it is exactly zero,
// and a zero denominator divides by 1. Run by a whole block of `nthreads`
// (>= 32) threads, with one barrier; `w` is shared scratch of n_split + 1
// floats. The first warp reads every split's (m, l) at once and reduces
// them with shuffles; then each thread sums its columns over the splits.
template <typename T>
__device__ __forceinline__ void combine_split_row(const SplitPartials& p,
                                                  size_t row, T* out,
                                                  float* w, int tid,
                                                  int nthreads) {
  const float* m = p.m + p.at(row, 0);
  const float* l = p.l + p.at(row, 0);
  const float* acc = p.acc + p.at(row, 0) * p.D;
  if (tid < 32) {
    float M = -INFINITY;
    for (int i = tid; i < p.n_split; i += 32) M = fmaxf(M, m[i]);
    M = warp_max(M);
    float den = 0.f;
    for (int i = tid; i < p.n_split; i += 32) {
      const float wi = isinf(m[i]) ? 0.f : expf(m[i] - M);
      w[i] = wi;
      den += wi * l[i];
    }
    den = warp_sum(den);
    if (tid == 0) w[p.n_split] = 1.f / (den == 0.f ? 1.f : den);
  }
  __syncthreads();
  const float inv = w[p.n_split];
  for (int d = tid; d < p.D; d += nthreads) {
    float num = 0.f;
#pragma unroll 4
    for (int i = 0; i < p.n_split; ++i) num += w[i] * acc[(size_t)i * p.D + d];
    out[d] = from_f<T>(num * inv);
  }
}

namespace split_decode {

// A row of D elements is read in vectors of VB bytes (16, 8, 4, or 2 for
// bf16): the widest that divides the row and every address a row can
// start at, chosen at launch (row_vec_bytes). A row that is not a whole
// number of 16-byte vectors thus needs no padded copy of the cache.
template <int VB> struct VecBits;
template <> struct VecBits<16> { using type = uint4; };
template <> struct VecBits<8> { using type = uint2; };
template <> struct VecBits<4> { using type = uint32_t; };
template <> struct VecBits<2> { using type = uint16_t; };

// the VB / sizeof(T) elements at p (VB-aligned) as fp32
template <typename T, int VB>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  using V = typename VecBits<VB>::type;
  const V u = *reinterpret_cast<const V*>(p);
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < VB / (int)sizeof(T); ++i) f[i] = to_f(e[i]);
}

// VB bytes global -> shared: cp.async (16 through L2 only, 8 and 4 through
// L1), or a plain copy for 2 (cp.async has no 2-byte form); either is
// visible to the block after cp_async_wait and a barrier
template <int VB, typename T>
__device__ __forceinline__ void copy_vec(T* dst, const T* src) {
  if constexpr (VB == 16) {
    cp_async16(smem_addr(dst), src);
  } else if constexpr (VB == 2) {
    *reinterpret_cast<uint16_t*>(dst) =
        *reinterpret_cast<const uint16_t*>(src);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(VB)
                 : "memory");
  }
}

// The widest vector (16, 8, 4 or 2 bytes, at least one element of
// `es` bytes) that divides the row of D elements and each of `n`
// element strides and byte addresses.
inline int row_vec_bytes(int D, int es, const long long* strides, int n,
                         const void* const* ptrs, int n_ptrs) {
  int vb = 16;
  auto fits = [&](int b) {
    if ((long long)D * es % b) return false;
    for (int i = 0; i < n; ++i)
      if (strides[i] * es % b) return false;
    for (int i = 0; i < n_ptrs; ++i)
      if (reinterpret_cast<uintptr_t>(ptrs[i]) % b) return false;
    return true;
  };
  while (vb > es && !fits(vb)) vb /= 2;
  return vb;
}

constexpr int kThreads = 256;  // the split kernel's block
constexpr int kWarps = kThreads / 32;
constexpr int kCombineThreads = 128;
constexpr int kQVecs = 2;  // 16-byte q vectors a lane keeps in registers

struct SmemLayout {  // byte offsets into dynamic shared memory
  size_t q, k, v, p, acc, m, l, ids, total;
  __host__ __device__ SmemLayout(int R, int D, int Tc, int es, int n_ids) {
    const size_t stage = (size_t)Tc * D * es;
    q = 0;                                        // [R][D] fp32, pre-scaled
    k = q + sizeof(float) * R * D;                // [2][Tc][D] T
    v = k + 2 * stage;                            // [2][Tc][D] T
    p = v + 2 * stage;                            // [kWarps][Tc] fp32
    acc = p + sizeof(float) * kWarps * Tc;        // [R][D] fp32
    const int items = R > kWarps ? R : kWarps;   // R * parts <= items
    m = acc + sizeof(float) * R * D;              // [items] fp32
    l = m + sizeof(float) * items;                // [items] fp32
    ids = l + sizeof(float) * items;              // [n_ids] int: Rows' own
    total = ids + sizeof(int) * n_ids;
  }
};

// Issue the copies of `nt` tokens starting at position `s0` into stage
// buffers kd and vd (VB bytes a copy); `rows` maps a position to its K
// and V rows.
template <typename T, typename Rows, int VB>
__device__ __forceinline__ void load_chunk(T* kd, T* vd, const Rows& rows,
                                           int s0, int nt, int D, int tid) {
  constexpr int kVec = VB / sizeof(T);
  const int row_vecs = D / kVec;
  for (int i = tid; i < nt * row_vecs; i += kThreads) {
    const int t = i / row_vecs;
    const int d = (i - t * row_vecs) * kVec;
    copy_vec<VB>(kd + t * D + d, rows.k_row(s0 + t) + d);
    copy_vec<VB>(vd + t * D + d, rows.v_row(s0 + t) + d);
  }
  cp_async_commit();
}

// U consecutive elements (U = 2: an aligned pair, U = 1: one) as fp32
template <int U>
__device__ __forceinline__ float2 unit_f(const float* p) {
  if constexpr (U == 2) return *reinterpret_cast<const float2*>(p);
  else return make_float2(*p, 0.f);
}
template <int U>
__device__ __forceinline__ float2 unit_f(const __nv_bfloat16* p) {
  if constexpr (U == 2)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  else return make_float2(__bfloat162float(*p), 0.f);
}
template <int U>
__device__ __forceinline__ void unit_store(float* p, float2 a) {
  if constexpr (U == 2) *reinterpret_cast<float2*>(p) = a;
  else *p = a.x;
}

// Grid (B * KV, n_split): the block of (row, KV head, split) walks
// positions [split * span, min((split + 1) * span, length, S)) through a
// two-stage ring of Tc-token chunks and writes the partial of each of
// its R query heads. `rows` is the caller's mapping: `bind` points it at
// (row, KV head) and the split's positions, using `ids` (shared memory
// of `n_ids` ints, which the launch sizes) if it needs to (then with
// kUsesIds set, and a barrier follows); `k_row(pos)` / `v_row(pos)` give
// a position's rows, read in vectors of VB bytes.
template <typename T, typename Rows, int VB>
__global__ void __launch_bounds__(kThreads)
split_kernel(const T* __restrict__ q, Rows rows,
             const int* __restrict__ lengths, float* __restrict__ ws, int B,
             int KV, int R, int D, int S, int Tc, int span, int n_split,
             int n_ids, float scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  const SmemLayout L(R, D, Tc, sizeof(T), n_ids);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  T* k_s = reinterpret_cast<T*>(smem + L.k);
  T* v_s = reinterpret_cast<T*>(smem + L.v);
  float* p_s = reinterpret_cast<float*>(smem + L.p);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);
  int* ids = reinterpret_cast<int*>(smem + L.ids);

  // the combine kernel may be scheduled now: it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int row = blockIdx.x / KV;
  const int kvh = blockIdx.x % KV;
  const int split = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t head0 = ((size_t)row * KV + kvh) * R;  // first query head
  const SplitPartials part(ws, (size_t)B * KV * R, n_split, D);

  const int n = max(0, min(lengths[row], S));  // early stop
  const int s0 = split * span;
  const int s1 = min(s0 + span, n);
  if (s0 >= s1) {
    write_empty_partials(part, head0, R, split, tid, kThreads);
    return;
  }
  rows.bind(row, kvh, s0, s1, ids, tid, kThreads);
  if (Rows::kUsesIds) __syncthreads();
  const int n_chunks = (s1 - s0 + Tc - 1) / Tc;
  load_chunk<T, Rows, VB>(k_s, v_s, rows, s0, min(Tc, s1 - s0), D, tid);

  const T* q_row = q + head0 * D;
  for (int i = tid; i < R * D; i += kThreads) {
    q_s[i] = to_f(q_row[i]) * scale;
    acc[i] = 0.f;
  }
  // Work items of this warp: (head r, part of D). With R >= kWarps a warp
  // owns whole heads w, w + kWarps, ...; with fewer heads, `parts` warps
  // share one head, each computing its scores and softmax (identical) and
  // accumulating its own part of D. Item state lives at index r * parts +
  // part of m_s and l_s, touched by its warp only.
  const int parts = R >= kWarps ? 1 : kWarps / R;
  const int first = R >= kWarps ? warp : warp / parts;
  const int step = R >= kWarps ? kWarps : R;  // a shared head is one item
  // p @ v runs over units of U elements: aligned pairs where a vector
  // holds two, else single elements (a row of odd length)
  constexpr int U = VB >= 2 * (int)sizeof(T) ? 2 : 1;
  const int pairs = D / U;
  const int part_pairs = (pairs + parts - 1) / parts;
  const int my_part = R >= kWarps ? 0 : warp % parts;
  const bool has_work = R >= kWarps || warp < R * parts;
  if (has_work && lane == 0)
    for (int r = first; r < R; r += step) {
      m_s[r * parts + my_part] = -INFINITY;
      l_s[r * parts + my_part] = 0.f;
    }

  // lanes per token in the score phase: a power of two <= 32 that covers
  // the row's vectors in as few passes as possible; lane `sub` of a
  // token's group takes vectors sub, sub + lpt, ...
  constexpr int kVec = VB / sizeof(T);
  const int row_vecs = D / kVec;
  int lpt = 1;
  while (lpt < 32 && lpt < row_vecs) lpt <<= 1;
  const int group = lane / lpt, sub = lane % lpt, groups = 32 / lpt;
  float* p_w = p_s + warp * Tc;  // this warp's probability row

  for (int c = 0; c < n_chunks; ++c) {
    const int st = c & 1;
    cp_async_wait<0>();
    __syncthreads();  // chunk c landed for all; chunk c - 1's readers done
    const int c0 = s0 + c * Tc;
    if (c + 1 < n_chunks) {
      const int nx = c0 + Tc;
      load_chunk<T, Rows, VB>(k_s + (st ^ 1) * Tc * D,
                              v_s + (st ^ 1) * Tc * D, rows, nx,
                              min(Tc, s1 - nx), D, tid);
    }
    if (!has_work) continue;
    const int nt = min(Tc, s1 - c0);
    const T* kc = k_s + st * Tc * D;
    const T* vc = v_s + st * Tc * D;
    for (int r = first; r < R; r += step) {
      const float* qr = q_s + r * D;
      // this lane's first kQVecs vectors of q in registers (the rest, for
      // rows over 32 * kQVecs vectors, are read from shared memory)
      float qv[kQVecs][kVec];
#pragma unroll
      for (int v_ = 0; v_ < kQVecs; ++v_) {
        const int j = sub + v_ * lpt;
#pragma unroll
        for (int u = 0; u < kVec; ++u)
          qv[v_][u] = j < row_vecs ? qr[j * kVec + u] : 0.f;
      }
      // scores: `lpt` lanes across D per token, `groups` tokens at a time
#pragma unroll 2
      for (int tb = 0; tb < nt; tb += groups) {
        const int t = tb + group;
        float s = 0.f;
        if (t < nt) {
          const T* kr = kc + t * D;
#pragma unroll
          for (int v_ = 0; v_ < kQVecs; ++v_) {
            const int j = sub + v_ * lpt;
            if (j < row_vecs) {
              float kf[kVec];
              load_vec<T, VB>(kr + j * kVec, kf);
#pragma unroll
              for (int u = 0; u < kVec; ++u) s += qv[v_][u] * kf[u];
            }
          }
          for (int j = sub + kQVecs * lpt; j < row_vecs; j += lpt) {
            float kf[kVec];
            load_vec<T, VB>(kr + j * kVec, kf);
#pragma unroll
            for (int u = 0; u < kVec; ++u) s += qr[j * kVec + u] * kf[u];
          }
        }
        for (int o = lpt >> 1; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (t < nt && sub == 0) p_w[t] = s;
      }
      __syncwarp();
      // online softmax over the chunk, with the TPU kernels' -inf guards
      float mx = -INFINITY;
      for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, p_w[t]);
      mx = warp_max(mx);
      const int item = r * parts + my_part;
      const float m_prev = m_s[item];
      const float m_new = fmaxf(m_prev, mx);
      const float safe = isinf(m_new) ? 0.f : m_new;
      float sum = 0.f;
      for (int t = lane; t < nt; t += 32) {
        const float e = expf(p_w[t] - safe);
        p_w[t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      const float alpha = isinf(m_prev) ? 0.f : expf(m_prev - safe);
      __syncwarp();
      if (lane == 0) {
        m_s[item] = m_new;
        l_s[item] = l_s[item] * alpha + sum;
      }
      // acc = acc * alpha + p @ v over this item's pairs of D
      const int p_end = min(pairs, (my_part + 1) * part_pairs);
      for (int pr = my_part * part_pairs + lane; pr < p_end; pr += 32) {
        float2 a = unit_f<U>(acc + r * D + U * pr);
        a.x *= alpha;
        a.y *= alpha;
#pragma unroll 4
        for (int t = 0; t < nt; ++t) {
          const float w = p_w[t];
          const float2 vv = unit_f<U>(vc + t * D + U * pr);
          a.x += w * vv.x;
          a.y += w * vv.y;
        }
        unit_store<U>(acc + r * D + U * pr, a);
      }
      __syncwarp();  // p_w is rewritten by the next item
    }
  }

  // this warp's items to the workspace
  if (!has_work) return;
  for (int r = first; r < R; r += step) {
    const size_t at = part.at(head0 + r, split);
    const int p_end = min(pairs, (my_part + 1) * part_pairs);
    for (int pr = my_part * part_pairs + lane; pr < p_end; pr += 32)
      unit_store<U>(part.acc + at * D + U * pr,
                    unit_f<U>(acc + r * D + U * pr));
    if (my_part == 0 && lane == 0) {
      part.m[at] = m_s[r * parts];
      part.l[at] = l_s[r * parts];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(float* __restrict__ ws, T* __restrict__ out, int rows,
               int n_split, int D) {
  extern __shared__ float w[];  // n_split + 1 weights
  // launched early (programmatic dependent launch): wait until the split
  // kernel has finished and its partials are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const SplitPartials part(ws, rows, n_split, D);
  const size_t row = blockIdx.x;  // (batch, query head)
  combine_split_row(part, row, out + row * D, w, threadIdx.x,
                    kCombineThreads);
}

// Tokens per chunk: 64, fewer where two stages of K and V and the
// accumulators would not fit
inline int chunk_tokens(int R, int D, int es, int n_ids) {
  int Tc = 64;
  while (Tc > 8 && SmemLayout(R, D, Tc, es, n_ids).total > 100 * 1024)
    Tc /= 2;
  return Tc;
}

// The two launches of a split-K decode call on `stream`: the split kernel
// over (B * KV, n_split), reading rows in vectors of VB bytes, then the
// combine over the B * KV * R rows as a programmatic dependent launch, so
// that its launch and block scheduling overlap the split kernel's run (it
// waits on griddepcontrol.wait).
template <typename T, typename Rows, int VB>
cudaError_t launch_vb(const void* q, const Rows& rows, const int* lengths,
                      void* out, float* ws, int B, int KV, int R, int D,
                      int S, int n_split, int span, int n_ids,
                      cudaStream_t stream) {
  const int Tc = chunk_tokens(R, D, sizeof(T), n_ids);
  const size_t smem = SmemLayout(R, D, Tc, sizeof(T), n_ids).total;
  static size_t allowed = 48 * 1024;
  cudaError_t err = allow_smem(split_kernel<T, Rows, VB>, smem, &allowed);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)D);
  split_kernel<T, Rows, VB>
      <<<dim3(B * KV, n_split), kThreads, smem, stream>>>(
          static_cast<const T*>(q), rows, lengths, ws, B, KV, R, D, S, Tc,
          span, n_split, n_ids, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t w_smem = sizeof(float) * (n_split + 1);
  static size_t w_allowed = 48 * 1024;
  err = allow_smem(combine_kernel<T>, w_smem, &w_allowed);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * KV * R);
  cfg.blockDim = dim3(kCombineThreads);
  cfg.dynamicSmemBytes = w_smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, combine_kernel<T>, ws,
                            static_cast<T*>(out), B * KV * R, n_split, D);
}

// launch_vb at the vector width `vb` (row_vec_bytes)
template <typename T, typename Rows>
cudaError_t launch(const void* q, const Rows& rows, const int* lengths,
                   void* out, float* ws, int B, int KV, int R, int D, int S,
                   int n_split, int span, int n_ids, int vb,
                   cudaStream_t stream) {
  switch (vb) {
    case 16:
      return launch_vb<T, Rows, 16>(q, rows, lengths, out, ws, B, KV, R, D,
                                    S, n_split, span, n_ids, stream);
    case 8:
      return launch_vb<T, Rows, 8>(q, rows, lengths, out, ws, B, KV, R, D, S,
                                   n_split, span, n_ids, stream);
    case 4:
      return launch_vb<T, Rows, 4>(q, rows, lengths, out, ws, B, KV, R, D, S,
                                   n_split, span, n_ids, stream);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch_vb<T, Rows, 2>(q, rows, lengths, out, ws, B, KV, R, D,
                                     S, n_split, span, n_ids, stream);
  }
  return cudaErrorMisalignedAddress;
}

}  // namespace split_decode

}  // namespace repro
