// Blocked flash attention for Hopper (sm_90a): GQA, causal or not, fp32
// online softmax. Plain C interface, loaded from Python through ctypes
// (repro_torch/kernels/flash_attention.py).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention (pallas_call at :93, body _flash_kernel at :30), with
// the same contract:
//   q     [B, H, Sq, D]      fp32 or bf16; any strides but a contiguous
//   k, v  [B, KV, Sk, D]     last dim (the kernel API passes the model's
//   out   [B, H, Sq, D]      [B, S, H, D] tensors as transposed views)
// Query head h reads KV head h / (H / KV). The causal mask counts q and k
// positions both from 0 (k_pos <= q_pos), as the Pallas kernel does, with
// its guards against rows with no key to attend. Ragged Sq and Sk are masked
// here (the Pallas kernel needs block multiples; the kernel API pads
// exactly as the reference does before calling either).
//
// Head dims: every D up to 256 (the Pallas kernel takes any D). The kernels
// are instantiated at the widths W of kWidths (64, 80, 96, 112, 128, 160,
// 192, 256: the repo's head dims 64, 112, 128, 160 and 256 among them), and
// a D runs on the smallest W >= D, its columns from D up to W zero-filled in
// the loads and never stored; 1/sqrt(D) is taken from the caller's head dim
// (scale_dim), never from W. bf16 also needs D a multiple of 8 (16-byte
// rows); the wrapper copies other operands into zero-padded rows
// (flash_attention.py: pad_head_dim). D above 256 is the kernels' bound: O
// lives in registers (W / 2 fp32 a thread in the bf16 kernel).
//
// Bound on an H100 SXM: at prefill lengths this is compute-bound. The
// least work is 4 * D flops per unmasked (q, k) pair and head, about
// B * H * Sq * Sk / 2 pairs when causal, against the input type's peak
// (989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32); the bytes
// (q, k, v read once, out written once) are far below it.
//
// bf16 (flash_wgmma_kernel): FlashAttention-3's layout without warp
// specialisation. A thread block holds two consumer warpgroups of 128
// threads; each owns 64 query rows of one (batch, head), so a block covers
// 128 rows. The Q tile is copied once into shared memory; K and V tiles
// (TK = 128 keys at W 64, 64 at the wider W) go through a two-stage ring
// in shared memory, filled by 16-byte cp.async copies, so tile j + 1 loads
// while tile j computes. Every tile is stored in the 128-byte swizzled
// layout the wgmma descriptors read. S = Q K^T is one wgmma m64nTKk16 per
// 16 columns of D, Q and K both from shared memory; the online softmax
// runs on the fp32 accumulator fragments in registers (row max and sum
// are shuffles within a lane quad), with 1/sqrt(D) folded into the fp32
// exponent (2^(s log2(e) / sqrt(D) - m log2(e) / sqrt(D)), one FMA and
// one SFU exp2 per score) instead of a bf16
// pre-scaled Q, which would round Q once more at D 128; O += P V is a
// second wgmma with P converted to bf16 and passed in registers (the
// accumulator layout of S is the A-fragment layout of the next product)
// and V read transposed (MN-major) through its descriptor. O stays in
// registers for the whole walk. Causal key tiles wholly above a
// warpgroup's last row are skipped (the Pallas kernel masks them;
// skipping gives the same result).
//
// Where the bf16 result differs from the Pallas kernel and the plain
// version: P is rounded to bf16 before P V (they keep it fp32), a
// relative error of at most 2^-9 per weight; the tolerance against the
// plain version stays 2e-2 (PERF.md gives the error measured on the card).
// The row sum l is taken over the fp32 P.
//
// fp32 (flash_kernel): the CUDA-core kernel. Tensor cores would mean
// TF32, which keeps about three decimal digits and cannot meet the fp32
// tolerance of 3e-5; fp32 is not a production type on the card. Each
// thread block owns 64 query rows of one head and walks the key tiles,
// keeping the score and probability tiles in shared memory and the output
// accumulator in registers; products are fp32 FMAs on the CUDA cores from
// register tiles over shared memory.
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;  // 16 x 16 (see tile_fma)
constexpr int TQ = 64;         // query rows per thread block
constexpr int LQ = TQ + 1;     // padded row of the q-major tiles

struct Strides {  // in elements: batch, head, sequence
  long long b, h, s;
};

// the kernels' widths, ascending; a head dim runs on the first W >= D
constexpr int kWidths[] = {64, 80, 96, 112, 128, 160, 192, 256};

template <int W>
__host__ __device__ constexpr int key_tile() {
  return W <= 128 ? 64 : 32;
}

template <int W>
__host__ __device__ constexpr size_t smem_floats() {
  constexpr int TK = key_tile<W>();
  return (size_t)W * LQ + (size_t)W * (TK + 1) + (size_t)TK * W +
         (size_t)TK * LQ;
}

// Shared memory, fp32 (columns D .. W zero):
//   qt[W][LQ]   (q tile transposed, pre-scaled)
//   kt[W][TK+1] (k tile transposed)
//   vs[TK][W]
//   pt[TK][LQ]  (probabilities, transposed)
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, Strides qs,
             Strides ks, Strides vs, Strides os, int H, int KV, int D,
             int Sq, int Sk, int causal, float scale) {
  constexpr int TK = key_tile<W>();
  constexpr int LK = TK + 1;
  constexpr int TM = TQ / 16, TN = TK / 16, TD = W / 16;
  extern __shared__ float smem[];
  float* qt = smem;
  float* kt = qt + W * LQ;
  float* vt = kt + W * LK;
  float* pt = vt + TK * W;

  const int q0 = blockIdx.x * TQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  const T* q_bh = q + b * qs.b + h * qs.h;
  for (int i = tid; i < TQ * W; i += kThreads) {
    const int r = i / W, d = i - (i / W) * W;
    const float x =
        q0 + r < Sq && d < D ? to_f(q_bh[(q0 + r) * qs.s + d]) : 0.f;
    qt[d * LQ + r] = x * scale;
  }

  float o[TM][TD], m[TM], l[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TD; ++j) o[i][j] = 0.f;
  }

  // causal: keys past the tile's last query row are masked for every
  // row, so their tiles are skipped
  const int k_end = causal ? min(Sk, q0 + TQ) : Sk;
  const T* k_b = k + b * ks.b + kvh * ks.h;
  const T* v_b = v + b * vs.b + kvh * vs.h;
  for (int k0 = 0; k0 < k_end; k0 += TK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < TK * W; i += kThreads) {
      const int r = i / W, d = i - (i / W) * W;
      const bool in = k0 + r < Sk && d < D;
      kt[d * LK + r] = in ? to_f(k_b[(k0 + r) * ks.s + d]) : 0.f;
      vt[r * W + d] = in ? to_f(v_b[(k0 + r) * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
    tile_fma<TM, TN>(qt, LQ, kt, LK, D, ty, tx, s);

    // mask and online softmax, with the Pallas kernel's -inf guards
    // (_flash_kernel :52-58); a row is spread over 16 lanes
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= Sk || (causal && kpos > qpos)) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row16_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float safe = isinf(m_new) ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = isinf(s[i][j]) ? 0.f : expf(s[i][j] - safe);
        pt[(tx + 16 * j) * LQ + ty + 16 * i] = p;
        sum += p;
      }
      sum = row16_sum(sum);
      const float alpha = isinf(m[i]) ? 0.f : expf(m[i] - safe);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < TD; ++j) o[i][j] *= alpha;
    }
    __syncthreads();
    tile_fma<TM, TD>(pt, LQ, vt, W, TK, ty, tx, o);
  }

  T* o_bh = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int j = 0; j < TD; ++j)
      if (tx + 16 * j < D)
        o_bh[r * os.s + tx + 16 * j] = from_f<T>(o[i][j] * inv);
  }
}

template <typename T, int W>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   Strides qs, Strides ks, Strides vs, Strides os, int B,
                   int H, int KV, int D, int Sq, int Sk, int causal,
                   int scale_dim, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<W>();
  static size_t allowed = 48 * 1024;
  cudaError_t err = allow_smem(flash_kernel<T, W>, smem, &allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + TQ - 1) / TQ, B * H);
  flash_kernel<T, W><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), qs, ks, vs, os, H, KV,
      D, Sq, Sk, causal, 1.0f / sqrtf((float)scale_dim));
  return cudaGetLastError();
}

// ------------------------------------------------------------ bf16: wgmma
using bf16 = __nv_bfloat16;

template <int W>
struct WgTiles {
  static constexpr int kWG = 2;             // consumer warpgroups
  static constexpr int kThreads = 128 * kWG;
  static constexpr int TQ = 64 * kWG;       // query rows per thread block
  static constexpr int TK = W == 64 ? 128 : 64;  // keys per tile
  // a tile row is W columns in whole 64-column (128-byte) swizzle blocks
  static constexpr int DP = (W + 63) / 64 * 64;
  static constexpr uint32_t q_bytes = TQ * DP * 2;
  static constexpr uint32_t kv_bytes = TK * DP * 2;  // one K or V tile
  // 1024 bytes of slack align the tiles to the swizzle's 1024-byte atoms
  static constexpr size_t smem = 1024 + q_bytes + 4 * kv_bytes;
};

// Copy rows [row0, row0 + ROWS) of a [*, D] bf16 operand (row stride `ld`
// elements, D a multiple of 8) into the first W columns of the swizzled
// tile at shared address `dst`, 16 bytes per cp.async; rows at or past
// `n_rows` and columns at or past D are zero-filled.
template <int ROWS, int W, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long ld, int row0, int n_rows,
                                          int D, int tid) {
  constexpr int CPR = W / 8;  // 16-byte chunks per row
#pragma unroll 4
  for (int i = tid; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c = i % CPR;
    const bool in = row0 + r < n_rows && c * 8 < D;
    const bf16* g = in ? src + (row0 + r) * ld + c * 8 : src;
    cp_async16(dst + (c >> 3) * (ROWS * 128) + sw128_offset(r, c & 7), g,
               in ? 16 : 0);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db, 1);
  else if constexpr (N == 80) wgmma_rs_n80(d, a, db, 1);
  else if constexpr (N == 96) wgmma_rs_n96(d, a, db, 1);
  else if constexpr (N == 112) wgmma_rs_n112(d, a, db, 1);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db, 1);
  else if constexpr (N == 160) wgmma_rs_n160(d, a, db, 1);
  else if constexpr (N == 192) wgmma_rs_n192(d, a, db, 1);
  else wgmma_rs_n256(d, a, db, 1);
}

template <int W>
__global__ void __launch_bounds__(WgTiles<W>::kThreads, 1)
flash_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ out,
                   Strides qs, Strides ks, Strides vs, Strides os, int H,
                   int KV, int D, int Sq, int Sk, int causal,
                   float scale_log2) {
  using Tl = WgTiles<W>;
  constexpr int TQ = Tl::TQ, TK = Tl::TK, NT = Tl::kThreads;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + Tl::q_bytes;       // stage s at sK + s * kv_bytes
  const uint32_t sV = sK + 2 * Tl::kv_bytes;  // likewise

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int q0 = blockIdx.x * TQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / (H / KV);
  const bf16* k_b = k + b * ks.b + kvh * ks.h;
  const bf16* v_b = v + b * vs.b + kvh * vs.h;

  // causal: keys past the block's last query row are masked for every
  // row, so their tiles are not loaded
  const int k_end = causal ? min(Sk, q0 + TQ) : Sk;
  const int n_tiles = (k_end + TK - 1) / TK;
  load_tile<TQ, W, NT>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, Sq, D, tid);
  load_tile<TK, W, NT>(sK, k_b, ks.s, 0, Sk, D, tid);
  load_tile<TK, W, NT>(sV, v_b, vs.s, 0, Sk, D, tid);
  cp_async_commit();

  // this warpgroup's rows, and this thread's two rows of each fragment
  const int wq0 = q0 + 64 * wg;
  const int row_a = wq0 + 16 * warp + (lane >> 2), row_b = row_a + 8;
  const int col0 = 2 * (lane & 3);
  const int wk_end = causal ? min(Sk, wq0 + 64) : Sk;
  const bool rows_live = wq0 < Sq;

  // Q K^T runs over the k16 steps that hold columns below D only
  const int k_steps = (D + 15) / 16;
  float o[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) o[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    cp_async_wait<0>();   // this thread's copies of tile j have landed
    fence_proxy_async();  // ... and are visible to wgmma
    __syncthreads();      // everyone's have; tile j - 1's readers are done
    if (j + 1 < n_tiles) {
      const int nk = (j + 1) * TK;
      load_tile<TK, W, NT>(sK + (st ^ 1) * Tl::kv_bytes, k_b, ks.s, nk, Sk,
                           D, tid);
      load_tile<TK, W, NT>(sV + (st ^ 1) * Tl::kv_bytes, v_b, vs.s, nk, Sk,
                           D, tid);
      cp_async_commit();
    }
    const int k0 = j * TK;
    if (k0 >= wk_end || !rows_live) continue;

    // S = Q K^T over D in steps of 16: K-major descriptors, each step 32
    // bytes further along the 128-byte rows, 64-column blocks apart
    float s[TK / 2];
    const uint32_t kt = sK + st * Tl::kv_bytes;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) {
      if (kk >= k_steps) break;
      const uint32_t qa = sQ + (kk >> 2) * (TQ * 128) + wg * (64 * 128) +
                          (kk & 3) * 32;
      const uint32_t ka = kt + (kk >> 2) * (TK * 128) + (kk & 3) * 32;
      wgmma_ss<TK>(s, sw128_desc(qa, 16, 1024), sw128_desc(ka, 16, 1024),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // mask (only tiles that cross Sk or the diagonal), then the online
    // softmax with the Pallas kernel's -inf guards (_flash_kernel :52-58)
    if (k0 + TK > Sk || (causal && k0 + TK - 1 > wq0)) {
#pragma unroll
      for (int i = 0; i < TK / 2; ++i) {
        const int col = k0 + 8 * (i >> 2) + col0 + (i & 1);
        const int row = (i & 2) ? row_b : row_a;
        if (col >= Sk || (causal && col > row)) s[i] = -INFINITY;
      }
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int i = 0; i < TK / 2; i += 4) {
      mx_a = fmaxf(mx_a, fmaxf(s[i], s[i + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[i + 2], s[i + 3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o_));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o_));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float safe_a = isinf(mn_a) ? 0.f : mn_a;
    const float safe_b = isinf(mn_b) ? 0.f : mn_b;
    // alpha = 0 where m was -inf
    const float alpha_a = exp2_approx((m_a - safe_a) * scale_log2);
    const float alpha_b = exp2_approx((m_b - safe_b) * scale_log2);
    const float off_a = safe_a * scale_log2, off_b = safe_b * scale_log2;
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
    uint32_t p[TK / 16][4];
#pragma unroll
    for (int i = 0; i < TK / 2; i += 2) {
      const float off = (i & 2) ? off_b : off_a;
      const float e0 = exp2_approx(fmaf(s[i], scale_log2, -off));  // 0 at -inf
      const float e1 = exp2_approx(fmaf(s[i + 1], scale_log2, -off));
      if (i & 2) sum_b += e0 + e1;
      else sum_a += e0 + e1;
      p[i >> 3][(i >> 1) & 3] = pack_bf16x2(e0, e1);
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, o_);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, o_);
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int i = 0; i < W / 2; ++i) o[i] *= (i & 2) ? alpha_b : alpha_a;

    // O += P V over the tile's keys in steps of 16, N = W columns (those
    // from D on are zero and not stored): V is [TK][W] row-major in its
    // tile, which is B = V read MN-major; a step is 16 rows (2048 bytes)
    // on, 64-column blocks TK * 128 bytes apart (leading offset)
    const uint32_t vt = sV + st * Tl::kv_bytes;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      wgmma_rs<W>(o, p[kk], sw128_desc(vt + kk * 2048, TK * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }

  if (!rows_live) return;
  bf16* o_bh = out + b * os.b + h * os.h;
  const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
  const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
#pragma unroll
  for (int i = 0; i < W / 2; i += 2) {
    const int row = (i & 2) ? row_b : row_a;
    const int col = 8 * (i >> 2) + col0;  // even, so col + 1 < D too
    if (row >= Sq || col >= D) continue;
    const float inv = (i & 2) ? inv_b : inv_a;
    *reinterpret_cast<uint32_t*>(o_bh + row * os.s + col) =
        pack_bf16x2(o[i] * inv, o[i + 1] * inv);
  }
}

template <int W>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, Strides qs, Strides ks, Strides vs,
                         Strides os, int B, int H, int KV, int D, int Sq,
                         int Sk, int causal, int scale_dim,
                         cudaStream_t stream) {
  using Tl = WgTiles<W>;
  static size_t allowed = 48 * 1024;
  cudaError_t err = allow_smem(flash_wgmma_kernel<W>, Tl::smem, &allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + Tl::TQ - 1) / Tl::TQ, B * H);
  flash_wgmma_kernel<W><<<grid, Tl::kThreads, Tl::smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), qs, ks, vs, os, H,
      KV, D, Sq, Sk, causal, 1.4426950408889634f / sqrtf((float)scale_dim));
  return cudaGetLastError();
}

constexpr int kNumWidths = sizeof(kWidths) / sizeof(kWidths[0]);

// f(std::integral_constant<int, W>{}) for the smallest width W >= D
template <int I = 0, typename F>
cudaError_t by_width(int D, F f) {
  if constexpr (I == kNumWidths) {
    return cudaErrorInvalidValue;
  } else {
    if (D <= kWidths[I]) return f(std::integral_constant<int, kWidths[I]>{});
    return by_width<I + 1>(D, f);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; 0 < D <= 256 (the widest of kWidths),
// a multiple of 8 in bf16; the softmax scale is 1 / sqrt(scale_dim). Strides
// are in elements (batch, head, sequence); the head dim is contiguous.
// bf16 needs 16-byte rows: base pointers 16-byte aligned and strides
// multiples of 8 elements. Returns the cudaError_t of the launch (0 on
// success). Launches on `stream` and does not synchronise.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int dtype, int B, int H, int KV,
                               int D, int scale_dim, int Sq, int Sk,
                               int causal, const long long* strides,
                               void* stream) {
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  if (KV <= 0 || H % KV != 0 || Sk < 0 || D <= 0 || scale_dim <= 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)by_width(D, [&](auto w) {
      return launch<float, decltype(w)::value>(q, k, v, out, qs, ks, vs, os,
                                               B, H, KV, D, Sq, Sk, causal,
                                               scale_dim, s);
    });
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (D % 8 != 0) return (int)cudaErrorMisalignedAddress;
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8 != 0) return (int)cudaErrorMisalignedAddress;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
          16 !=
      0)
    return (int)cudaErrorMisalignedAddress;
  return (int)by_width(D, [&](auto w) {
    return launch_wgmma<decltype(w)::value>(q, k, v, out, qs, ks, vs, os, B,
                                            H, KV, D, Sq, Sk, causal,
                                            scale_dim, s);
  });
}
