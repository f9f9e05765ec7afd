// Paged decode attention for Hopper (sm_90a): one new query token per
// batch row against a block-table KV pool, GQA-grouped, fp32 online
// softmax. Plain C interface, loaded from Python through ctypes
// (repro_torch/kernels/paged_decode.py).
//
// Replaces the TPU kernel repro/kernels/paged_decode.py:
// paged_decode_attention (pallas_call at :122, body _paged_kernel at :34),
// with the same contract:
//   q       [B, H, D]                  fp32 or bf16, contiguous
//   k, v    [n_blocks, KV, bs, D]      one layer of the KV-head-major pool
//   tables  [B, max_blocks] int32      entries outside [0, n_blocks) read
//                                      block 0 and are masked by length
//   lengths [B] int32                  0 gives exact zeros
//   out     [B, H, D]                  q's type
// The R = H / KV query heads that share a KV head are handled together.
//
// Bound on an H100 SXM: decode attention is memory-bound. The least work
// is reading each valid K and V tile once,
//   sum_b ceil(len_b / bs) * bs * KV * D * 2 * sizeof(dtype)  bytes,
// over 3.35 TB/s; the q / out / table bytes are small beside it, and the
// 4 * H * len * D flops per row are far below the compute roof.
//
// What this design does about it: every thread block reads only the
// blocks below ceil(len / bs) of its row (the loop stops there, like the
// Pallas index-map clamp), stages them into shared memory a chunk of
// about 64 tokens at a time with coalesced 16-byte loads, reading each
// K/V tile of its KV head exactly once and sharing it across the R query
// heads, so device traffic is the bound's bytes and no more. It does NOT reach
// the bandwidth: one thread block per (row, KV head) gives B * KV blocks
// (4 * batch at tinyllama's shapes) on 132 SMs — under-occupied and
// launch-bound at decode batch sizes — and a chunk's loads do not
// overlap the previous chunk's math. Split-K over blocks, cp.async / TMA
// staging and a CUDA graph over the per-layer launches are later work.
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// One thread block per (row, KV head); it walks the row's valid blocks
// in chunks of `cb` pool blocks (T = cb * bs tokens). Shared memory, fp32
// but for the block ids:
//   q[R*D] (pre-scaled) | k[T*(D+1)] (rows padded: conflict-free column
//   reads) | v[T*D] | p[R*T] | acc[R*D] | m[R] | l[R] | alpha[R] | ids[cb]
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int KV, int R, int D, int bs, int max_blocks,
                    int n_blocks, int cb, float scale) {
  extern __shared__ float smem[];
  const int Tc = cb * bs;  // tokens per chunk
  const int Dk = D + 1;    // padded k row
  float* q_s = smem;
  float* k_s = q_s + R * D;
  float* v_s = k_s + Tc * Dk;
  float* p_s = v_s + Tc * D;
  float* acc = p_s + R * Tc;
  float* m_s = acc + R * D;
  float* l_s = m_s + R;
  float* a_s = l_s + R;
  int* ids = reinterpret_cast<int*>(a_s + R);

  const int row = blockIdx.x / KV;
  const int kvh = blockIdx.x % KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t head0 = ((size_t)row * KV + kvh) * R;  // first query head

  const T* q_row = q + head0 * D;
  for (int i = tid; i < R * D; i += kThreads) {
    q_s[i] = to_f(q_row[i]) * scale;
    acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  const int length = lengths[row];
  int n_valid = length > 0 ? (length + bs - 1) / bs : 0;  // early stop
  if (n_valid > max_blocks) n_valid = max_blocks;

  constexpr int kVec = Vec16<T>::n;
  const int tile = bs * D;
  const int tile_vecs = tile / kVec;
  for (int c0 = 0; c0 < n_valid; c0 += cb) {
    const int nb = min(cb, n_valid - c0);
    const int nt = nb * bs;  // tokens loaded this chunk
    if (tid < nb) {
      int blk = tables[(size_t)row * max_blocks + c0 + tid];
      ids[tid] = (blk < 0 || blk >= n_blocks) ? 0 : blk;
    }
    __syncthreads();
    // each (block, KV head) tile [bs, D] is contiguous: copy it in
    // 16-byte vectors (the wrapper checks D and the alignment)
#pragma unroll 4
    for (int i = tid; i < nb * tile_vecs; i += kThreads) {
      const int j = i / tile_vecs;
      const int e = (i - j * tile_vecs) * kVec;
      const size_t src = ((size_t)ids[j] * KV + kvh) * tile + e;
      const uint4 kr = *reinterpret_cast<const uint4*>(k_pool + src);
      const uint4 vr = *reinterpret_cast<const uint4*>(v_pool + src);
      const int t = j * bs + e / D;
      const int d = e - (e / D) * D;
      float kf[kVec], vf[kVec];
      Vec16<T>::unpack(kr, kf);
      Vec16<T>::unpack(vr, vf);
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        k_s[t * Dk + d + u] = kf[u];
        v_s[t * D + d + u] = vf[u];
      }
    }
    __syncthreads();

    // scores: one thread per (query head, token)
    for (int pr = tid; pr < R * Tc; pr += kThreads) {
      const int r = pr / Tc;
      const int t = pr - r * Tc;
      float s = -INFINITY;
      if (t < nt && c0 * bs + t < length) {
        const float* qr = q_s + r * D;
        const float* kt = k_s + t * Dk;
        s = 0.f;
        for (int d = 0; d < D; ++d) s += qr[d] * kt[d];
      }
      p_s[pr] = s;
    }
    __syncthreads();

    // online softmax, one warp per query head; -inf guards as in the
    // TPU kernel (_paged_kernel :57-61)
    for (int r = warp; r < R; r += kWarps) {
      float* pr = p_s + r * Tc;
      float mx = -INFINITY;
      for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, pr[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float safe = isinf(m_new) ? 0.f : m_new;
      float sum = 0.f;
      for (int t = lane; t < nt; t += 32) {
        const float s = pr[t];
        const float e = isinf(s) ? 0.f : expf(s - safe);
        pr[t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = isinf(m_prev) ? 0.f : expf(m_prev - safe);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v over the tokens loaded this chunk
    for (int i = tid; i < R * D; i += kThreads) {
      const int r = i / D;
      const int d = i - r * D;
      const float* pr = p_s + r * Tc;
      float a = acc[i] * a_s[r];
      for (int t = 0; t < nt; ++t) a += pr[t] * v_s[t * D + d];
      acc[i] = a;
    }
    __syncthreads();
  }

  __syncthreads();  // l_s comes from other threads (n_valid may be 0)
  T* o_row = out + head0 * D;
  for (int i = tid; i < R * D; i += kThreads) {
    const float l = l_s[i / D];
    o_row[i] = from_f<T>(acc[i] / (l == 0.f ? 1.f : l));
  }
}

size_t smem_bytes(int R, int D, int bs, int cb) {
  const size_t Tc = (size_t)cb * bs;
  return sizeof(float) * ((size_t)2 * R * D + Tc * (D + 1) + Tc * D +
                          (size_t)R * Tc + (size_t)3 * R) +
         sizeof(int) * (size_t)cb;
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* tables, const int* lengths, void* out, int B,
                   int KV, int R, int D, int bs, int max_blocks, int n_blocks,
                   cudaStream_t stream) {
  // ~64 tokens per chunk, fewer where the tiles would not fit
  int cb = bs >= 64 ? 1 : 64 / bs;
  while (cb > 1 && smem_bytes(R, D, bs, cb) > 100 * 1024) cb /= 2;
  const size_t smem = smem_bytes(R, D, bs, cb);
  static size_t allowed = 48 * 1024;
  cudaError_t err = allow_smem(paged_decode_kernel<T>, smem, &allowed);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)D);
  paged_decode_kernel<T><<<B * KV, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, lengths, static_cast<T*>(out),
      KV, R, D, bs, max_blocks, n_blocks, cb, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch
// (0 on success). Launches on `stream` and does not synchronise.
extern "C" int paged_decode_attention(const void* q, const void* k_pool,
                                      const void* v_pool, const int* tables,
                                      const int* lengths, void* out,
                                      int dtype, int B, int H, int KV, int D,
                                      int bs, int max_blocks, int n_blocks,
                                      void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (KV <= 0 || H % KV != 0 || D <= 0 || bs <= 0 || max_blocks <= 0 ||
      n_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const int vec = dtype == 0 ? 4 : 8;  // elements per 16-byte load
  if (D % vec != 0 || reinterpret_cast<uintptr_t>(k_pool) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_pool) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int R = H / KV;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(q, k_pool, v_pool, tables, lengths, out, B, KV, R, D,
                        bs, max_blocks, n_blocks, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(q, k_pool, v_pool, tables, lengths, out, B,
                                KV, R, D, bs, max_blocks, n_blocks, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
