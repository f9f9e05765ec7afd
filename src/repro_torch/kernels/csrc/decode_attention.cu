// Decode attention for Hopper (sm_90a): one query token per batch row
// against a dense KV cache, GQA-grouped, fp32 online softmax. Plain C
// interface, loaded from Python through ctypes
// (repro_torch/kernels/decode_attention.py).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:
// decode_attention (pallas_call at :77, body _decode_kernel at :26),
// with the same contract:
//   q       [B, H, D]          fp32 or bf16, contiguous
//   k, v    [B, KV, S, D]      any strides but a contiguous last dim (the
//                              kernel API passes the model's [B, S, KV, D]
//                              cache as a transposed view, not a copy)
//   lengths [B] int32          keys at positions >= length are masked;
//                              a length of 0 gives exact zeros
//   out     [B, H, D]          q's type
//
// Bound on an H100 SXM: decode attention is memory-bound. The least work
// is reading each row's first min(length, S) K and V rows once,
//   sum_b min(len_b, S) * KV * D * 2 * sizeof(dtype)  bytes,
// over 3.35 TB/s; 4 * H * len * D flops per row are far below the
// compute roof.
//
// What this design does about it: one thread block per (row, KV head)
// walks only the row's first min(length, S) positions (the Pallas kernel
// streams every block and masks; stopping gives the same result), staging
// ~64 tokens at a time into shared memory with 16-byte loads and sharing
// each K/V row across the R = H / KV query heads, so device traffic is the
// bound's bytes. It does NOT reach the bandwidth: B * KV thread blocks
// (32 at tinyllama's decode shapes) under-fill 132 SMs, and a chunk's
// loads do not overlap the previous chunk's math. Split-K over the
// sequence and cp.async / TMA staging are later work.
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

struct Strides {  // in elements: batch, sequence, KV head
  long long b, s, h;
};

// Shared memory, fp32:
//   q[R*D] (pre-scaled) | k[Tc*(D+1)] (rows padded: conflict-free column
//   reads) | v[Tc*D] | p[R*Tc] | acc[R*D] | m[R] | l[R] | alpha[R]
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ out, Strides ks, Strides vs, int KV, int R,
              int D, int S, int Tc, float scale) {
  extern __shared__ float smem[];
  const int Dk = D + 1;
  float* q_s = smem;
  float* k_s = q_s + R * D;
  float* v_s = k_s + Tc * Dk;
  float* p_s = v_s + Tc * D;
  float* acc = p_s + R * Tc;
  float* m_s = acc + R * D;
  float* l_s = m_s + R;
  float* a_s = l_s + R;

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
  const int n = max(0, min(lengths[row], S));  // early stop
  const T* k_base = k + row * ks.b + kvh * ks.h;
  const T* v_base = v + row * vs.b + kvh * vs.h;

  constexpr int kVec = Vec16<T>::n;
  const int row_vecs = D / kVec;
  for (int c0 = 0; c0 < n; c0 += Tc) {
    const int nt = min(Tc, n - c0);  // tokens loaded this chunk
    __syncthreads();
#pragma unroll 4
    for (int i = tid; i < nt * row_vecs; i += kThreads) {
      const int t = i / row_vecs;
      const int d = (i - t * row_vecs) * kVec;
      const uint4 kr =
          *reinterpret_cast<const uint4*>(k_base + (c0 + t) * ks.s + d);
      const uint4 vr =
          *reinterpret_cast<const uint4*>(v_base + (c0 + t) * vs.s + d);
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
      if (t < nt) {
        const float* qr = q_s + r * D;
        const float* kt = k_s + t * Dk;
        s = 0.f;
        for (int d = 0; d < D; ++d) s += qr[d] * kt[d];
      }
      p_s[pr] = s;
    }
    __syncthreads();

    // online softmax, one warp per query head; -inf guards as in the
    // TPU kernel (_decode_kernel :46-50)
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
  }

  __syncthreads();  // l_s and acc come from other threads (n may be 0)
  T* o_row = out + head0 * D;
  for (int i = tid; i < R * D; i += kThreads) {
    const float l = l_s[i / D];
    o_row[i] = from_f<T>(acc[i] / (l == 0.f ? 1.f : l));
  }
}

size_t smem_bytes(int R, int D, int Tc) {
  return sizeof(float) * ((size_t)2 * R * D + (size_t)Tc * (D + 1) +
                          (size_t)Tc * D + (size_t)R * Tc + (size_t)3 * R);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, Strides ks, Strides vs,
                   int B, int KV, int R, int D, int S, cudaStream_t stream) {
  int Tc = 64;  // tokens per chunk, fewer where the tiles would not fit
  while (Tc > 8 && smem_bytes(R, D, Tc) > 100 * 1024) Tc /= 2;
  const size_t smem = smem_bytes(R, D, Tc);
  static size_t allowed = 48 * 1024;
  cudaError_t err = allow_smem(decode_kernel<T>, smem, &allowed);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)D);
  decode_kernel<T><<<B * KV, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), ks, vs, KV, R,
      D, S, Tc, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements (batch,
// sequence, KV head); the head dim is contiguous. Returns the cudaError_t
// of the launch (0 on success). Launches on `stream`, does not synchronise.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* lengths, void* out, int dtype,
                                int B, int H, int KV, int D, int S,
                                long long k_sb, long long k_ss,
                                long long k_sh, long long v_sb,
                                long long v_ss, long long v_sh,
                                void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (KV <= 0 || H % KV != 0 || D <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  const int vec = dtype == 0 ? 4 : 8;  // elements per 16-byte load
  if (D % vec != 0 || k_sb % vec || k_ss % vec || k_sh % vec || v_sb % vec ||
      v_ss % vec || v_sh % vec ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const Strides ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const int R = H / KV;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, lengths, out, ks, vs, B, KV, R, D, S,
                              s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, lengths, out, ks, vs, B, KV,
                                      R, D, S, s);
  return (int)cudaErrorInvalidValue;
}
