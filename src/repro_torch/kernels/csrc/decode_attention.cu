// Decode attention for Hopper (sm_90a): one query token per batch row
// against a dense KV cache, GQA-grouped, fp32 online softmax, split-K over
// the sequence. Plain C interface, loaded from Python through ctypes
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
// compute roof. At the main path's shapes that is under a microsecond, so
// the floor is latency: two launches, a few dependent loads.
//
// What this design does about it. A call is two launches.
// 1. decode_split_kernel, grid (B * KV, n_split): the sequence is cut into
//    n_split ranges of `span` positions (a multiple of 64), chosen on the
//    host from shapes alone (decode_attention.py: plan_splits) so that the
//    grid covers the SMs four times. A block walks its range up to
//    min(length, S) (the Pallas kernel streams every block and masks;
//    stopping gives the same result); a range that starts past the row's
//    length writes an empty partial (m = -inf, l = 0) and exits. K/V go
//    through a two-stage ring of Tc-token chunks filled by 16-byte cp.async
//    copies, so chunk c + 1 loads while chunk c computes, with one block
//    barrier per chunk. Each K/V row is shared across the R = H / KV query
//    heads. Of the block's 8 warps, warp w owns heads w, w + 8, ... (or,
//    when R < 8, a part of D of one head): it computes that head's scores
//    with a group of lanes across D per token (q's slice in registers)
//    and a shuffle reduction, runs the online softmax
//    on a warp-private row of shared memory, and accumulates p V for its
//    part of D; nothing but the ring is shared between warps. The partial
//    (acc, m, l) of every (row, head, split) goes to a workspace that the
//    wrapper allocates (common.cuh: SplitPartials).
// 2. decode_combine_kernel, one block per (row, head): the split-K merge
//    of common.cuh (combine_split_row), with the same -inf guards, so a
//    length-0 row stays exactly zero. It is a programmatic dependent
//    launch: it is scheduled while the split kernel runs and waits for its
//    end, so the second launch's latency mostly hides. One warp reads
//    every split's (m, l) in one round and reduces them with shuffles; the
//    columns are then summed over the splits with independent loads.
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;          // the split kernel's block
constexpr int kWarps = kThreads / 32;
constexpr int kCombineThreads = 128;
constexpr int kQVecs = 2;  // 16-byte q vectors a lane keeps in registers

struct Strides {  // in elements: batch, sequence, KV head
  long long b, s, h;
};

struct SmemLayout {  // byte offsets into dynamic shared memory
  size_t q, k, v, p, acc, m, l, total;
  __host__ __device__ SmemLayout(int R, int D, int Tc, int es) {
    const size_t stage = (size_t)Tc * D * es;
    q = 0;                                        // [R][D] fp32, pre-scaled
    k = q + sizeof(float) * R * D;                // [2][Tc][D] T
    v = k + 2 * stage;                            // [2][Tc][D] T
    p = v + 2 * stage;                            // [kWarps][Tc] fp32
    acc = p + sizeof(float) * kWarps * Tc;        // [R][D] fp32
    const int items = R > kWarps ? R : kWarps;   // R * parts <= items
    m = acc + sizeof(float) * R * D;              // [items] fp32
    l = m + sizeof(float) * items;                // [items] fp32
    total = l + sizeof(float) * items;
  }
};

// Issue the copies of `nt` tokens starting at position `s0` into stage
// buffers kd and vd (16 bytes per cp.async).
template <typename T>
__device__ __forceinline__ void load_chunk(T* kd, T* vd, const T* k_base,
                                           const T* v_base, Strides ks,
                                           Strides vs, int s0, int nt, int D,
                                           int tid) {
  constexpr int kVec = Vec16<T>::n;
  const int row_vecs = D / kVec;
  for (int i = tid; i < nt * row_vecs; i += kThreads) {
    const int t = i / row_vecs;
    const int d = (i - t * row_vecs) * kVec;
    cp_async16(smem_addr(kd + t * D + d), k_base + (s0 + t) * ks.s + d);
    cp_async16(smem_addr(vd + t * D + d), v_base + (s0 + t) * vs.s + d);
  }
  cp_async_commit();
}

__device__ __forceinline__ float2 pair_f(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_f(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ ws, Strides ks, Strides vs, int B,
                    int KV, int R, int D, int S, int Tc, int span, int n_split,
                    float scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  const SmemLayout L(R, D, Tc, sizeof(T));
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  T* k_s = reinterpret_cast<T*>(smem + L.k);
  T* v_s = reinterpret_cast<T*>(smem + L.v);
  float* p_s = reinterpret_cast<float*>(smem + L.p);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);

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
  const T* k_base = k + row * ks.b + kvh * ks.h;
  const T* v_base = v + row * vs.b + kvh * vs.h;
  const int n_chunks = (s1 - s0 + Tc - 1) / Tc;
  load_chunk(k_s, v_s, k_base, v_base, ks, vs, s0, min(Tc, s1 - s0), D, tid);

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
  const int pairs = D / 2;
  const int part_pairs = (pairs + parts - 1) / parts;
  const int my_part = R >= kWarps ? 0 : warp % parts;
  const bool has_work = R >= kWarps || warp < R * parts;
  if (has_work && lane == 0)
    for (int r = first; r < R; r += step) {
      m_s[r * parts + my_part] = -INFINITY;
      l_s[r * parts + my_part] = 0.f;
    }

  // lanes per token in the score phase: a power of two <= 32 that covers
  // the row's 16-byte vectors in as few passes as possible; lane `sub` of
  // a token's group takes vectors sub, sub + lpt, ...
  constexpr int kVec = Vec16<T>::n;
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
      load_chunk(k_s + (st ^ 1) * Tc * D, v_s + (st ^ 1) * Tc * D, k_base,
                 v_base, ks, vs, nx, min(Tc, s1 - nx), D, tid);
    }
    if (!has_work) continue;
    const int nt = min(Tc, s1 - c0);
    const T* kc = k_s + st * Tc * D;
    const T* vc = v_s + st * Tc * D;
    for (int r = first; r < R; r += step) {
      const float* qr = q_s + r * D;
      // this lane's first kQVecs vectors of q in registers (the rest, for
      // rows over 32 * kQVecs * 16 bytes, are read from shared memory)
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
              Vec16<T>::unpack(
                  *reinterpret_cast<const uint4*>(kr + j * kVec), kf);
#pragma unroll
              for (int u = 0; u < kVec; ++u) s += qv[v_][u] * kf[u];
            }
          }
          for (int j = sub + kQVecs * lpt; j < row_vecs; j += lpt) {
            float kf[kVec];
            Vec16<T>::unpack(*reinterpret_cast<const uint4*>(kr + j * kVec),
                             kf);
#pragma unroll
            for (int u = 0; u < kVec; ++u) s += qr[j * kVec + u] * kf[u];
          }
        }
        for (int o = lpt >> 1; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (t < nt && sub == 0) p_w[t] = s;
      }
      __syncwarp();
      // online softmax over the chunk, with the TPU kernel's -inf guards
      // (_decode_kernel :46-50)
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
        float2 a = pair_f(acc + r * D + 2 * pr);
        a.x *= alpha;
        a.y *= alpha;
#pragma unroll 4
        for (int t = 0; t < nt; ++t) {
          const float w = p_w[t];
          const float2 vv = pair_f(vc + t * D + 2 * pr);
          a.x += w * vv.x;
          a.y += w * vv.y;
        }
        *reinterpret_cast<float2*>(acc + r * D + 2 * pr) = a;
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
      *reinterpret_cast<float2*>(part.acc + at * D + 2 * pr) =
          pair_f(acc + r * D + 2 * pr);
    if (my_part == 0 && lane == 0) {
      part.m[at] = m_s[r * parts];
      part.l[at] = l_s[r * parts];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(float* __restrict__ ws, T* __restrict__ out, int rows,
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
int chunk_tokens(int R, int D, int es) {
  int Tc = 64;
  while (Tc > 8 && SmemLayout(R, D, Tc, es).total > 100 * 1024) Tc /= 2;
  return Tc;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, float* ws, Strides ks,
                   Strides vs, int B, int KV, int R, int D, int S,
                   int n_split, int span, cudaStream_t stream) {
  const int Tc = chunk_tokens(R, D, sizeof(T));
  const size_t smem = SmemLayout(R, D, Tc, sizeof(T)).total;
  static size_t allowed = 48 * 1024;
  cudaError_t err = allow_smem(decode_split_kernel<T>, smem, &allowed);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)D);
  decode_split_kernel<T><<<dim3(B * KV, n_split), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, ws, ks, vs, B, KV, R, D, S, Tc, span,
      n_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t w_smem = sizeof(float) * (n_split + 1);
  static size_t w_allowed = 48 * 1024;
  err = allow_smem(decode_combine_kernel<T>, w_smem, &w_allowed);
  if (err != cudaSuccess) return err;
  // programmatic dependent launch: the combine's launch and block
  // scheduling overlap the split kernel's run
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
  return cudaLaunchKernelEx(&cfg, decode_combine_kernel<T>, ws,
                            static_cast<T*>(out), B * KV * R, n_split, D);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements (batch,
// sequence, KV head); the head dim is contiguous. `ws` holds
// B * H * n_split * (D + 2) floats (SplitPartials); `span` is a
// multiple of 64 with n_split * span >= S. Returns the cudaError_t of the
// launches (0 on success). Launches on `stream`, does not synchronise.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* lengths, void* out, float* ws,
                                int dtype, int B, int H, int KV, int D, int S,
                                int n_split, int span, long long k_sb,
                                long long k_ss, long long k_sh,
                                long long v_sb, long long v_ss,
                                long long v_sh, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (KV <= 0 || H % KV != 0 || D <= 0 || S <= 0 || n_split <= 0 ||
      span <= 0 || span % 64 != 0 || (long long)n_split * span < S)
    return (int)cudaErrorInvalidValue;
  const int vec = dtype == 0 ? 4 : 8;  // elements per 16-byte load
  if (D % vec != 0 || k_sb % vec || k_ss % vec || k_sh % vec || v_sb % vec ||
      v_ss % vec || v_sh % vec ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(ws) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const Strides ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const int R = H / KV;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, lengths, out, ws, ks, vs, B, KV, R, D,
                              S, n_split, span, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, lengths, out, ws, ks, vs, B,
                                      KV, R, D, S, n_split, span, s);
  return (int)cudaErrorInvalidValue;
}
