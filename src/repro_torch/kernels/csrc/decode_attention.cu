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
// What this design does about it. A call is two launches, both the
// split-K walk of common.cuh (namespace split_decode), which this file
// shares with paged decode: it supplies only how a position maps to its
// K/V row (DenseRows: a strided row) and the C entry point.
// 1. split_kernel, grid (B * KV, n_split): the sequence is cut into
//    n_split ranges of `span` positions (a multiple of 64), chosen on the
//    host from shapes alone (decode_attention.py: plan_splits) so that the
//    grid covers the SMs four times. A block walks its range up to
//    min(length, S) (the Pallas kernel streams every block and masks;
//    stopping gives the same result); a range that starts past the row's
//    length writes an empty partial (m = -inf, l = 0) and exits. K/V go
//    through a two-stage ring of Tc-token chunks filled by 16-byte cp.async
//    copies (8, 4 or 2 bytes where a row or stride is not a whole number
//    of 16-byte vectors: any D, as the Pallas kernel takes), so chunk
//    c + 1 loads while chunk c computes, with one block
//    barrier per chunk. Each K/V row is shared across the R = H / KV query
//    heads. Of the block's 8 warps, warp w owns heads w, w + 8, ... (or,
//    when R < 8, a part of D of one head): it computes that head's scores
//    with a group of lanes across D per token (q's slice in registers)
//    and a shuffle reduction, runs the online softmax
//    on a warp-private row of shared memory, and accumulates p V for its
//    part of D; nothing but the ring is shared between warps. The partial
//    (acc, m, l) of every (row, head, split) goes to a workspace that the
//    wrapper allocates (common.cuh: SplitPartials).
// 2. combine_kernel, one block per (row, head): the split-K merge
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

struct Strides {  // in elements: batch, sequence, KV head
  long long b, s, h;
};

// A position's K/V row in the dense cache: row base + pos * stride.
template <typename T>
struct DenseRows {
  static constexpr bool kUsesIds = false;
  const T* k;
  const T* v;
  Strides ks, vs;
  __device__ void bind(int row, int kvh, int, int, int*, int, int) {
    k += row * ks.b + kvh * ks.h;
    v += row * vs.b + kvh * vs.h;
  }
  __device__ const T* k_row(int pos) const { return k + pos * ks.s; }
  __device__ const T* v_row(int pos) const { return v + pos * vs.s; }
};

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, float* ws, Strides ks,
                   Strides vs, int B, int KV, int R, int D, int S,
                   int n_split, int span, cudaStream_t stream) {
  const DenseRows<T> rows{static_cast<const T*>(k), static_cast<const T*>(v),
                          ks, vs};
  const long long strides[6] = {ks.b, ks.s, ks.h, vs.b, vs.s, vs.h};
  const void* ptrs[2] = {k, v};
  const int vb =
      split_decode::row_vec_bytes(D, sizeof(T), strides, 6, ptrs, 2);
  return split_decode::launch<T>(q, rows, lengths, out, ws, B, KV, R, D, S,
                                 n_split, span, 0, vb, stream);
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
  if (reinterpret_cast<uintptr_t>(ws) % 16 != 0)
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
