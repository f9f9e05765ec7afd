// Paged decode attention for Hopper (sm_90a): one new query token per
// batch row against a block-table KV pool, GQA-grouped, fp32 online
// softmax, split-K over the block table. Plain C interface, loaded from
// Python through ctypes (repro_torch/kernels/paged_decode.py).
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
//
// What bounds it on an H100 SXM: bytes. The least work is reading each
// valid K and V tile once,
//   sum_b ceil(len_b / bs) * bs * KV * D * 2 * sizeof(dtype)  bytes,
// over 3.35 TB/s; the q / out / table bytes are small beside it, and the
// 4 * H * len * D flops per row are far below the compute roof. At the
// serving path's decode shapes (B 8, 32 heads, 4 KV heads, D 64, lengths
// up to ~600) that is about half a microsecond, so what is left is
// latency: launches and the chain of dependent loads in each block.
//
// What this design does about it: the split-K walk of dense decode
// (common.cuh, namespace split_decode), with a table lookup where dense
// decode has a strided row. A call is two launches:
// 1. split_kernel, grid (B * KV, n_split). The table's capacity
//    S = max_blocks * bs is cut into n_split ranges of `span` positions,
//    a multiple of both 64 and bs, so a range is a whole number of pool
//    blocks (paged_decode.py: plan_paged_splits, from shapes and the SM
//    count only, no device-to-host read of the lengths). A block reads its
//    range's table entries into shared memory once (PagedRows::bind;
//    entries outside [0, n_blocks) become block 0), stops at
//    min(length, range end), and stages each (pool block, KV head) tile,
//    bs * D contiguous elements, through the two-stage cp.async ring of
//    64-token chunks, sharing every K/V row across the R query heads. A
//    range wholly past the row's length writes an empty partial, so a
//    length-0 row comes out exactly zero.
// 2. combine_kernel, one block per (row, query head), as a programmatic
//    dependent launch: the merge of common.cuh (combine_split_row).
// At B 8, KV 4 and a 64-block table of bs 16 this gives 16 splits of 64
// positions: 512 blocks on 132 SMs.
//
// What is still left: the decode step around the kernel is host-bound
// (eager PyTorch: the card idles over 90% of the step), so a CUDA graph over
// the whole decode step is the next lever, in a later change; inside the
// kernel, the second launch and the table read before the first K/V load
// are the latency that remains.
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace repro;

// A position's K/V row in the pool: the table entry of its block, staged
// in shared memory by bind() for the block's range of positions.
template <typename T>
struct PagedRows {
  static constexpr bool kUsesIds = true;
  int bs;
  const T* k;
  const T* v;
  const int* tables;
  int KV, max_blocks, n_blocks, D;
  const int* ids = nullptr;  // the range's block ids (shared memory)
  int first = 0;             // table column of ids[0]

  __device__ void bind(int row, int kvh, int s0, int s1, int* ids_s, int tid,
                       int nthreads) {
    first = s0 / bs;
    const int n = (s1 + bs - 1) / bs - first;
    const int* trow = tables + (size_t)row * max_blocks + first;
    for (int i = tid; i < n; i += nthreads) {
      const int blk = trow[i];
      ids_s[i] = (blk < 0 || blk >= n_blocks) ? 0 : blk;
    }
    ids = ids_s;
    const size_t head = (size_t)kvh * bs * D;
    k += head;
    v += head;
  }
  __device__ size_t offset(int pos) const {
    const int j = pos / bs;
    return (size_t)ids[j - first] * KV * bs * D + (size_t)(pos - j * bs) * D;
  }
  __device__ const T* k_row(int pos) const { return k + offset(pos); }
  __device__ const T* v_row(int pos) const { return v + offset(pos); }
};

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* tables, const int* lengths, void* out, float* ws,
                   int B, int KV, int R, int D, int bs, int max_blocks,
                   int n_blocks, int n_split, int span, cudaStream_t stream) {
  PagedRows<T> rows{bs, static_cast<const T*>(k_pool),
                    static_cast<const T*>(v_pool), tables, KV, max_blocks,
                    n_blocks, D};
  // every row starts a whole number of rows into its pool
  const void* ptrs[2] = {k_pool, v_pool};
  const int vb =
      split_decode::row_vec_bytes(D, sizeof(T), nullptr, 0, ptrs, 2);
  // a range of `span` positions reads span / bs table entries
  return split_decode::launch<T>(q, rows, lengths, out, ws, B, KV, R, D,
                                 max_blocks * bs, n_split, span, span / bs,
                                 vb, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `ws` holds B * H * n_split * (D + 2)
// floats (SplitPartials); `span` is a multiple of 64 and of bs with
// n_split * span >= max_blocks * bs. Returns the cudaError_t of the
// launches (0 on success). Launches on `stream`, does not synchronise.
extern "C" int paged_decode_attention(const void* q, const void* k_pool,
                                      const void* v_pool, const int* tables,
                                      const int* lengths, void* out,
                                      float* ws, int dtype, int B, int H,
                                      int KV, int D, int bs, int max_blocks,
                                      int n_blocks, int n_split, int span,
                                      void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (KV <= 0 || H % KV != 0 || D <= 0 || bs <= 0 || max_blocks <= 0 ||
      n_blocks <= 0 || n_split <= 0 || span <= 0 || span % 64 != 0 ||
      span % bs != 0 || (long long)n_split * span < (long long)max_blocks * bs)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(ws) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int R = H / KV;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k_pool, v_pool, tables, lengths, out, ws, B,
                              KV, R, D, bs, max_blocks, n_blocks, n_split,
                              span, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k_pool, v_pool, tables, lengths, out,
                                      ws, B, KV, R, D, bs, max_blocks,
                                      n_blocks, n_split, span, s);
  return (int)cudaErrorInvalidValue;
}
