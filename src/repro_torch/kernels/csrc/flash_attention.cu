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
// Bound on an H100 SXM: at prefill lengths this is compute-bound. The
// least work is 4 * B * H * D flops per unmasked (q, k) pair, about
// B * H * Sq * Sk / 2 pairs when causal, against the input type's peak
// (989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32); the bytes
// (q, k, v read once, out written once) are far below it.
//
// What this design does about it, and what it does not: each thread
// block owns 64 query rows of one head and walks the key tiles, keeping
// the score and probability tiles in shared memory and the output
// accumulator in registers, so nothing quadratic touches device memory;
// causal key tiles wholly above the diagonal are skipped (the Pallas
// kernel masks them; skipping gives the same result). The products run
// as fp32 FMAs on the CUDA cores (no TF32, no tensor cores) from
// register tiles over shared memory, so bf16 runs at the fp32 rate, far
// below the tensor-core roof: wgmma / mma.sync on bf16 tiles is the lever.
// Tiles are sized by D so that D = 256 fits in shared memory: 64 query
// rows, 64 key rows up to D = 128 and 32 beyond.
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;  // 16 x 16 (see tile_fma)
constexpr int TQ = 64;         // query rows per thread block
constexpr int LQ = TQ + 1;     // padded row of the q-major tiles

struct Strides {  // in elements: batch, head, sequence
  long long b, h, s;
};

template <int D>
__host__ __device__ constexpr int key_tile() {
  return D <= 128 ? 64 : 32;
}

template <int D>
__host__ __device__ constexpr size_t smem_floats() {
  constexpr int TK = key_tile<D>();
  return (size_t)D * LQ + (size_t)D * (TK + 1) + (size_t)TK * D +
         (size_t)TK * LQ;
}

// Shared memory, fp32:
//   qt[D][LQ]   (q tile transposed, pre-scaled)
//   kt[D][TK+1] (k tile transposed)
//   vs[TK][D]
//   pt[TK][LQ]  (probabilities, transposed)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, Strides qs,
             Strides ks, Strides vs, Strides os, int H, int KV, int Sq,
             int Sk, int causal, float scale) {
  constexpr int TK = key_tile<D>();
  constexpr int LK = TK + 1;
  constexpr int TM = TQ / 16, TN = TK / 16, TD = D / 16;
  extern __shared__ float smem[];
  float* qt = smem;
  float* kt = qt + D * LQ;
  float* vt = kt + D * LK;
  float* pt = vt + TK * D;

  const int q0 = blockIdx.x * TQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  const T* q_bh = q + b * qs.b + h * qs.h;
  for (int i = tid; i < TQ * D; i += kThreads) {
    const int r = i / D, d = i - (i / D) * D;
    const float x = q0 + r < Sq ? to_f(q_bh[(q0 + r) * qs.s + d]) : 0.f;
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
    for (int i = tid; i < TK * D; i += kThreads) {
      const int r = i / D, d = i - (i / D) * D;
      const bool in = k0 + r < Sk;
      kt[d * LK + r] = in ? to_f(k_b[(k0 + r) * ks.s + d]) : 0.f;
      vt[r * D + d] = in ? to_f(v_b[(k0 + r) * vs.s + d]) : 0.f;
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
    tile_fma<TM, TD>(pt, LQ, vt, D, TK, ty, tx, o);
  }

  T* o_bh = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int j = 0; j < TD; ++j)
      o_bh[r * os.s + tx + 16 * j] = from_f<T>(o[i][j] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   Strides qs, Strides ks, Strides vs, Strides os, int B,
                   int H, int KV, int Sq, int Sk, int causal,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  static size_t allowed = 48 * 1024;
  cudaError_t err = allow_smem(flash_kernel<T, D>, smem, &allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + TQ - 1) / TQ, B * H);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), qs, ks, vs, os, H, KV,
      Sq, Sk, causal, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     Strides qs, Strides ks, Strides vs, Strides os, int B,
                     int H, int KV, int D, int Sq, int Sk, int causal,
                     cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, out, qs, ks, vs, os, B, H, KV, Sq, Sk,
                           causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, qs, ks, vs, os, B, H, KV, Sq, Sk,
                            causal, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, qs, ks, vs, os, B, H, KV, Sq, Sk,
                            causal, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D one of 64, 128, 256. Strides are in
// elements (batch, head, sequence); the head dim is contiguous. Returns
// the cudaError_t of the launch (0 on success). Launches on `stream` and
// does not synchronise.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int dtype, int B, int H, int KV,
                               int D, int Sq, int Sk, int causal,
                               const long long* strides, void* stream) {
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  if (KV <= 0 || H % KV != 0 || Sk < 0) return (int)cudaErrorInvalidValue;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_d<float>(q, k, v, out, qs, ks, vs, os, B, H, KV, D,
                                Sq, Sk, causal, s);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(q, k, v, out, qs, ks, vs, os, B, H,
                                        KV, D, Sq, Sk, causal, s);
  return (int)cudaErrorInvalidValue;
}
