// Mamba2 SSD chunked scan for Hopper (sm_90a), from a zero state. Plain
// C interface, loaded from Python through ctypes
// (repro_torch/kernels/ssd_scan.py).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py: ssd_scan
// (pallas_call at :99, body _ssd_kernel at :38), with the same contract:
//   x     [b, L, H, P]   fp32 or bf16, contiguous
//   dt    [b, L, H]      fp32 (already softplus'd)
//   A     [H]            fp32 (negative)
//   B, C  [b, L, G, N]   x's type; head h reads group h / (H / G)
//   y     [b, L, H, P]   x's type
//   h_out [b, H, P, N]   x's type: the state after the last token
// Per chunk of Q tokens, with cs the in-chunk cumulative sum of dt * A:
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//           + exp(cs_i) C_i . h
//   h    <- exp(cs_last) h + sum_j exp(cs_last - cs_j) dt_j x_j (x) B_j
// in fp32, exp of cumulative-sum differences as _segsum_exp (:28) does.
// The wrapper passes L as a multiple of the chunk, as the Pallas kernel
// requires; a ragged last chunk would be masked here all the same.
//
// Bound on an H100 SXM: per chunk and group, C B^T is 2 Q^2 N flops
// (causal half: Q^2 N); per head the masked scores times x, C h and the
// state update add about Q^2 P + 4 Q P N. At mamba2-780m's widths
// (H 48, P 64, G 1, N 128, Q 256) the least work over the input type's
// peak is below the time to read x, B, C and write y once, so the bound
// is bytes.
//
// What this design does, and what it does not: one thread block per
// (batch, head) carries h [P, N] in shared memory along the chunks — the
// TPU grid's sequential axis becomes a loop in the block. A 256-token
// chunk's B and C in fp32 (128 KB each) and its Q x Q score tile (256 KB)
// do not fit in 227 KB of shared memory, so the chunk is walked in 64-row
// tiles: for each tile of query rows, the causal key tiles up to it
// (C B^T masked and scaled, then times x), then C h; then the state
// update over the chunk's key tiles. Products are fp32 FMAs from register
// tiles over shared memory (tile_fma). Only b * H thread blocks run (48 at
// b = 1 on 132 SMs), and every head of a group recomputes C B^T: splitting
// the chunks across blocks (chunk states in parallel, then a short pass
// over them) and sharing C B^T per group are the levers.
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;  // 16 x 16 (see tile_fma)
constexpr int TI = 64;         // token rows per tile
constexpr int LI = TI + 1;     // padded row of the token-major tiles
constexpr int PT = 64;         // largest head dim P
constexpr int NT = 128;        // largest state dim N

size_t smem_floats(int Q) {
  return (size_t)NT * PT      // ht: state, [N][P]
         + (size_t)NT * LI    // ct: C tile transposed / B tile in the update
         + (size_t)NT * LI    // bt: B tile transposed / weighted x tile
         + (size_t)TI * PT    // xs: x tile
         + (size_t)TI * LI    // st: masked scores, transposed
         + (size_t)2 * Q;     // dts, cs
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, T* __restrict__ y, T* __restrict__ h_out,
           int L, int H, int G, int P, int N, int Q) {
  extern __shared__ float smem[];
  float* ht = smem;
  float* ct = ht + NT * PT;
  float* bt = ct + NT * LI;
  float* xs = bt + NT * LI;
  float* st = xs + TI * PT;
  float* dts = st + TI * LI;
  float* cs = dts + Q;

  const int bi = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const float a_h = A[h];

  for (int i = tid; i < NT * PT; i += kThreads) ht[i] = 0.f;

  // row t of the [b, L, H|G, P|N] operands for this (batch, head)
  auto x_row = [&](int t) { return x + (((size_t)bi * L + t) * H + h) * P; };
  auto bc_row = [&](const T* base, int t) {
    return base + (((size_t)bi * L + t) * G + g) * N;
  };

  for (int t0 = 0; t0 < L; t0 += Q) {
    const int qn = min(Q, L - t0);
    __syncthreads();  // the previous chunk's readers of dts / cs are done
    for (int t = tid; t < qn; t += kThreads)
      dts[t] = dt[((size_t)bi * L + t0 + t) * H + h];
    __syncthreads();
    if (tid == 0) {  // in-chunk cumulative sum of dt * A
      float acc = 0.f;
      for (int t = 0; t < qn; ++t) {
        acc += dts[t] * a_h;
        cs[t] = acc;
      }
    }
    __syncthreads();

    // ---- outputs, 64 query rows at a time
    for (int i0 = 0; i0 < qn; i0 += TI) {
      for (int e = tid; e < TI * NT; e += kThreads) {
        const int i = e / NT, n = e - (e / NT) * NT;
        float c = 0.f;
        if (i0 + i < qn && n < N) c = to_f(bc_row(Cm, t0 + i0 + i)[n]);
        ct[n * LI + i] = c;
      }
      float yacc[4][4] = {};
      for (int j0 = 0; j0 <= i0; j0 += TI) {
        __syncthreads();
        for (int e = tid; e < TI * NT; e += kThreads) {
          const int j = e / NT, n = e - (e / NT) * NT;
          float bv = 0.f;
          if (j0 + j < qn && n < N) bv = to_f(bc_row(Bm, t0 + j0 + j)[n]);
          bt[n * LI + j] = bv;
        }
        for (int e = tid; e < TI * PT; e += kThreads) {
          const int j = e / PT, p = e - (e / PT) * PT;
          float xv = 0.f;
          if (j0 + j < qn && p < P) xv = to_f(x_row(t0 + j0 + j)[p]);
          xs[j * PT + p] = xv;
        }
        __syncthreads();
        float s[4][4] = {};
        tile_fma<4, 4>(ct, LI, bt, LI, N, ty, tx, s);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int gi = i0 + ty + 16 * a;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int gj = j0 + tx + 16 * c;
            float w = 0.f;
            if (gj <= gi && gi < qn) w = expf(cs[gi] - cs[gj]) * dts[gj];
            st[(tx + 16 * c) * LI + ty + 16 * a] = s[a][c] * w;
          }
        }
        __syncthreads();
        tile_fma<4, 4>(st, LI, xs, PT, TI, ty, tx, yacc);
      }
      // carried state: exp(cs_i) * (C_i . h)
      float off[4][4] = {};
      tile_fma<4, 4>(ct, LI, ht, PT, N, ty, tx, off);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int gi = i0 + ty + 16 * a;
        if (gi >= qn) continue;
        const float e = expf(cs[gi]);
        T* y_row = y + (((size_t)bi * L + t0 + gi) * H + h) * P;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tx + 16 * c;
          if (p < P) y_row[p] = from_f<T>(yacc[a][c] + e * off[a][c]);
        }
      }
      __syncthreads();  // ct is reloaded by the next row tile
    }

    // ---- state update: h = exp(cs_last) h + sum_j B_j^T (w_j x_j)
    const float cl = cs[qn - 1];
    float hacc[8][4];
    const float decay = expf(cl);
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        hacc[a][c] = ht[(ty + 16 * a) * PT + tx + 16 * c] * decay;
    float* bn = ct;  // [TI][NT]: B tile, token-major
    float* xw = bt;  // [TI][PT]: weighted x tile
    for (int j0 = 0; j0 < qn; j0 += TI) {
      __syncthreads();
      for (int e = tid; e < TI * NT; e += kThreads) {
        const int j = e / NT, n = e - (e / NT) * NT;
        float bv = 0.f;
        if (j0 + j < qn && n < N) bv = to_f(bc_row(Bm, t0 + j0 + j)[n]);
        bn[j * NT + n] = bv;
      }
      for (int e = tid; e < TI * PT; e += kThreads) {
        const int j = e / PT, p = e - (e / PT) * PT;
        float xv = 0.f;
        if (j0 + j < qn && p < P) {
          const float w = expf(cl - cs[j0 + j]) * dts[j0 + j];
          xv = to_f(x_row(t0 + j0 + j)[p]) * w;
        }
        xw[j * PT + p] = xv;
      }
      __syncthreads();
      tile_fma<8, 4>(bn, NT, xw, PT, TI, ty, tx, hacc);
    }
    __syncthreads();  // all readers of ht (C h above) are done
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ht[(ty + 16 * a) * PT + tx + 16 * c] = hacc[a][c];
  }

  __syncthreads();
  T* h_bh = h_out + ((size_t)bi * H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e - (e / N) * N;
    h_bh[e] = from_f<T>(ht[n * PT + p]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, void* y, void* h_out,
                   int b, int L, int H, int G, int P, int N, int Q,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(Q);
  static size_t allowed = 48 * 1024;
  cudaError_t err = allow_smem(ssd_kernel<T>, smem, &allowed);
  if (err != cudaSuccess) return err;
  ssd_kernel<T><<<b * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), static_cast<T*>(h_out),
      L, H, G, P, N, Q);
  return cudaGetLastError();
}

}  // namespace

// Largest chunk the kernel takes: the chunk's dt and cumulative sums sit in
// shared memory beside fixed tiles, within 227 KB.
extern "C" int ssd_max_chunk() {
  return (int)((232448 / sizeof(float) - smem_floats(0)) / 2);
}

// dtype: 0 = float32, 1 = bfloat16; P <= 64, N <= 128, G divides H.
// Returns the cudaError_t of the launch (0 on success). Launches on
// `stream` and does not synchronise.
extern "C" int ssd_scan(const void* x, const float* dt, const float* A,
                        const void* Bm, const void* Cm, void* y, void* h_out,
                        int dtype, int b, int L, int H, int G, int P, int N,
                        int Q, void* stream) {
  if (b == 0 || H == 0) return (int)cudaSuccess;
  if (G <= 0 || H % G != 0 || P <= 0 || P > PT || N <= 0 || N > NT ||
      Q <= 0 || Q > ssd_max_chunk() || L <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, dt, A, Bm, Cm, y, h_out, b, L, H, G, P, N, Q,
                              s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, h_out, b, L, H, G,
                                      P, N, Q, s);
  return (int)cudaErrorInvalidValue;
}
