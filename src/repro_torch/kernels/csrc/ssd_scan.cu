// Mamba2 SSD chunked scan for Hopper (sm_90a), from a zero state, in the
// chunk-parallel form of the SSD paper (arXiv:2405.21060, the block
// decomposition). Plain C interface, loaded from Python through ctypes
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
// The wrapper passes L as a multiple of the chunk, as the Pallas kernel
// requires; a ragged last chunk would be masked here all the same.
//
// Widths: any P, and N up to 256 (the Pallas kernel takes any P and N), in
// whole 16-byte rows (P and N multiples of 8 in bf16, of 4 in fp32; the
// wrapper zero-pads others, which is exact: zero x columns give y columns
// that are dropped, zero B and C columns add nothing). y's columns and the
// state's rows are independent in p, so P runs in slabs of 64 over the
// grids of passes 1 and 3; the state's columns are independent in n, so
// pass 1 runs N in slabs of 128, and pass 3, whose C_i . B_j and C_i . h_c
// sum over all of N, is built for N up to 128 and up to 256 (its key and
// query tiles hold whole rows of N). Columns past P or N up to the next
// multiple of 16 (the products' k16 and n16 steps) are zero-filled in the
// loads and never stored. N above 256 and chunks above kMaxChunk are the
// kernels' bounds.
//
// What bounds it on an H100 SXM: bytes. At mamba2-780m's widths (H 48,
// P 64, G 1, N 128, Q 256, b 1, L 2048) reading x, B, C, dt and writing
// y and the state once is 27.4 MB, 8.2 us at 3.35 TB/s; the least work
// (C B^T once per group over each chunk's causal pairs, then per head the
// masked scores times x, C h and the state update) is 4.9 GFLOP, 5.0 us at
// the bf16 tensor-core peak (chip_smoke.py: ssd_flops).
//
// What this design does about it: the chunks run in parallel, and the
// sequential part shrinks to an elementwise walk over the chunk states.
// A call is three launches, chained as programmatic dependent launches:
// 1. chunk states, grid (chunk * H + head, batch): a block computes its
//    chunk's cumulative sum cs (one warp, from dt staged in shared memory)
//    and the chunk's own contribution to the state,
//      s_c[p][n] = sum_j exp(cs_last - cs_j) dt_j x_j[p] B_j[n],
//    a [P x Q] . [Q x N] product over 64-token slabs (bf16: B and x in a
//    two-stage cp.async ring, x weighted in shared memory), into an fp32
//    workspace with cs_last.
// 2. state passing, grid (tile of P * N, head, batch): each thread walks
//    its four state elements through the chunks in order,
//      h_0 = 0,  h_{c+1} = exp(cs_last,c) h_c + s_c,
//    overwriting s_c with h_c (the state entering chunk c, fp32) and
//    writing the final state in x's type. Loads of eight chunks are in
//    flight at once.
// 3. chunk scan, grid ((chunk * H + head) * query tiles + tile, batch): a
//    block of query rows (bf16: 128, 8 warps; fp32: 64) recomputes cs,
//    then for each key tile of 64 up to its last row (a warp skips the
//    tiles wholly above its rows) computes C_i . B_j, masks and scales it
//    by exp(cs_i - cs_j) dt_j, and multiplies by x_j; only then does it
//    wait for pass 2 (griddepcontrol.wait) and add exp(cs_i) C_i . h_c.
//    Everything before the wait reads only the inputs, so it overlaps the
//    first two passes' tails.
// Measured on an H100 (chip_ssd_passes.py, which times variant builds of
// this file; PERF.md has the run): at mamba2-780m, b 1, the call takes
// 0.110 ms, of which pass 1 ~0.021, pass 2 ~0.011, pass 3 ~0.085 ms.
// C B^T is recomputed per head rather than once per (chunk, group):
// skipping those products entirely takes only 0.013 ms off pass 3, the
// most that sharing could save, and a shared copy needs either a fourth
// launch with an fp32 round trip through memory or blocks holding several
// heads (a two-head variant needed 207 registers, fit two blocks an SM
// instead of three, and ran slower). 128 query rows a block rather than 64
// load each key tile for twice the rows: 0.110 against 0.126 ms.
//
// bf16 runs every product on the tensor cores: mma.sync m16n8k16 (bf16
// in, fp32 accumulate) with operands staged in padded shared memory
// (rows of 272 or 144 bytes, so ldmatrix reads are free of bank
// conflicts) and read by ldmatrix (.trans where the operand is stored
// K-major). Inputs go to shared memory through 16-byte cp.async copies,
// the key tiles of passes 1 and 3 through two-stage rings. The places
// where bf16 rounds (the plain model ssd_scan.py: ssd_scan_chunked_ref
// rounds at exactly these):
//   - the weighted x, exp(cs_last - cs_j) dt_j x_j, before the product
//     with B in pass 1;
//   - the masked, scaled scores (C_i . B_j) exp(cs_i - cs_j) dt_j before
//     the product with x in pass 3;
//   - h_c, before C_i . h_c in pass 3;
//   - y and the final state, on output (as the Pallas kernel does).
// Every sum, cs, the chunk states and h_c stay fp32.
// fp32 keeps CUDA-core FMAs (common.cuh: tile_fma, 256 threads) in the
// same three passes: TF32 cannot meet the fp32 tolerances.
//
// What is still left (the call is at ~7% of its bound): pass 3 without
// its C B^T and C h products still takes ~0.06 ms, so the latency of its
// key-tile walk (a two-stage ring, 16 warps an SM, each tile waited for
// by the whole block) is the next thing to cut, e.g. with TMA loads and
// wgmma fed by a producer warp; h_c crosses memory in fp32 (12.6 MB at
// mamba2-780m) and is read once per query tile; y is stored in 4-byte
// pairs.
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace repro;
using bf16 = __nv_bfloat16;

constexpr int TI = 64;          // token rows per tile
constexpr int PT = 64;          // P slab: head-dim columns a block holds
constexpr int NT = 128;         // N slab of pass 1; pass 3's narrower build
constexpr int kMaxN = 256;      // pass 3's wider build: the largest N
constexpr int kMaxChunk = 1024;  // the chunk's dt and cs sit in shared memory
constexpr int kMmaThreads = 128;   // bf16 pass 1: 4 warps x 16 state rows
constexpr int kFmaThreads = 256;   // fp32 passes 1 and 3: 16 x 16 (tile_fma)
constexpr int kPassThreads = 256;  // pass 2
constexpr int kQRows = 128;  // bf16 pass 3: query rows a block, 16 a warp
constexpr int kScanThreads = kQRows * 2;
constexpr int kHLoads = 8;  // 16-byte loads of h_c in flight a thread (pass 3)
constexpr int LDN = NT + 8;     // bf16 row of a [.][N] tile: 272 bytes
constexpr int LDP = PT + 8;     // bf16 row of a [.][P] tile: 144 bytes
// bf16 row of pass 3's [.][N] tiles for N up to NTL (528 bytes at 256)
template <int NTL>
__host__ __device__ constexpr int ldn() {
  return NTL + 8;
}
__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }
constexpr int LI = TI + 1;      // fp32 row of a token-major tile, padded

// ------------------------------------------------ tensor-core building blocks
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// d (16 x 8, fp32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16).
// Fragments (lane l, g = l / 4, q = l % 4): a[0] (row g, cols 2q, 2q+1),
// a[1] row g + 8, a[2] cols + 8, a[3] both; b0 (k 2q, 2q+1, col g), b1
// k + 8; d[0], d[1] (row g, cols 2q, 2q+1), d[2], d[3] row g + 8.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// --------------------------------------------------------- shared pieces
// dt of the chunk's first qn tokens to shared memory (all threads), then
// cs = their inclusive cumulative sum of dt * a, by warp 0: lane l sums
// tokens [l E, l E + E) in order, E = ceil(qn / 32), then adds the sum of
// the lanes below it. The same qn gives the same cs in every pass.
__device__ __forceinline__ void chunk_cumsum(const float* dt, int stride,
                                             float a, int qn, float* dts,
                                             float* cs, int tid,
                                             int nthreads) {
  for (int t = tid; t < qn; t += nthreads) dts[t] = dt[(size_t)t * stride];
  __syncthreads();
  if (tid < 32) {
    const int E = (qn + 31) / 32;
    const int beg = tid * E, end = min(beg + E, qn);
    float run = 0.f;
    for (int t = beg; t < end; ++t) {
      run += dts[t] * a;
      cs[t] = run;
    }
    float incl = run;
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, incl, o);
      if (tid >= o) incl += y;
    }
    float below = __shfl_up_sync(0xffffffffu, incl, 1);
    if (tid == 0) below = 0.f;
    for (int t = beg; t < end; ++t) cs[t] += below;
  }
  __syncthreads();
}

struct Dims {
  int b, L, H, G, P, N, Q, nc;
  __device__ int group(int h) const { return h / (H / G); }
  __host__ __device__ int p_slabs() const { return (P + PT - 1) / PT; }
  __host__ __device__ int n_slabs() const { return (N + NT - 1) / NT; }
  // element offsets of token t's rows
  __device__ size_t x_at(int bi, int t, int h) const {
    return (((size_t)bi * L + t) * H + h) * P;
  }
  __device__ size_t bc_at(int bi, int t, int g) const {
    return (((size_t)bi * L + t) * G + g) * N;
  }
  __device__ size_t dt_at(int bi, int t, int h) const {
    return ((size_t)bi * L + t) * H + h;
  }
  // the fp32 state workspace [b][H][nc][P][N], then cs_last [b][H][nc]
  __device__ size_t state_at(int bi, int h, int c) const {
    return (((size_t)bi * H + h) * nc + c) * P * N;
  }
  __device__ size_t last_at(int bi, int h, int c) const {
    return (size_t)b * H * nc * P * N + ((size_t)bi * H + h) * nc + c;
  }
};

// rows r0.. of a [rows][vcols] bf16 operand (row stride `gstride`
// elements, vcols a multiple of 8) into the first `cols` columns of shared
// memory rows of `ld` elements, 16 bytes per cp.async; rows at or past
// `valid` and columns at or past vcols are zero-filled
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, const bf16* src,
                                           size_t gstride, int rows, int valid,
                                           int cols, int vcols, int tid,
                                           int nthreads) {
  const int vecs = cols / 8, vvecs = vcols / 8;
  for (int i = tid; i < rows * vecs; i += nthreads) {
    const int r = i / vecs, v = i - r * vecs;
    const bool ok = r < valid && v < vvecs;
    cp_async16(smem_addr(dst + r * ld + v * 8),
               ok ? src + r * gstride + v * 8 : src, ok ? 16 : 0);
  }
}

// ============================================================== pass 1
// A block computes the state's slab of rows [p0, p0 + PT) and columns
// [n0, n0 + NT), blockIdx.z = p slab * n_slabs + n slab; slab 0 writes
// cs_last. Pv and Nv are the slab's real rows and columns.
struct StateSlab {
  int p0, n0, Pv, Nv;
  __device__ explicit StateSlab(const Dims& d) {
    const int ns = d.n_slabs();
    p0 = (blockIdx.z / ns) * PT;
    n0 = (blockIdx.z % ns) * NT;
    Pv = min(PT, d.P - p0);
    Nv = min(NT, d.N - n0);
  }
};

// bf16: warp w owns slab rows p in [16 w, 16 w + 16), all its columns. The
// chunk's B and x go through a two-stage ring of 64-token slabs (raw
// cp.async copies), so slab s + 1 loads while slab s is weighted and
// multiplied.
__global__ void __launch_bounds__(kMmaThreads)
state_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const bf16* __restrict__ Bm,
                 float* __restrict__ ws, Dims d) {
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* b_s = reinterpret_cast<bf16*>(smem);  // [2][TI][LDN]: B slabs
  bf16* x_s = b_s + 2 * TI * LDN;             // [2][TI][LDP]: x slabs
  bf16* w_s = x_s + 2 * TI * LDP;             // [TI][LDP]: weighted x
  float* dts = reinterpret_cast<float*>(w_s + TI * LDP);
  float* cs = dts + d.Q;

  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int c = blockIdx.x / d.H, h = blockIdx.x % d.H, bi = blockIdx.y;
  const int g = d.group(h);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = c * d.Q, qn = min(d.Q, d.L - t0);
  const StateSlab sb(d);
  const int Pc = round16(sb.Pv), Nc = round16(sb.Nv);  // columns staged
  const size_t bc_stride = (size_t)d.G * d.N, x_stride = (size_t)d.H * d.P;
  const bf16* b_src = Bm + d.bc_at(bi, t0, g) + sb.n0;
  const bf16* x_src = x + d.x_at(bi, t0, h) + sb.p0;
  stage_rows(b_s, LDN, b_src, bc_stride, TI, qn, Nc, sb.Nv, tid,
             kMmaThreads);
  stage_rows(x_s, LDP, x_src, x_stride, TI, qn, Pc, sb.Pv, tid, kMmaThreads);
  cp_async_commit();
  chunk_cumsum(dt + d.dt_at(bi, t0, h), d.H, A[h], qn, dts, cs, tid,
               kMmaThreads);
  const float cl = cs[qn - 1];
  if (tid == 0 && blockIdx.z == 0) ws[d.last_at(bi, h, c)] = cl;

  float acc[NT / 8][4] = {};
  const int p0 = 16 * warp;
  const int n_pairs = Nc / 16;
  const int n_slabs = (qn + TI - 1) / TI;
  const int vecs = Pc / 8;
  for (int sl = 0; sl < n_slabs; ++sl) {
    const int st = sl & 1, j0 = sl * TI;
    cp_async_wait<0>();
    __syncthreads();  // slab sl landed; slab sl - 1's readers are done
    if (sl + 1 < n_slabs) {
      const int j1 = j0 + TI;
      stage_rows(b_s + (st ^ 1) * TI * LDN, LDN, b_src + j1 * bc_stride,
                 bc_stride, TI, qn - j1, Nc, sb.Nv, tid, kMmaThreads);
      stage_rows(x_s + (st ^ 1) * TI * LDP, LDP, x_src + j1 * x_stride,
                 x_stride, TI, qn - j1, Pc, sb.Pv, tid, kMmaThreads);
      cp_async_commit();
    }
    // weighted x: exp(cs_last - cs_j) dt_j x_j, rounded to bf16 (rows past
    // qn were zero-filled and stay zero)
    const bf16* xs = x_s + st * TI * LDP;
    for (int i = tid; i < TI * vecs; i += kMmaThreads) {
      const int r = i / vecs, v = i - r * vecs;
      const int j = min(j0 + r, qn - 1);
      const float w = __expf(cl - cs[j]) * dts[j];
      float f[8];
      Vec16<bf16>::unpack(
          *reinterpret_cast<const uint4*>(xs + r * LDP + v * 8), f);
      *reinterpret_cast<uint4*>(w_s + r * LDP + v * 8) =
          make_uint4(pack_bf16x2(f[0] * w, f[1] * w),
                     pack_bf16x2(f[2] * w, f[3] * w),
                     pack_bf16x2(f[4] * w, f[5] * w),
                     pack_bf16x2(f[6] * w, f[7] * w));
    }
    __syncthreads();
    if (p0 < Pc) {
      const bf16* bs = b_s + st * TI * LDN;
#pragma unroll
      for (int kk = 0; kk < TI / 16; ++kk) {
        // A = (weighted x)^T [p][j], stored [j][p]: transposed reads
        uint32_t a[4];
        ldsm_x4_t(a, w_s + (kk * 16 + (lane >> 4) * 8 + (lane & 7)) * LDP +
                         p0 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int np = 0; np < NT / 16; ++np) {
          if (np < n_pairs) {
            // B [j][n], stored [j][n]: transposed reads
            uint32_t b[4];
            ldsm_x4_t(b, bs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                  LDN +
                             np * 16 + (lane >> 4) * 8);
            mma16816(acc[2 * np], a, b[0], b[1]);
            mma16816(acc[2 * np + 1], a, b[2], b[3]);
          }
        }
      }
    }
  }
  if (p0 >= Pc) return;
  // the slab's origin; Nv is even, so n < Nv gives n + 1 < Nv too
  float* sto = ws + d.state_at(bi, h, c) + (size_t)sb.p0 * d.N + sb.n0;
  const int p = p0 + (lane >> 2), q2 = (lane & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < NT / 8; ++nt) {
    const int n = nt * 8 + q2;
    if (nt < 2 * n_pairs && n < sb.Nv) {
      if (p < sb.Pv)
        *reinterpret_cast<float2*>(sto + (size_t)p * d.N + n) =
            make_float2(acc[nt][0], acc[nt][1]);
      if (p + 8 < sb.Pv)
        *reinterpret_cast<float2*>(sto + (size_t)(p + 8) * d.N + n) =
            make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

// fp32: thread (ty, tx) owns rows p = ty + 16 a, columns n = tx + 16 c.
__global__ void __launch_bounds__(kFmaThreads)
state_fma_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 float* __restrict__ ws, Dims d) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* b_s = reinterpret_cast<float*>(smem);  // [TI][NT]: B slab
  float* w_s = b_s + TI * NT;                   // [TI][PT]: weighted x slab
  float* dts = w_s + TI * PT;
  float* cs = dts + d.Q;

  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int c = blockIdx.x / d.H, h = blockIdx.x % d.H, bi = blockIdx.y;
  const int g = d.group(h);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int t0 = c * d.Q, qn = min(d.Q, d.L - t0);
  const StateSlab sb(d);
  chunk_cumsum(dt + d.dt_at(bi, t0, h), d.H, A[h], qn, dts, cs, tid,
               kFmaThreads);
  const float cl = cs[qn - 1];
  if (tid == 0 && blockIdx.z == 0) ws[d.last_at(bi, h, c)] = cl;

  float acc[4][8] = {};
  for (int j0 = 0; j0 < qn; j0 += TI) {
    for (int e = tid; e < TI * NT; e += kFmaThreads) {
      const int j = e / NT, n = e - j * NT;
      b_s[e] = (j0 + j < qn && n < sb.Nv)
                   ? Bm[d.bc_at(bi, t0 + j0 + j, g) + sb.n0 + n] : 0.f;
    }
    for (int e = tid; e < TI * PT; e += kFmaThreads) {
      const int j = e / PT, p = e - j * PT;
      float v = 0.f;
      if (j0 + j < qn && p < sb.Pv)
        v = x[d.x_at(bi, t0 + j0 + j, h) + sb.p0 + p] *
            (expf(cl - cs[j0 + j]) * dts[j0 + j]);
      w_s[e] = v;
    }
    __syncthreads();
    tile_fma<4, 8>(w_s, PT, b_s, NT, TI, ty, tx, acc);
    __syncthreads();
  }
  float* st = ws + d.state_at(bi, h, c) + (size_t)sb.p0 * d.N + sb.n0;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) {
      const int p = ty + 16 * a, n = tx + 16 * cc;
      if (p < sb.Pv && n < sb.Nv) st[(size_t)p * d.N + n] = acc[a][cc];
    }
}

// ============================================================== pass 2
// Each thread walks 4 consecutive elements of one (batch, head) state
// through the chunks: s_c is overwritten by h_c, the state entering
// chunk c; the state after the last chunk goes to h_out in x's type.
template <typename T>
__global__ void __launch_bounds__(kPassThreads)
state_pass_kernel(float* __restrict__ ws, T* __restrict__ h_out, Dims d,
                  int tiles) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int h = blockIdx.x / tiles, bi = blockIdx.y;
  const size_t e = ((size_t)(blockIdx.x - h * tiles) * kPassThreads +
                    threadIdx.x) * 4;
  const size_t PN = (size_t)d.P * d.N;
  if (e >= PN) return;
  const float* last = ws + d.last_at(bi, h, 0);
  float* s = ws + d.state_at(bi, h, 0) + e;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  constexpr int kAhead = 8;  // chunk states loaded at once
  for (int c0 = 0; c0 < d.nc; c0 += kAhead) {
    float4 cur[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (c0 + k < d.nc)
        cur[k] = *reinterpret_cast<const float4*>(s + (c0 + k) * PN);
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k >= d.nc) break;
      *reinterpret_cast<float4*>(s + (c0 + k) * PN) = run;
      const float a = expf(last[c0 + k]);
      run.x = a * run.x + cur[k].x;
      run.y = a * run.y + cur[k].y;
      run.z = a * run.z + cur[k].z;
      run.w = a * run.w + cur[k].w;
    }
  }
  T* o = h_out + ((size_t)bi * d.H + h) * PN + e;
  o[0] = from_f<T>(run.x);
  o[1] = from_f<T>(run.y);
  o[2] = from_f<T>(run.z);
  o[3] = from_f<T>(run.w);
}

// ============================================================== pass 3
// The block of (chunk, head, query tile, batch, P slab); blockIdx.x is
// (c * H + h) * n_qt + qt, blockIdx.z the slab of y's columns [p0, p0 +
// Pv).
struct ScanBlock {
  int c, h, qt, bi, t0, qn, i0, p0, Pv;
  __device__ ScanBlock(const Dims& d, int n_qt, int rows) {
    qt = blockIdx.x % n_qt;
    const int ch = blockIdx.x / n_qt;
    c = ch / d.H;
    h = ch % d.H;
    bi = blockIdx.y;
    t0 = c * d.Q;
    qn = min(d.Q, d.L - t0);
    i0 = qt * rows;
    p0 = blockIdx.z * PT;
    Pv = min(PT, d.P - p0);
  }
};

// bf16: a block of kQRows query rows, warp w owning rows i0 + 16 w .. + 15
// and the slab's P columns; a warp skips the key tiles wholly above its
// rows. Built for N up to NTL.
template <int NTL>
__global__ void __launch_bounds__(kScanThreads)
scan_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const bf16* __restrict__ Bm,
                const bf16* __restrict__ Cm, const float* __restrict__ ws,
                bf16* __restrict__ y, Dims d, int n_qt) {
  constexpr int LDN = ldn<NTL>();
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* c_s = reinterpret_cast<bf16*>(smem);  // [kQRows][LDN]: C, queries
  bf16* b_s = c_s + kQRows * LDN;             // [2][TI][LDN]: B, key rows
  bf16* x_s = b_s + 2 * TI * LDN;             // [2][TI][LDP]: x, key rows
  float* dts = reinterpret_cast<float*>(x_s + 2 * TI * LDP);
  float* cs = dts + d.Q;
  bf16* h_s = b_s;  // [PT][LDN]: h_c (after the key tiles are done)

  const ScanBlock blk(d, n_qt, kQRows);
  if (blk.i0 >= blk.qn) {  // a query tile past a ragged last chunk
    asm volatile("griddepcontrol.wait;" ::: "memory");
    return;
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = d.group(blk.h);
  // causal: the key tiles up to the block's last row
  const int n_kt = (min(blk.i0 + kQRows, blk.qn) + TI - 1) / TI;
  const size_t bc_stride = (size_t)d.G * d.N, x_stride = (size_t)d.H * d.P;
  const int Nc = round16(d.N), Pc = round16(blk.Pv);  // columns staged
  const bf16* b_src = Bm + d.bc_at(blk.bi, blk.t0, g);
  const bf16* x_src = x + d.x_at(blk.bi, blk.t0, blk.h) + blk.p0;
  stage_rows(c_s, LDN, Cm + d.bc_at(blk.bi, blk.t0 + blk.i0, g), bc_stride,
             kQRows, blk.qn - blk.i0, Nc, d.N, tid, kScanThreads);
  stage_rows(b_s, LDN, b_src, bc_stride, TI, blk.qn, Nc, d.N, tid,
             kScanThreads);
  stage_rows(x_s, LDP, x_src, x_stride, TI, blk.qn, Pc, blk.Pv, tid,
             kScanThreads);
  cp_async_commit();
  chunk_cumsum(dt + d.dt_at(blk.bi, blk.t0, blk.h), d.H, A[blk.h], blk.qn,
               dts, cs, tid, kScanThreads);

  const int r_lo = warp * 16 + (lane >> 2);  // this thread's rows r_lo, +8
  const int q2 = (lane & 3) * 2;
  const int i_lo = blk.i0 + r_lo, i_hi = i_lo + 8;  // rows in the chunk
  const float cs_lo = i_lo < blk.qn ? cs[i_lo] : 0.f;
  const float cs_hi = i_hi < blk.qn ? cs[i_hi] : 0.f;
  const int warp_last = blk.i0 + warp * 16 + 15;  // this warp's last row
  const bool warp_rows = blk.i0 + warp * 16 < blk.qn;
  const int k_steps = Nc / 16, p_pairs = Pc / 16;
  float yacc[PT / 8][4] = {};

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kt) {
      const int j1 = (kt + 1) * TI;
      stage_rows(b_s + (st ^ 1) * TI * LDN, LDN, b_src + j1 * bc_stride,
                 bc_stride, TI, blk.qn - j1, Nc, d.N, tid, kScanThreads);
      stage_rows(x_s + (st ^ 1) * TI * LDP, LDP, x_src + j1 * x_stride,
                 x_stride, TI, blk.qn - j1, Pc, blk.Pv, tid, kScanThreads);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int j0 = kt * TI;
    if (j0 > warp_last || !warp_rows) {  // above this warp's rows
      __syncthreads();
      continue;
    }
    const bf16* bt = b_s + st * TI * LDN;
    const bf16* xt = x_s + st * TI * LDP;
    // S = C_i . B_j over this key tile: 16 rows x 64 keys a warp
    float s[TI / 8][4] = {};
    for (int kk = 0; kk < k_steps; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, c_s + (warp * 16 + (lane & 15)) * LDN + kk * 16 +
                     (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < TI / 16; ++np) {
        uint32_t b[4];
        ldsm_x4(b, bt + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LDN +
                       kk * 16 + ((lane >> 3) & 1) * 8);
        mma16816(s[2 * np], a, b[0], b[1]);
        mma16816(s[2 * np + 1], a, b[2], b[3]);
      }
    }
    // mask (j <= i, j < qn) and scale by exp(cs_i - cs_j) dt_j; round to
    // bf16 as the A fragments of S . x (the accumulator layout of two
    // n-tiles is the A layout of one k-step)
    uint32_t af[TI / 16][4];
#pragma unroll
    for (int nt = 0; nt < TI / 8; ++nt) {
      float w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + nt * 8 + q2 + (e & 1);
        const int i = e < 2 ? i_lo : i_hi;
        const float ci = e < 2 ? cs_lo : cs_hi;
        w[e] = (j <= i && j < blk.qn) ? __expf(ci - cs[j]) * dts[j] : 0.f;
      }
      af[nt >> 1][(nt & 1) * 2] = pack_bf16x2(s[nt][0] * w[0], s[nt][1] * w[1]);
      af[nt >> 1][(nt & 1) * 2 + 1] =
          pack_bf16x2(s[nt][2] * w[2], s[nt][3] * w[3]);
    }
    // y += S . x_j
#pragma unroll
    for (int t = 0; t < TI / 16; ++t) {
#pragma unroll
      for (int pp = 0; pp < PT / 16; ++pp) {
        if (pp < p_pairs) {
          uint32_t b[4];
          ldsm_x4_t(b, xt + (t * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                LDP +
                            pp * 16 + (lane >> 4) * 8);
          mma16816(yacc[2 * pp], af[t], b[0], b[1]);
          mma16816(yacc[2 * pp + 1], af[t], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this stage is refilled next
  }

  // the carried state: wait for pass 2, then y += exp(cs_i) C_i . h_c
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (blk.c > 0) {
    // h_c to bf16 in shared memory (the slab's rows), kHLoads 16-byte
    // loads in flight a thread; columns N .. Nc zero
    const float* hc = ws + d.state_at(blk.bi, blk.h, blk.c) +
                      (size_t)blk.p0 * d.N;
    const int n4 = Nc / 4, total = blk.Pv * n4;
    for (int base = 0; base < total; base += kHLoads * kScanThreads) {
      float4 v[kHLoads];
#pragma unroll
      for (int k = 0; k < kHLoads; ++k) {
        const int i = base + k * kScanThreads + tid;
        if (i < total) {
          const int p = i / n4, n = (i - p * n4) * 4;
          v[k] = n < d.N ? *reinterpret_cast<const float4*>(
                               hc + (size_t)p * d.N + n)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int k = 0; k < kHLoads; ++k) {
        const int i = base + k * kScanThreads + tid;
        if (i < total) {
          const int p = i / n4, n = (i - p * n4) * 4;
          *reinterpret_cast<uint2*>(h_s + p * LDN + n) = make_uint2(
              pack_bf16x2(v[k].x, v[k].y), pack_bf16x2(v[k].z, v[k].w));
        }
      }
    }
    __syncthreads();
    float off[PT / 8][4] = {};
    for (int kk = 0; kk < k_steps; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, c_s + (warp * 16 + (lane & 15)) * LDN + kk * 16 +
                     (lane >> 4) * 8);
#pragma unroll
      for (int pp = 0; pp < PT / 16; ++pp) {
        if (pp < p_pairs) {
          uint32_t b[4];
          ldsm_x4(b, h_s + (pp * 16 + (lane >> 4) * 8 + (lane & 7)) * LDN +
                         kk * 16 + ((lane >> 3) & 1) * 8);
          mma16816(off[2 * pp], a, b[0], b[1]);
          mma16816(off[2 * pp + 1], a, b[2], b[3]);
        }
      }
    }
    const float e_lo = __expf(cs_lo), e_hi = __expf(cs_hi);
#pragma unroll
    for (int nt = 0; nt < PT / 8; ++nt) {
      yacc[nt][0] += e_lo * off[nt][0];
      yacc[nt][1] += e_lo * off[nt][1];
      yacc[nt][2] += e_hi * off[nt][2];
      yacc[nt][3] += e_hi * off[nt][3];
    }
  }
  // Pv is even, so p < Pv gives p + 1 < Pv too
#pragma unroll
  for (int nt = 0; nt < PT / 8; ++nt) {
    const int p = nt * 8 + q2;
    if (nt >= 2 * p_pairs || p >= blk.Pv) continue;
    bf16* y_p = y + blk.p0 + p;
    if (i_lo < blk.qn)
      *reinterpret_cast<uint32_t*>(y_p + d.x_at(blk.bi, blk.t0 + i_lo,
                                                blk.h)) =
          pack_bf16x2(yacc[nt][0], yacc[nt][1]);
    if (i_hi < blk.qn)
      *reinterpret_cast<uint32_t*>(y_p + d.x_at(blk.bi, blk.t0 + i_hi,
                                                blk.h)) =
          pack_bf16x2(yacc[nt][2], yacc[nt][3]);
  }
}

// fp32: thread (ty, tx) owns query rows i0 + ty + 16 a, slab columns
// p = tx + 16 c. Operands are stored k-major for tile_fma: C^T [n][i],
// B^T [n][j], the masked scores S^T [j][i], x [j][p], h_c^T [n][p]. Built
// for N up to NTL.
template <int NTL>
__global__ void __launch_bounds__(kFmaThreads)
scan_fma_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ ws,
                float* __restrict__ y, Dims d, int n_qt) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* ct = reinterpret_cast<float*>(smem);  // [NTL][LI]
  float* bt = ct + NTL * LI;                   // [NTL][LI]
  float* xs = bt + NTL * LI;                   // [TI][PT]
  float* st = xs + TI * PT;                    // [TI][LI]
  float* dts = st + TI * LI;
  float* cs = dts + d.Q;
  float* ht = bt;  // [NTL][PT]: h_c^T (after the key tiles are done)

  const ScanBlock blk(d, n_qt, TI);
  if (blk.i0 >= blk.qn) {  // a query tile past a ragged last chunk
    asm volatile("griddepcontrol.wait;" ::: "memory");
    return;
  }
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int g = d.group(blk.h);
  chunk_cumsum(dt + d.dt_at(blk.bi, blk.t0, blk.h), d.H, A[blk.h], blk.qn,
               dts, cs, tid, kFmaThreads);
  for (int e = tid; e < TI * NTL; e += kFmaThreads) {
    const int i = e / NTL, n = e - i * NTL;
    const int gi = blk.i0 + i;
    ct[n * LI + i] = (gi < blk.qn && n < d.N)
                         ? Cm[d.bc_at(blk.bi, blk.t0 + gi, g) + n] : 0.f;
  }
  float yacc[4][4] = {};
  for (int j0 = 0; j0 <= blk.i0; j0 += TI) {
    __syncthreads();  // the previous tile's readers of bt / xs / st are done
    for (int e = tid; e < TI * NTL; e += kFmaThreads) {
      const int j = e / NTL, n = e - j * NTL;
      bt[n * LI + j] = (j0 + j < blk.qn && n < d.N)
                           ? Bm[d.bc_at(blk.bi, blk.t0 + j0 + j, g) + n] : 0.f;
    }
    for (int e = tid; e < TI * PT; e += kFmaThreads) {
      const int j = e / PT, p = e - j * PT;
      xs[e] = (j0 + j < blk.qn && p < blk.Pv)
                  ? x[d.x_at(blk.bi, blk.t0 + j0 + j, blk.h) + blk.p0 + p]
                  : 0.f;
    }
    __syncthreads();
    float s[4][4] = {};
    tile_fma<4, 4>(ct, LI, bt, LI, d.N, ty, tx, s);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int gi = blk.i0 + ty + 16 * a;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int gj = j0 + tx + 16 * cc;
        float w = 0.f;
        if (gj <= gi && gi < blk.qn) w = expf(cs[gi] - cs[gj]) * dts[gj];
        st[(tx + 16 * cc) * LI + ty + 16 * a] = s[a][cc] * w;
      }
    }
    __syncthreads();
    tile_fma<4, 4>(st, LI, xs, PT, TI, ty, tx, yacc);
  }

  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (blk.c > 0) {
    __syncthreads();  // all readers of bt are done: ht takes its place
    const float* hc = ws + d.state_at(blk.bi, blk.h, blk.c) +
                      (size_t)blk.p0 * d.N;
    for (int e = tid; e < blk.Pv * d.N; e += kFmaThreads) {
      const int p = e / d.N, n = e - p * d.N;
      ht[n * PT + p] = hc[e];
    }
    __syncthreads();
    float off[4][4] = {};
    tile_fma<4, 4>(ct, LI, ht, PT, d.N, ty, tx, off);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int gi = blk.i0 + ty + 16 * a;
      const float e = gi < blk.qn ? expf(cs[gi]) : 0.f;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) yacc[a][cc] += e * off[a][cc];
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int gi = blk.i0 + ty + 16 * a;
    if (gi >= blk.qn) continue;
    float* y_row = y + d.x_at(blk.bi, blk.t0 + gi, blk.h) + blk.p0;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int p = tx + 16 * cc;
      if (p < blk.Pv) y_row[p] = yacc[a][cc];
    }
  }
}

// ------------------------------------------------------------- launches
size_t state_smem(int es, int Q) {
  const size_t tiles = es == 2 ? (size_t)TI * (2 * LDN + 3 * LDP) * 2
                               : (size_t)TI * (NT + PT) * 4;
  return tiles + sizeof(float) * 2 * Q;
}

template <int NTL>
size_t scan_smem(int es, int Q) {
  const size_t tiles =
      es == 2 ? (size_t)(kQRows + 2 * TI) * ldn<NTL>() * 2 +
                    (size_t)TI * LDP * 2 * 2
              : sizeof(float) * ((size_t)2 * NTL * LI + TI * PT + TI * LI);
  return tiles + sizeof(float) * 2 * Q;
}

// a launch of `kernel` on `stream` as a programmatic dependent of the
// kernel before it (it waits on griddepcontrol.wait)
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, int threads,
                             size_t smem, cudaStream_t stream,
                             Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// the kernels of passes 1 and 3 for each input type
template <typename T> struct Passes;
template <> struct Passes<float> {
  static constexpr int threads = kFmaThreads, scan_threads = kFmaThreads;
  static constexpr int scan_rows = TI;
  static auto state() { return state_fma_kernel; }
  template <int NTL> static auto scan() { return scan_fma_kernel<NTL>; }
};
template <> struct Passes<bf16> {
  static constexpr int threads = kMmaThreads, scan_threads = kScanThreads;
  static constexpr int scan_rows = kQRows;
  static auto state() { return state_mma_kernel; }
  template <int NTL> static auto scan() { return scan_mma_kernel<NTL>; }
};

// pass 3, built for N up to NTL, as a dependent of pass 2
template <typename T, int NTL>
cudaError_t launch_scan(const T* xt, const float* dt, const float* A,
                        const T* bt, const void* Cm, void* y, float* ws,
                        const Dims& d, cudaStream_t stream) {
  const auto scan_k = Passes<T>::template scan<NTL>();
  const size_t s3 = scan_smem<NTL>(sizeof(T), d.Q);
  static size_t allowed3 = 48 * 1024;
  const cudaError_t err = allow_smem(scan_k, s3, &allowed3);
  if (err != cudaSuccess) return err;
  const int n_qt = (d.Q + Passes<T>::scan_rows - 1) / Passes<T>::scan_rows;
  return launch_dependent(scan_k, dim3(d.nc * d.H * n_qt, d.b, d.p_slabs()),
                          Passes<T>::scan_threads, s3,
                          stream, xt, dt, A, bt, static_cast<const T*>(Cm),
                          static_cast<const float*>(ws), static_cast<T*>(y),
                          d, n_qt);
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, void* y, void* h_out,
                   float* ws, const Dims& d, cudaStream_t stream) {
  constexpr int threads = Passes<T>::threads;
  const auto state_k = Passes<T>::state();
  const size_t s1 = state_smem(sizeof(T), d.Q);
  static size_t allowed1 = 48 * 1024;
  cudaError_t err = allow_smem(state_k, s1, &allowed1);
  if (err != cudaSuccess) return err;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const dim3 grid1(d.nc * d.H, d.b, d.p_slabs() * d.n_slabs());
  state_k<<<grid1, threads, s1, stream>>>(xt, dt, A, bt, ws, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int tiles = (d.P * d.N / 4 + kPassThreads - 1) / kPassThreads;
  err = launch_dependent(state_pass_kernel<T>, dim3(tiles * d.H, d.b),
                         kPassThreads, 0, stream, ws, static_cast<T*>(h_out),
                         d, tiles);
  if (err != cudaSuccess) return err;
  if (d.N <= NT)
    return launch_scan<T, NT>(xt, dt, A, bt, Cm, y, ws, d, stream);
  return launch_scan<T, kMaxN>(xt, dt, A, bt, Cm, y, ws, d, stream);
}

}  // namespace

// Largest chunk the kernels take: the chunk's dt and cumulative sums sit
// in shared memory beside fixed tiles.
extern "C" int ssd_max_chunk() { return kMaxChunk; }

// dtype: 0 = float32, 1 = bfloat16; P and N in whole 16-byte rows
// (multiples of 8 in bf16, of 4 in fp32), N <= 256 (kMaxN); G divides
// H; Q <= ssd_max_chunk(). `ws` holds
// b * H * nc * (P * N + 1) floats (nc = ceil(L / Q)), 16-byte aligned: the
// chunk states [b][H][nc][P][N], then cs_last [b][H][nc]. Returns the
// cudaError_t of the launches (0 on success). Launches on `stream` and
// does not synchronise.
extern "C" int ssd_scan(const void* x, const float* dt, const float* A,
                        const void* Bm, const void* Cm, void* y, void* h_out,
                        float* ws, int dtype, int b, int L, int H, int G,
                        int P, int N, int Q, void* stream) {
  if (b == 0 || H == 0) return (int)cudaSuccess;
  const int vec = dtype == 1 ? 8 : 4;  // elements in a 16-byte vector
  if (G <= 0 || H % G != 0 || P <= 0 || P % vec != 0 || N <= 0 ||
      N > kMaxN || N % vec != 0 || Q <= 0 || Q > kMaxChunk || L <= 0 ||
      b > 65535 || (P + PT - 1) / PT * ((N + NT - 1) / NT) > 65535)
    return (int)cudaErrorInvalidValue;
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(Bm) |
                          reinterpret_cast<uintptr_t>(Cm) |
                          reinterpret_cast<uintptr_t>(ws);
  if (align % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const Dims d{b, L, H, G, P, N, Q, (L + Q - 1) / Q};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, dt, A, Bm, Cm, y, h_out, ws, d, s);
  if (dtype == 1)
    return (int)launch<bf16>(x, dt, A, Bm, Cm, y, h_out, ws, d, s);
  return (int)cudaErrorInvalidValue;
}
