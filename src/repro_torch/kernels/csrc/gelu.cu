// The tanh-form gelu for Hopper (sm_90a), and its gradient, each op rounded
// to the input's type as XLA rounds jax.nn.gelu's op chain. Plain C
// interface, loaded from Python through ctypes
// (repro_torch/kernels/gelu.py).
//
// Replaces no Pallas kernel: the reference calls jax.nn.gelu
// (repro/models/layers.py:455 and :457), which XLA lowers for bf16 as a
// chain of bf16 ops. The port's plain version is that chain in torch ops
// (kernels/gelu.py: gelu_ref, gelu_grad_ref), one launch and one rounding
// per op; this file runs the same chain in one pass over the elements:
//   forward   x*x, *x, *c1, x+, *c2, tanh, +1, *0.5, x*
//   backward  JAX's VJP of that chain, op for op (gelu_grad_ref's order)
// Every op computes in fp32 and rounds its result to the input's type,
// as torch's elementwise ops do for bf16 (fp32 math, one rounding each);
// products and sums use __fmul_rn / __fadd_rn so that the compiler never
// fuses a multiply and an add into one rounding. c1 and c2 are
// 0.044715 and sqrt(2 / pi) rounded to the input's type on the host.
//   x, g, out   [n] contiguous, fp32 or bf16
//
// Bound on an H100 SXM: memory-bound. The least work reads x once (and g
// once for the gradient) and writes the output once, 2n (3n) elements
// over 3.35 TB/s; about 20 (35) fp32 operations an element are far below
// the compute roof, but the instructions are not: an fp32 op rounded to
// bf16 is three (the op and two conversions), and accurate tanhf some
// twenty. Each thread takes 16 bytes of x (8 bf16 or 4 fp32 elements)
// per step of a grid-stride loop, with one 16-byte load and store; bf16
// elements go in pairs through packed bf16x2 products and sums (apply2),
// one instruction for two roundings. Rounding every fp32 op by
// conversions instead took 0.048 ms at gemma-7b's prefill shape [600,
// 24576] on an H100 SXM (700 W), 2.1x torch's fused gelu. A tail or a
// misaligned operand takes the scalar loop.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

template <typename T>
struct Round;

template <>
struct Round<float> {
  static __device__ __forceinline__ float r(float v) { return v; }
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};

template <>
struct Round<__nv_bfloat16> {
  static __device__ __forceinline__ float r(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
};

template <typename T>
__device__ __forceinline__ float mul(float a, float b) {
  return Round<T>::r(__fmul_rn(a, b));
}

template <typename T>
__device__ __forceinline__ float add(float a, float b) {
  return Round<T>::r(__fadd_rn(a, b));
}

template <typename T>
__device__ __forceinline__ float sub(float a, float b) {
  return Round<T>::r(__fsub_rn(a, b));
}

// (t, cdf) of x: the forward chain up to the last product
template <typename T>
__device__ __forceinline__ void chain(float x, float c1, float c2, float& t,
                                      float& cdf) {
  const float x3 = mul<T>(mul<T>(x, x), x);
  t = Round<T>::r(tanhf(mul<T>(add<T>(x, mul<T>(x3, c1)), c2)));
  cdf = mul<T>(add<T>(t, 1.0f), 0.5f);
}

template <typename T>
__device__ __forceinline__ float forward(float x, float c1, float c2) {
  float t, cdf;
  chain<T>(x, c1, c2, t, cdf);
  return mul<T>(x, cdf);
}

// JAX's VJP: a = g x 0.5 (1 - t); gb = (a + a t) c2;
// dx = (g cdf + gb) + (gb c1) (x x 3)
template <typename T>
__device__ __forceinline__ float backward(float x, float g, float c1,
                                          float c2) {
  float t, cdf;
  chain<T>(x, c1, c2, t, cdf);
  const float a = mul<T>(mul<T>(mul<T>(g, x), 0.5f), sub<T>(1.0f, t));
  const float gb = mul<T>(add<T>(a, mul<T>(a, t)), c2);
  const float tail = mul<T>(mul<T>(gb, c1), mul<T>(mul<T>(x, x), 3.0f));
  return add<T>(add<T>(mul<T>(g, cdf), gb), tail);
}

// bf16 pairs: each product, sum and difference one packed bf16x2
// instruction with explicit round-to-nearest (never contracted into an
// fma). For bf16 operands that is the fp32 op rounded to bf16: a product
// of two bf16 values is exact in fp32, and a sum is exact in fp32 unless
// the exponents lie more than 16 apart, where the fp32 rounding cannot
// land on a bf16 tie. tanh runs in fp32 and rounds, as torch's does.
__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 pair(unsigned u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

__device__ __forceinline__ __nv_bfloat162 mul2(__nv_bfloat162 a,
                                               __nv_bfloat162 b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(bits(a)), "r"(bits(b)));
  return pair(d);
}

__device__ __forceinline__ __nv_bfloat162 add2(__nv_bfloat162 a,
                                               __nv_bfloat162 b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(bits(a)), "r"(bits(b)));
  return pair(d);
}

__device__ __forceinline__ __nv_bfloat162 sub2(__nv_bfloat162 a,
                                               __nv_bfloat162 b) {
  unsigned d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(bits(a)), "r"(bits(b)));
  return pair(d);
}

__device__ __forceinline__ __nv_bfloat162 tanh2(__nv_bfloat162 v) {
  const float2 f = __bfloat1622float2(v);
  return __floats2bfloat162_rn(tanhf(f.x), tanhf(f.y));
}

// chain() and forward() / backward() on a pair, op for op
template <bool kGrad>
__device__ __forceinline__ __nv_bfloat162 apply2(__nv_bfloat162 x,
                                                 __nv_bfloat162 g,
                                                 __nv_bfloat162 c1,
                                                 __nv_bfloat162 c2) {
  const __nv_bfloat162 one = __float2bfloat162_rn(1.0f);
  const __nv_bfloat162 half = __float2bfloat162_rn(0.5f);
  const __nv_bfloat162 t =
      tanh2(mul2(add2(x, mul2(mul2(mul2(x, x), x), c1)), c2));
  const __nv_bfloat162 cdf = mul2(add2(t, one), half);
  if constexpr (!kGrad) {
    return mul2(x, cdf);
  } else {
    const __nv_bfloat162 a = mul2(mul2(mul2(g, x), half), sub2(one, t));
    const __nv_bfloat162 gb = mul2(add2(a, mul2(a, t)), c2);
    const __nv_bfloat162 tail =
        mul2(mul2(gb, c1), mul2(mul2(x, x), __float2bfloat162_rn(3.0f)));
    return add2(add2(mul2(g, cdf), gb), tail);
  }
}

template <typename T, bool kGrad>
__device__ __forceinline__ float apply(float x, float g, float c1, float c2) {
  if constexpr (kGrad)
    return backward<T>(x, g, c1, c2);
  else
    return forward<T>(x, c1, c2);
}

template <typename T>
struct alignas(16) Pack {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

// out = gelu(x) (g == nullptr) or its gradient against g
template <typename T, bool kGrad, bool kVec>
__global__ void __launch_bounds__(256)
    gelu_kernel(const T* __restrict__ x, const T* __restrict__ g,
                T* __restrict__ out, long long n, float c1, float c2) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (kVec) {
    constexpr int kN = Pack<T>::kN;
    const long long packs = n / kN;
    for (; i < packs; i += stride) {
      const Pack<T> xv = reinterpret_cast<const Pack<T>*>(x)[i];
      Pack<T> gv = xv;
      if constexpr (kGrad) gv = reinterpret_cast<const Pack<T>*>(g)[i];
      Pack<T> ov;
      if constexpr (std::is_same_v<T, __nv_bfloat16>) {
        const __nv_bfloat162 c1p = __float2bfloat162_rn(c1);
        const __nv_bfloat162 c2p = __float2bfloat162_rn(c2);
        const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(xv.v);
        const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(gv.v);
        __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(ov.v);
#pragma unroll
        for (int j = 0; j < kN / 2; ++j) op[j] = apply2<kGrad>(xp[j], gp[j], c1p, c2p);
      } else {
#pragma unroll
        for (int j = 0; j < kN; ++j)
          ov.v[j] = Round<T>::store(apply<T, kGrad>(
              Round<T>::load(xv.v[j]), Round<T>::load(gv.v[j]), c1, c2));
      }
      reinterpret_cast<Pack<T>*>(out)[i] = ov;
    }
    // the tail past the last whole pack
    i = packs * kN + (long long)blockIdx.x * blockDim.x + threadIdx.x;
  }
  for (; i < n; i += stride)
    out[i] = Round<T>::store(apply<T, kGrad>(
        Round<T>::load(x[i]), kGrad ? Round<T>::load(g[i]) : 0.0f, c1, c2));
}

template <typename T, bool kGrad>
cudaError_t launch(const void* x, const void* g, void* out, long long n,
                   float c1, float c2, int n_sm, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* ot = static_cast<T*>(out);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   (!kGrad || reinterpret_cast<uintptr_t>(g) % 16 == 0);
  constexpr int kThreads = 256;
  const long long work = vec ? n / Pack<T>::kN + 1 : n;
  // enough blocks to fill the SMs eight times over, no more than the work
  const long long want = (work + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 8LL * n_sm ? want : 8LL * n_sm);
  if (vec)
    gelu_kernel<T, kGrad, true><<<blocks, kThreads, 0, stream>>>(xt, gt, ot, n,
                                                                  c1, c2);
  else
    gelu_kernel<T, kGrad, false><<<blocks, kThreads, 0, stream>>>(xt, gt, ot,
                                                                   n, c1, c2);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. g is null for the forward (grad = 0)
// and the output's cotangent for the gradient (grad = 1). n_sm sizes the
// grid. Returns the cudaError_t of the launch (0 on success). Launches on
// `stream`, does not synchronise.
extern "C" int gelu(const void* x, const void* g, void* out, long long n,
                    int dtype, int grad, float c1, float c2, int n_sm,
                    void* stream) {
  if (n == 0) return (int)cudaSuccess;
  if (n < 0 || n_sm <= 0 || (grad && g == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(grad ? launch<float, true>(x, g, out, n, c1, c2, n_sm, s)
                      : launch<float, false>(x, g, out, n, c1, c2, n_sm, s));
  if (dtype == 1)
    return (int)(grad ? launch<__nv_bfloat16, true>(x, g, out, n, c1, c2,
                                                    n_sm, s)
                      : launch<__nv_bfloat16, false>(x, g, out, n, c1, c2,
                                                     n_sm, s));
  return (int)cudaErrorInvalidValue;
}
