"""The tanh-form gelu as XLA lowers ``jax.nn.gelu``, and its gradient.

XLA lowers ``jax.nn.gelu`` for bf16 as a chain of bf16 ops, each one
rounded; torch's fused ``F.gelu`` rounds once, and 42.8% of its bf16
outputs differ. ``gelu_ref`` is the chain in torch ops and
``gelu_grad_ref`` JAX's VJP of it written op for op (autograd through
the chain rounds elsewhere: 47.5% of bf16 gradients differ); both are
bit-equal to the reference in bf16 on the CPU.

``gelu`` and ``gelu_grad`` are the wrappers. On CUDA tensors they launch
the hand-written Hopper kernel (``csrc/gelu.cu``: the same chain in one
pass, where the plain version is one launch per op); on CPU tensors they
run the plain versions, and on meta tensors (``launch.dryrun``'s, which
hold no values) too, for their shapes. There is no fallback: a kernel that fails to
build or launch raises. ``gelu.launches`` and ``gelu_grad.launches``
count calls that launched the kernel; plain-version calls do not count.
This replaces no Pallas kernel: it is the port's kernel for
``jax.nn.gelu`` (``repro/models/layers.py``), in whisper's MLP and
gemma's GeGLU.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import sm_count

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def consts(dtype):
    """jax.nn.gelu's 0.044715 and sqrt(2 / pi), rounded to ``dtype`` as
    the reference rounds them (0.044677734 and 0.796875 in bf16)."""
    return tuple(float(torch.tensor(c, dtype=dtype))
                 for c in (0.044715, math.sqrt(2 / math.pi)))


def _chain(x):
    """(t, cdf) of the chain: x**3 as x * x * x, tanh, 1 +, 0.5 *."""
    c1, c2 = consts(x.dtype)
    t = torch.tanh((x + x * x * x * c1) * c2)
    return t, (t + 1.0) * 0.5


def gelu_ref(x):
    """Plain PyTorch version: the chain, each op rounded to x's type."""
    return x * _chain(x)[1]


def gelu_grad_ref(x, g):
    """Plain PyTorch version of the gradient: JAX's VJP of the chain, each
    op rounded to x's type: tanh's jvp ``(g + g * t) * (1 - t)``
    transposed (``c + c * t``, ``c = g * (1 - t)``) and integer_pow's
    ``g * (3 * x**2)``, the three cotangents of x summed in the order the
    reference's transpose meets them."""
    t, cdf = _chain(x)
    c1, c2 = consts(x.dtype)
    a = g * x * 0.5 * (1 - t)
    gb = (a + a * t) * c2
    return (g * cdf + gb) + gb * c1 * (x * x * 3)


def _check(x, g=None):
    if not x.is_floating_point():
        raise TypeError(f"gelu takes a floating type; got {x.dtype}")
    if g is not None and (g.shape != x.shape or g.dtype != x.dtype
                          or g.device != x.device):
        raise ValueError(f"g must match x: {tuple(g.shape)} {g.dtype} "
                         f"{g.device} against {tuple(x.shape)} {x.dtype} "
                         f"{x.device}")


@functools.cache
def _kernel():
    fn = build.load("gelu").gelu
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, g):
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the gelu kernel takes float32 or bfloat16; got "
                        f"{x.dtype}")
    x = x.contiguous()
    g = None if g is None else g.contiguous()
    out = torch.empty_like(x)
    c1, c2 = consts(x.dtype)
    with torch.cuda.device(x.device):
        err = _kernel()(x.data_ptr(), None if g is None else g.data_ptr(),
                        out.data_ptr(), x.numel(), _DTYPE_CODES[x.dtype],
                        int(g is not None), c1, c2, sm_count(x.device.index),
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gelu kernel launch failed: cudaError {err}")
    return out


def gelu(x):
    """x: any shape and floating type (float32 or bfloat16 on the card)
    -> gelu(x) in x's type. One
    launch on CUDA, no host sync (the call can be captured in a CUDA
    graph). Refuses an input that requires grad under grad mode:
    ``models.layers._gelu`` takes the gradient through ``gelu_grad``."""
    _check(x)
    if x.device.type in ("cpu", "meta"):
        return gelu_ref(x)
    build.check_no_grad("gelu", x)
    out = _launch(x, None)
    gelu.launches += 1
    return out


def gelu_grad(x, g):
    """The gradient of ``gelu`` at x against the cotangent g (x's shape
    and type): JAX's VJP. One launch on CUDA, no host sync."""
    _check(x, g)
    if x.device.type in ("cpu", "meta"):
        return gelu_grad_ref(x, g)
    build.check_no_grad("gelu_grad", x, g)
    out = _launch(x, g)
    gelu_grad.launches += 1
    return out


gelu.launches = 0
gelu_grad.launches = 0
