"""Fused batched token sampling on the device, with JAX's random bits.

PyTorch counterpart of ``repro.serving.sampling``: greedy rows
(``temperature <= 0``) take an argmax, stochastic rows use the
Gumbel-max trick over a per-row top-k mask. Determinism is counter-based:
each row's key is ``fold_in(fold_in(PRNGKey(0), seed), counter)`` with
``counter`` the number of tokens already generated, so a replayed request
reproduces its continuation.

Sampled streams match the reference only if the noise does, so the
reference's PRNG is reproduced here bit for bit: threefry2x32 (in int64
tensors masked to 32 bits, since torch has no full uint32 arithmetic),
``fold_in``, ``random_bits`` for a 1-D uint32 draw as JAX computes it
under ``jax_threefry_partitionable=True`` (its default), ``uniform``'s
mantissa trick, and ``gumbel``'s ``-log(-log(u))`` on ``[tiny, 1)``,
whose two ``log`` calls are XLA's CPU float32 ``log`` written op for op
(``_xla_log``), so the noise is exact too, on the CPU and on the card.
"""
from __future__ import annotations

import numpy as np
import torch

# This sampler is pure argmax (Gumbel-max, no softmax), so masks use real
# -inf: a finite large-negative would stop masking once temperature scales
# it below the Gumbel noise spread.
NEG_INF = float("-inf")

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl32(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key0, key1, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) as ``jax.random`` runs
    it. All arguments are int64 tensors holding uint32 values; they
    broadcast. Returns the two output words."""
    ks = (key0, key1, key0 ^ key1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def fold_in(key, data):
    """``jax.random.fold_in`` for a batch of keys: key is (k0, k1) int64
    tensors [B], data [B] uint32 values as int64."""
    k0, k1 = key
    return threefry2x32(k0, k1, torch.zeros_like(data), data)


def random_bits(key, n: int):
    """``jax.random.bits(key, (n,), uint32)`` for a batch of keys ->
    [B, n] int64 holding uint32 values. The counter of element i is the
    64-bit iota split into (hi, lo) = (0, i)."""
    k0, k1 = key
    idx = torch.arange(n, dtype=torch.int64, device=k0.device)
    b0, b1 = threefry2x32(k0[:, None], k1[:, None], torch.zeros_like(idx),
                          idx)
    return b0 ^ b1


def uniform(key, n: int, minval: float, maxval: float):
    """``jax.random.uniform(key, (n,), float32, minval, maxval)``."""
    bits = random_bits(key, n)
    # 23 mantissa bits under exponent 0 give a float in [1, 2); the
    # value stays below 2**31, so the int32 view is exact
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    # JAX forms maxval - minval in float32; python scalars keep the
    # device free of host->device copies
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp(floats * span + lo, min=lo)


def _fma(a, b, c):
    """float32 fused multiply-add (tensor a, constants or tensors b and
    c): the product of two float32 values is exact in float64, so one
    rounding to float32 remains."""
    def f64(v):
        return v.double() if torch.is_tensor(v) else float(np.float32(v))
    return (f64(a) * f64(b) + f64(c)).float()


def _xla_log(x):
    """XLA's CPU float32 ``log``, op for op: the Cephes ``logf``
    polynomial in Estrin form, with the multiply-adds the backend fuses.
    Bit-equal to ``jnp.log`` for positive finite x (torch's own ``log``
    differs in ~14% of inputs); 0, inf and negatives are not handled —
    ``gumbel`` never passes them."""
    x = torch.clamp(x, min=torch.finfo(torch.float32).tiny)
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x807FFFFF) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    s = m < 0.70710677
    t = (m - 1.0) + torch.where(s, m, 0.0)
    e = e - s.float()
    t2 = t * t
    t3 = t2 * t
    a = _fma(_fma(t, 7.0376836292e-2, -1.1514610310e-1), t, 1.1676998740e-1)
    b = _fma(_fma(t, -1.2420140846e-1, 1.4249322787e-1), t, -1.6668057665e-1)
    c = _fma(_fma(t, 2.0000714765e-1, -2.4999993993e-1), t, 3.3333331174e-1)
    y = _fma(_fma(_fma(a, t3, b), t3, c), t3, -2.12194440e-4 * e)
    r = (t - 0.5 * t2) + y
    return r + 0.693359375 * e


def gumbel(key, n: int):
    """``jax.random.gumbel(key, (n,), float32)`` (low-precision mode),
    bit for bit."""
    tiny = torch.finfo(torch.float32).tiny
    return -_xla_log(-_xla_log(uniform(key, n, tiny, 1.0)))


def sample_tokens(logits, temps, top_ks, seeds, counters, vocab_size: int,
                  stochastic: bool = True, max_top_k: int = -1):
    """Sample one token per row.

    logits: [B, Vpad] float; temps: [B] float32 (<=0 means greedy);
    top_ks: [B] int (0 means full distribution); seeds/counters: [B]
    int64 holding uint32 values. All on logits' device. Returns [B] int32
    token ids < vocab_size. ``stochastic=False`` skips the top-k + Gumbel
    work when the whole batch is greedy; ``max_top_k`` (the host-known
    batch max of ``top_ks``; 0 = no row masks, -1 = unknown) bounds the
    k-th-largest threshold to a ``topk`` instead of a full sort.
    """
    B, V = logits.shape
    dev = logits.device
    lg = logits.float()
    if vocab_size < V:  # mask vocab padding rows
        lg = torch.where(torch.arange(V, device=dev) < vocab_size, lg, NEG_INF)
    greedy = lg.argmax(dim=-1).to(torch.int32)
    if not stochastic:
        return greedy

    # per-row top-k mask via the k-th largest logit (k=0 -> no mask)
    if max_top_k == 0:
        masked = lg
    else:
        if 0 < max_top_k < V:
            sorted_desc = torch.topk(lg, max_top_k, dim=-1).values
        else:
            sorted_desc = torch.sort(lg, dim=-1, descending=True).values
        kth_idx = torch.clamp(top_ks.long() - 1, 0, sorted_desc.shape[-1] - 1)
        kth = sorted_desc.gather(-1, kth_idx[:, None])
        masked = torch.where((top_ks[:, None] > 0) & (lg < kth), NEG_INF, lg)

    zero = torch.zeros((B,), dtype=torch.int64, device=dev)
    key = fold_in(fold_in((zero, zero), seeds.long()), counters.long())
    temp = torch.clamp(temps.float(), min=1e-6)[:, None]
    sampled = (masked / temp + gumbel(key, V)).argmax(dim=-1).to(torch.int32)
    return torch.where(temps > 0.0, sampled, greedy)
