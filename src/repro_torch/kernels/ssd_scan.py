"""Mamba2 SSD chunked scan from a zero state: intra-chunk quadratic form
plus a carried state h [P, N] in fp32.

``ssd_scan`` is the wrapper. On CUDA tensors it launches the hand-written
Hopper kernel (``csrc/ssd_scan.cu``, the port of the Pallas kernel
``repro/kernels/ssd_scan.py``) on the current stream; on CPU tensors it
runs ``ssd_scan_ref``, the plain PyTorch version beside it. There is no
fallback: a kernel that fails to build or launch raises.
``ssd_scan.launches`` counts calls that launched the kernel (plain-version
calls do not count); each such call is three launches on the card, the
passes of the chunk-parallel algorithm.

The kernel computes each chunk's own state contribution in parallel,
passes the states along the chunks, then each chunk's outputs in
parallel. ``ssd_scan_chunked_ref`` is that algorithm in plain PyTorch,
rounding to bf16 where the bf16 kernel rounds, for the tests.

The kernel takes any head dim P and state dims N up to ``MAX_N`` (256),
in whole 16-byte rows; the wrapper zero-pads a P or N that is not
(``pad_dims``), which is exact. Above N 256 or a chunk of
``ssd_max_chunk()`` (1024) it raises: those are the kernel's bounds
(ROADMAP B).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_N = 256   # the kernel's largest state dim (csrc/ssd_scan.cu: kMaxN)


def _check(x, dt, A, B, C, chunk):
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 4:
        raise ValueError(f"x must be [b,L,H,P], dt [b,L,H], A [H], B/C "
                         f"[b,L,G,N]; got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(B.shape)}")
    b, L, H, P = x.shape
    G = B.shape[2]
    if tuple(dt.shape) != (b, L, H) or tuple(A.shape) != (H,) \
            or C.shape != B.shape or B.shape[:2] != (b, L) or G == 0 \
            or H % G != 0:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    if chunk <= 0 or L % min(chunk, L):
        raise ValueError(f"L={L} must be a multiple of the chunk {chunk} "
                         f"(the kernel API pads it)")
    if x.dtype not in _DTYPE_CODES or B.dtype != x.dtype \
            or C.dtype != x.dtype:
        raise TypeError(f"x, B and C must share float32 or bfloat16; got "
                        f"{x.dtype}, {B.dtype}, {C.dtype}")
    if not (dt.is_floating_point() and A.is_floating_point()):
        raise TypeError("dt and A must be floating point")
    tensors = (x, dt, A, B, C)
    if any(t.device != x.device for t in tensors):
        raise ValueError("all operands must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all operands must be contiguous")


def ssd_scan_ref(x, dt, A, B, C, chunk: int = 128):
    """Plain PyTorch version, chunk by chunk as the kernel walks it:
    the masked quadratic form inside a chunk, the carried state across."""
    b, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Q = min(chunk, L)
    A = A.float()
    h = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    ys = []
    for t0 in range(0, L, Q):
        xc = x[:, t0:t0 + Q].float()                        # [b,Q,H,P]
        dtc = dt[:, t0:t0 + Q].float()                      # [b,Q,H]
        Bc = B[:, t0:t0 + Q].float()                        # [b,Q,G,N]
        Cc = C[:, t0:t0 + Q].float()
        cs = torch.cumsum(dtc * A, dim=1)                   # [b,Q,H]
        seg = cs[:, :, None, :] - cs[:, None, :, :]         # [b,i,j,H]
        decay = torch.where(causal[None, :, :, None], torch.exp(seg), 0.0)
        CB = torch.einsum("bign,bjgn->bgij", Cc, Bc)
        CB = torch.repeat_interleave(CB, rep, dim=1)        # [b,H,i,j]
        scores = CB * decay.permute(0, 3, 1, 2) \
            * dtc.permute(0, 2, 1)[:, :, None, :]
        y = torch.einsum("bhij,bjhp->bihp", scores, xc)
        Ch = torch.repeat_interleave(Cc, rep, dim=2)        # [b,Q,H,N]
        y = y + torch.einsum("bihn,bhpn->bihp", Ch, h) \
            * torch.exp(cs)[..., None]
        ys.append(y)
        w = torch.exp(cs[:, -1:, :] - cs) * dtc             # [b,Q,H]
        Bh = torch.repeat_interleave(Bc, rep, dim=2)        # [b,Q,H,N]
        h = h * torch.exp(cs[:, -1, :])[:, :, None, None] \
            + torch.einsum("bjhp,bjhn->bhpn", xc * w[..., None], Bh)
    y = torch.cat(ys, dim=1)
    return y.to(x.dtype), h.to(x.dtype)


def ssd_scan_chunked_ref(x, dt, A, B, C, chunk: int = 128):
    """The kernel's three passes in plain PyTorch (tests only), with cs the
    in-chunk cumulative sum of dt * A:

    1. each chunk's state contribution s_c = sum_j w_j x_j (x) B_j, with
       w_j = exp(cs_last - cs_j) dt_j;
    2. the states passed along: h_0 = 0, h_{c+1} = exp(cs_last,c) h_c + s_c;
    3. y_i = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
       + exp(cs_i) C_i . h_c.

    For bf16 inputs it rounds to bf16 where the kernel does: the weighted
    x before the product with B, the masked scaled scores before the
    product with x, h_c before C . h_c (and y and the final state on
    output); everything else is fp32. L must be a multiple of the chunk."""
    b, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Q = min(chunk, L)
    nc = L // Q
    if x.dtype == torch.bfloat16:
        def rnd(t):
            return t.to(torch.bfloat16).float()
    else:
        def rnd(t):
            return t
    xc = x.float().reshape(b, nc, Q, H, P)
    dtc = dt.float().reshape(b, nc, Q, H)
    Bc = B.float().reshape(b, nc, Q, G, N)
    Cc = C.float().reshape(b, nc, Q, G, N)
    cs = torch.cumsum(dtc * A.float(), dim=2)                  # [b,nc,Q,H]
    # pass 1: chunk states
    w = torch.exp(cs[:, :, -1:] - cs) * dtc
    wx = rnd(xc * w[..., None])                                # [b,nc,Q,H,P]
    Bh = torch.repeat_interleave(Bc, rep, dim=3)               # [b,nc,Q,H,N]
    states = torch.einsum("bcjhp,bcjhn->bchpn", wx, Bh)
    # pass 2: state passing
    h = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = torch.exp(cs[:, c, -1])[:, :, None, None] * h + states[:, c]
    h_in = torch.stack(h_in, dim=1)                            # [b,nc,H,P,N]
    # pass 3: chunk scan
    CB = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc)
    CB = torch.repeat_interleave(CB, rep, dim=2)               # [b,nc,H,i,j]
    csh = cs.permute(0, 1, 3, 2)                               # [b,nc,H,Q]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    decay = torch.where(causal, torch.exp(csh[..., :, None]
                                          - csh[..., None, :]), 0.0)
    scores = rnd(CB * (decay * dtc.permute(0, 1, 3, 2)[..., None, :]))
    y = torch.einsum("bchij,bcjhp->bcihp", scores, xc)
    Ch = torch.repeat_interleave(Cc, rep, dim=3)               # [b,nc,Q,H,N]
    off = torch.einsum("bcihn,bchpn->bcihp", Ch, rnd(h_in))
    y = y + torch.exp(cs)[..., None] * off
    return y.reshape(b, L, H, P).to(x.dtype), h.to(x.dtype)


@functools.cache
def _lib():
    lib = build.load("ssd_scan")
    lib.ssd_scan.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    lib.ssd_scan.restype = ctypes.c_int
    lib.ssd_max_chunk.argtypes = []
    lib.ssd_max_chunk.restype = ctypes.c_int
    return lib


def pad_dims(x, B, C, multiple):
    """x with P, and B and C with N, zero-padded to multiples of
    ``multiple`` (a 16-byte row), contiguous. Exact: zero x columns give
    y and state rows that the caller drops, and zero B and C columns add
    nothing to C . B or to the state's other columns."""
    def pad(t):
        n = t.shape[-1]
        extra = -n % multiple
        return torch.nn.functional.pad(t, (0, extra)) if extra else t
    return pad(x), pad(B), pad(C)


def ssd_scan(x, dt, A, B, C, chunk: int = 128):
    """x: [b,L,H,P]; dt: [b,L,H] (softplus'd); A: [H] (negative); B, C:
    [b,L,G,N] in x's type, G dividing H; L a multiple of min(chunk, L).
    Returns (y [b,L,H,P], final_state [b,H,P,N]), both in x.dtype (as the
    Pallas kernel gives them), starting from h = 0.

    On CUDA this is three launches (chunk states, state passing, chunk
    scan) into a workspace allocated here; no host sync. P or N that is
    not a whole 16-byte row runs on zero-padded copies (``pad_dims``)."""
    _check(x, dt, A, B, C, chunk)
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, B, C, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    build.check_no_grad("ssd_scan", x, dt, A, B, C)
    b, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Q = min(chunk, L)
    lib = _lib()
    if N > MAX_N or Q > lib.ssd_max_chunk():
        raise ValueError(f"the kernel takes state dims up to {MAX_N} and "
                         f"chunks up to {lib.ssd_max_chunk()} (ROADMAP B); "
                         f"got N={N}, chunk {Q}")
    vec = 16 // x.element_size()
    if P % vec or N % vec:
        xp, Bp, Cp = pad_dims(x, B, C, vec)
        y, h = _launch(lib, xp, dt, A, Bp, Cp, Q)
        return y[..., :P].contiguous(), h[:, :, :P, :N].contiguous()
    return _launch(lib, x, dt, A, B, C, Q)


def _launch(lib, x, dt, A, B, C, Q):
    b, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    dt32 = dt.float().contiguous()
    A32 = A.float().contiguous()
    y = torch.empty_like(x)
    h = torch.empty((b, H, P, N), dtype=x.dtype, device=x.device)
    # chunk states [b, H, nc, P, N], then cs_last [b, H, nc], fp32
    ws = torch.empty(b * H * (-(-L // Q)) * (P * N + 1), dtype=torch.float32,
                     device=x.device)
    with torch.cuda.device(x.device):
        err = lib.ssd_scan(
            x.data_ptr(), dt32.data_ptr(), A32.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), h.data_ptr(), ws.data_ptr(),
            _DTYPE_CODES[x.dtype], b, L, H, G, P, N, Q,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
    ssd_scan.launches += 1
    return y, h


ssd_scan.launches = 0
