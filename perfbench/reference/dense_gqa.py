"""The layout ``dense_gqa``: a dense decoder with grouped K/V heads, as a
configuration file that names it (``"reference": "dense_gqa"``) is run.
Its parameter shapes (``shapes``), the counts the roofline takes
(``work``), and a plain float32 forward (``Reference``), written from the
configuration file alone: PyTorch operations, no cache, no batching, no
kernel, nothing of the program imported.

The model: token embedding; per layer, a pre-norm (RMSNorm with a scale)
attention block (q, k, v projections, optional scale-free RMS qk-norm
over the head dim, rotary embedding over the whole head dim in the
rotate-half form, causal softmax attention with grouped K/V heads, the
output projection) added to the residual, then a pre-norm SwiGLU MLP
added to the residual; a final RMSNorm and the head. The weights are the
benchmark's (``weights.py`` draws them to ``shapes``), read a layer at a
time and widened to float32; matrix products run with TF32 off.

``quant="fp8"`` is the control: every matrix product's operands rounded
to float8 e4m3 (weights per output column, activations per row, each
scaled by its largest magnitude), the rest as above."""
from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence

import torch

def padded_vocab(m: dict) -> int:
    """The vocabulary the port's tables hold: a multiple of 256 rows
    (``ModelConfig.padded_vocab``); the padding's logits are masked."""
    return -(-m["vocab_size"] // 256) * 256


def shapes(m: dict) -> dict:
    """Leaf name -> (shape, fan-in, or None for a norm scale) in the
    port's parameter layout (``repro_torch.models.transformer``'s
    ``init_params``): ``embed [V, d]``, ``lm_head [d, V]``,
    ``final_norm.scale [d]`` and ``layers`` stacked over the depth."""
    L, d = m["num_hidden_layers"], m["hidden_size"]
    H, KV, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                 m["head_dim"])
    f, V = m["intermediate_size"], padded_vocab(m)
    return {
        "embed": ((V, d), None),
        "lm_head": ((d, V), d),
        "final_norm.scale": ((d,), None),
        "layers.norm1.scale": ((L, d), None),
        "layers.norm2.scale": ((L, d), None),
        "layers.attn.wq": ((L, d, H, hd), d),
        "layers.attn.wk": ((L, d, KV, hd), d),
        "layers.attn.wv": ((L, d, KV, hd), d),
        "layers.attn.wo": ((L, H * hd, d), H * hd),
        "layers.mlp.w_gate": ((L, d, f), d),
        "layers.mlp.w_up": ((L, d, f), d),
        "layers.mlp.w_down": ((L, f, d), f),
    }


def work(m: dict) -> dict:
    """The sizes ``roofline.py`` counts with: the layers; one layer's
    matrix-product weights; the head's; K/V elements a token a layer;
    query elements a token a layer; attention operations a query a key a
    layer (q.k and p.v, 2 a multiply-add)."""
    L, d = m["num_hidden_layers"], m["hidden_size"]
    H, KV, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                 m["head_dim"])
    f = m["intermediate_size"]
    return {"layers": L,
            "layer_weights": d * H * hd + 2 * d * KV * hd + H * hd * d
            + 3 * d * f,
            "head_weights": d * padded_vocab(m),
            "kv_per_token": 2 * KV * hd, "q_per_token": H * hd,
            "attn_flops_per_key": 4 * H * hd}


#: query rows attended at once (bounds the score tensor)
Q_BLOCK = 512
#: rows of an MLP product at once
ROW_BLOCK = 2048
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for the block, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3, scaled by its largest magnitude
    along ``dim``, back in float32."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _rms(x, scale, eps):
    y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return y if scale is None else y * scale


def _rope(x, theta):
    """Rotary embedding of x [S, h, D] at positions 0..S-1, the halves of
    the head dim rotated together."""
    S, _, D = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float64,
                                        device=x.device) / D))
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = ang.cos().to(torch.float32)[:, None, :]
    sin = ang.sin().to(torch.float32)[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attend(q, k, v):
    """Causal attention: q [S, H, D], k and v [S, KV, D]; head h reads
    K/V head h // (H / KV)."""
    S, H, D = q.shape
    R = H // k.shape[1]
    k = k.repeat_interleave(R, dim=1)
    v = v.repeat_interleave(R, dim=1)
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(D)
    for a in range(0, S, Q_BLOCK):
        b = min(S, a + Q_BLOCK)
        s = torch.einsum("qhd,khd->hqk", q[a:b], k[:b]) * scale
        qi = torch.arange(a, b, device=q.device)[:, None]
        ki = torch.arange(b, device=q.device)[None, :]
        s.masked_fill_((ki > qi)[None], float("-inf"))
        out[a:b] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1),
                                v[:b])
    return out


class Reference:
    """The reference over the benchmark's weights ``params`` for the
    configuration file ``m``."""

    def __init__(self, params: dict, m: dict, quant: Optional[str] = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown quant {quant!r}")
        self.p, self.m, self.quant = params, m, quant
        self.eps = m["layer_norm_eps"]
        self.qk_eps = m["qk_norm_eps"] if m["qk_layernorm"] else None

    def _w(self, t):
        """A weight [in, ..., out...] as float32 [in, out]."""
        w = t.reshape(t.shape[0], -1).to(torch.float32)
        return fp8(w, 0) if self.quant else w

    def _mm(self, x, w):
        if self.quant:
            x = fp8(x, -1)
        out = torch.empty((x.shape[0], w.shape[1]), dtype=torch.float32,
                          device=x.device)
        for a in range(0, x.shape[0], ROW_BLOCK):
            torch.matmul(x[a:a + ROW_BLOCK], w, out=out[a:a + ROW_BLOCK])
        return out

    def _layer(self, x, lw):
        m = self.m
        H, KV, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                     m["head_dim"])
        S = x.shape[0]
        h = _rms(x, lw["norm1"], self.eps)
        q = self._mm(h, lw["wq"]).view(S, H, hd)
        k = self._mm(h, lw["wk"]).view(S, KV, hd)
        v = self._mm(h, lw["wv"]).view(S, KV, hd)
        if self.qk_eps is not None:
            q, k = _rms(q, None, self.qk_eps), _rms(k, None, self.qk_eps)
        q, k = _rope(q, m["rope_theta"]), _rope(k, m["rope_theta"])
        x = x + self._mm(_attend(q, k, v).reshape(S, H * hd), lw["wo"])
        h = _rms(x, lw["norm2"], self.eps)
        for a in range(0, S, ROW_BLOCK):
            hb = h[a:a + ROW_BLOCK]
            g = self._mm(hb, lw["w_gate"])
            g = g * torch.sigmoid(g) * self._mm(hb, lw["w_up"])
            x[a:a + ROW_BLOCK] += self._mm(g, lw["w_down"])
        return x

    @torch.no_grad()
    def logits(self, seqs: Sequence[Sequence[int]],
               rows: Sequence[slice]) -> List[torch.Tensor]:
        """float32 logits over the real vocabulary at ``rows[i]`` of each
        sequence ``seqs[i]`` (positions whose next token is judged)."""
        p, m = self.p, self.m
        dev = p["embed"].device
        with exact_fp32():
            xs = [p["embed"][torch.as_tensor(list(s), device=dev)].to(
                torch.float32) for s in seqs]
            lay = p["layers"]
            for i in range(m["num_hidden_layers"]):
                lw = {
                    "norm1": lay["norm1"]["scale"][i].to(torch.float32),
                    "norm2": lay["norm2"]["scale"][i].to(torch.float32),
                    "wq": self._w(lay["attn"]["wq"][i]),
                    "wk": self._w(lay["attn"]["wk"][i]),
                    "wv": self._w(lay["attn"]["wv"][i]),
                    "wo": self._w(lay["attn"]["wo"][i]),
                    "w_gate": self._w(lay["mlp"]["w_gate"][i]),
                    "w_up": self._w(lay["mlp"]["w_up"][i]),
                    "w_down": self._w(lay["mlp"]["w_down"][i]),
                }
                xs = [self._layer(x, lw) for x in xs]
                del lw
            head = self._w(p["lm_head"])
            fnorm = p["final_norm"]["scale"].to(torch.float32)
            out = []
            for x, r in zip(xs, rows):
                h = _rms(x[r], fnorm, self.eps)
                out.append(self._mm(h, head)[:, :m["vocab_size"]])
            return out
