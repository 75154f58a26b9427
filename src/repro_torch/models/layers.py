"""Model-zoo layers on the compiled path (PyTorch, single device).

The counterparts of the JAX package's ``models/layers.py`` functions that
the decoder stack of a dense transformer runs: RMS/LayerNorm, RoPE,
full (no-cache) grouped-query attention and the (Swi)GLU MLP.  Each is a
plain function of tensors with the reference's name and argument order,
written so that it traces through the DHLO bridge into the same op
structure the reference traces into (``dot_general`` for the grouped
attention contractions, ``mean`` + ``rsqrt`` norms, explicit softmax).

``maybe_shard`` is the identity: sharding arrives with the multi-GPU slice.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..core.primitives import dot_general
from .common import ArchConfig, dtype_of, param_init

Params = Dict[str, Any]

__all__ = ["norm_init", "norm_apply", "rope_tables", "apply_rope",
           "attn_init", "attn_apply", "mlp_init", "mlp_apply", "maybe_shard"]


def maybe_shard(x: torch.Tensor, spec: Any = None) -> torch.Tensor:
    """Single device: sharding constraints are the identity."""
    return x


# ---------------------------------------------------------------- norms --
def norm_init(cfg: ArchConfig, device, d: Optional[int] = None) -> Params:
    d = d or cfg.d_model
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def norm_apply(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        xc = xf - mu
        var = (xc * xc).mean(-1, keepdim=True)
        y = xc * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + 1e-6) * p["scale"]
    return y.to(x.dtype)


# ----------------------------------------------------------------- rope --
def rope_tables(positions: torch.Tensor, dim: int, theta: float) -> Tuple:
    """positions (...,) -> cos/sin tables (..., dim/2)."""
    freqs = torch.arange(0, dim, 2, dtype=torch.float32,
                         device=positions.device)
    inv = 1.0 / (theta ** (freqs / dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, hd); cos/sin (..., S, hd/2) broadcast over heads."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c],
                     dim=-1).to(x.dtype)


# ------------------------------------------------------------ attention --
def attn_init(generator: torch.Generator, cfg: ArchConfig, device) -> Params:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = dtype_of(cfg)
    return {
        "wq": param_init(generator, (d, h * hd), dt, device),
        "wk": param_init(generator, (d, hkv * hd), dt, device),
        "wv": param_init(generator, (d, hkv * hd), dt, device),
        "wo": param_init(generator, (h * hd, d), dt, device),
    }


_CHUNK_THRESHOLD = 2048  # beyond this, scores are never materialized


def _q_positions(sq: int, q_offset: int, device) -> torch.Tensor:
    """Absolute query positions (1, Sq) for a scalar cache offset."""
    return (torch.arange(sq, device=device) + q_offset)[None, :]


def _sdpa_chunked(q, k, v, *, causal: bool, lens, q_offset,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Online-softmax attention for sequences whose (Sq, Sk) score matrix
    must never exist.  It arrives with the serving slice."""
    raise NotImplementedError(
        f"attention over {q.shape[2]} query positions needs the chunked "
        f"online-softmax path, which the port does not have yet; keep "
        f"requests below {_CHUNK_THRESHOLD} tokens")


def _sdpa(q, k, v, *, causal: bool, lens: Optional[torch.Tensor],
          q_offset: int = 0) -> torch.Tensor:
    """q (B,H,Sq,hd) x k,v (B,Hkv,Sk,hd) -> (B,H,Sq,hd); f32 softmax."""
    b, h, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if sq >= _CHUNK_THRESHOLD or sk > 4 * _CHUNK_THRESHOLD:
        return _sdpa_chunked(q, k, v, causal=causal, lens=lens,
                             q_offset=q_offset)
    group = h // hkv
    qf = q.float() / math.sqrt(hd)
    # grouped contraction without materializing repeated K/V
    qg = qf.reshape(b, hkv, group, sq, hd)
    s = dot_general(qg, k.float(), (((4,), (3,)), ((0, 1), (0, 1))))
    k_idx = torch.arange(sk, device=q.device)[None, None, None, None, :]
    neg = -1e30
    if lens is not None:
        s = torch.where(k_idx < lens[:, None, None, None, None], s, neg)
    if causal:
        q_idx = _q_positions(sq, q_offset, q.device)[:, None, None, :, None]
        s = torch.where(k_idx <= q_idx, s, neg)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m.detach())
    p = e / e.sum(-1, keepdim=True)
    o = dot_general(p, v.float(), (((4,), (2,)), ((0, 1), (0, 1))))
    return o.reshape(b, h, sq, hd).to(q.dtype)


def attn_apply(cfg: ArchConfig, p: Params, x: torch.Tensor, *,
               positions: torch.Tensor, lens: Optional[torch.Tensor] = None,
               causal: bool = True):
    """Full self-attention over x (B, S, D) (no KV cache: the decode and
    batched-prefill branches arrive with the serving slice)."""
    b, s, d = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, hkv, hd)
    v = (x @ p["wv"]).reshape(b, s, hkv, hd)
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    q = q.transpose(1, 2)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    o = _sdpa(q, k, v, causal=causal, lens=lens, q_offset=0)
    o = o.transpose(1, 2).reshape(b, s, h * hd)
    return o @ p["wo"], None


# ------------------------------------------------------------------ mlp --
def mlp_init(generator: torch.Generator, cfg: ArchConfig, device,
             d_ff: Optional[int] = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    p = {"w_in": param_init(generator, (d, f), dt, device),
         "w_out": param_init(generator, (f, d), dt, device)}
    if cfg.act == "silu":
        p["w_gate"] = param_init(generator, (d, f), dt, device)
    return p


def mlp_apply(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["w_in"]
    if cfg.act == "silu":
        g = x @ p["w_gate"]
        h = g * torch.sigmoid(g) * h
    else:
        h = torch.nn.functional.gelu(h, approximate="tanh")
    return h @ p["w_out"]
