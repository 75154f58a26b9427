"""Model-zoo layers on the compiled path (PyTorch, single device).

The counterparts of the JAX package's ``models/layers.py`` functions that
a dense transformer runs: RMS/LayerNorm, RoPE, grouped-query attention
(full, batched prefill against a KV cache, and decode) and the (Swi)GLU
MLP.  Each is a plain function of tensors with the reference's name and
argument order.

Attention and RMSNorm go through their kernels' wrappers
(``kernels/flash_attention/ops.py``, ``kernels/rmsnorm/ops.py``): the
CUDA C++ flash-attention and Triton RMSNorm kernels on the card, their
plain versions on the CPU.  The DHLO bridge traces these functions inside
``plain_versions()``, so they trace into the same op structure the
reference traces into (``dot_general`` for the grouped attention
contractions, ``mean`` + ``rsqrt`` norms, explicit softmax).

``maybe_shard`` is the identity: sharding arrives with the multi-GPU slice.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..kernels.flash_attention import ops as fa_ops
from ..kernels.flash_attention.ref import (  # noqa: F401 (reference names)
    CHUNK_THRESHOLD as _CHUNK_THRESHOLD, pick_chunk as _pick_chunk,
    q_positions as _q_positions, sdpa_chunked_ref as _sdpa_chunked)
from ..kernels.rmsnorm import ops as rms_ops
from .common import ArchConfig, dtype_of, param_init

Params = Dict[str, Any]

__all__ = ["norm_init", "norm_apply", "rope_tables", "apply_rope",
           "attn_init", "attn_apply", "attn_cache_init", "mlp_init",
           "mlp_apply", "maybe_shard"]


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
    """LayerNorm (eps 1e-5) or RMSNorm (eps 1e-6), f32 accumulation, cast
    back to x's dtype.  RMSNorm is the Triton kernel on the card and its
    plain version (the reference's ops) on the CPU."""
    if cfg.norm == "layernorm":
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        xc = xf - mu
        var = (xc * xc).mean(-1, keepdim=True)
        y = xc * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
        return y.to(x.dtype)
    return rms_ops.rmsnorm(x, p["scale"], eps=1e-6)


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


def _sdpa(q, k, v, *, causal: bool, lens: Optional[torch.Tensor],
          q_offset=0) -> torch.Tensor:
    """q (B,H,Sq,hd) x k,v (B,Hkv,Sk,hd) -> (B,H,Sq,hd); f32 softmax.

    ``q_offset`` is a scalar or a per-row (B,) vector (batched prefill).
    On the card this is the flash-attention kernel (its decode form for
    one query row); on the CPU, and inside ``plain_versions()``, the
    reference's dense form, or ``_sdpa_chunked`` for long queries."""
    return fa_ops.flash_attention(q, k, v, lens, causal=causal,
                                  q_offset=q_offset)


def attn_apply(cfg: ArchConfig, p: Params, x: torch.Tensor, *,
               positions: torch.Tensor, lens: Optional[torch.Tensor] = None,
               cache: Optional[Params] = None, causal: bool = True,
               offsets: Optional[torch.Tensor] = None):
    """Full attention; ``cache`` switches to decode mode (x is (B,1,D)).

    ``cache`` + ``offsets`` switches to *batched prefill* mode instead
    (serve path): x is a (B, S, D) chunk whose row r holds ``lens[r]``
    true tokens destined for absolute cache positions
    ``[offsets[r], offsets[r] + lens[r])``; the chunk's K/V are scattered
    into the cache in one pass and queries attend causally against the
    whole cache at absolute positions."""
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
    new_cache = None
    if cache is not None and offsets is not None:
        # batched prefill: scatter the chunk's K/V to absolute positions
        # [offset, offset+len) per row — padded chunk positions are never
        # written — then attend causally against the whole cache
        kc, vc = cache["k"], cache["v"]
        lc = kc.shape[2]
        j = torch.arange(lc, device=x.device)[None, :] - offsets[:, None]
        written = (j >= 0) & (j < lens[:, None])
        idx = j.clamp(0, s - 1)[:, None, :, None].expand(b, hkv, lc, hd)
        wmask = written[:, None, :, None]
        kc = torch.where(wmask, torch.gather(k, 2, idx).to(kc.dtype), kc)
        vc = torch.where(wmask, torch.gather(v, 2, idx).to(vc.dtype), vc)
        new_cache = {"k": kc, "v": vc}
        o = _sdpa(q, kc.to(q.dtype), vc.to(q.dtype), causal=True,
                  lens=None, q_offset=offsets)
    elif cache is not None:
        # decode: append to the cache at position lens (per batch row)
        kc, vc = cache["k"], cache["v"]
        pos = torch.arange(kc.shape[2], device=x.device)[None, None, :, None]
        write = pos == lens[:, None, None, None]
        kc = torch.where(write, k.to(kc.dtype), kc)
        vc = torch.where(write, v.to(vc.dtype), vc)
        new_cache = {"k": kc, "v": vc}
        o = _sdpa(q, kc.to(q.dtype), vc.to(q.dtype), causal=False,
                  lens=lens + 1)
    else:
        o = _sdpa(q, k, v, causal=causal, lens=lens, q_offset=0)
    o = o.transpose(1, 2).reshape(b, s, h * hd)
    return o @ p["wo"], new_cache


def attn_cache_init(cfg: ArchConfig, batch: int, max_len: int,
                    device) -> Params:
    hkv, hd = cfg.n_kv_heads, cfg.hd
    dt = dtype_of(cfg)
    return {"k": torch.zeros((batch, hkv, max_len, hd), dtype=dt,
                             device=device),
            "v": torch.zeros((batch, hkv, max_len, hd), dtype=dt,
                             device=device)}


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
