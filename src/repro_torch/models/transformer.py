"""Decoder-only transformer LM (PyTorch), dense and MoE.

The counterpart of the JAX package's ``models/transformer.py`` for the
dense and MoE families (a block's FFN is the routed MoE where
``cfg.is_moe``).  The reference stacks its layers and runs them under
``lax.scan``; the port keeps a Python list of per-layer parameter dicts
and unrolls the layers, which is what the DHLO bridge traces, so each
layer's clusters fuse (a body of the bridge's ``d.scan`` runs op by op).

The token embedding is a gather, which the DHLO pipeline does not lower:
on that pipeline :func:`embed_tokens` runs outside ``disc_torch.compile``,
and the compiled function starts from hidden states
(:func:`decoder_logits`).  The serve path (:func:`prefill`,
:func:`decode_step`) runs whole, on the jit pipeline.

The KV cache keeps the reference's layout: a dict of layer-stacked leaves
``{"k", "v"}`` of shape (L, B, Hkv, S, hd) (:func:`init_cache`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from . import layers as L
from .common import ArchConfig, dtype_of, param_init

Params = Dict[str, Any]

__all__ = ["block_init", "block_apply", "init", "embed_tokens",
           "logits_from_hidden", "decoder_logits", "forward", "prefill",
           "init_cache", "decode_step"]


# ----------------------------------------------------------------- block --
def block_init(generator: torch.Generator, cfg: ArchConfig,
               device) -> Params:
    return {"ln1": L.norm_init(cfg, device), "ln2": L.norm_init(cfg, device),
            "attn": L.attn_init(generator, cfg, device),
            "ffn": L.moe_init(generator, cfg, device) if cfg.is_moe
            else L.mlp_init(generator, cfg, device)}


def block_apply(cfg: ArchConfig, p: Params, x: torch.Tensor, *, positions,
                lens: Optional[torch.Tensor] = None,
                cache: Optional[Params] = None, offsets=None):
    h = L.norm_apply(cfg, p["ln1"], x)
    a, new_cache = L.attn_apply(cfg, p["attn"], h, positions=positions,
                                lens=lens, cache=cache, offsets=offsets)
    x = x + a
    h = L.norm_apply(cfg, p["ln2"], x)
    if cfg.is_moe:
        # ``lens`` marks the valid tokens except in a decode step, where
        # it is the cache fill and every row's token counts
        decode = cache is not None and offsets is None
        f = L.moe_apply(cfg, p["ffn"], h, lens=None if decode else lens)
    else:
        f = L.mlp_apply(cfg, p["ffn"], h)
    return x + f, new_cache


# ------------------------------------------------------------------- LM --
def init(cfg: ArchConfig, generator: torch.Generator, device) -> Params:
    """Random weights for the whole model, drawn from ``generator`` on
    ``device`` (``blocks`` is a list with one dict per layer)."""
    dt = dtype_of(cfg)
    p = {
        "embed": param_init(generator, (cfg.vocab, cfg.d_model), dt, device,
                            scale=0.02),
        "blocks": [block_init(generator, cfg, device)
                   for _ in range(cfg.n_layers)],
        "ln_f": L.norm_init(cfg, device),
    }
    if not cfg.tie_embeddings:
        p["head"] = param_init(generator, (cfg.d_model, cfg.vocab), dt,
                               device)
    return p


def embed_tokens(cfg: ArchConfig, params: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def logits_from_hidden(cfg: ArchConfig, params: Params,
                       x: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x @ head


def decoder_logits(cfg: ArchConfig, params: Params,
                   x: torch.Tensor) -> torch.Tensor:
    """Hidden states (B, S, D) → logits (B, S, V): every layer unrolled at
    positions ``0..S-1``, then ``ln_f`` and the head — the function the
    compiled path serves."""
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    for bp in params["blocks"]:
        x, _ = block_apply(cfg, bp, x, positions=positions)
    x = L.norm_apply(cfg, params["ln_f"], x)
    return logits_from_hidden(cfg, params, x)


def _run_blocks(cfg: ArchConfig, blocks, x: torch.Tensor, *, positions,
                lens, caches: Optional[Params] = None, offsets=None):
    """Every layer in order; with ``caches`` (layer-stacked leaves), each
    layer reads and writes its slice, and the new caches come back
    stacked."""
    if caches is None:
        for bp in blocks:
            x, _ = block_apply(cfg, bp, x, positions=positions, lens=lens)
        return x, None
    new = []
    for i, bp in enumerate(blocks):
        x, c = block_apply(cfg, bp, x, positions=positions, lens=lens,
                           cache={k: v[i] for k, v in caches.items()},
                           offsets=offsets)
        new.append(c)
    return x, {k: torch.stack([c[k] for c in new]) for k in caches}


def forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor, *,
            lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward: tokens (B, S) -> logits (B, S, V)."""
    x = embed_tokens(cfg, params, tokens)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    x, _ = _run_blocks(cfg, params["blocks"], x, positions=positions,
                       lens=lens)
    x = L.norm_apply(cfg, params["ln_f"], x)
    return logits_from_hidden(cfg, params, x)


# -------------------------------------------------------------- prefill --
def _prefill_hidden(cfg: ArchConfig, params: Params, cache: Params,
                    tokens: torch.Tensor, lens: torch.Tensor,
                    offsets: torch.Tensor):
    """The chunk pass of :func:`prefill`: embed, run the blocks at
    absolute positions ``offset + arange(S)``, norm — returns the
    (B, S, D) hidden states plus the updated cache."""
    x = embed_tokens(cfg, params, tokens)
    s = x.shape[1]
    positions = offsets[:, None] + torch.arange(s, device=x.device)[None, :]
    x, new_cache = _run_blocks(cfg, params["blocks"], x, positions=positions,
                               lens=lens, caches=cache, offsets=offsets)
    return L.norm_apply(cfg, params["ln_f"], x), new_cache


def prefill(cfg: ArchConfig, params: Params, cache: Params,
            tokens: torch.Tensor, lens: torch.Tensor, offsets: torch.Tensor):
    """Single-pass batched prefill with cache offset (the serve path).

    ``tokens`` (B, S) right-padded prompt chunks; ``lens`` (B,) true chunk
    lengths; ``offsets`` (B,) current per-row cache fill (0 = fresh).  One
    launch computes every chunk position's K/V, writes them at absolute
    cache positions ``[offset, offset+len)``, and returns
    ``(last_logits, new_cache)`` where ``last_logits[r]`` (V,) is the
    logits at row r's final valid position — the head runs on that single
    hidden state per row, never on the full (B, S, vocab) tensor.
    """
    x, new_cache = _prefill_hidden(cfg, params, cache, tokens, lens, offsets)
    b = x.shape[0]
    last = x[torch.arange(b, device=x.device), (lens - 1).clamp(min=0)]
    return logits_from_hidden(cfg, params, last), new_cache


# --------------------------------------------------------------- decode --
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device) -> Params:
    """Zeroed KV cache: layer-stacked leaves (L, B, Hkv, max_len, hd)."""
    one = L.attn_cache_init(cfg, batch, max_len, device)
    return {k: v[None].repeat((cfg.n_layers,) + (1,) * v.dim())
            for k, v in one.items()}


def decode_step(cfg: ArchConfig, params: Params, cache: Params,
                tokens: torch.Tensor, lens: torch.Tensor):
    """One decode step: tokens (B, 1), lens (B,) current cache fill ->
    (logits (B, 1, V), new cache)."""
    x = embed_tokens(cfg, params, tokens)
    x, new_cache = _run_blocks(cfg, params["blocks"], x,
                               positions=lens[:, None], lens=lens,
                               caches=cache)
    x = L.norm_apply(cfg, params["ln_f"], x)
    return logits_from_hidden(cfg, params, x), new_cache
