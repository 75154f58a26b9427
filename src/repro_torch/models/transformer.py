"""Decoder-only transformer LM (PyTorch), dense, MoE and vision-language.

The counterpart of the JAX package's ``models/transformer.py`` for the
dense, MoE and ``vlm`` families (a block's FFN is the routed MoE where
``cfg.is_moe``; llava's image tokens are prefix embeddings of
:func:`forward`).  The reference stacks its layers and runs them under
``lax.scan``; the port keeps a Python list of per-layer parameter dicts
and unrolls the layers, which is what the DHLO bridge traces, so each
layer's clusters fuse (a body of the bridge's ``d.scan`` runs op by op).

The token embedding is a gather, which the DHLO pipeline does not lower:
on that pipeline :func:`embed_tokens` runs outside ``disc_torch.compile``,
and the compiled function starts from hidden states
(:func:`decoder_logits`).  The serve path (:func:`prefill`, :func:`verify`,
:func:`decode_step`) runs whole, on the jit pipeline.

The KV cache keeps the reference's layouts (:func:`init_cache`): a dict
of layer-stacked leaves ``{"k", "v"}`` of shape (L, B, Hkv, S, hd), or,
where the config has MLA (``cfg.mla_kv_lora``: DeepSeek-V2), the latent
cache ``{"kv_c": (L, B, S, kv_lora), "k_pe": (L, B, S, rope)}``.  A paged
serve engine keeps the same leaves as a pool of blocks
(:func:`init_block_pool`, the sequence axis of each leaf by
:func:`page_axes`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from torch.utils import _pytree

from ..dist.profiles import PartitionSpec as P
from . import layers as L
from .common import (ArchConfig, cross_entropy_loss, dtype_of,
                     maybe_remat, param_init)

Params = Dict[str, Any]

__all__ = ["specs", "cache_specs", "block_init", "block_apply", "init", "embed_tokens",
           "logits_from_hidden", "decoder_logits", "forward", "loss_fn",
           "prefill",
           "verify", "init_cache", "init_block_pool", "page_axes",
           "decode_step"]


# ----------------------------------------------------------------- block --
def block_init(generator: torch.Generator, cfg: ArchConfig,
               device) -> Params:
    attn = L.mla_init if cfg.mla_kv_lora else L.attn_init
    return {"ln1": L.norm_init(cfg, device), "ln2": L.norm_init(cfg, device),
            "attn": attn(generator, cfg, device),
            "ffn": L.moe_init(generator, cfg, device) if cfg.is_moe
            else L.mlp_init(generator, cfg, device)}


def block_apply(cfg: ArchConfig, p: Params, x: torch.Tensor, *, positions,
                lens: Optional[torch.Tensor] = None,
                cache: Optional[Params] = None, offsets=None):
    h = L.norm_apply(cfg, p["ln1"], x)
    attn = L.mla_apply if cfg.mla_kv_lora else L.attn_apply
    a, new_cache = attn(cfg, p["attn"], h, positions=positions, lens=lens,
                        cache=cache, offsets=offsets)
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


def block_specs(cfg: ArchConfig) -> Params:
    p = {"ln1": L.norm_specs(cfg), "ln2": L.norm_specs(cfg)}
    p["attn"] = L.mla_specs(cfg) if cfg.mla_kv_lora else L.attn_specs(cfg)
    p["ffn"] = L.moe_specs(cfg) if cfg.is_moe else L.mlp_specs(cfg)
    return p


def specs(cfg: ArchConfig) -> Params:
    """Logical specs congruent with :func:`init`'s tree (``blocks`` one
    dict a layer, where the reference stacks them)."""
    p = {
        "embed": L.wspec(cfg, "model", "data"),
        "blocks": [block_specs(cfg) for _ in range(cfg.n_layers)],
        "ln_f": L.norm_specs(cfg),
    }
    if not cfg.tie_embeddings:
        p["head"] = L.wspec(cfg, "data", "model")
    return p


def embed_tokens(cfg: ArchConfig, params: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    return L.maybe_shard(L.embed(params["embed"], tokens), L.act_bsd(cfg))


def logits_from_hidden(cfg: ArchConfig, params: Params,
                       x: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    spec = (P(L._DP_ALL, None, None) if cfg.sharding_profile == "fsdp"
            else P(("pod", "data"), None, "model"))
    return L.maybe_shard(x @ head, spec)


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
    stacked.  Without caches each block is rematerialised per
    ``cfg.remat`` (:func:`~.common.maybe_remat`)."""
    if caches is None:
        def body(h, bp):
            return block_apply(cfg, bp, h, positions=positions,
                               lens=lens)[0]

        body = maybe_remat(cfg, body)
        for bp in blocks:
            x = body(x, bp)
        return x, None
    new = []
    for i, bp in enumerate(blocks):
        x, c = block_apply(cfg, bp, x, positions=positions, lens=lens,
                           cache={k: v[i] for k, v in caches.items()},
                           offsets=offsets)
        new.append(c)
    return x, {k: torch.stack([c[k] for c in new]) for k in caches}


def forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor, *,
            lens: Optional[torch.Tensor] = None,
            extra_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward: tokens (B, S) -> logits (B, S, V).

    ``extra_embeds`` (B, S_img, D) are prefix embeddings (llava's image
    tokens from the anyres-tiling stub) put before the token embeddings:
    the logits are then (B, S_img + S, V)."""
    x = embed_tokens(cfg, params, tokens)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    x, _ = _run_blocks(cfg, params["blocks"], x, positions=positions,
                       lens=lens)
    x = L.norm_apply(cfg, params["ln_f"], x)
    return logits_from_hidden(cfg, params, x)


def loss_fn(cfg: ArchConfig, params: Params,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The training loss: :func:`forward` over ``batch["tokens"]`` (with
    llava's ``image_embeds`` prefix, whose positions the labels skip: the
    logits are cut to the last ``labels.shape[1]`` positions), then the
    token-mean cross entropy under ``batch["mask"]``."""
    extra = batch.get("image_embeds")
    logits = forward(cfg, params, batch["tokens"], lens=batch.get("lens"),
                     extra_embeds=extra)
    labels = batch["labels"]
    if extra is not None:
        logits = logits[:, -labels.shape[1]:]
    return cross_entropy_loss(logits, labels, batch.get("mask"))


# -------------------------------------------------------------- prefill --
def _prefill_hidden(cfg: ArchConfig, params: Params, cache: Params,
                    tokens: torch.Tensor, lens: torch.Tensor,
                    offsets: torch.Tensor):
    """The chunk pass of :func:`prefill` and :func:`verify`: embed, run
    the blocks at absolute positions ``offset + arange(S)``, norm —
    returns the (B, S, D) hidden states plus the updated cache."""
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


def verify(cfg: ArchConfig, params: Params, cache: Params,
           tokens: torch.Tensor, lens: torch.Tensor, offsets: torch.Tensor):
    """Speculative-verify pass: :func:`prefill` semantics, but the head
    runs at EVERY chunk position — ``logits[r, j]`` (B, S, V) is the
    model's next-token distribution after consuming ``tokens[r, j]``, so
    one widened launch scores a whole drafted chunk per row.  Rows with
    ``lens[r] == 0`` write nothing (the same masks as prefill)."""
    x, new_cache = _prefill_hidden(cfg, params, cache, tokens, lens, offsets)
    return logits_from_hidden(cfg, params, x), new_cache


# --------------------------------------------------------------- decode --
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device) -> Params:
    """Zeroed KV cache: layer-stacked leaves (L, B, Hkv, max_len, hd), or
    MLA's (L, B, max_len, kv_lora) and (L, B, max_len, rope)."""
    cache_init = L.mla_cache_init if cfg.mla_kv_lora else L.attn_cache_init
    one = cache_init(cfg, batch, max_len, device)
    return {k: v[None].repeat((cfg.n_layers,) + (1,) * v.dim())
            for k, v in one.items()}


def cache_specs(cfg: ArchConfig) -> Params:
    one = L.mla_cache_specs(cfg) if cfg.mla_kv_lora else L.attn_cache_specs(cfg)
    return _stacked(one)


def _stacked(tree):
    """A per-layer spec tree for layer-stacked leaves: a leading None."""
    return _pytree.tree_map(lambda s: P(*((None,) + tuple(s))), tree)


def init_block_pool(cfg: ArchConfig, n_blocks: int, block_size: int,
                    device) -> Params:
    """Physical KV block pool for paged serving: the fixed-row cache with
    the batch axis reinterpreted as the block-id axis and the sequence
    axis cut to one block — leaves are ``(L, n_blocks, ..., block_size,
    ...)``.  Callers reserve id 0 as the null block (see
    :func:`repro_torch.models.layers.paged_gather`)."""
    return init_cache(cfg, n_blocks, block_size, device)


def page_axes(cfg: ArchConfig) -> Dict[str, int]:
    """Per-leaf sequence-axis index of the layer-stacked cache / pool
    leaves (the block axis is always axis 1, per
    :func:`repro_torch.models.registry.cache_batch_axis`)."""
    if cfg.mla_kv_lora:
        return {"kv_c": 2, "k_pe": 2}   # (L, B, S, lora / rope)
    return {"k": 3, "v": 3}             # (L, B, hkv, S, hd)


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
