"""Zamba2-style hybrid: Mamba-2 backbone + one *shared* attention block
(PyTorch).

The counterpart of the JAX package's ``models/zamba.py``.  The single
attention block's weights are reused after every
``cfg.shared_attn_every`` Mamba blocks, with a small per-invocation LoRA
delta on its query projection.  The reference scans each group of Mamba
blocks under ``lax.scan``; the port keeps one parameter dict per layer
and unrolls them.

The cache keeps the reference's tree: ``{"mamba": {"h": (L, B, H, N, P)
f32}, "attn": {"k", "v": (n_inv, B, Hkv, S, hd)}}``; the batch axis is
1 on both subtrees.

The reference has no single-pass prefill: its registry replays the chunk
through decode steps (``replay_prefill``).  :func:`prefill` computes the
same function in one pass: every Mamba layer one SSD kernel launch over
the chunk from the cache's state, with per-row ``lens``, and every
shared block the batched-prefill form of ``attn_apply`` at ``offsets``.
There is no ``greedy_decode`` (the reference has none).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from torch.utils import _pytree

from ..dist.profiles import PartitionSpec as P
from . import layers as L
from .common import (ArchConfig, cross_entropy_loss, dtype_of,
                     maybe_remat, param_init)

Params = Dict[str, Any]

__all__ = ["specs", "cache_specs", "init", "forward", "loss_fn", "init_cache", "decode_step",
           "prefill"]

_LORA_RANK = 8


def _mamba_block_init(generator: torch.Generator, cfg: ArchConfig,
                      device) -> Params:
    return {"ln1": L.norm_init(cfg, device),
            "mix": L.mamba2_init(generator, cfg, device),
            "ln2": L.norm_init(cfg, device),
            "mlp": L.mlp_init(generator, cfg, device, d_ff=cfg.d_ff // 2)}


def _n_invocations(cfg: ArchConfig) -> int:
    return max(cfg.n_layers // max(cfg.shared_attn_every, 1), 1)


def _group_sizes(cfg: ArchConfig) -> List[int]:
    """Mamba layers before each shared-block invocation: groups of
    ``shared_attn_every``, the remainder going to the last group."""
    every = max(cfg.shared_attn_every, 1)
    sizes = []
    done = 0
    for _ in range(_n_invocations(cfg)):
        size = min(every, cfg.n_layers - done)
        sizes.append(size)
        done += size
    if done < cfg.n_layers:
        sizes[-1] += cfg.n_layers - done
    return sizes


def init(cfg: ArchConfig, generator: torch.Generator, device) -> Params:
    """Random weights for the whole model, drawn from ``generator`` on
    ``device`` (``blocks`` is a list with one dict per layer; the LoRA
    factors are stacked over invocations, ``b_q`` zero as in the
    reference)."""
    dt = dtype_of(cfg)
    n_inv = _n_invocations(cfg)
    return {
        "embed": param_init(generator, (cfg.vocab, cfg.d_model), dt, device,
                            scale=0.02),
        "blocks": [_mamba_block_init(generator, cfg, device)
                   for _ in range(cfg.n_layers)],
        "shared_attn": L.attn_init(generator, cfg, device),
        "shared_ln": L.norm_init(cfg, device),
        "lora": {
            "a_q": param_init(generator, (n_inv, cfg.d_model, _LORA_RANK),
                              dt, device),
            "b_q": torch.zeros((n_inv, _LORA_RANK, cfg.n_heads * cfg.hd),
                               dtype=dt, device=device),
        },
        "ln_f": L.norm_init(cfg, device),
        "head": param_init(generator, (cfg.d_model, cfg.vocab), dt, device),
    }


def _mamba_block_specs(cfg: ArchConfig) -> Params:
    return {"ln1": L.norm_specs(cfg), "mix": L.mamba2_specs(cfg),
            "ln2": L.norm_specs(cfg), "mlp": L.mlp_specs(cfg)}


def specs(cfg: ArchConfig) -> Params:
    """Logical specs congruent with :func:`init`'s tree."""
    return {
        "embed": P("model", "data"),
        "blocks": [_mamba_block_specs(cfg) for _ in range(cfg.n_layers)],
        "shared_attn": L.attn_specs(cfg),
        "shared_ln": L.norm_specs(cfg),
        "lora": {"a_q": P(None, "data", None), "b_q": P(None, None, "model")},
        "ln_f": L.norm_specs(cfg),
        "head": P("data", "model"),
    }


def cache_specs(cfg: ArchConfig) -> Params:
    stack = lambda t: _pytree.tree_map(  # noqa: E731
        lambda s: P(*((None,) + tuple(s))), t)
    return {"mamba": stack(L.mamba2_cache_specs(cfg)),
            "attn": stack(L.attn_cache_specs(cfg))}


def _mamba_group(cfg: ArchConfig, blocks, x: torch.Tensor, caches=None,
                 lens: Optional[torch.Tensor] = None):
    """The Mamba blocks of one group in order; with ``caches`` (a list of
    per-layer ``{"h"}``), each continues from its state for the first
    ``lens[b]`` positions (None: all) and the new states come back as a
    list.  Without caches each block is rematerialised per
    ``cfg.remat``, as in the reference (the shared attention is not)."""
    if caches is None:
        def body(h, bp):
            a, _ = L.mamba2_apply(cfg, bp["mix"],
                                  L.norm_apply(cfg, bp["ln1"], h), lens=lens)
            h = h + a
            return h + L.mlp_apply(cfg, bp["mlp"],
                                   L.norm_apply(cfg, bp["ln2"], h))

        body = maybe_remat(cfg, body)
        for bp in blocks:
            x = body(x, bp)
        return x, [None] * len(blocks)
    new = []
    for i, bp in enumerate(blocks):
        a, c = L.mamba2_apply(cfg, bp["mix"], L.norm_apply(cfg, bp["ln1"], x),
                              cache=caches[i], lens=lens)
        x = x + a
        x = x + L.mlp_apply(cfg, bp["mlp"], L.norm_apply(cfg, bp["ln2"], x))
        new.append(c)
    return x, new


def _shared_attn(cfg: ArchConfig, params: Params, inv: int, x, *, positions,
                 lens, cache=None, offsets=None):
    """The shared block at invocation ``inv``: its query projection plus
    that invocation's LoRA delta (added in the weight dtype, as the
    reference adds it), after the shared norm.  Returns the residual
    delta (the caller adds it to x) and the new KV cache."""
    p = dict(params["shared_attn"])
    p["wq"] = p["wq"] + params["lora"]["a_q"][inv] @ params["lora"]["b_q"][inv]
    h = L.norm_apply(cfg, params["shared_ln"], x)
    a, new_cache = L.attn_apply(cfg, p, h, positions=positions, lens=lens,
                                cache=cache, offsets=offsets)
    return a, new_cache


def forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor, *,
            lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward from a zero state: tokens (B, S) -> logits
    (B, S, V).  ``lens`` masks the shared blocks' keys only; the Mamba
    blocks ignore it, as in the reference."""
    x = L.embed(params["embed"], tokens)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    off = 0
    for inv, size in enumerate(_group_sizes(cfg)):
        x, _ = _mamba_group(cfg, params["blocks"][off:off + size], x)
        a, _ = _shared_attn(cfg, params, inv, x, positions=positions,
                            lens=lens)
        x = x + a
        off += size
    x = L.norm_apply(cfg, params["ln_f"], x)
    return x @ params["head"]


def loss_fn(cfg: ArchConfig, params: Params, batch) -> torch.Tensor:
    """The training loss: :func:`forward` over ``batch["tokens"]``, then
    the token-mean cross entropy under ``batch["mask"]``."""
    logits = forward(cfg, params, batch["tokens"])
    return cross_entropy_loss(logits, batch["labels"], batch.get("mask"))


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device) -> Params:
    """Zeroed cache: the Mamba layers' states and the shared blocks'
    KV rows, each layer- (invocation-) stacked."""
    h = L.mamba2_cache_init(cfg, batch, device)["h"]
    kv = L.attn_cache_init(cfg, batch, max_len, device)
    n_inv = _n_invocations(cfg)
    return {"mamba": {"h": h[None].repeat((cfg.n_layers,) + (1,) * h.dim())},
            "attn": {k: v[None].repeat((n_inv,) + (1,) * v.dim())
                     for k, v in kv.items()}}


def _run(cfg: ArchConfig, params: Params, cache: Params, x: torch.Tensor, *,
         positions, lens, mamba_lens=None, offsets=None):
    """Every group and shared block over x (B, S, D) from the cache;
    returns the hidden states and the new cache, stacked as the old."""
    hs, ks, vs = [], [], []
    off = 0
    for inv, size in enumerate(_group_sizes(cfg)):
        caches = [{"h": cache["mamba"]["h"][i]}
                  for i in range(off, off + size)]
        x, new = _mamba_group(cfg, params["blocks"][off:off + size], x,
                              caches=caches, lens=mamba_lens)
        hs += [c["h"] for c in new]
        a, ac = _shared_attn(cfg, params, inv, x, positions=positions,
                             lens=lens,
                             cache={k: v[inv]
                                    for k, v in cache["attn"].items()},
                             offsets=offsets)
        x = x + a
        ks.append(ac["k"])
        vs.append(ac["v"])
        off += size
    return x, {"mamba": {"h": torch.stack(hs)},
               "attn": {"k": torch.stack(ks), "v": torch.stack(vs)}}


def decode_step(cfg: ArchConfig, params: Params, cache: Params,
                tokens: torch.Tensor, lens: torch.Tensor):
    """One decode step: tokens (B, 1), lens (B,) current cache fill ->
    (logits (B, 1, V), new cache)."""
    x = L.embed(params["embed"], tokens)
    x, new_cache = _run(cfg, params, cache, x, positions=lens[:, None],
                        lens=lens)
    x = L.norm_apply(cfg, params["ln_f"], x)
    return x @ params["head"], new_cache


def prefill(cfg: ArchConfig, params: Params, cache: Params,
            tokens: torch.Tensor, lens: torch.Tensor, offsets: torch.Tensor):
    """Single-pass batched prefill from the cache (the serve path): what
    the reference's ``replay_prefill(decode_step)`` computes.

    ``tokens`` (B, S) right-padded chunks, ``lens`` (B,) true chunk
    lengths, ``offsets`` (B,) the cache fill (0 = fresh).  Every Mamba
    layer runs the chunk from its cache state for the first ``lens[b]``
    steps (one SSD launch); every shared block writes the chunk's K/V at
    ``[offset, offset + lens)`` and attends causally at absolute
    positions.  Returns ``(last_logits (B, V), new_cache)``: the logits
    at each row's last valid position, and the cache after ``lens[b]``
    tokens; a row with ``lens = 0`` keeps its cache (its logits are
    unspecified)."""
    x = L.embed(params["embed"], tokens)
    s = x.shape[1]
    positions = offsets[:, None] + torch.arange(s, device=x.device)[None, :]
    x, new_cache = _run(cfg, params, cache, x, positions=positions,
                        lens=lens, mamba_lens=lens, offsets=offsets)
    b = x.shape[0]
    last = x[torch.arange(b, device=x.device), (lens - 1).clamp(min=0)]
    last = L.norm_apply(cfg, params["ln_f"], last[:, None])[:, 0]
    return last @ params["head"], new_cache
