"""Model registry: family -> (init / forward / cache / prefill / decode)
bundle, the counterpart of the JAX package's ``models/registry.py`` for
the dense, MoE (``"moe"``, DBRX and DeepSeek-V2: the transformer with
routed experts, DeepSeek-V2's attention MLA over a latent cache),
vision-language (``"vlm"``, llava: the transformer with image-token
prefixes), recurrent (``"ssm"``, RWKV-6), hybrid (``"hybrid"``, Zamba2)
and encoder-decoder (``"encdec"``, whisper) families.

Cache trees may nest (RWKV's ``{"tmix": {"s", "x_prev"}, "cmix_x"}``,
Zamba2's ``{"mamba": {"h"}, "attn": {"k", "v"}}``): every per-row
operation on a cache maps over its tensor leaves (:func:`tree_map`),
whose batch axis is 1.

``verify`` (all-position logits of a drafted chunk, the speculative
decode's launch) is the transformer's single pass for the dense, MoE and
``vlm`` families and :func:`replay_verify` elsewhere.  The paged-KV entry
points (``init_block_pool``, ``page_axes``) exist for the transformer
families only, as in the reference: a recurrent state has no sequence
axis to page.  The encoder-decoder bundle's decode step takes
``enc_out`` as a keyword, which the serve engine (LM-only, as the
reference's) never passes: its path is ``encode`` and ``greedy_decode``.
``loss`` is every family's training loss, ``(params, batch) -> scalar``
(each model module's ``loss_fn``), which ``train/step.py``
differentiates.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils import _pytree

from . import rwkv, transformer, whisper, zamba
from .common import ArchConfig

Params = Dict[str, Any]

__all__ = ["Model", "cache_batch_axis", "row_keep_mask", "tree_map",
           "gate_rows", "replay_verify", "replay_prefill", "get_model",
           "MODEL_FAMILIES"]

#: ``tree_map(fn, tree, *rests)``: ``fn`` over the tensor leaves of one or
#: more cache trees of the same structure (nested dicts)
tree_map = _pytree.tree_map


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable          # (generator, device) -> params
    forward: Callable       # (params, batch) -> logits
    loss: Callable          # (params, batch) -> scalar
    init_cache: Callable    # (batch, max_len, device) -> cache
    decode_step: Callable   # (params, cache, tokens, lens) -> (logits, cache)
    prefill: Callable       # (params, cache, tokens, lens, offsets) -> (last_logits, cache)
    verify: Callable        # (params, cache, tokens, lens, offsets) -> (all_logits, cache)
    # paged-KV entry points; None for families whose cache has no
    # sequence axis to page (recurrent state)
    init_block_pool: Optional[Callable] = None  # (n_blocks, block_size, device) -> pool
    page_axes: Optional[Callable] = None        # () -> per-leaf seq-axis tree
    # (params, cache, tokens, lens, *, max_new, eos_id) -> (tokens, n, cache)
    greedy_decode: Optional[Callable] = None
    specs: Optional[Callable] = None        # () -> PartitionSpec tree
    cache_specs: Optional[Callable] = None  # () -> PartitionSpec tree


def cache_batch_axis(shape, batch: int) -> Optional[int]:
    """The batch axis of a cache leaf, or ``None`` if no axis matches.

    Cache leaves are layer-stacked ``(L, B, ...)`` (``init_cache`` stacks
    per-layer trees), so the batch axis is axis 1; a leaf whose axis 1
    doesn't match falls back to a leading batch axis.  The single source
    of this rule for masking (:func:`row_keep_mask`) and the serve
    engine's row gathers.
    """
    nd = len(shape)
    if nd >= 2 and shape[1] == batch:
        return 1
    if nd >= 1 and shape[0] == batch:
        return 0
    return None


def row_keep_mask(keep: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-row mask (B,) against a cache leaf (see
    :func:`cache_batch_axis` for the axis rule).  Used to gate cache
    updates so inactive rows (mid-prefill slots, padded batch rows) are
    never touched by a step they didn't take."""
    b = keep.shape[0]
    nd = leaf.dim()
    ax = cache_batch_axis(tuple(leaf.shape), b)
    if ax == 1:
        return keep.reshape((1, b) + (1,) * (nd - 2))
    if ax == 0:
        return keep.reshape((b,) + (1,) * (nd - 1))
    raise ValueError(
        f"cache leaf of shape {tuple(leaf.shape)} has no axis matching "
        f"batch={b}; cannot gate per-row updates")


def gate_rows(keep: torch.Tensor, new, old):
    """The cache tree whose rows are ``new``'s where ``keep`` (B,) and
    ``old``'s elsewhere, leaf for leaf, in ``old``'s dtypes."""
    return tree_map(lambda n, o: torch.where(row_keep_mask(keep, o),
                                             n.to(o.dtype), o), new, old)


def replay_verify(decode_step: Callable) -> Callable:
    """All-position logits by replaying a chunk through decode steps:
    ``logits[r, j]`` is the model's next-token distribution after
    consuming ``tokens[r, j]``.  Row updates are gated by ``j < lens`` so
    padded chunk positions never touch the cache."""
    def verify(params, cache, tokens, lens, offsets):
        rows = []
        for j in range(tokens.shape[1]):
            logits, new_cache = decode_step(params, cache, tokens[:, j:j + 1],
                                            offsets + j)
            cache = gate_rows(j < lens, new_cache, cache)
            rows.append(logits[:, 0])
        return torch.stack(rows, dim=1), cache

    return verify


def replay_prefill(decode_step: Callable) -> Callable:
    """Batched prefill by replaying the chunk through decode steps — the
    serve engine's O(prompt_len)-launches baseline
    (``ServeConfig(prefill_mode="replay")``).  :func:`replay_verify` does
    the sequential work; this selects each row's last valid position."""
    vf = replay_verify(decode_step)

    def prefill(params, cache, tokens, lens, offsets):
        logits, cache = vf(params, cache, tokens, lens, offsets)
        b = tokens.shape[0]
        last = logits[torch.arange(b, device=logits.device),
                      (lens - 1).clamp(min=0)]
        return last, cache

    return prefill


def _lm_bundle(mod, cfg: ArchConfig) -> Model:
    def fwd(params, batch):
        # llava's image-token prefix; the other families take none
        extra = {} if batch.get("image_embeds") is None else \
            {"extra_embeds": batch["image_embeds"]}
        return mod.forward(cfg, params, batch["tokens"],
                           lens=batch.get("lens"), **extra)

    def decode(params, cache, tokens, lens):
        return mod.decode_step(cfg, params, cache, tokens, lens)

    if hasattr(mod, "prefill"):
        pf = lambda params, cache, tokens, lens, offsets: \
            mod.prefill(cfg, params, cache, tokens, lens, offsets)
    else:
        pf = replay_prefill(decode)
    if hasattr(mod, "verify"):
        vf = lambda params, cache, tokens, lens, offsets: \
            mod.verify(cfg, params, cache, tokens, lens, offsets)
    else:
        vf = replay_verify(decode)
    paged = hasattr(mod, "init_block_pool")

    return Model(
        cfg=cfg,
        init=lambda generator, device: mod.init(cfg, generator, device),
        forward=fwd,
        loss=lambda params, batch: mod.loss_fn(cfg, params, batch),
        init_cache=lambda b, s, device: mod.init_cache(cfg, b, s, device),
        decode_step=decode,
        prefill=pf,
        verify=vf,
        init_block_pool=(lambda n, bs, device:
                         mod.init_block_pool(cfg, n, bs, device))
        if paged else None,
        page_axes=(lambda: mod.page_axes(cfg)) if paged else None,
        greedy_decode=(lambda params, cache, tokens, lens, **kw:
                       mod.greedy_decode(cfg, params, cache, tokens, lens,
                                         **kw))
        if hasattr(mod, "greedy_decode") else None,
        specs=lambda: mod.specs(cfg),
        cache_specs=lambda: mod.cache_specs(cfg),
    )


def _whisper_bundle(cfg: ArchConfig) -> Model:
    def fwd(params, batch):
        return whisper.forward(cfg, params, batch["tokens"],
                               frames=batch["frames"],
                               lens=batch.get("lens"))

    def decode(params, cache, tokens, lens, **kw):
        return whisper.decode_step(cfg, params, cache, tokens, lens, **kw)

    return Model(
        cfg=cfg,
        init=lambda generator, device: whisper.init(cfg, generator, device),
        forward=fwd,
        loss=lambda params, batch: whisper.loss_fn(cfg, params, batch),
        init_cache=lambda b, s, device: whisper.init_cache(cfg, b, s,
                                                           device),
        decode_step=decode,
        # decoder-side replay only; a caller threads enc_out through
        # decode_step's keywords itself (the serve engine is LM-only)
        prefill=replay_prefill(decode),
        verify=replay_verify(decode),
        greedy_decode=lambda params, cache, tokens, lens, **kw:
            whisper.greedy_decode(cfg, params, cache, tokens, lens, **kw),
        specs=lambda: whisper.specs(cfg),
        cache_specs=lambda: whisper.cache_specs(cfg),
    )


MODEL_FAMILIES = {
    "dense": lambda cfg: _lm_bundle(transformer, cfg),
    "moe": lambda cfg: _lm_bundle(transformer, cfg),
    "vlm": lambda cfg: _lm_bundle(transformer, cfg),
    "ssm": lambda cfg: _lm_bundle(rwkv, cfg),
    "hybrid": lambda cfg: _lm_bundle(zamba, cfg),
    "encdec": _whisper_bundle,
}


def get_model(cfg: ArchConfig) -> Model:
    try:
        return MODEL_FAMILIES[cfg.family](cfg)
    except KeyError:
        raise ValueError(f"model family {cfg.family!r} is not ported yet; "
                         f"ported: {sorted(MODEL_FAMILIES)}") from None
