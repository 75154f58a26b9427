"""Model registry: family -> (init / forward / cache / prefill / decode)
bundle, the counterpart of the JAX package's ``models/registry.py`` for
the dense family.

The MoE, recurrent, hybrid and encoder-decoder families arrive with their
slices of the port; ``verify``, the paged-KV entry points and the
training loss wait for the paged/speculative and training slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from . import transformer
from .common import ArchConfig

Params = Dict[str, Any]

__all__ = ["Model", "cache_batch_axis", "row_keep_mask", "replay_verify",
           "replay_prefill", "get_model", "MODEL_FAMILIES"]


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable          # (generator, device) -> params
    forward: Callable       # (params, batch) -> logits
    init_cache: Callable    # (batch, max_len, device) -> cache
    decode_step: Callable   # (params, cache, tokens, lens) -> (logits, cache)
    prefill: Callable       # (params, cache, tokens, lens, offsets) -> (last_logits, cache)


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
            keep = j < lens
            cache = {k: torch.where(row_keep_mask(keep, o),
                                    new_cache[k].to(o.dtype), o)
                     for k, o in cache.items()}
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
        return mod.forward(cfg, params, batch["tokens"],
                           lens=batch.get("lens"))

    def decode(params, cache, tokens, lens):
        return mod.decode_step(cfg, params, cache, tokens, lens)

    if hasattr(mod, "prefill"):
        pf = lambda params, cache, tokens, lens, offsets: \
            mod.prefill(cfg, params, cache, tokens, lens, offsets)
    else:
        pf = replay_prefill(decode)

    return Model(
        cfg=cfg,
        init=lambda generator, device: mod.init(cfg, generator, device),
        forward=fwd,
        init_cache=lambda b, s, device: mod.init_cache(cfg, b, s, device),
        decode_step=decode,
        prefill=pf,
    )


MODEL_FAMILIES = {
    "dense": lambda cfg: _lm_bundle(transformer, cfg),
}


def get_model(cfg: ArchConfig) -> Model:
    try:
        return MODEL_FAMILIES[cfg.family](cfg)
    except KeyError:
        raise ValueError(f"model family {cfg.family!r} is not ported yet; "
                         f"ported: {sorted(MODEL_FAMILIES)}") from None
