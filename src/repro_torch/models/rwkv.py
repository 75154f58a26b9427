"""RWKV-6 (Finch) language model — the attention-free recurrent family
(PyTorch).

The counterpart of the JAX package's ``models/rwkv.py``.  A block is the
time mix (the WKV recurrence with data-dependent decay,
``layers.rwkv6_apply``) and the channel mix, each after a LayerNorm.
The reference stacks its layers under ``lax.scan``; the port keeps one
parameter dict per layer and unrolls them.

The cache keeps the reference's tree: layer-stacked leaves
``{"tmix": {"s": (L, B, H, K, V) f32, "x_prev": (L, B, D)}, "cmix_x":
(L, B, D)}``; the batch axis is 1, as on the dense cache.

The reference has no single-pass prefill: its registry replays the chunk
through decode steps (``replay_prefill``), one compiled ``lax.scan``.
The port runs its serve entries eagerly, where a replay would be S x L
Python steps per prompt, so :func:`prefill` computes the same function
in one pass: per layer one WKV kernel launch over the chunk, from the
cache's state, with per-row ``lens``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from torch.utils import _pytree

from ..dist.profiles import PartitionSpec as P
from . import layers as L
from .common import ArchConfig, cross_entropy_loss, dtype_of, \
    greedy_decode as _greedy_decode, maybe_remat, param_init

Params = Dict[str, Any]

__all__ = ["specs", "cache_specs", "block_init", "init", "forward", "loss_fn", "init_cache",
           "decode_step", "prefill", "greedy_decode"]


def _chanmix_init(generator: torch.Generator, cfg: ArchConfig,
                  device) -> Params:
    dt = dtype_of(cfg)
    return {"w_k": param_init(generator, (cfg.d_model, cfg.d_ff), dt,
                              device),
            "w_v": param_init(generator, (cfg.d_ff, cfg.d_model), dt,
                              device),
            "w_r": param_init(generator, (cfg.d_model, cfg.d_model), dt,
                              device),
            "mix": param_init(generator, (2, cfg.d_model), torch.float32,
                              device, scale=0.1)}


def _chanmix_specs(cfg: ArchConfig) -> Params:
    return {"w_k": P("data", "model"), "w_v": P("model", "data"),
            "w_r": P("data", "model"), "mix": P(None, None)}


def block_specs(cfg: ArchConfig) -> Params:
    return {"ln1": L.norm_specs(cfg), "tmix": L.rwkv6_specs(cfg),
            "ln2": L.norm_specs(cfg), "cmix": _chanmix_specs(cfg)}


def specs(cfg: ArchConfig) -> Params:
    """Logical specs congruent with :func:`init`'s tree."""
    return {"embed": P("model", "data"),
            "blocks": [block_specs(cfg) for _ in range(cfg.n_layers)],
            "ln_f": L.norm_specs(cfg), "head": P("data", "model")}


def cache_specs(cfg: ArchConfig) -> Params:
    one = {"tmix": L.rwkv6_cache_specs(cfg),
           "cmix_x": P(("pod", "data"), None)}
    return _pytree.tree_map(lambda s: P(*((None,) + tuple(s))), one)


def _chanmix_apply(cfg: ArchConfig, p: Params, x: torch.Tensor,
                   x_prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Channel mix of x (B, S, D); ``x_prev`` (B, D) is the token before
    x[:, 0] (None: zeros)."""
    xp = L._shifted(x, x_prev)
    mix = torch.sigmoid(p["mix"]).to(x.dtype)
    xk = x * mix[0] + xp * (1 - mix[0])
    xr = x * mix[1] + xp * (1 - mix[1])
    k = L.maybe_shard(torch.square(torch.relu(xk @ p["w_k"])), L.A_BSF)
    r = torch.sigmoid(xr @ p["w_r"])
    return L.maybe_shard(r * (k @ p["w_v"]), L.A_BSD)


def block_init(generator: torch.Generator, cfg: ArchConfig,
               device) -> Params:
    return {"ln1": L.norm_init(cfg, device),
            "tmix": L.rwkv6_init(generator, cfg, device),
            "ln2": L.norm_init(cfg, device),
            "cmix": _chanmix_init(generator, cfg, device)}


def init(cfg: ArchConfig, generator: torch.Generator, device) -> Params:
    """Random weights for the whole model, drawn from ``generator`` on
    ``device`` (``blocks`` is a list with one dict per layer)."""
    dt = dtype_of(cfg)
    return {"embed": param_init(generator, (cfg.vocab, cfg.d_model), dt,
                                device, scale=0.02),
            "blocks": [block_init(generator, cfg, device)
                       for _ in range(cfg.n_layers)],
            "ln_f": L.norm_init(cfg, device),
            "head": param_init(generator, (cfg.d_model, cfg.vocab), dt,
                               device)}


def forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor, *,
            lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward from a zero state: tokens (B, S) -> logits
    (B, S, V).  ``lens`` is ignored, as in the reference.  Each block
    (time mix and channel mix) is rematerialised per ``cfg.remat``."""
    def body(h, bp):
        a, _ = L.rwkv6_apply(cfg, bp["tmix"],
                             L.norm_apply(cfg, bp["ln1"], h))
        h = h + a
        return h + _chanmix_apply(cfg, bp["cmix"],
                                  L.norm_apply(cfg, bp["ln2"], h))

    body = maybe_remat(cfg, body)
    x = L.embed(params["embed"], tokens)
    for bp in params["blocks"]:
        x = body(x, bp)
    x = L.norm_apply(cfg, params["ln_f"], x)
    return x @ params["head"]


def loss_fn(cfg: ArchConfig, params: Params, batch) -> torch.Tensor:
    """The training loss: :func:`forward` over ``batch["tokens"]``, then
    the token-mean cross entropy under ``batch["mask"]``."""
    logits = forward(cfg, params, batch["tokens"])
    return cross_entropy_loss(logits, batch["labels"], batch.get("mask"))


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device) -> Params:
    """Zeroed recurrent state, layer-stacked; ``max_len`` is unused (the
    state is O(1) in sequence length)."""
    n = cfg.n_layers
    one = L.rwkv6_cache_init(cfg, batch, device)
    return {"tmix": {k: v[None].repeat((n,) + (1,) * v.dim())
                     for k, v in one.items()},
            "cmix_x": torch.zeros((n, batch, cfg.d_model),
                                  dtype=dtype_of(cfg), device=device)}


def _run_blocks(cfg: ArchConfig, params: Params, cache: Params,
                x: torch.Tensor, lens: Optional[torch.Tensor]):
    """Every layer over x (B, S, D) from the cache's state, for the first
    ``lens[b]`` positions of each row (None: all); returns the hidden
    states and the new cache, stacked as the old."""
    new = []
    for i, bp in enumerate(params["blocks"]):
        c = {"tmix": {k: v[i] for k, v in cache["tmix"].items()},
             "cmix_x": cache["cmix_x"][i]}
        a, tmix_c = L.rwkv6_apply(cfg, bp["tmix"],
                                  L.norm_apply(cfg, bp["ln1"], x),
                                  cache=c["tmix"], lens=lens)
        x = x + a
        h2 = L.norm_apply(cfg, bp["ln2"], x)
        x = x + _chanmix_apply(cfg, bp["cmix"], h2, x_prev=c["cmix_x"])
        new.append({"tmix": tmix_c,
                    "cmix_x": L._last_rows(h2, lens, c["cmix_x"])})
    stacked = {"tmix": {k: torch.stack([c["tmix"][k] for c in new])
                        for k in cache["tmix"]},
               "cmix_x": torch.stack([c["cmix_x"] for c in new])}
    return x, stacked


def decode_step(cfg: ArchConfig, params: Params, cache: Params,
                tokens: torch.Tensor, lens: torch.Tensor):
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), new cache).
    ``lens`` (the cache fill) is unused: the state carries the prefix."""
    x = L.embed(params["embed"], tokens)
    x, new_cache = _run_blocks(cfg, params, cache, x, None)
    x = L.norm_apply(cfg, params["ln_f"], x)
    return x @ params["head"], new_cache


def prefill(cfg: ArchConfig, params: Params, cache: Params,
            tokens: torch.Tensor, lens: torch.Tensor, offsets: torch.Tensor):
    """Single-pass batched prefill from the cache's state (the serve
    path): what the reference's ``replay_prefill(decode_step)`` computes.

    ``tokens`` (B, S) right-padded chunks, ``lens`` (B,) true chunk
    lengths; ``offsets`` (the prefix already consumed) is unused, since
    the cache's state carries it.  Per layer the token shift starts from
    the cache's previous token, and one WKV launch runs the chunk from
    the cache's state for the first ``lens[b]`` steps.  Returns
    ``(last_logits (B, V), new_cache)``: the logits at each row's last
    valid position, and the cache after ``lens[b]`` tokens; a row with
    ``lens = 0`` keeps its cache (its logits are unspecified)."""
    x = L.embed(params["embed"], tokens)
    x, new_cache = _run_blocks(cfg, params, cache, x, lens)
    b = x.shape[0]
    last = x[torch.arange(b, device=x.device), (lens - 1).clamp(min=0)]
    last = L.norm_apply(cfg, params["ln_f"], last[:, None])[:, 0]
    return last @ params["head"], new_cache


def greedy_decode(cfg: ArchConfig, params: Params, cache: Params,
                  tokens: torch.Tensor, lens: torch.Tensor, *,
                  max_new: int, eos_id: int = 0):
    """Greedy generation from ``tokens`` (B, 1): ``max_new`` gated steps
    that stop changing anything once every row has emitted ``eos_id``
    (:func:`common.greedy_decode`)."""
    step = lambda c, t, ln: decode_step(cfg, params, c, t, ln)
    return _greedy_decode(step, cache, tokens, lens, max_new=max_new,
                          eos_id=eos_id)
