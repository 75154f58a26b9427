"""Whisper-style encoder-decoder (PyTorch; the conv frontend is a STUB).

The counterpart of the JAX package's ``models/whisper.py``.  The caller
supplies *precomputed frame embeddings* (B, encoder_len, D): the
mel-spectrogram conv stem is out of scope, as in the reference.  The
encoder runs at its static 1500 frames (non-causal self-attention,
with RoPE, as the reference applies it); the decoder is the dynamic
part: causal self-attention over its KV cache, then cross-attention to
the encoder's output (no RoPE, no mask), then the GELU MLP, each after a
LayerNorm.

The reference stacks each side's layers under ``lax.scan``; the port
keeps a list of per-layer dicts (``"encoder"``, ``"decoder"``), as
``models/transformer.py`` keeps ``blocks``, and unrolls them.  The
decoder's KV cache keeps the reference's layer-stacked ``{"k", "v"}``
leaves (L, B, Hkv, S, hd).  Each decode step projects the
cross-attention K and V from ``enc_out`` again, as the reference does.

Sharding (``specs``) arrives with the port's multi-GPU slice.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from torch.utils import _pytree

from ..dist.profiles import PartitionSpec as P
from . import layers as L
from .common import ArchConfig, cross_entropy_loss, dtype_of, \
    greedy_decode as _greedy_decode, param_init

Params = Dict[str, Any]

__all__ = ["specs", "cache_specs", "init", "encode", "forward", "init_cache", "decode_step",
           "greedy_decode", "specs", "loss_fn"]


def _enc_block_init(generator: torch.Generator, cfg: ArchConfig,
                    device) -> Params:
    return {"ln1": L.norm_init(cfg, device),
            "attn": L.attn_init(generator, cfg, device),
            "ln2": L.norm_init(cfg, device),
            "mlp": L.mlp_init(generator, cfg, device)}


def _dec_block_init(generator: torch.Generator, cfg: ArchConfig,
                    device) -> Params:
    return {"ln1": L.norm_init(cfg, device),
            "self": L.attn_init(generator, cfg, device),
            "ln2": L.norm_init(cfg, device),
            "cross": L.attn_init(generator, cfg, device),
            "ln3": L.norm_init(cfg, device),
            "mlp": L.mlp_init(generator, cfg, device)}


def init(cfg: ArchConfig, generator: torch.Generator, device) -> Params:
    """Random weights drawn from ``generator`` on ``device``
    (``encoder`` and ``decoder`` are lists of per-layer dicts)."""
    dt = dtype_of(cfg)
    return {
        "embed": param_init(generator, (cfg.vocab, cfg.d_model), dt, device,
                            scale=0.02),
        "enc_pos": param_init(generator, (cfg.encoder_len, cfg.d_model), dt,
                              device, scale=0.02),
        "encoder": [_enc_block_init(generator, cfg, device)
                    for _ in range(cfg.n_encoder_layers)],
        "decoder": [_dec_block_init(generator, cfg, device)
                    for _ in range(cfg.n_layers)],
        "ln_enc": L.norm_init(cfg, device),
        "ln_f": L.norm_init(cfg, device),
        "head": param_init(generator, (cfg.d_model, cfg.vocab), dt, device),
    }


def _enc_block_specs(cfg: ArchConfig) -> Params:
    return {"ln1": L.norm_specs(cfg), "attn": L.attn_specs(cfg),
            "ln2": L.norm_specs(cfg), "mlp": L.mlp_specs(cfg)}


def _dec_block_specs(cfg: ArchConfig) -> Params:
    return {"ln1": L.norm_specs(cfg), "self": L.attn_specs(cfg),
            "ln2": L.norm_specs(cfg), "cross": L.attn_specs(cfg),
            "ln3": L.norm_specs(cfg), "mlp": L.mlp_specs(cfg)}


def specs(cfg: ArchConfig) -> Params:
    """Logical specs congruent with :func:`init`'s tree."""
    return {
        "embed": P("model", "data"),
        "enc_pos": P(None, "data"),
        "encoder": [_enc_block_specs(cfg)
                    for _ in range(cfg.n_encoder_layers)],
        "decoder": [_dec_block_specs(cfg) for _ in range(cfg.n_layers)],
        "ln_enc": L.norm_specs(cfg),
        "ln_f": L.norm_specs(cfg),
        "head": P("data", "model"),
    }


def cache_specs(cfg: ArchConfig) -> Params:
    return _pytree.tree_map(lambda s: P(*((None,) + tuple(s))),
                            L.attn_cache_specs(cfg))


def encode(cfg: ArchConfig, params: Params,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: precomputed conv-stub embeddings (B, encoder_len, D)."""
    x = frames + params["enc_pos"][None]
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    for bp in params["encoder"]:
        a, _ = L.attn_apply(cfg, bp["attn"], L.norm_apply(cfg, bp["ln1"], x),
                            positions=positions, causal=False)
        x = x + a
        x = x + L.mlp_apply(cfg, bp["mlp"], L.norm_apply(cfg, bp["ln2"], x))
    return L.norm_apply(cfg, params["ln_enc"], x)


def _decoder_blocks(cfg: ArchConfig, params: Params, x: torch.Tensor,
                    enc_out: torch.Tensor, *, positions,
                    lens: Optional[torch.Tensor],
                    caches: Optional[Params] = None):
    """Every decoder layer in order; with ``caches`` (layer-stacked
    leaves) each reads and writes its slice, and the new caches come
    back stacked."""
    new = []
    for i, bp in enumerate(params["decoder"]):
        c = None if caches is None else {k: v[i] for k, v in caches.items()}
        a, c2 = L.attn_apply(cfg, bp["self"], L.norm_apply(cfg, bp["ln1"], x),
                             positions=positions, lens=lens, cache=c)
        x = x + a
        ca, _ = L.attn_apply(cfg, bp["cross"],
                             L.norm_apply(cfg, bp["ln2"], x),
                             positions=positions, kv_source=enc_out,
                             causal=False)
        x = x + ca
        x = x + L.mlp_apply(cfg, bp["mlp"], L.norm_apply(cfg, bp["ln3"], x))
        new.append(c2)
    if caches is None:
        return x, None
    return x, {k: torch.stack([c[k] for c in new]) for k in caches}


def forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor, *,
            frames: torch.Tensor,
            lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Encoder over ``frames``, then the decoder over ``tokens`` (B, S)
    -> logits (B, S, V)."""
    enc_out = encode(cfg, params, frames)
    x = params["embed"][tokens]
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, _ = _decoder_blocks(cfg, params, x, enc_out, positions=positions,
                           lens=lens)
    x = L.norm_apply(cfg, params["ln_f"], x)
    return x @ params["head"]


def loss_fn(cfg: ArchConfig, params: Params, batch) -> torch.Tensor:
    """The training loss: :func:`forward` over ``batch["tokens"]`` and
    ``batch["frames"]``, then the token-mean cross entropy under
    ``batch["mask"]``."""
    logits = forward(cfg, params, batch["tokens"], frames=batch["frames"])
    return cross_entropy_loss(logits, batch["labels"], batch.get("mask"))


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device) -> Params:
    """Zeroed decoder KV cache: layer-stacked leaves (L, B, Hkv, max_len,
    hd)."""
    one = L.attn_cache_init(cfg, batch, max_len, device)
    return {k: v[None].repeat((cfg.n_layers,) + (1,) * v.dim())
            for k, v in one.items()}


def decode_step(cfg: ArchConfig, params: Params, cache: Params,
                tokens: torch.Tensor, lens: torch.Tensor, *,
                enc_out: torch.Tensor):
    """One decoder step: tokens (B, 1), lens (B,) the cache fill, enc_out
    (B, encoder_len, D) -> (logits (B, 1, V), new cache)."""
    x = params["embed"][tokens]
    x, new_cache = _decoder_blocks(cfg, params, x, enc_out,
                                   positions=lens[:, None], lens=lens,
                                   caches=cache)
    x = L.norm_apply(cfg, params["ln_f"], x)
    return x @ params["head"], new_cache


def greedy_decode(cfg: ArchConfig, params: Params, cache: Params,
                  tokens: torch.Tensor, lens: torch.Tensor, *,
                  enc_out: torch.Tensor, max_new: int, eos_id: int = 0):
    """The whole greedy transcription loop, ``max_new`` gated steps that
    read nothing on the host (:func:`common.greedy_decode`): one CUDA
    graph a batch bucket on the jit pipeline, as the reference's is one
    ``lax.while_loop`` in one executable."""
    step = lambda c, t, ln: decode_step(cfg, params, c, t, ln,
                                        enc_out=enc_out)
    return _greedy_decode(step, cache, tokens, lens, max_new=max_new,
                          eos_id=eos_id)
