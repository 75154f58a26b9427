"""Decoder-only dense transformer LM (PyTorch).

The counterpart of the JAX package's ``models/transformer.py`` for the
dense family.  The reference stacks its layers and runs them under
``lax.scan``; the port keeps a Python list of per-layer parameter dicts
and unrolls the layers, which is what the DHLO bridge traces (the port's
frontend lowers no control flow yet).

The token embedding is a gather, which the DHLO pipeline does not lower:
:func:`embed_tokens` runs outside ``disc_torch.compile``, and the
compiled function starts from hidden states (:func:`decoder_logits`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from . import layers as L
from .common import ArchConfig, dtype_of, param_init

Params = Dict[str, Any]

__all__ = ["block_init", "block_apply", "init", "embed_tokens",
           "logits_from_hidden", "decoder_logits"]


# ----------------------------------------------------------------- block --
def block_init(generator: torch.Generator, cfg: ArchConfig,
               device) -> Params:
    return {"ln1": L.norm_init(cfg, device), "ln2": L.norm_init(cfg, device),
            "attn": L.attn_init(generator, cfg, device),
            "ffn": L.mlp_init(generator, cfg, device)}


def block_apply(cfg: ArchConfig, p: Params, x: torch.Tensor, *, positions,
                lens: Optional[torch.Tensor] = None):
    h = L.norm_apply(cfg, p["ln1"], x)
    a, new_cache = L.attn_apply(cfg, p["attn"], h, positions=positions,
                                lens=lens)
    x = x + a
    h = L.norm_apply(cfg, p["ln2"], x)
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
