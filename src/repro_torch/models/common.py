"""Shared model-zoo infrastructure: configs and parameter initialisation.

Parameters are plain nested dicts of tensors.  The port keeps the JAX
package's parameter layout (``x @ w`` with ``w`` of shape ``(in, out)``),
so a tree initialised in JAX converts leaf for leaf
(:mod:`repro_torch.models.convert`).  Sharding specs arrive with the
multi-GPU slice; until then models run on one device.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

__all__ = ["ArchConfig", "param_init", "DTYPES", "dtype_of"]

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


@dataclass(frozen=True)
class ArchConfig:
    """Architecture config covering all assigned families."""

    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_expert: Optional[int] = None  # fine-grained expert width (else d_ff)
    capacity_factor: float = 1.25
    # MLA (deepseek-v2)
    mla_kv_lora: int = 0
    mla_rope_dim: int = 0
    # SSM
    ssm_state: int = 0
    ssm_head_dim: int = 64
    # hybrid (zamba2): one shared attention block every k blocks
    shared_attn_every: int = 0
    # enc-dec (whisper)
    n_encoder_layers: int = 0
    encoder_len: int = 0           # static frame count (conv stub output)
    # vlm (llava)
    max_image_tokens: int = 0
    # sharding profile (§Perf H2): "tp" = 2-D TP x FSDP (default);
    # "fsdp" = pure ZeRO-3 over both mesh axes — small dense models pay TP
    # activation all-reduces without needing TP for memory, so they run
    # data-parallel on all 256 chips with fully-sharded params instead
    sharding_profile: str = "tp"
    # numerics / scale
    dtype: str = "bf16"
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    act: str = "silu"              # silu (swiglu) | gelu
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    remat: str = "full"            # none | full | dots
    max_seq: int = 8192
    # attention flavor for long ctx runs
    attn_kind: str = "full"        # full | none (ssm)

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def expert_width(self) -> int:
        return self.d_expert if self.d_expert else self.d_ff

    def n_params(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline baselines)."""
        d, v, L = self.d_model, self.vocab, self.n_layers
        hd, h, hkv = self.hd, self.n_heads, self.n_kv_heads
        embed = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":  # rwkv6: time-mix ~4 d^2 + channel-mix
            per_layer = 4 * d * d + 2 * d * self.d_ff + d * d
            return embed + L * per_layer
        if self.mla_kv_lora:
            attn = d * (h * hd) + d * self.mla_kv_lora + \
                self.mla_kv_lora * (h * hd * 2) + (h * hd) * d + \
                d * self.mla_rope_dim
        else:
            attn = d * (h * hd) + 2 * d * (hkv * hd) + (h * hd) * d
        if self.is_moe:
            e_w = self.expert_width
            ffn = self.n_experts * 3 * d * e_w + \
                self.n_shared_experts * 3 * d * e_w + d * self.n_experts
        else:
            ffn = 3 * d * self.d_ff if self.act == "silu" else 2 * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        if self.family == "hybrid":
            # mamba2 blocks + one shared attention block
            dm_inner = 2 * d
            mamba = d * dm_inner * 2 + dm_inner * d + \
                dm_inner * (2 * self.ssm_state + 2)
            n_attn = 1
            return embed + L * (mamba + 3 * d * self.d_ff // 2) + \
                n_attn * attn
        total = embed + L * per_layer
        if self.n_encoder_layers:
            total += self.n_encoder_layers * (attn + ffn + 2 * d) + \
                self.n_encoder_layers * attn  # cross-attn in decoder counted approx
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE-aware) for MODEL_FLOPS = 6·N_act·D."""
        if not self.is_moe:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        e_w = self.expert_width
        routed_all = self.n_experts * 3 * d * e_w
        routed_active = self.top_k * 3 * d * e_w
        return self.n_params() - L * routed_all + L * routed_active

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            head_dim=16,
            d_ff=128,
            vocab=256,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            d_expert=32 if self.d_expert else None,
            mla_kv_lora=32 if self.mla_kv_lora else 0,
            mla_rope_dim=8 if self.mla_rope_dim else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16,
            shared_attn_every=2 if self.shared_attn_every else 0,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            encoder_len=32 if self.encoder_len else 0,
            max_image_tokens=16 if self.max_image_tokens else 0,
            dtype="f32",
            remat="none",
            max_seq=128,
        )


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    """The working dtype of a config's weights and activations."""
    return DTYPES[cfg.dtype]


def param_init(generator: torch.Generator, shape: Tuple[int, ...], dtype,
               device, scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, 1/sqrt(fan_in)) weights drawn from ``generator`` on
    ``device`` (the JAX package's ``param_init`` rule)."""
    if scale is None:
        fan_in = shape[0] if len(shape) > 1 else max(shape[0], 1)
        scale = 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)
