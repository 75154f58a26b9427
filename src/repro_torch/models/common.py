"""Shared model-zoo infrastructure: configs and parameter initialisation.

Parameters are plain nested dicts of tensors.  The port keeps the JAX
package's parameter layout (``x @ w`` with ``w`` of shape ``(in, out)``),
so a tree initialised in JAX converts leaf for leaf
(:mod:`repro_torch.models.convert`).

Rematerialisation (:func:`maybe_remat`, the reference's ``jax.checkpoint``
around each block of a forward without caches) follows ``cfg.remat``:

* ``"none"``: every op's saved tensors stay alive until the backward;
* ``"full"``: a block keeps only its inputs (non-reentrant
  ``torch.utils.checkpoint``); the backward runs the block's forward
  again, kernels included, to get the rest;
* ``"dots"``: as ``"full"``, but the outputs of ``aten.mm`` (the
  projections ``x @ w``, a dot with no batch dims) are saved from the
  forward and every other op is recomputed, ``bmm`` and the kernels'
  outputs included: the port's form of the reference's
  ``dots_with_no_batch_dims_saveable``.

A block's recompute runs as its forward ran: with the kernels, or inside
``plain_versions()`` where the forward was, and under the forward's mesh
(the backward of CUDA tensors runs on autograd's device thread, which
sees neither context).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
from torch.utils import _pytree

__all__ = ["ArchConfig", "param_init", "DTYPES", "dtype_of",
           "cross_entropy_loss", "greedy_decode", "maybe_remat"]

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


def _dots_policy(ctx, op, *args, **kwargs):
    """``"dots"``: save a 2-D dot's output, recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def maybe_remat(cfg: ArchConfig, fn: Callable) -> Callable:
    """``fn`` rematerialised per ``cfg.remat`` (see the module docstring),
    the counterpart of the reference's ``_maybe_remat``.  Without grad
    (serving, a decode step, a trace for the DHLO bridge) nothing is
    saved, so ``fn`` runs as it is.  The models draw no random numbers,
    so no RNG state is stashed for the recompute."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"remat must be 'none', 'full' or 'dots', got "
                         f"{cfg.remat!r}")
    from torch.utils import checkpoint as ckpt

    from ..dist.context import scope_here
    from ..kernels.select import in_plain_versions, plain_versions

    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = lambda: ckpt.create_selective_checkpoint_contexts(
            _dots_policy)

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        # the forward's contexts, entered again by the recompute
        scope = scope_here()
        plain = plain_versions if in_plain_versions() else \
            contextlib.nullcontext

        def block(*args):
            with scope(), plain():
                return fn(*args)

        return ckpt.checkpoint(block, *args, use_reentrant=False,
                               preserve_rng_state=False, **kw)

    return run


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


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross entropy in f32 with an optional validity mask
    (the denominator ``max(mask.sum(), 1)``), as the reference computes
    it, outside any kernel."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    if _is_dtensor(logits):
        gold = _selected_gold(logits, labels)
    else:
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()


def _is_dtensor(x: torch.Tensor) -> bool:
    if type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _selected_gold(logits: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., labels]`` of a DTensor: each rank selects its own
    slice's hit against the vocabulary's indices, and the sum over the
    axis combines the ranks where the vocabulary is split (one all-reduce
    of the (B, S) result).  ``torch.gather`` is not used on a DTensor:
    over a split vocabulary DTensor masks its partial result with one
    axis too many (the trace or the run raises), and its gradient starts
    from ``new_zeros``, which DTensor makes at the logits' global shape
    on every rank (TinyLlama's ``train_4k``: 134 GB a rank)."""
    from torch.distributed.tensor import Replicate, Shard

    if _is_dtensor(labels):
        # the labels laid out as the logits' leading axes (a local slice:
        # the batch may be split over more mesh axes in the logits)
        place = tuple(p if isinstance(p, Shard) and p.dim < labels.dim()
                      else Replicate() for p in logits.placements)
        labels = labels.redistribute(logits.device_mesh, place)
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    hit = vocab == labels[..., None].long()
    return torch.where(hit, logits, 0.0).sum(-1)


def greedy_decode(step_fn: Callable, cache, first_tokens: torch.Tensor,
                  lens: torch.Tensor, *, max_new: int, eos_id: int):
    """Greedy autoregressive decode: the reference's ``lax.while_loop``
    (``models/common.py`` ``greedy_decode``) as a bounded loop of
    ``max_new`` steps that reads nothing on the host, so that one CUDA
    graph can hold it whole.

    ``step_fn(cache, tokens, lens) -> (logits, cache)`` is a decode step
    already closed over params.  The loop state stays on the device:
    ``active`` (0-d bool, not every row done yet), ``n`` (0-d int32),
    ``lens``, the token buffer, the current tokens and the done mask.
    Every step runs the decode step and gates the cache, ``lens`` and
    ``n`` by ``active`` (a row that is done writes ``eos_id``, which its
    buffer already holds), so once every row has emitted ``eos_id`` the
    remaining steps change nothing: the result is the reference's early
    exit's, the same tokens, the same ``n`` and the same cache.  Rows
    that finish keep emitting ``eos_id``; the cache still advances for
    every row while any is active, as in the reference.

    Returns ``(tokens (B, max_new) int32, n_steps 0-d int32, cache)``.
    """
    b = first_tokens.shape[0]
    dev = first_tokens.device
    buf = torch.full((b, max_new), eos_id, dtype=torch.int32, device=dev)
    cur = first_tokens.to(torch.int32).reshape(b, 1)
    lens = lens.to(torch.int32)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    n = torch.zeros((), dtype=torch.int32, device=dev)
    eos = torch.full((b,), eos_id, dtype=torch.int32, device=dev)
    for i in range(max_new):
        active = ~done.all()
        logits, new_cache = step_fn(cache, cur, lens)
        cache = _pytree.tree_map(
            lambda new, old: torch.where(active, new.to(old.dtype), old),
            new_cache, cache)
        nxt = logits[:, -1, :].argmax(-1).to(torch.int32)
        nxt = torch.where(done, eos, nxt)
        buf[:, i] = nxt
        done = done | (nxt == eos_id)
        cur = nxt[:, None]
        step = active.to(torch.int32)
        lens = lens + step
        n = n + step
    return buf, n, cache
