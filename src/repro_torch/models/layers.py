"""Model-zoo layers on the compiled path (PyTorch, single device).

The counterparts of the JAX package's ``models/layers.py`` functions that
a dense transformer, DBRX's and DeepSeek-V2's MoE, RWKV-6, Zamba2 and
whisper run: RMS/LayerNorm, RoPE, grouped-query attention (full, batched
prefill against a KV cache, decode, and whisper's cross-attention),
DeepSeek-V2's multi-head latent attention (MLA; the same modes, its
decode absorbed into the latent cache), the (Swi)GLU or GELU MLP, the
routed MoE, the RWKV-6 time mix and the Mamba-2 block, and the paged
KV cache's block gather and scatter.  Each is a plain function of
tensors with the reference's name and argument order.

Attention, both norms, the MoE router's softmax, the WKV recurrence and
the SSD scan go through their kernels' wrappers
(``kernels/flash_attention/ops.py``, ``kernels/rmsnorm/ops.py``,
``kernels/layernorm/ops.py``, ``kernels/softmax/ops.py``,
``kernels/rwkv6/ops.py``, ``kernels/mamba2/ops.py``): the CUDA C++
flash-attention, RMSNorm, LayerNorm, masked softmax, WKV and SSD kernels
on the card, their plain versions on the CPU.  The DHLO bridge traces these functions inside
``plain_versions()``, so they trace into the same op structure the
reference traces into (``dot_general`` for the grouped attention
contractions, ``mean`` + ``rsqrt`` norms, explicit softmax).

Every layer family has a mirrored ``<name>_specs(cfg)`` giving an
identically-structured tree of logical
:class:`~repro_torch.dist.profiles.PartitionSpec` for the production
mesh axes ``("pod", "data", "model")``, the reference's own rules, and
``maybe_shard`` (``repro_torch.dist.context``) marks the activation
boundaries the reference marks: under a mesh it redistributes a DTensor,
elsewhere it is the identity.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..kernels.flash_attention import ops as fa_ops
from ..kernels.flash_attention.ref import (  # noqa: F401 (reference names)
    CHUNK_THRESHOLD as _CHUNK_THRESHOLD, pick_chunk as _pick_chunk,
    q_positions as _q_positions, sdpa_chunked_ref as _sdpa_chunked)
from ..kernels.layernorm import ops as ln_ops
from ..kernels.mamba2 import ops as ssd_ops
from ..kernels.rmsnorm import ops as rms_ops
from ..kernels.rwkv6 import ops as wkv_ops
from ..kernels.softmax import ops as sm_ops
from ..dist.context import get_mesh, maybe_shard
from ..dist.profiles import PartitionSpec as P
from .common import ArchConfig, dtype_of, param_init

Params = Dict[str, Any]

# activation sharding specs (logical) — "tp" profile
A_BSD = P(("pod", "data"), None, None)      # (B, S, D)
A_BSH = P(("pod", "data"), None, "model", None)  # (B, S, H, hd)
A_BSF = P(("pod", "data"), None, "model")   # (B, S, F)

# "fsdp" profile: both mesh axes are data-parallel; params are fully
# sharded and gathered per layer; no TP activation collectives
_DP_ALL = ("pod", "data", "model")


def act_bsd(cfg: ArchConfig) -> P:
    return P(_DP_ALL, None, None) if cfg.sharding_profile == "fsdp" else A_BSD


def act_bsh(cfg: ArchConfig) -> P:
    return (P(_DP_ALL, None, None, None)
            if cfg.sharding_profile == "fsdp" else A_BSH)


def act_bsf(cfg: ArchConfig) -> P:
    return P(_DP_ALL, None, None) if cfg.sharding_profile == "fsdp" else A_BSF


def wspec(cfg: ArchConfig, *entries) -> P:
    """Weight spec under the arch's profile: in "fsdp", every sharded dim
    folds onto the joint DP axis group, one dim only (ZeRO-3 layout)."""
    if cfg.sharding_profile != "fsdp":
        return P(*entries)
    out, used = [], False
    for e in entries:
        if e is None or used:
            out.append(None)
        else:
            out.append(_DP_ALL)
            used = True
    return P(*out)

__all__ = ["norm_init", "norm_apply", "rope_tables", "apply_rope",
           "attn_init", "attn_apply", "attn_cache_init", "MLA_ABSORBED_DECODE",
           "mla_init", "mla_apply", "mla_cache_init", "mlp_init",
           "mlp_apply", "moe_init", "moe_apply", "rwkv6_init",
           "rwkv6_apply", "rwkv6_cache_init",
           "mamba2_init", "mamba2_apply", "mamba2_cache_init",
           "paged_gather", "paged_scatter", "maybe_shard", "A_BSD",
           "A_BSH", "A_BSF", "act_bsd", "act_bsh", "act_bsf", "wspec",
           "norm_specs", "attn_specs", "attn_cache_specs", "mla_specs",
           "mla_cache_specs", "mlp_specs", "moe_specs", "rwkv6_specs",
           "rwkv6_cache_specs", "mamba2_specs", "mamba2_cache_specs"]


# ---------------------------------------------------------------- norms --
def norm_init(cfg: ArchConfig, device, d: Optional[int] = None) -> Params:
    d = d or cfg.d_model
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def norm_specs(cfg: ArchConfig) -> Params:
    p = {"scale": P(None)}
    if cfg.norm == "layernorm":
        p["bias"] = P(None)
    return p


def norm_apply(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm (eps 1e-5) or RMSNorm (eps 1e-6), f32 accumulation, cast
    back to x's dtype.  Each is its CUDA C++ kernel on the card and its
    plain version (the reference's ops) on the CPU."""
    if cfg.norm == "layernorm":
        return ln_ops.layernorm(x, p["scale"], p["bias"], eps=1e-5)
    return rms_ops.rmsnorm(x, p["scale"], eps=1e-6)


# ----------------------------------------------------------------- rope --
def rope_tables(positions: torch.Tensor, dim: int, theta: float) -> Tuple:
    """positions (...,) -> cos/sin tables (..., dim/2)."""
    freqs = torch.arange(0, dim, 2, dtype=torch.float32,
                         device=positions.device)
    inv = 1.0 / (theta ** (freqs / dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, hd); cos/sin (..., S, hd/2) broadcast over heads."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c],
                     dim=-1).to(x.dtype)


# ------------------------------------------------------------ attention --
def attn_init(generator: torch.Generator, cfg: ArchConfig, device) -> Params:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = dtype_of(cfg)
    return {
        "wq": param_init(generator, (d, h * hd), dt, device),
        "wk": param_init(generator, (d, hkv * hd), dt, device),
        "wv": param_init(generator, (d, hkv * hd), dt, device),
        "wo": param_init(generator, (h * hd, d), dt, device),
    }


def attn_specs(cfg: ArchConfig) -> Params:
    return {"wq": wspec(cfg, "data", "model"),
            "wk": wspec(cfg, "data", "model"),
            "wv": wspec(cfg, "data", "model"),
            "wo": wspec(cfg, "model", "data")}


def attn_cache_specs(cfg: ArchConfig) -> Params:
    # few KV heads (< model-axis size 16, e.g. MQA/GQA): shard the sequence
    # axis of the cache instead of heads so the 16-way split divides evenly
    kv_spec = (P(("pod", "data"), "model", None, None)
               if cfg.n_kv_heads >= 16 else
               P(("pod", "data"), None, "model", None))
    return {"k": kv_spec, "v": kv_spec}


def _sdpa(q, k, v, *, causal: bool, lens: Optional[torch.Tensor],
          q_offset=0) -> torch.Tensor:
    """q (B,H,Sq,hd) x k,v (B,Hkv,Sk,hd) -> (B,H,Sq,hd); f32 softmax.

    ``q_offset`` is a scalar or a per-row (B,) vector (batched prefill).
    On the card this is the flash-attention kernel (its decode form for
    one query row); on the CPU, and inside ``plain_versions()``, the
    reference's dense form, or ``_sdpa_chunked`` for long queries."""
    return fa_ops.flash_attention(q, k, v, lens, causal=causal,
                                  q_offset=q_offset)


def attn_apply(cfg: ArchConfig, p: Params, x: torch.Tensor, *,
               positions: torch.Tensor, lens: Optional[torch.Tensor] = None,
               cache: Optional[Params] = None, causal: bool = True,
               kv_source: Optional[torch.Tensor] = None,
               offsets: Optional[torch.Tensor] = None):
    """Full attention; ``cache`` switches to decode mode (x is (B,1,D)).

    ``cache`` + ``offsets`` switches to *batched prefill* mode instead
    (serve path): x is a (B, S, D) chunk whose row r holds ``lens[r]``
    true tokens destined for absolute cache positions
    ``[offsets[r], offsets[r] + lens[r])``; the chunk's K/V are scattered
    into the cache in one pass and queries attend causally against the
    whole cache at absolute positions.

    ``kv_source`` (B, Sk, D) makes it cross-attention (whisper's
    decoder): K and V are projected from it, with no RoPE and no causal
    mask; every key is valid."""
    b, s, d = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    src = x if kv_source is None else kv_source
    q = maybe_shard((x @ p["wq"]).reshape(b, s, h, hd), act_bsh(cfg))
    k = (src @ p["wk"]).reshape(b, src.shape[1], hkv, hd)
    v = (src @ p["wv"]).reshape(b, src.shape[1], hkv, hd)
    if kv_source is None:   # self-attention: RoPE
        cos, sin = rope_tables(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    q = q.transpose(1, 2)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    new_cache = None
    if cache is not None and offsets is not None:
        # batched prefill: scatter the chunk's K/V to absolute positions
        # [offset, offset+len) per row — padded chunk positions are never
        # written — then attend causally against the whole cache
        kc, vc = cache["k"], cache["v"]
        lc = kc.shape[2]
        j = torch.arange(lc, device=x.device)[None, :] - offsets[:, None]
        written = (j >= 0) & (j < lens[:, None])
        idx = j.clamp(0, s - 1)[:, None, :, None].expand(b, hkv, lc, hd)
        wmask = written[:, None, :, None]
        kc = torch.where(wmask, torch.gather(k, 2, idx).to(kc.dtype), kc)
        vc = torch.where(wmask, torch.gather(v, 2, idx).to(vc.dtype), vc)
        new_cache = {"k": kc, "v": vc}
        o = _sdpa(q, kc.to(q.dtype), vc.to(q.dtype), causal=True,
                  lens=None, q_offset=offsets)
    elif cache is not None:
        # decode: append to the cache at position lens (per batch row)
        kc, vc = cache["k"], cache["v"]
        pos = torch.arange(kc.shape[2], device=x.device)[None, None, :, None]
        write = pos == lens[:, None, None, None]
        kc = torch.where(write, k.to(kc.dtype), kc)
        vc = torch.where(write, v.to(vc.dtype), vc)
        new_cache = {"k": kc, "v": vc}
        o = _sdpa(q, kc.to(q.dtype), vc.to(q.dtype), causal=False,
                  lens=lens + 1)
    else:
        o = _sdpa(q, k, v, causal=causal and kv_source is None, lens=lens,
                  q_offset=0)
    o = o.transpose(1, 2).reshape(b, s, h * hd)
    return maybe_shard(o @ p["wo"], act_bsd(cfg)), new_cache


def attn_cache_init(cfg: ArchConfig, batch: int, max_len: int,
                    device) -> Params:
    hkv, hd = cfg.n_kv_heads, cfg.hd
    dt = dtype_of(cfg)
    return {"k": torch.zeros((batch, hkv, max_len, hd), dtype=dt,
                             device=device),
            "v": torch.zeros((batch, hkv, max_len, hd), dtype=dt,
                             device=device)}


# ------------------------------------------------------ MLA (deepseek) --
#: the decode step's attention against the latent cache (``True``), or the
#: expansion path's, as a prefill takes (the reference's switch)
MLA_ABSORBED_DECODE = True


def mla_init(generator: torch.Generator, cfg: ArchConfig, device) -> Params:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
    lora, rdim = cfg.mla_kv_lora, cfg.mla_rope_dim
    dt = dtype_of(cfg)
    return {
        "wq": param_init(generator, (d, h * (hd + rdim)), dt, device),
        "w_dkv": param_init(generator, (d, lora), dt, device),
        "w_kpe": param_init(generator, (d, rdim), dt, device),
        "w_uk": param_init(generator, (lora, h * hd), dt, device),
        "w_uv": param_init(generator, (lora, h * hd), dt, device),
        "wo": param_init(generator, (h * hd, d), dt, device),
    }


def mla_specs(cfg: ArchConfig) -> Params:
    return {"wq": P("data", "model"), "w_dkv": P("data", None),
            "w_kpe": P("data", None), "w_uk": P(None, "model"),
            "w_uv": P(None, "model"), "wo": P("model", "data")}


def mla_apply(cfg: ArchConfig, p: Params, x: torch.Tensor, *,
              positions: torch.Tensor, lens=None, cache=None,
              offsets: Optional[torch.Tensor] = None):
    """Multi-head latent attention: the cache holds the compressed kv
    ``{"kv_c": (B, S, lora), "k_pe": (B, S, rope)}``.

    The modes of :func:`attn_apply`: no cache (causal, keys ``< lens``);
    ``cache`` + ``offsets``, batched prefill (the chunk's compressed K/V
    scattered to absolute positions, then causal attention against the
    whole cache at absolute positions through the expansion path); and
    ``cache`` alone, a decode step (x (B, 1, D), written at ``lens``).
    The expansion path builds per-head keys ``[k_nope | k_pe]`` (192
    wide) and values (128) from the latent and runs the flash-attention
    kernel at scale ``1 / sqrt(hd + rope)``.  A decode step with
    :data:`MLA_ABSORBED_DECODE` folds ``W_uk`` into the query and ``W_uv``
    into the output, so its attention (``ops.mla_decode``: one kernel
    launch) reads the latent cache in place, in f32 in an f32 model (the
    reference rounds ``q_abs`` and the latent to bf16 there; ROADMAP Queue
    3); without the flag it takes the expansion path."""
    b, s, d = x.shape
    h, hd, rdim = cfg.n_heads, cfg.hd, cfg.mla_rope_dim
    q = (x @ p["wq"]).reshape(b, s, h, hd + rdim)
    q_nope, q_pe = q[..., :hd], q[..., hd:]
    kv_c = x @ p["w_dkv"]                         # (B, S, lora)
    k_pe = (x @ p["w_kpe"]).reshape(b, s, 1, rdim)
    cos, sin = rope_tables(positions, rdim, cfg.rope_theta)
    q_pe = apply_rope(q_pe, cos, sin)
    k_pe = apply_rope(k_pe, cos, sin)[..., 0, :]  # (B, S, rope)
    new_cache = None
    if cache is not None and offsets is not None:
        # batched prefill: scatter the chunk's compressed K/V to absolute
        # positions [offset, offset+len) per row (padded positions are
        # never written), then attend causally at absolute positions
        lc = cache["kv_c"].shape[1]
        j = torch.arange(lc, device=x.device)[None, :] - offsets[:, None]
        written = ((j >= 0) & (j < lens[:, None]))[:, :, None]
        jc = j.clamp(0, s - 1)[:, :, None]
        kv_al = torch.gather(kv_c, 1, jc.expand(b, lc, kv_c.shape[-1]))
        kpe_al = torch.gather(k_pe, 1, jc.expand(b, lc, rdim))
        kv_all = torch.where(written, kv_al.to(cache["kv_c"].dtype),
                             cache["kv_c"])
        kpe_all = torch.where(written, kpe_al.to(cache["k_pe"].dtype),
                              cache["k_pe"])
        new_cache = {"kv_c": kv_all, "k_pe": kpe_all}
        eff_lens, causal = None, True
    elif cache is not None:
        pos = torch.arange(cache["kv_c"].shape[1], device=x.device)
        write = (pos[None, :] == lens[:, None])[:, :, None]
        kv_all = torch.where(write, kv_c.to(cache["kv_c"].dtype),
                             cache["kv_c"])
        kpe_all = torch.where(write, k_pe.to(cache["k_pe"].dtype),
                              cache["k_pe"])
        new_cache = {"kv_c": kv_all, "k_pe": kpe_all}
        eff_lens, causal = lens + 1, False
    else:
        kv_all, kpe_all = kv_c, k_pe
        eff_lens, causal = lens, True
    scale = 1.0 / math.sqrt(hd + rdim)
    if cache is not None and offsets is None and s == 1 \
            and MLA_ABSORBED_DECODE:
        lora = cfg.mla_kv_lora
        w_uk = p["w_uk"].reshape(lora, h, hd)
        w_uv = p["w_uv"].reshape(lora, h, hd)
        q_abs = torch.einsum("bqhd,lhd->bqhl", q_nope.float(),
                             w_uk.float())           # (B, 1, H, lora)
        dt = kv_all.dtype
        o_lat = fa_ops.mla_decode(q_abs.to(dt), q_pe.to(dt), kv_all,
                                  kpe_all, eff_lens, scale)
        o = torch.einsum("bqhl,lhd->bqhd", o_lat.float(), w_uv.float())
        return o.reshape(b, s, h * hd).to(x.dtype) @ p["wo"], new_cache

    # prefill / train / expanded decode: per-head keys and values from the
    # latent, the rope part folded into the head dim: scores =
    # [q_nope | q_pe] . [k_nope | k_pe]
    sk = kv_all.shape[1]
    k_nope = (kv_all @ p["w_uk"]).reshape(b, sk, h, hd)
    v = (kv_all @ p["w_uv"]).reshape(b, sk, h, hd)
    q_eff = torch.cat([q_nope, q_pe], dim=-1)      # (B, S, H, hd + rope)
    k_eff = torch.cat([k_nope, kpe_all[:, :, None, :].expand(
        b, sk, h, rdim).to(k_nope.dtype)], dim=-1)
    o = fa_ops.flash_attention(
        q_eff.transpose(1, 2), k_eff.transpose(1, 2), v.transpose(1, 2),
        eff_lens, causal=causal, q_offset=0 if offsets is None else offsets,
        scale=scale)
    o = o.transpose(1, 2).reshape(b, s, h * hd).to(x.dtype)
    return o @ p["wo"], new_cache


def mla_cache_init(cfg: ArchConfig, batch: int, max_len: int,
                   device) -> Params:
    dt = dtype_of(cfg)
    return {"kv_c": torch.zeros((batch, max_len, cfg.mla_kv_lora), dtype=dt,
                                device=device),
            "k_pe": torch.zeros((batch, max_len, cfg.mla_rope_dim),
                                dtype=dt, device=device)}


# ----------------------------------------------------- paged KV blocks --
def mla_cache_specs(cfg: ArchConfig) -> Params:
    return {"kv_c": P(("pod", "data"), "model", None),
            "k_pe": P(("pod", "data"), "model", None)}


def paged_gather(pool: torch.Tensor, tables: torch.Tensor, *,
                 block_axis: int, seq_axis: int) -> torch.Tensor:
    """Gather per-row cache rows out of a physical block pool.

    ``pool`` holds the blocks: ``block_axis`` is the block-id axis (size
    ``n_blocks + 1``, id 0 = the null block), ``seq_axis`` the
    within-block token axis (size ``block_size``).  ``tables`` (B, M)
    maps each row's logical block ``j`` to a physical id (null-padded
    with 0).  The result is a dense, contiguous per-row leaf — block axis
    replaced by the row axis B, seq axis widened to ``M * block_size`` —
    the fixed-row layout :func:`attn_apply` / :func:`mla_apply` consume.
    One indexing pass over the (block, token) grid of the pool, read in
    place, with static shapes and no host read (a CUDA graph captures
    it)."""
    bs = pool.shape[seq_axis]
    m = tables.shape[1]
    pos = torch.arange(m * bs, device=pool.device)
    x = pool.movedim((block_axis, seq_axis), (0, 1))
    rows = x[tables[:, pos // bs].long(), pos % bs]       # (B, M*bs, ...)
    return rows.movedim((0, 1), (block_axis, seq_axis)).contiguous()


def paged_scatter(pool: torch.Tensor, dense: torch.Tensor,
                  tables: torch.Tensor, keep: torch.Tensor, *,
                  block_axis: int, seq_axis: int,
                  positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write dense per-row cache leaves back into the block pool, in
    place, and return ``pool``.

    The inverse of :func:`paged_gather` restricted to the token positions
    selected by ``keep``: only freshly written positions persist.
    ``keep`` (B, W) marks the positions ``positions`` (B, W) of each row
    (``None``: every position ``0 .. M*block_size - 1``, ``W = M *
    block_size``, the reference's form).  A caller that knows which few
    positions a launch wrote passes just those (a decode step its
    ``lens``, a verify its drafted chunk), so the scatter moves W rows a
    row instead of ``max_seq``.  Positions with ``keep`` False, and any
    position whose table entry is null, are routed into the null block,
    which absorbs them the way masked writes do on the fixed path."""
    bs = pool.shape[seq_axis]
    b, m = tables.shape
    s = m * bs
    if positions is None:
        positions = torch.arange(s, device=pool.device).expand(b, s)
    pos = positions.long().clamp(0, s - 1)
    blk = torch.where(keep, torch.gather(tables.long(), 1, pos // bs), 0)
    d = dense.movedim((block_axis, seq_axis), (0, 1))     # (B, S, ...)
    rows = torch.arange(b, device=pool.device)[:, None]
    x = pool.movedim((block_axis, seq_axis), (0, 1))
    x[blk, pos % bs] = d[rows, pos].to(pool.dtype)
    return pool


# ------------------------------------------------------------------ mlp --
def mlp_init(generator: torch.Generator, cfg: ArchConfig, device,
             d_ff: Optional[int] = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    p = {"w_in": param_init(generator, (d, f), dt, device),
         "w_out": param_init(generator, (f, d), dt, device)}
    if cfg.act == "silu":
        p["w_gate"] = param_init(generator, (d, f), dt, device)
    return p


def mlp_specs(cfg: ArchConfig) -> Params:
    p = {"w_in": wspec(cfg, "data", "model"),
         "w_out": wspec(cfg, "model", "data")}
    if cfg.act == "silu":
        p["w_gate"] = wspec(cfg, "data", "model")
    return p


def mlp_apply(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["w_in"]
    if cfg.act == "silu":
        g = x @ p["w_gate"]
        h = g * torch.sigmoid(g) * h
    else:
        h = torch.nn.functional.gelu(h, approximate="tanh")
    h = maybe_shard(h, act_bsf(cfg))
    return maybe_shard(h @ p["w_out"], act_bsd(cfg))


# ------------------------------------------------------------------ moe --
def moe_init(generator: torch.Generator, cfg: ArchConfig,
             device) -> Params:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.expert_width
    dt = dtype_of(cfg)
    p = {"router": param_init(generator, (d, e), torch.float32, device),
         "w_in": param_init(generator, (e, d, f), dt, device),
         "w_gate": param_init(generator, (e, d, f), dt, device),
         "w_out": param_init(generator, (e, f, d), dt, device)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {"w_in": param_init(generator, (d, fs), dt, device),
                       "w_gate": param_init(generator, (d, fs), dt, device),
                       "w_out": param_init(generator, (fs, d), dt, device)}
    return p


def moe_specs(cfg: ArchConfig) -> Params:
    p = {"router": P(None, None),
         "w_in": P("model", "data", None),
         "w_gate": P("model", "data", None),
         "w_out": P("model", None, "data")}
    if cfg.n_shared_experts:
        p["shared"] = {"w_in": P("data", "model"),
                       "w_gate": P("data", "model"),
                       "w_out": P("model", "data")}
    return p


def _moe_experts_local(cfg: ArchConfig, w_in, w_gate, w_out, x_tokens,
                       gates, ids, capacity: int,
                       valid: Optional[torch.Tensor] = None,
                       limit: Optional[torch.Tensor] = None):
    """Sort-based capacity dispatch over the experts of ``w_in``.

    x_tokens (T, D); gates/ids (T, k); experts (E, D, F).  The (token,
    choice) pairs are sorted stably by expert id, so an expert's pairs
    keep flat token order; pair ``i`` of expert e takes slot ``i`` of its
    ``capacity`` slots if ``i < limit`` and drops otherwise (GShard token
    dropping).  ``valid`` (T,) bool: tokens outside it (a bucket's
    padding) sort last and take no slot.  ``limit`` (a device scalar, at
    most ``capacity``; None: ``capacity``) is the runtime capacity.

    Since a token picks an expert at most once, the order within an
    expert depends on token indices only, never on the order of a
    token's k choices.  Every step is a sort, a gather or a scatter to
    unique destinations: no host sync and no float atomics.  Each token
    sums its k contributions in choice order, where the reference
    scatter-adds them in expert order (``.at[st].add``)."""
    t, dmod = x_tokens.shape
    e_loc = w_in.shape[0]
    k = ids.shape[1]
    n = t * k
    dev = x_tokens.device
    flat_tok = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)
    key = ids if valid is None else torch.where(valid[:, None], ids, e_loc)
    se, order = torch.sort(key.reshape(-1), stable=True)   # padding last
    st = flat_tok[order]
    counts = torch.zeros(e_loc + 1, dtype=se.dtype, device=dev)
    counts.scatter_add_(0, se, torch.ones_like(se))
    starts = counts.cumsum(0) - counts
    pos_in_e = torch.arange(n, device=dev) - starts[se]
    cap = capacity if limit is None else limit
    keep = (se < e_loc) & (pos_in_e < cap)
    slot = torch.where(keep, se * capacity + pos_in_e, 0)
    # slot c of expert e holds sorted pair starts[e] + c, if that pair
    # is kept: a gather into the (E, C, D) buffers
    col = torch.arange(capacity, device=dev)
    filled = col[None, :] < counts[:e_loc].clamp(max=cap)[:, None]
    src = (starts[:e_loc, None] + col[None, :]).clamp(max=n - 1)
    buf = torch.where(filled[..., None], x_tokens[st[src]], 0)
    h = torch.bmm(buf, w_in)
    g = torch.bmm(buf, w_gate)
    h = g * torch.sigmoid(g) * h
    out = torch.bmm(h, w_out).reshape(e_loc * capacity, dmod)
    # combine: each pair's output back in flat (token, choice) order
    # through the inverse permutation, weighted, summed per token
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(n, device=dev))
    kept = keep[inv][:, None]
    contrib = out[slot[inv]] * gates.reshape(-1, 1).to(out.dtype)
    contrib = torch.where(kept, contrib, 0)
    return contrib.reshape(t, k, dmod).sum(1)


def _moe_expert_parallel(cfg: ArchConfig, p: Params, tokens, gates, ids,
                         valid: Optional[torch.Tensor], mesh):
    """The reference's expert-parallel branch: the experts split over
    ``"model"`` (``E / ep`` a rank), the tokens of each data shard
    replicated across ``"model"``, each rank running its expert slice
    (local ids ``id − r·e_loc``, the rest invalid) at the data shard's
    capacity ``max(8, ⌈int(cf · t_loc · k / E)⌉₈)``, then one all-reduce
    of the partial outputs over ``"model"``.

    With ``valid`` (the bucket's real tokens) the capacity applied is the
    same rule over the data shard's *valid* tokens, a device scalar, so
    the output does not depend on the bucket; where no token is padded
    it is the reference's.  A plain ``tokens`` (no DTensor) is every
    data rank's: the result is then a plain tensor too."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard

    from ..kernels.sharded import _local, _wrap, is_dtensor

    names = list(mesh.mesh_dim_names)
    mi = names.index("model")
    ep = mesh.size(mi)
    e = cfg.n_experts
    e_loc = e // ep
    t, d = tokens.shape
    dp_dims = [names.index(a) for a in ("pod", "data") if a in names]
    dp = math.prod(mesh.size(j) for j in dp_dims)
    sharded_rows = is_dtensor(tokens) and t % dp == 0
    tok_place = tuple(Shard(0) if j in dp_dims and sharded_rows
                      else Replicate() for j in range(mesh.ndim))
    w_place = tuple(Shard(0) if j == mi else Replicate()
                    for j in range(mesh.ndim))
    toks, gat, idd = (_local(v, mesh, tok_place) for v in (tokens, gates, ids))
    w_in, w_gate, w_out = (_local(p[k], mesh, w_place)
                           for k in ("w_in", "w_gate", "w_out"))
    r = mesh.get_coordinate()[mi]
    local_ids = idd - r * e_loc      # out-of-slice ids become invalid
    local_ids = torch.where((local_ids >= 0) & (local_ids < e_loc),
                            local_ids, e_loc)
    t_loc = toks.shape[0]
    cap = int(cfg.capacity_factor * t_loc * cfg.top_k / e)
    cap = max(8, -(-cap // 8) * 8)
    limit = vloc = None
    if valid is not None:
        vloc = _local(valid, mesh, tok_place)
        n = vloc.sum(dtype=torch.float64)
        lim = (cfg.capacity_factor * n * cfg.top_k / e).floor()
        limit = (torch.ceil(lim / 8) * 8).clamp(min=8).long()
    y = _moe_experts_local(cfg, w_in, w_gate, w_out, toks, gat, local_ids,
                           cap, vloc, limit)
    # each token's k experts may live on different EP ranks
    y = funcol.all_reduce(y, "sum", (mesh, mi))
    y = funcol.wait_tensor(y) if hasattr(funcol, "wait_tensor") else y
    if not is_dtensor(tokens):
        return y
    return _wrap(y, mesh, tok_place, (t, d))


def moe_apply(cfg: ArchConfig, p: Params, x: torch.Tensor, *,
              lens: Optional[torch.Tensor] = None,
              mesh: Any = None) -> torch.Tensor:
    """Top-k routed MoE with optional shared experts (dbrx / deepseek-v2).

    The router's f32 logits go through the masked softmax kernel
    (``n_valid = E``), then ``topk``; gates are renormalised.  The
    expert buffers are sized from the call's T = B * S tokens as the
    reference sizes them, ``max(4, int(cf * T * k / E))``.  With ``lens``
    (B,), token (b, s) is valid iff ``s < lens[b]``: padded tokens take
    no slot, and the capacity applied is ``max(4, floor(cf * n * k /
    E))`` over the ``n = lens.sum()`` valid tokens, a device scalar, so
    the output does not depend on the bucket.  Without ``lens`` every
    token counts, as in the reference.

    Under a mesh with a ``"model"`` axis (``mesh``, or the ambient one of
    ``use_mesh``) the experts run expert-parallel, as the reference's
    ``shard_map`` branch: see :func:`_moe_expert_parallel`."""
    if mesh is None:
        mesh = get_mesh()
    elif not hasattr(mesh, "mesh_dim_names"):
        from ..dist.context import check_mesh
        check_mesh(mesh, "moe_apply")
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    t = tokens.shape[0]
    e = cfg.n_experts
    logits = tokens.float() @ p["router"]                   # (T, E)
    gates, ids = torch.topk(sm_ops.masked_softmax(logits, e), cfg.top_k,
                            dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    gates = gates.to(x.dtype)
    valid = None
    if lens is not None:
        valid = (torch.arange(s, device=x.device)[None, :]
                 < lens[:, None]).reshape(-1)
    if mesh is not None and "model" in (mesh.mesh_dim_names or ()):
        y = _moe_expert_parallel(cfg, p, tokens, gates, ids, valid, mesh)
    else:
        cap = max(4, int(cfg.capacity_factor * t * cfg.top_k / e))
        limit = None
        if lens is not None:
            n_valid = lens.sum(dtype=torch.float64)
            limit = (cfg.capacity_factor * n_valid * cfg.top_k / e) \
                .floor().clamp(min=4).long()
        y = _moe_experts_local(cfg, p["w_in"], p["w_gate"], p["w_out"],
                               tokens, gates, ids, cap, valid, limit)
    if cfg.n_shared_experts:
        sh = p["shared"]
        g = tokens @ sh["w_gate"]
        y = y + (g * torch.sigmoid(g) * (tokens @ sh["w_in"])) @ sh["w_out"]
    return maybe_shard(y.reshape(b, s, d), A_BSD)


# ---------------------------------------------------------------- rwkv6 --
def rwkv6_init(generator: torch.Generator, cfg: ArchConfig,
               device) -> Params:
    d = cfg.d_model
    hp = cfg.ssm_head_dim
    n_heads = d // hp
    dt = dtype_of(cfg)
    p = {name: param_init(generator, (d, d), dt, device)
         for name in ("w_r", "w_k", "w_v", "w_g", "w_w")}  # w_w: decay
    p["u"] = param_init(generator, (n_heads, hp), torch.float32, device,
                        scale=0.1)
    p["w_out"] = param_init(generator, (d, d), dt, device)
    p["mix"] = param_init(generator, (5, d), torch.float32, device,
                          scale=0.1)
    return p


def _shifted(x: torch.Tensor, x_prev: Optional[torch.Tensor]):
    """The token-shift sequence of x (B, S, D): position t sees x[t-1],
    position 0 sees ``x_prev`` (B, D) (None: zeros)."""
    first = (torch.zeros_like(x[:, :1]) if x_prev is None
             else x_prev[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _last_rows(x: torch.Tensor, lens: Optional[torch.Tensor],
               old: torch.Tensor) -> torch.Tensor:
    """Each row's last valid position of x (B, S, D): ``x[b, lens[b]-1]``
    (None: the last position); a row with ``lens = 0`` keeps ``old``."""
    if lens is None:
        return x[:, -1]
    b = x.shape[0]
    last = x[torch.arange(b, device=x.device), (lens - 1).clamp(min=0)]
    return torch.where((lens > 0)[:, None], last, old.to(x.dtype))


def _wkv_scan(r, k, v, w, u):
    """The reference's sequential form: r, k, w (B, H, T, K); v (B, H,
    T, V); u (H, K) -> (y, s_final), from a zero state.  The WKV kernel
    on the card, its plain version on the CPU."""
    return wkv_ops.rwkv6(r, k, v, w, u)


def rwkv6_specs(cfg: ArchConfig) -> Params:
    return {"w_r": P("data", "model"), "w_k": P("data", "model"),
            "w_v": P("data", "model"), "w_g": P("data", "model"),
            "w_w": P("data", "model"), "u": P("model", None),
            "w_out": P("model", "data"), "mix": P(None, None)}


def rwkv6_apply(cfg: ArchConfig, p: Params, x: torch.Tensor, *,
                cache: Optional[Params] = None,
                lens: Optional[torch.Tensor] = None):
    """RWKV-6 time-mix block (token-shift simplified to previous-x mix).

    Without ``cache``: the whole sequence from a zero state, as the
    reference's ``_wkv_scan`` (r, k, v widened to f32).  With ``cache``
    (``{"s", "x_prev"}``): x (B, S, D) continues each row from the
    cache's state and previous token, for the first ``lens[b]``
    positions (None: all S).  S = 1 is the reference's decode step;
    longer chunks are the serve path's prefill, the same recurrence in
    one kernel launch.  The new cache holds the final state and x at
    each row's last valid position; a row with ``lens = 0`` keeps its
    cache."""
    b, s, d = x.shape
    hp = cfg.ssm_head_dim
    n_heads = d // hp
    xp = _shifted(x, None if cache is None else cache["x_prev"])
    # token-shift mix in the activation dtype, as the reference mixes
    mix = torch.sigmoid(p["mix"]).to(x.dtype)   # (5, D)

    def mixed(i):
        return x * mix[i] + xp * (1 - mix[i])

    def heads(t):   # (B, S, D) -> a (B, H, S, hp) view
        return t.reshape(b, s, n_heads, hp).transpose(1, 2)

    r = heads(mixed(0) @ p["w_r"])
    k = heads(mixed(1) @ p["w_k"])
    v = heads(mixed(2) @ p["w_v"])
    g = torch.nn.functional.silu(mixed(3) @ p["w_g"])
    log_dec = -torch.exp((mixed(4) @ p["w_w"]).float().clamp(-8, 4))
    w = heads(torch.exp(log_dec))
    new_cache = None
    if cache is None:
        y, _ = _wkv_scan(r.float(), k.float(), v.float(), w, p["u"])
    else:
        y, s_new = wkv_ops.rwkv6(r, k, v, w, p["u"], cache["s"], lens)
        new_cache = {"s": s_new,
                     "x_prev": _last_rows(x, lens, cache["x_prev"])}
    y = y.transpose(1, 2).reshape(b, s, d).to(x.dtype)
    return (y * g) @ p["w_out"], new_cache


def rwkv6_cache_init(cfg: ArchConfig, batch: int, device) -> Params:
    hp = cfg.ssm_head_dim
    n_heads = cfg.d_model // hp
    return {"s": torch.zeros((batch, n_heads, hp, hp), dtype=torch.float32,
                             device=device),
            "x_prev": torch.zeros((batch, cfg.d_model), dtype=dtype_of(cfg),
                                  device=device)}


# --------------------------------------------------------------- mamba2 --
def rwkv6_cache_specs(cfg: ArchConfig) -> Params:
    return {"s": P(("pod", "data"), "model", None, None),
            "x_prev": P(("pod", "data"), None)}


def mamba2_init(generator: torch.Generator, cfg: ArchConfig,
                device) -> Params:
    d = cfg.d_model
    d_in = 2 * d
    n, hp = cfg.ssm_state, cfg.ssm_head_dim
    n_heads = d_in // hp
    dt = dtype_of(cfg)
    return {
        "w_x": param_init(generator, (d, d_in), dt, device),
        "w_z": param_init(generator, (d, d_in), dt, device),
        "w_bc": param_init(generator, (d, 2 * n), dt, device),
        "w_dt": param_init(generator, (d, n_heads), dt, device),
        "a_log": torch.zeros((n_heads,), dtype=torch.float32, device=device),
        "w_out": param_init(generator, (d_in, d), dt, device),
        "skip": param_init(generator, (n_heads,), torch.float32, device,
                           scale=1.0),
    }


def mamba2_specs(cfg: ArchConfig) -> Params:
    return {"w_x": P("data", "model"), "w_z": P("data", "model"),
            "w_bc": P("data", None), "w_dt": P("data", "model"),
            "a_log": P("model"), "w_out": P("model", "data"),
            "skip": P("model")}


def mamba2_apply(cfg: ArchConfig, p: Params, x: torch.Tensor, *,
                 cache: Optional[Params] = None,
                 lens: Optional[torch.Tensor] = None):
    """Mamba-2 block over x (B, S, D).

    Without ``cache``: the whole sequence from a zero state (the
    reference's ``_ssd_chunked``, here in exact f32).  With ``cache``
    (``{"h": (B, H, N, P) f32}``): x continues each row from the cache's
    state for the first ``lens[b]`` positions (None: all S).  S = 1 is
    the reference's decode step (its one-step einsums); longer chunks are
    the serve path's prefill, the same recurrence in one kernel launch.
    A row with ``lens = 0`` keeps its state.  b and c stay (B, S, N),
    shared by the heads; x and y are viewed per head, never copied."""
    b, s, d = x.shape
    d_in = 2 * d
    n, hp = cfg.ssm_state, cfg.ssm_head_dim
    n_heads = d_in // hp
    xz = x @ p["w_x"]
    z = torch.nn.functional.silu(x @ p["w_z"])
    bc = x @ p["w_bc"]
    bmat, cmat = bc[..., :n], bc[..., n:]
    dt_ = torch.nn.functional.softplus((x @ p["w_dt"]).float())  # (B,S,H)
    a = torch.exp(-dt_ * torch.exp(p["a_log"]))
    xh = xz.reshape(b, s, n_heads, hp).transpose(1, 2)           # (B,H,S,P)
    ah = a.transpose(1, 2)                                       # (B,H,S)
    new_cache = None
    if cache is None:
        y, _ = ssd_ops.mamba2_scan(xh, ah, bmat, cmat)
    else:
        y, h_new = ssd_ops.mamba2_scan(xh, ah, bmat, cmat, cache["h"], lens)
        new_cache = {"h": h_new}
    y = y + p["skip"][None, :, None, None] * xh.float()
    y = y.transpose(1, 2).reshape(b, s, d_in).to(x.dtype)
    return (y * z) @ p["w_out"], new_cache


def mamba2_cache_init(cfg: ArchConfig, batch: int, device) -> Params:
    n_heads = 2 * cfg.d_model // cfg.ssm_head_dim
    return {"h": torch.zeros((batch, n_heads, cfg.ssm_state,
                              cfg.ssm_head_dim), dtype=torch.float32,
                             device=device)}


def mamba2_cache_specs(cfg: ArchConfig) -> Params:
    return {"h": P(("pod", "data"), "model", None, None)}
