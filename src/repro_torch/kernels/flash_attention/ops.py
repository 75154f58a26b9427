"""Wrappers of the flash-attention kernel: prefill (varlen, causal, per-row
query offsets) and decode (one query row per head).

Each picks the kernel or its plain version by the tensors' device
(:func:`~repro_torch.kernels.select.use_kernel`): a CUDA tensor launches
the CUDA C++ kernel and counts the launch; a CPU tensor, or any tensor
inside :func:`~repro_torch.kernels.select.plain_versions`, runs the plain
version (``ref.sdpa_ref``: the reference ``_sdpa``'s dense form, or its
online-softmax chunked form for long queries).  There is no fallback: a
kernel that fails to build or launch raises.

:func:`flash_attention` also takes v wider or narrower than q / k and an
explicit ``scale`` (MLA's prefill: q/k 192, v 128, ``1 / sqrt(192)``);
:func:`mla_decode` is MLA's absorbed decode against the latent cache
(plain version ``ref.mla_decode_ref``).  Every launch of either counts
in :data:`LAUNCHES`; :data:`FORM_LAUNCHES` counts the MLA forms apart.
Under grad, :func:`flash_attention`'s output carries the plain version's
gradient (:func:`~repro_torch.kernels.grad.kernel_call`); MLA's absorbed
decode is a serve-path form, never differentiated.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..grad import kernel_call, plain_call
from ..select import use_kernel
from .. import sharded
from ..triton_build import LaunchCounter
from .flash_attention import BLOCK_K, BLOCK_Q
from .ref import mla_decode_ref, sdpa_ref

__all__ = ["flash_attention", "flash_decode", "mla_decode", "decode_splits",
           "LAUNCHES", "FORM_LAUNCHES"]

#: launches of the flash-attention kernel (every form) on the card
LAUNCHES = LaunchCounter()
#: of those, the MLA forms': ``"mla"`` the instances with v narrower than
#: q / k, (192, 128) and the reduced (24, 16) (prefill, chunks, expanded
#: decode), ``"mla_decode"`` the absorbed decode
FORM_LAUNCHES = {"mla": LaunchCounter(), "mla_decode": LaunchCounter()}


def _pick_blocks(sq: int, sk: int, causal: bool) -> Tuple[int, int]:
    """The (query rows, keys) tile one block of the kernel steps over —
    the shape-adaptive version choice of the reference's ``_pick_blocks``.
    One query row without a causal mask (decode) takes the decode form:
    a block holds one row per head of a GQA group, against 64-key tiles
    of its key split (:func:`decode_splits`).
    Everything else takes the prefill form's 64 x 64 tile.  Sizes need
    not divide the tile: the kernel masks its ragged edges (the
    reference pads to a block multiple instead)."""
    if sq == 1 and not causal:
        return 1, BLOCK_K
    return BLOCK_Q, BLOCK_K


def decode_splits(sk: int, b: int, hkv: int, n_sm: int) -> Tuple[int, int]:
    """The decode form's split of the keys over blocks: ``(n_split,
    keys_per_split)``.

    Split ``i`` holds keys ``[i * keys_per_split, (i + 1) *
    keys_per_split)``, the last one up to ``sk``; a block scores its split
    clipped to ``lens[b]``.  The plan reads only the cache's static extent
    ``sk``, the batch ``b``, the kv heads ``hkv`` and the SM count, never
    ``lens``, so it needs nothing from the card.  It aims at about two
    waves of ``n_sm`` blocks over the ``b * hkv * n_split`` grid, and
    every split holds at least one full 64-key tile (when ``sk >= 64``):
    ``keys_per_split`` is a multiple of ``BLOCK_K`` and the last split
    takes the remainder.
    """
    tiles = sk // BLOCK_K  # whole 64-key tiles of the cache
    if tiles <= 1:
        return 1, BLOCK_K
    want = -(-2 * n_sm // max(1, b * hkv))
    n_split = max(1, min(want, tiles))
    per = -(-tiles // n_split)  # tiles per split
    return -(-tiles // per), per * BLOCK_K


def _kernel(q, k, v, lens, q_offset, causal: bool, scale):
    from .flash_attention import flash_attention_kernel

    block_q, _ = _pick_blocks(q.shape[2], k.shape[2], causal)
    return flash_attention_kernel(q, k, v, lens, q_offset, causal=causal,
                                  decode=block_q == 1, scale=scale)


def _plain(q, k, v, lens, q_offset, causal: bool, scale):
    return sdpa_ref(q, k, v, causal=causal, lens=lens, q_offset=q_offset,
                    scale=scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lens: Optional[torch.Tensor] = None, *,
                    causal: bool = True,
                    q_offset: Union[int, torch.Tensor] = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B,H,Sq,D) x k (B,Hkv,Sk,D), v (B,Hkv,Sk,Dv), per-row valid kv
    ``lens`` and, when ``causal``, per-row query offsets: key ``k`` is
    visible to query ``i`` of row ``b`` when ``k <= q_offset[b] + i``.
    ``scale`` defaults to ``1 / sqrt(D)``."""
    if any(sharded.is_dtensor(t) for t in (q, k, v)):
        return sharded.flash_attention(flash_attention, q, k, v, lens,
                                       causal=causal, q_offset=q_offset,
                                       scale=scale)
    if not use_kernel(q, "flash_attention"):
        return plain_call(_plain, q, k, v, lens, q_offset, causal,
                          scale)
    out = kernel_call(_kernel, _plain, q, k, v, lens, q_offset, causal,
                      scale)
    LAUNCHES.launches += 1
    if q.shape[-1] != v.shape[-1]:
        FORM_LAUNCHES["mla"].launches += 1
    return out


def mla_decode(q_abs: torch.Tensor, q_pe: torch.Tensor, kv_c: torch.Tensor,
               k_pe: torch.Tensor, lens: Optional[torch.Tensor],
               scale: float) -> torch.Tensor:
    """MLA's absorbed decode step: q_abs (B,1,H,L) and q_pe (B,1,H,R)
    against the latent cache kv_c (B,S,L) and k_pe (B,S,R), keys ``<
    lens[b]`` valid -> (B,1,H,L).  On the card one launch of the kernel's
    MLA decode form, which reads both cache leaves in place."""
    if any(sharded.is_dtensor(t) for t in (q_abs, q_pe, kv_c, k_pe)):
        return sharded.mla_decode(mla_decode, q_abs, q_pe, kv_c, k_pe,
                                  lens, scale)
    if not use_kernel(q_abs, "mla_decode"):
        return mla_decode_ref(q_abs, q_pe, kv_c, k_pe, lens, scale)
    from .flash_attention import mla_decode_kernel

    out = mla_decode_kernel(q_abs, q_pe, kv_c, k_pe, lens, scale)
    LAUNCHES.launches += 1
    FORM_LAUNCHES["mla_decode"].launches += 1
    return out


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor,
                 lens: Optional[torch.Tensor]) -> torch.Tensor:
    """Single-token decode: q (B,H,1,D) against the cache (B,Hkv,Smax,D),
    keys ``< lens[b]`` valid."""
    if q.shape[2] != 1:
        raise ValueError(f"flash_decode takes one query row, got "
                         f"{q.shape[2]}")
    return flash_attention(q, k_cache, v_cache, lens, causal=False)
