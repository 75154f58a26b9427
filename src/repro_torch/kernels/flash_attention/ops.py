"""Wrappers of the flash-attention kernel: prefill (varlen, causal, per-row
query offsets) and decode (one query row per head).

Each picks the kernel or its plain version by the tensors' device
(:func:`~repro_torch.kernels.select.use_kernel`): a CUDA tensor launches
the CUDA C++ kernel and counts the launch; a CPU tensor, or any tensor
inside :func:`~repro_torch.kernels.select.plain_versions`, runs the plain
version (``ref.sdpa_ref``: the reference ``_sdpa``'s dense form, or its
online-softmax chunked form for long queries).  There is no fallback: a
kernel that fails to build or launch raises.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..select import use_kernel
from ..triton_build import LaunchCounter
from .flash_attention import BLOCK_K, BLOCK_Q
from .ref import sdpa_ref

__all__ = ["flash_attention", "flash_decode", "LAUNCHES"]

#: launches of the flash-attention kernel (both forms) on the card
LAUNCHES = LaunchCounter()


def _pick_blocks(sq: int, sk: int, causal: bool) -> Tuple[int, int]:
    """The (query rows, keys) tile one block of the kernel steps over —
    the shape-adaptive version choice of the reference's ``_pick_blocks``.
    One query row without a causal mask (decode) takes the decode form:
    a block holds one row per head of a GQA group, against 64 keys.
    Everything else takes the prefill form's 64 x 64 tile.  Sizes need
    not divide the tile: the kernel masks its ragged edges (the
    reference pads to a block multiple instead)."""
    if sq == 1 and not causal:
        return 1, BLOCK_K
    return BLOCK_Q, BLOCK_K


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lens: Optional[torch.Tensor] = None, *,
                    causal: bool = True,
                    q_offset: Union[int, torch.Tensor] = 0) -> torch.Tensor:
    """q (B,H,Sq,D) x kv (B,Hkv,Sk,D), per-row valid kv ``lens`` and, when
    ``causal``, per-row query offsets: key ``k`` is visible to query ``i``
    of row ``b`` when ``k <= q_offset[b] + i``."""
    if not use_kernel(q, "flash_attention"):
        return sdpa_ref(q, k, v, causal=causal, lens=lens, q_offset=q_offset)
    from .flash_attention import flash_attention_kernel

    block_q, _ = _pick_blocks(q.shape[2], k.shape[2], causal)
    out = flash_attention_kernel(q, k, v, lens, q_offset, causal=causal,
                                 decode=block_q == 1)
    LAUNCHES.launches += 1
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
