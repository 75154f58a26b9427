"""Wrapper of the RWKV-6 WKV kernel: picks kernel or plain version by
device.

A CUDA tensor launches the CUDA C++ kernel (and counts the launch); a
CPU tensor, or any tensor inside
:func:`~repro_torch.kernels.select.plain_versions`, runs the plain
version in ``ref.py``.  There is no fallback: a kernel that fails to
build or launch raises.  Under grad the kernel's outputs carry the plain
version's gradient (:func:`~repro_torch.kernels.grad.kernel_call`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..grad import kernel_call
from ..select import use_kernel
from .. import sharded
from ..triton_build import LaunchCounter
from .ref import rwkv6_ref

__all__ = ["rwkv6", "LAUNCHES"]

#: launches of the WKV kernel on the card
LAUNCHES = LaunchCounter()


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          w: torch.Tensor, u: torch.Tensor,
          s0: Optional[torch.Tensor] = None,
          lens: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV recurrence over r, k, v, w (B, H, T, N) with bonus u
    (H, N), from state ``s0`` (B, H, N, N) f32 (None: zeros), for the
    first ``lens[b]`` steps of each row (None: all T).  Returns ``(y,
    s_final)``: y (B, H, T, N) in r's dtype, exactly 0 at steps past a
    row's length; s_final f32, ``s0`` itself for a row of length 0."""
    if any(sharded.is_dtensor(t) for t in (r, k, v, w, u, s0)):
        bh = {"B": 0, "H": 1}
        return sharded.batch_heads(
            lambda *xs, lens: rwkv6(*xs, lens=lens), r,
            (r, k, v, w, u, s0),
            (bh, bh, bh, bh, {"H": 0}, bh if s0 is not None else None),
            (bh, bh), lens)
    if not use_kernel(r, "rwkv6"):
        return rwkv6_ref(r, k, v, w, u, s0, lens)
    from .rwkv6 import rwkv6_kernel

    out = kernel_call(rwkv6_kernel, rwkv6_ref, r, k, v, w, u, s0, lens)
    LAUNCHES.launches += 1
    return out
