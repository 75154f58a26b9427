"""Wrapper of the Mamba-2 SSD scan kernel: picks kernel or plain version
by device.

A CUDA tensor launches the CUDA C++ kernel (and counts the launch); a
CPU tensor, or any tensor inside
:func:`~repro_torch.kernels.select.plain_versions`, runs the plain
chunked version in ``ref.py``.  There is no fallback: a kernel that
fails to build or launch raises.  Under grad the kernel's outputs carry
the plain version's gradient
(:func:`~repro_torch.kernels.grad.kernel_call`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..grad import kernel_call
from ..select import use_kernel
from .. import sharded
from ..triton_build import LaunchCounter
from .ref import mamba2_chunked

__all__ = ["mamba2_scan", "LAUNCHES"]

#: launches of the SSD kernel on the card
LAUNCHES = LaunchCounter()


def mamba2_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, s0: Optional[torch.Tensor] = None,
                lens: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan over x (B, H, T, P) with decay a (B, H, T) and the
    rows' b, c (B, T, N), from state ``s0`` (B, H, N, P) f32 (None:
    zeros), for the first ``lens[b]`` steps of each row (None: all T).
    Returns ``(y, s_final)``: y (B, H, T, P) f32, exactly 0 at steps past
    a row's length; s_final f32, ``s0`` itself for a row of length 0."""
    if any(sharded.is_dtensor(t) for t in (x, a, b, c, s0)):
        bh = {"B": 0, "H": 1}
        return sharded.batch_heads(
            lambda *xs, lens: mamba2_scan(*xs, lens=lens), x,
            (x, a, b, c, s0),
            (bh, bh, {"B": 0}, {"B": 0}, bh if s0 is not None else None),
            (bh, bh), lens)
    if not use_kernel(x, "mamba2_scan"):
        return mamba2_chunked(x, a, b, c, s0, lens)
    from .mamba2 import mamba2_kernel

    out = kernel_call(mamba2_kernel, mamba2_chunked, x, a, b, c, s0, lens)
    LAUNCHES.launches += 1
    return out
