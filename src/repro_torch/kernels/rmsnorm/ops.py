"""Wrapper of the RMSNorm kernel: picks kernel or plain version by device.

A CUDA tensor launches the Triton kernel (and counts the launch); a CPU
tensor, or any tensor inside
:func:`~repro_torch.kernels.select.plain_versions`, runs the plain
version in ``ref.py``.  There is no fallback: a kernel that fails to
build or launch raises.
"""
from __future__ import annotations

import torch

from ..select import use_kernel
from ..triton_build import LaunchCounter
from .ref import rmsnorm_ref

__all__ = ["rmsnorm", "LAUNCHES"]

#: launches of the RMSNorm kernel on the card
LAUNCHES = LaunchCounter()


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2, -1) + eps) * w`` in f32, cast to x's dtype."""
    if not use_kernel(x, "rmsnorm"):
        return rmsnorm_ref(x, w, eps)
    from .rmsnorm import rmsnorm_kernel

    out = rmsnorm_kernel(x, w, eps=eps)
    LAUNCHES.launches += 1
    return out
