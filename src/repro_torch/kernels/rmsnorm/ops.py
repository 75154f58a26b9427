"""Wrapper of the RMSNorm kernel: picks kernel or plain version by device.

A CUDA tensor launches the CUDA C++ kernel (and counts the launch); a CPU
tensor, or any tensor inside
:func:`~repro_torch.kernels.select.plain_versions`, runs the plain
version in ``ref.py``.  There is no fallback: a kernel that fails to
build or launch raises.  Under grad the kernel's output carries the plain
version's gradient (:func:`~repro_torch.kernels.grad.kernel_call`).
"""
from __future__ import annotations

import torch

from ..grad import kernel_call
from ..select import use_kernel
from .. import sharded
from ..triton_build import LaunchCounter
from .rmsnorm import rmsnorm_kernel
from .ref import rmsnorm_ref

__all__ = ["rmsnorm", "LAUNCHES"]

#: launches of the RMSNorm kernel on the card
LAUNCHES = LaunchCounter()


def _kernel(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return rmsnorm_kernel(x, w, eps=eps)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2, -1) + eps) * w`` in f32, cast to x's dtype."""
    if sharded.is_dtensor(x) or sharded.is_dtensor(w):
        return sharded.rows(rmsnorm, x, w, eps=eps)
    if not use_kernel(x, "rmsnorm"):
        return rmsnorm_ref(x, w, eps)
    out = kernel_call(_kernel, rmsnorm_ref, x, w, eps)
    LAUNCHES.launches += 1
    return out
