"""Wrapper of the LayerNorm kernel: picks kernel or plain version by device.

A CUDA tensor launches the CUDA C++ kernel (and counts the launch); a CPU
tensor, or any tensor inside
:func:`~repro_torch.kernels.select.plain_versions`, runs the plain
version in ``ref.py``.  There is no fallback: a kernel that fails to
build or launch raises.  Under grad the kernel's output carries the plain
version's gradient (:func:`~repro_torch.kernels.grad.kernel_call`).
"""
from __future__ import annotations

import torch

from ..grad import kernel_call, plain_call
from ..select import use_kernel
from .. import sharded
from ..triton_build import LaunchCounter
from .layernorm import layernorm_kernel
from .ref import layernorm_ref

__all__ = ["layernorm", "LAUNCHES"]

#: launches of the LayerNorm kernel on the card
LAUNCHES = LaunchCounter()


def _kernel(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float) -> torch.Tensor:
    return layernorm_kernel(x, scale, bias, eps=eps)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
              eps: float = 1e-5) -> torch.Tensor:
    """``(x - mean) * rsqrt(var + eps) * scale + bias`` over the last
    axis, in f32, cast to x's dtype."""
    if any(sharded.is_dtensor(t) for t in (x, scale, bias)):
        return sharded.rows(layernorm, x, scale, bias, eps=eps)
    if not use_kernel(x, "layernorm"):
        return plain_call(layernorm_ref, x, scale, bias, eps)
    out = kernel_call(_kernel, layernorm_ref, x, scale, bias, eps)
    LAUNCHES.launches += 1
    return out
