"""Wrapper of the masked softmax kernel: picks kernel or plain version by
device.

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
from .ref import masked_softmax_ref

__all__ = ["masked_softmax", "LAUNCHES"]

#: launches of the masked softmax kernel on the card
LAUNCHES = LaunchCounter()


def masked_softmax(x: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Softmax over the last axis of ``x`` using only the columns below
    ``n_valid`` (the rest exactly 0), in f32, cast to x's dtype; the
    leading axes are flattened into rows, as the reference wrapper
    (``kernels/softmax/ops.py``) flattens them."""
    if sharded.is_dtensor(x):
        return sharded.rows(masked_softmax, x, n_valid)
    c = x.shape[-1]
    rows = x.reshape(-1, c)
    if not use_kernel(x, "masked_softmax"):
        return masked_softmax_ref(rows, n_valid).reshape(x.shape)
    from .softmax import masked_softmax_kernel

    out = kernel_call(masked_softmax_kernel, masked_softmax_ref, rows,
                      int(n_valid))
    LAUNCHES.launches += 1
    return out.reshape(x.shape)
