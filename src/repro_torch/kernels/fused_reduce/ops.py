"""Wrapper of the kInput kernel: picks kernel or plain version by device.

A CUDA operand launches the Triton kernel (and counts the launch); a CPU
operand runs the plain version in ``ref.py``.  There is no fallback: a
kernel that fails to build or launch raises.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..program import Program
from ..triton_build import LaunchCounter
from .ref import fused_reduce_ref

__all__ = ["fused_reduce", "LAUNCHES", "UNALIGNED_LAUNCHES"]

#: launches of the kInput kernel on the card
LAUNCHES = LaunchCounter()
#: ... of them in the unaligned class (an operand or row pitch off 16
#: bytes: element-wide accesses)
UNALIGNED_LAUNCHES = LaunchCounter()


def fused_reduce(program: Program, inputs: Sequence[torch.Tensor],
                 n_valid_cols: int, kind: str = "sum", *, axis: int = -1,
                 shape: Sequence[int], out_dtype=None) -> torch.Tensor:
    """Reduce ``program(*inputs)`` over ``axis`` with a dynamic valid
    length; ``inputs`` broadcast to ``shape``.  Returns the kept axes in
    their original order."""
    out_dtype = out_dtype or program.out_dtypes[0]
    dev = inputs[0].device
    if dev.type == "cpu":
        return fused_reduce_ref(program, inputs, n_valid_cols, kind, axis,
                                shape, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"fused_reduce: no kernel for {dev}")
    from .fused_reduce import fused_reduce_kernel

    out = fused_reduce_kernel(program, inputs, n_valid_cols, kind, axis,
                              shape, out_dtype)
    LAUNCHES.launches += 1
    return out
