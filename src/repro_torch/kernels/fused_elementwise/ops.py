"""Wrapper of the kLoop kernel: picks kernel or plain version by device.

A CUDA operand launches the Triton kernel (and counts the launch); a CPU
operand runs the plain version in ``ref.py``.  There is no fallback: a
kernel that fails to build or launch raises.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from ..program import Program
from ..triton_build import LaunchCounter
from .ref import fused_elementwise_ref

__all__ = ["fused_elementwise", "LAUNCHES", "UNALIGNED_LAUNCHES"]

#: launches of the kLoop kernel on the card
LAUNCHES = LaunchCounter()
#: ... of them in the unaligned class (an operand or row pitch off 16
#: bytes: element-wide accesses)
UNALIGNED_LAUNCHES = LaunchCounter()


def fused_elementwise(program: Program, inputs: Sequence[torch.Tensor],
                      n_valid: int, shape: Sequence[int]
                      ) -> List[torch.Tensor]:
    """Run ``program`` over ``inputs`` broadcast to ``shape``; outputs are
    dense ``shape`` tensors, zero at flat positions ``>= n_valid``."""
    dev = inputs[0].device
    if dev.type == "cpu":
        return fused_elementwise_ref(program, inputs, n_valid, shape)
    if dev.type != "cuda":
        raise ValueError(f"fused_elementwise: no kernel for {dev}")
    from .fused_elementwise import fused_elementwise_kernel

    outs = fused_elementwise_kernel(program, inputs, n_valid, shape)
    LAUNCHES.launches += 1
    return outs
