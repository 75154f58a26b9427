"""RMSNorm for Hopper (CUDA C++).

Replaces the JAX package's Pallas TPU kernel ``rmsnorm_kernel``
(``kernels/rmsnorm/rmsnorm.py:26``): ``y = x * rsqrt(mean(x^2) + eps) *
w`` over rows of width D, accumulated in f32 whatever the input type,
then cast to the input type.

The kernel is the RMSNorm instance of ``common/csrc/row_norm.cuh`` (its
header comment holds the design, what bounds it and its numerics), built
into the library of ``csrc/rmsnorm.cu``; ``kernels/row_norm.py`` holds
the plan and the launch it shares with LayerNorm.  x is f32, bf16 or
f16, the weight any of the three (f32 in every model, bf16 x included),
widened to f32 once a thread.  One launch a call.
"""
from __future__ import annotations

import torch

from .. import row_norm

__all__ = ["rmsnorm_kernel"]

_DTYPES = row_norm.DTYPES


def rmsnorm_kernel(x: torch.Tensor, w: torch.Tensor, *,
                   eps: float = 1e-6) -> torch.Tensor:
    """Launch RMSNorm over the last axis of ``x`` with weight ``w`` (D,);
    returns a tensor of ``x``'s shape and dtype."""
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"rmsnorm: weight {tuple(w.shape)} for width {d}")
    xdt, wdt = _DTYPES.get(x.dtype), _DTYPES.get(w.dtype)
    if xdt is None or wdt is None:
        raise TypeError(f"rmsnorm: x {x.dtype}, w {w.dtype}")
    dev = x.device
    if dev.type != "cuda" or w.device != dev:
        raise ValueError("rmsnorm kernel: x and w on one CUDA device")
    return row_norm.launch("rmsnorm", x, w, None, eps, (xdt, wdt, 0))
