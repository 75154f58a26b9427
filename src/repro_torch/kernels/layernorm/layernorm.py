"""LayerNorm for Hopper (CUDA C++).

Replaces the JAX package's Pallas TPU kernel ``layernorm_kernel``
(``kernels/layernorm/layernorm.py:24``): ``y = (x - mean) * rsqrt(var +
eps) * g + b`` over rows of width D, accumulated in f32 whatever the
input type, then cast to the input type.

The kernel is the LayerNorm instance of ``common/csrc/row_norm.cuh`` (its
header comment holds the design, what bounds it and its numerics), built
into the library of ``csrc/layernorm.cu``; ``kernels/row_norm.py`` holds
the plan and the launch it shares with RMSNorm.  Two passes over the
register-held row: the mean first, then the variance of the centred row,
as the plain version computes it (a one-pass ``E[x^2] - E[x]^2`` would
cancel badly for rows far from zero mean).  x, the scale and the bias are
each f32 or bf16; the scale and bias are widened to f32 once a thread.
One launch a call.
"""
from __future__ import annotations

import torch

from .. import row_norm

__all__ = ["layernorm_kernel"]

_DTYPES = {t: c for t, c in row_norm.DTYPES.items()
           if t in (torch.float32, torch.bfloat16)}


def layernorm_kernel(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, *,
                     eps: float = 1e-5) -> torch.Tensor:
    """Launch LayerNorm over the last axis of ``x`` with scale ``g`` and
    bias ``b`` (D,) each; returns a tensor of ``x``'s shape and dtype."""
    d = x.shape[-1]
    if g.shape != (d,) or b.shape != (d,):
        raise ValueError(f"layernorm: scale {tuple(g.shape)}, bias "
                         f"{tuple(b.shape)} for width {d}")
    codes = (_DTYPES.get(x.dtype), _DTYPES.get(g.dtype),
             _DTYPES.get(b.dtype))
    if None in codes:
        raise TypeError(f"layernorm: x {x.dtype}, scale {g.dtype}, "
                        f"bias {b.dtype}")
    dev = x.device
    if dev.type != "cuda" or g.device != dev or b.device != dev:
        raise ValueError("layernorm kernel: x, scale and bias on one CUDA "
                         "device")
    return row_norm.launch("layernorm", x, g, b, eps, codes)
