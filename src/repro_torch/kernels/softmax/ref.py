"""Plain PyTorch version of the masked softmax kernel: the JAX package's
``kernels/softmax/ref.py`` oracle, computed in f32 and cast once to the
input type.

Columns at or past ``n_valid`` are exactly 0.  A row with no valid column
is all zeros: its max is kept finite and its sum of 0 is replaced by 1.
"""
from __future__ import annotations

import torch

__all__ = ["masked_softmax_ref"]


def masked_softmax_ref(x: torch.Tensor, n_valid) -> torch.Tensor:
    """Softmax over the last axis of ``x`` (R, C), columns ``< n_valid``."""
    c = x.shape[-1]
    mask = torch.arange(c, device=x.device) < n_valid
    xm = torch.where(mask, x.float(), float("-inf"))
    m = xm.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.where(mask, torch.exp(xm - m), 0.0)
    s = e.sum(-1, keepdim=True)
    s = torch.where(s == 0, 1.0, s)
    return (e / s).to(x.dtype)
