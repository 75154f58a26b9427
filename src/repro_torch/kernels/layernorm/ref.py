"""Plain PyTorch version of the LayerNorm kernel: ``norm_apply``'s
LayerNorm branch (f32 accumulation, centred variance, ``rsqrt``, then a
cast back to the input type), in the same ops.

The JAX package's ``kernels/layernorm/ref.py`` divides by ``sqrt``
instead; the model path follows ``norm_apply``, and so does this."""
from __future__ import annotations

import torch

__all__ = ["layernorm_ref"]


def layernorm_ref(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * scale + bias
    return y.to(x.dtype)
