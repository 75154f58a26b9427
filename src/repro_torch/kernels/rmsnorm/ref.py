"""Plain PyTorch version of the RMSNorm kernel: ``norm_apply``'s RMS
branch (f32 accumulation, then a cast back to the input type), in the
same ops, so the DHLO bridge traces it into the reference's plan."""
from __future__ import annotations

import torch

__all__ = ["rmsnorm_ref"]


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps) * w
    return y.to(x.dtype)
