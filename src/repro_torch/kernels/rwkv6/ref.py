"""Plain PyTorch version of the RWKV-6 WKV recurrence.

The mirror of the JAX package's ``kernels/rwkv6/ref.py`` ``rwkv6_ref``,
vectorised over (B, H) with a loop over T, extended as the kernel is: an
optional initial state ``s0`` and per-row ``lens``, and the final state
returned.  Per step, in f32:

    kv  = k_t v_t^T     (formed in the input type: exact in f32; in bf16
                         this is the rounding the model's decode step
                         applies, models/layers.py rwkv6_apply)
    y_t = r_t . (S + u kv)
    S  <- w_t S + kv

Steps ``t >= lens[b]`` leave row b's state alone and give ``y = 0``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["rwkv6_ref"]


def rwkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              s0: Optional[torch.Tensor] = None,
              lens: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, w (B, H, T, K); v (B, H, T, V); u (H, K); s0 (B, H, K, V)
    or None.  Returns ``(y (B, H, T, V) in r's dtype, s (B, H, K, V)
    f32)``."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    s = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    uf = u.float()[None, :, :, None]
    ys = []
    for i in range(t):
        kv = (k[:, :, i, :, None] * v[:, :, i, None, :]).float()
        yt = torch.einsum("bhk,bhkv->bhv", r[:, :, i].float(), s + uf * kv)
        s_new = w[:, :, i, :, None].float() * s + kv
        if lens is not None:
            keep = (i < lens).reshape(b, 1, 1)
            yt = torch.where(keep, yt, 0.0)
            s_new = torch.where(keep[..., None], s_new, s)
        s = s_new
        ys.append(yt)
    y = (torch.stack(ys, dim=2) if ys else
         torch.zeros((b, h, 0, dv), dtype=torch.float32, device=r.device))
    return y.to(r.dtype), s
