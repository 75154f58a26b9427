"""Plain PyTorch versions of the Mamba-2 SSD scan.

Per (batch row b, head h), with the state h_t (N x P, f32):

    h_t = a_t h_{t-1} + b_t x_t^T        (a_t in (0, 1), one per head)
    y_t = c_t^T h_t

x (B, H, T, P) and the decay a (B, H, T) are per head; b and c (B, T, N)
are shared by every head of a row, as the model's are.  Inputs are
widened to f32, as the reference widens them before its SSD
(``models/layers.py`` ``mamba2_apply``), and y comes out in f32.  Both
versions are extended as the kernel is: an optional initial state
``s0`` (B, H, N, P) and per-row ``lens``, and the final state returned.
Steps ``t >= lens[b]`` leave row b's state alone and give ``y = 0`` (the
reference's padding rule: identity decay, zero input).

* :func:`mamba2_ref` mirrors the JAX package's sequential oracle
  (``kernels/mamba2/ref.py``): a loop over T.  The CPU tests hold the
  other versions to it.
* :func:`mamba2_chunked` is the chunk-parallel form the kernel computes
  (the TPU kernel's and ``models/layers.py`` ``_ssd_chunked``'s), in
  exact f32: unlike ``_ssd_chunked`` it keeps the carried per-chunk
  states in f32.  The wrapper takes it on the CPU and inside
  ``plain_versions()``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["CHUNK", "mamba2_ref", "mamba2_chunked"]

#: steps per chunk, the kernel's as well
CHUNK = 64


def _valid(t: int, lens: Optional[torch.Tensor], device):
    """(B, T) mask of the steps each row takes, or None (all)."""
    if lens is None:
        return None
    return torch.arange(t, device=device)[None, :] < lens.to(device)[:, None]


def mamba2_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor, s0: Optional[torch.Tensor] = None,
               lens: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential form: x (B, H, T, P), a (B, H, T), b, c (B, T, N),
    s0 (B, H, N, P) or None.  Returns ``(y (B, H, T, P) f32, s (B, H, N,
    P) f32)``."""
    bs, h, t, p = x.shape
    n = b.shape[-1]
    s = (torch.zeros((bs, h, n, p), dtype=torch.float32, device=x.device)
         if s0 is None else s0.float())
    valid = _valid(t, lens, x.device)
    ys = []
    for i in range(t):
        bx = b[:, None, i, :, None].float() * x[:, :, i, None, :].float()
        s_new = a[:, :, i, None, None].float() * s + bx
        yt = torch.einsum("bn,bhnp->bhp", c[:, i].float(), s_new)
        if valid is not None:
            keep = valid[:, i].reshape(bs, 1, 1)
            yt = torch.where(keep, yt, 0.0)
            s_new = torch.where(keep[..., None], s_new, s)
        s = s_new
        ys.append(yt)
    y = (torch.stack(ys, dim=2) if ys else
         torch.zeros((bs, h, 0, p), dtype=torch.float32, device=x.device))
    return y, s


def mamba2_chunked(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, s0: Optional[torch.Tensor] = None,
                   lens: Optional[torch.Tensor] = None, *,
                   chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunk-parallel form, chunks of ``chunk`` steps from step 0 (a
    ragged last chunk, and every step past ``lens[b]``, runs as identity
    decay and zero input).  Per chunk, with ``cum`` the cumulative
    log-decay and ``g = exp(cum)``:

        y = (L o C B^T) X + diag(g) C h_prev,  L[t, s] = exp(cum_t - cum_s)
        h = g_last h_prev + (B o exp(cum_last - cum))^T X

    Same arguments and results as :func:`mamba2_ref`."""
    bs, h, t, p = x.shape
    n = b.shape[-1]
    dev = x.device
    xf, bf, cf = x.float(), b.float(), c.float()
    la = torch.log(a.float().clamp(min=1e-37))
    valid = _valid(t, lens, dev)
    if valid is not None:
        la = torch.where(valid[:, None], la, 0.0)
        xf = torch.where(valid[:, None, :, None], xf, 0.0)
        bf = torch.where(valid[..., None], bf, 0.0)
    pad = (-t) % chunk
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, pad))
        la = torch.nn.functional.pad(la, (0, pad))
        bf = torch.nn.functional.pad(bf, (0, 0, 0, pad))
        cf = torch.nn.functional.pad(cf, (0, 0, 0, pad))
    nc = (t + pad) // chunk
    xs = xf.reshape(bs, h, nc, chunk, p)
    bc = bf.reshape(bs, nc, chunk, n)
    cc = cf.reshape(bs, nc, chunk, n)
    cum = torch.cumsum(la.reshape(bs, h, nc, chunk), dim=-1)
    g = torch.exp(cum)
    tt = torch.arange(chunk, device=dev)
    causal = tt[:, None] >= tt[None, :]
    decay = torch.where(causal, torch.exp(cum[..., :, None]
                                          - cum[..., None, :]), 0.0)
    scores = torch.einsum("bctn,bcsn->bcts", cc, bc)[:, None] * decay
    y_intra = scores @ xs                                # (B,H,nc,L,P)
    de = torch.exp(cum[..., -1:] - cum)                  # (B,H,nc,L)
    bx = torch.einsum("bhcsn,bhcsp->bhcnp", bc[:, None] * de[..., None], xs)
    g_last = g[..., -1]                                  # (B,H,nc)
    state = (torch.zeros((bs, h, n, p), dtype=torch.float32, device=dev)
             if s0 is None else s0.float())
    prevs = []
    for i in range(nc):
        prevs.append(state)
        state = g_last[:, :, i, None, None] * state + bx[:, :, i]
    h_prev = (torch.stack(prevs, dim=2) if prevs else
              torch.zeros((bs, h, 0, n, p), dtype=torch.float32, device=dev))
    y_inter = g[..., None] * torch.einsum("bctn,bhcnp->bhctp", cc, h_prev)
    y = (y_inter + y_intra).reshape(bs, h, nc * chunk, p)[:, :, :t]
    if valid is not None:
        y = torch.where(valid[:, None, :, None], y, 0.0)
    return y, state
