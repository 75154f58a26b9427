"""Plain PyTorch versions of the flash-attention kernel: the JAX package's
``models/layers.py`` ``_sdpa`` (the full (Sq, Sk) score matrix, below
``CHUNK_THRESHOLD``) and ``_sdpa_chunked`` (online softmax over key
chunks, above it), with the reference's switch between them.

Both take a scalar or a per-row (B,) ``q_offset`` (the causal mask is
``k <= q_offset[b] + i``) and an optional per-row ``lens`` (keys
``k >= lens[b]`` are masked).  A row whose every key is masked gives 0,
as the TPU kernel's ``l == 0`` rule does (``kernels/flash_attention/
flash_attention.py:86-90``); on the serve path no row is (key 0 is always
valid there), so this agrees with the reference's ``_sdpa`` wherever it
runs.  The dense form is written with ``dot_general`` so that the DHLO
bridge traces it into the reference's plan.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ...core.primitives import dot_general

__all__ = ["CHUNK_THRESHOLD", "pick_chunk", "q_positions", "sdpa_dense_ref",
           "sdpa_chunked_ref", "sdpa_ref"]

CHUNK_THRESHOLD = 2048  # beyond this, scores are never materialized
_NEG = -1e30


def pick_chunk(s: int, prefer: int = 1024) -> int:
    for c in (prefer, 512, 256, 128, 64, 32, 16, 8, 4, 2, 1):
        if s % c == 0 and c <= s:
            return c
    return 1


def q_positions(sq: int, q_offset, device) -> torch.Tensor:
    """Absolute query positions (1|B, Sq): ``q_offset`` is a scalar or a
    per-row (B,) vector of cache offsets (batched prefill)."""
    if isinstance(q_offset, torch.Tensor) and q_offset.dim() == 1:
        return q_offset[:, None] + torch.arange(sq, device=device)[None, :]
    return (torch.arange(sq, device=device) + q_offset)[None, :]


def _zero_empty_rows(o: torch.Tensor, lens: Optional[torch.Tensor]):
    """Rows of batches with no valid key give 0 (the ``l == 0`` rule)."""
    if lens is None:
        return o
    return torch.where((lens > 0)[:, None, None, None], o, 0.0)


def sdpa_dense_ref(q, k, v, *, causal: bool, lens: Optional[torch.Tensor],
                   q_offset=0) -> torch.Tensor:
    """q (B,H,Sq,hd) x k,v (B,Hkv,Sk,hd) -> (B,H,Sq,hd); f32 softmax over
    the whole (Sq, Sk) score matrix."""
    b, h, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = h // hkv
    qf = q.float() / math.sqrt(hd)
    # grouped contraction without materializing repeated K/V
    qg = qf.reshape(b, hkv, group, sq, hd)
    s = dot_general(qg, k.float(), (((4,), (3,)), ((0, 1), (0, 1))))
    k_idx = torch.arange(sk, device=q.device)[None, None, None, None, :]
    if lens is not None:
        s = torch.where(k_idx < lens[:, None, None, None, None], s, _NEG)
    if causal:
        q_idx = q_positions(sq, q_offset, q.device)[:, None, None, :, None]
        s = torch.where(k_idx <= q_idx, s, _NEG)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m.detach())
    p = e / e.sum(-1, keepdim=True)
    o = dot_general(p, v.float(), (((4,), (2,)), ((0, 1), (0, 1))))
    o = _zero_empty_rows(o.reshape(b, h, sq, v.shape[-1]), lens)
    return o.to(q.dtype)


def sdpa_chunked_ref(q, k, v, *, causal: bool, lens, q_offset,
                     scale: Optional[float] = None) -> torch.Tensor:
    """FlashAttention-style online softmax over (query chunk, key chunk)
    pairs, for shapes whose full (Sq, Sk) score matrix must never exist.
    q (B,H,Sq,hd) x k,v (B,Hkv,Sk,hd) -> (B,H,Sq,dv)."""
    b, h, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    group = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qc, kc = pick_chunk(sq), pick_chunk(sk)
    nq, nk = sq // qc, sk // kc
    qf = (q.float() * scale).reshape(b, hkv, group, nq, qc, hd)
    kf, vf = k.float(), v.float()
    lens_b = None if lens is None else lens[:, None, None, None, None]
    dev = q.device
    outs = []
    for iq in range(nq):
        qi = qf[:, :, :, iq]
        q_idx = (q_positions(qc, q_offset, dev) + iq * qc)[
            :, None, None, :, None]
        m = torch.full((b, hkv, group, qc, 1), _NEG, device=dev)
        l = torch.zeros((b, hkv, group, qc, 1), device=dev)
        acc = torch.zeros((b, hkv, group, qc, dv), device=dev)
        for ik in range(nk):
            ki = kf[:, :, ik * kc:(ik + 1) * kc]
            vi = vf[:, :, ik * kc:(ik + 1) * kc]
            s = torch.einsum("bgnqd,bgkd->bgnqk", qi, ki)
            k_idx = (ik * kc + torch.arange(kc, device=dev))[
                None, None, None, None, :]
            if lens_b is not None:
                s = torch.where(k_idx < lens_b, s, _NEG)
            if causal:
                s = torch.where(k_idx <= q_idx, s, _NEG)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bgnqk,bgkd->bgnqd", p, vi)
            m = m_new
        l = torch.where(l == 0.0, 1.0, l)
        outs.append(acc / l)
    out = torch.stack(outs, dim=3).reshape(b, h, sq, dv)
    return _zero_empty_rows(out, lens).to(q.dtype)


def sdpa_ref(q, k, v, *, causal: bool, lens: Optional[torch.Tensor],
             q_offset=0) -> torch.Tensor:
    """The reference's ``_sdpa``: the dense form, or the chunked one for
    long queries or very long caches."""
    sq, sk = q.shape[2], k.shape[2]
    if sq >= CHUNK_THRESHOLD or sk > 4 * CHUNK_THRESHOLD:
        return sdpa_chunked_ref(q, k, v, causal=causal, lens=lens,
                                q_offset=q_offset)
    return sdpa_dense_ref(q, k, v, causal=causal, lens=lens,
                          q_offset=q_offset)
