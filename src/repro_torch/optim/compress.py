"""Gradient compression for the data-parallel reduce, the JAX package's
``optim/compress.py``.

Two composable stages, both with error feedback:
  * dtype compression: f32 -> bf16 on the wire (2x collective bytes)
  * top-k sparsification (per-tensor magnitude top-k), optional: per
    tensor of the reference's layout, whose layer-stacked leaves hold
    every layer of the port's per-layer lists

Off by default; enabled by ``TrainConfig.grad_compression``.  The error-
feedback residual is carried in the train state so that compression is
unbiased over time (Karimireddy et al., 2019).
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch.utils import _pytree

__all__ = ["compress_grads", "decompress_grads"]

#: tensors of at most this many elements skip top-k
TOPK_MIN_SIZE = 64


def _group(gs: List[torch.Tensor], rs: List[torch.Tensor],
           topk_frac: Optional[float]):
    """One reference leaf, given as its layers' tensors: the top-k
    threshold is taken over all of them together, as over the
    reference's ``(L, ...)`` leaf."""
    gfs = [g.float() + r for g, r in zip(gs, rs)]
    n = sum(gf.numel() for gf in gfs)
    if topk_frac is not None and n > TOPK_MIN_SIZE:
        k = max(int(n * topk_frac), 1)
        flat = torch.cat([gf.reshape(-1) for gf in gfs])
        thresh = torch.topk(flat.abs(), k).values[-1]
        wires = [torch.where(gf.abs() >= thresh, gf, 0.0).to(torch.bfloat16)
                 for gf in gfs]
    else:
        wires = [gf.to(torch.bfloat16) for gf in gfs]
    return wires, [gf - w.float() for gf, w in zip(gfs, wires)]


def _layers(gs: list, rs: list, topk_frac: Optional[float]):
    """The same subtree of every layer of a per-layer list, compressed
    leaf by leaf; returns the lists of wire and residual subtrees."""
    if isinstance(gs[0], dict):
        parts = {k: _layers([g[k] for g in gs], [r[k] for r in rs],
                            topk_frac) for k in gs[0]}
        return ([{k: parts[k][0][i] for k in parts} for i in range(len(gs))],
                [{k: parts[k][1][i] for k in parts} for i in range(len(gs))])
    return _group(gs, rs, topk_frac)


def _compress(g, r, topk_frac: Optional[float]):
    if isinstance(g, dict):
        parts = {k: _compress(g[k], r[k], topk_frac) for k in g}
        return ({k: v[0] for k, v in parts.items()},
                {k: v[1] for k, v in parts.items()})
    if isinstance(g, list) and g and isinstance(g[0], dict):
        return _layers(g, r, topk_frac)
    if isinstance(g, (list, tuple)):
        parts = [_compress(a, b, topk_frac) for a, b in zip(g, r)]
        return type(g)(p[0] for p in parts), type(g)(p[1] for p in parts)
    (wire,), (res,) = _group([g], [r], topk_frac)
    return wire, res


def compress_grads(grads, residual=None, *,
                   topk_frac: Optional[float] = None):
    """Returns ``(wire_grads, new_residual)``: bf16 wire tensors and the
    f32 error each leaves behind (``residual`` None: zeros).  Top-k is
    per reference leaf: a per-layer list's tensors (``blocks``) share
    one threshold, as the layers of the reference's stacked leaf do."""
    if residual is None:
        residual = _pytree.tree_map(
            lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device), grads)
    return _compress(grads, residual, topk_frac)


def decompress_grads(wire):
    return _pytree.tree_map(lambda w: w.float(), wire)
