"""Carry a parameter tree from the JAX package into the port.

The JAX package initialises a transformer as a nested dict of arrays whose
``blocks`` leaves are stacked over layers (``(L, ...)``, for its
``lax.scan``); the port keeps one dict per layer.  :func:`params_from_numpy`
takes the JAX tree *as numpy arrays* (``jax.tree.map(np.asarray, params)``
on the JAX side — the port never imports JAX) and returns the port's tree
on ``device``, leaf for leaf, so both packages compute the same function.
:func:`cache_from_numpy` does the same for a KV cache, whose leaves both
packages keep layer-stacked, (L, B, Hkv, S, hd).

Like ``disc_torch.compile``, both functions put their tensors on the card
unless the caller passes ``device="cpu"``, and raise
:class:`~repro_torch.errors.NoDeviceError` when asked for a card that is
not there.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..api.options import resolve_device
from .common import ArchConfig

__all__ = ["params_from_numpy", "cache_from_numpy", "tensor_from_numpy"]


def tensor_from_numpy(a: Any, device="cuda") -> torch.Tensor:
    """A tensor on ``device`` with ``a``'s values and dtype; bfloat16
    arrays (numpy has no such dtype of its own; JAX hands them out as a
    2-byte extension type) are reinterpreted bit for bit."""
    device = resolve_device(device)
    a = np.array(a)  # an owned, writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree(x: Any, device, index=None):
    if isinstance(x, dict):
        return {k: _tree(v, device, index) for k, v in x.items()}
    arr = np.asarray(x) if index is None else np.asarray(x)[index]
    return tensor_from_numpy(arr, device)


def params_from_numpy(np_tree: Dict[str, Any], cfg: ArchConfig,
                      device="cuda") -> Dict[str, Any]:
    """The JAX package's transformer parameter tree → the port's tree, on
    ``device``."""
    device = resolve_device(device)
    out: Dict[str, Any] = {}
    for k, v in np_tree.items():
        if k == "blocks":
            out[k] = [_tree(v, device, i) for i in range(cfg.n_layers)]
        else:
            out[k] = _tree(v, device)
    return out


def cache_from_numpy(np_tree: Dict[str, Any], device="cuda"
                     ) -> Dict[str, torch.Tensor]:
    """The JAX package's KV cache (``{"k", "v"}`` of layer-stacked
    (L, B, Hkv, S, hd) leaves, as numpy) → the port's, on ``device``."""
    device = resolve_device(device)
    return {k: tensor_from_numpy(v, device) for k, v in np_tree.items()}
