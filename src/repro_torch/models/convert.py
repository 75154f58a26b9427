"""Carry a parameter tree from the JAX package into the port.

The JAX package initialises a transformer as a nested dict of arrays whose
``blocks`` leaves are stacked over layers (``(L, ...)``, for its
``lax.scan``); the port keeps one dict per layer.  :func:`params_from_numpy`
takes the JAX tree *as numpy arrays* (``jax.tree.map(np.asarray, params)``
on the JAX side — the port never imports JAX) and returns the port's tree
on ``device``, leaf for leaf, so both packages compute the same function.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .common import ArchConfig

__all__ = ["params_from_numpy", "tensor_from_numpy"]


def tensor_from_numpy(a: Any, device="cpu") -> torch.Tensor:
    """A tensor with ``a``'s values and dtype; bfloat16 arrays (numpy has
    no such dtype of its own; JAX hands them out as a 2-byte extension
    type) are reinterpreted bit for bit."""
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
                      device="cpu") -> Dict[str, Any]:
    """The JAX package's transformer parameter tree → the port's tree."""
    out: Dict[str, Any] = {}
    for k, v in np_tree.items():
        if k == "blocks":
            out[k] = [_tree(v, device, i) for i in range(cfg.n_layers)]
        else:
            out[k] = _tree(v, device)
    return out
