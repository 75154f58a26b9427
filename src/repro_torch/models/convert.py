"""Carry a parameter tree from the JAX package into the port.

The JAX package initialises a model as a nested dict of arrays whose
``blocks`` leaves (whisper's: ``encoder`` and ``decoder``) are stacked
over layers (``(L, ...)``, for its ``lax.scan``); the port keeps one
dict per layer, leaf for leaf and in the JAX dtypes (a MoE block's ``ffn`` carries its f32 ``router`` (D, E),
the expert stacks ``w_in``/``w_gate`` (E, D, F) and ``w_out`` (E, F, D)
and, where the config has them, the ``shared`` experts).  Every other subtree
(Zamba2's ``shared_attn``, ``shared_ln`` and its ``lora`` factors,
stacked over invocations as the port keeps them too) carries over leaf
for leaf.  :func:`params_from_numpy` takes the JAX tree *as numpy arrays* (``jax.tree.map(np.asarray, params)``
on the JAX side — the port never imports JAX) and returns the port's tree
on ``device``, leaf for leaf, so both packages compute the same function.
:func:`cache_from_numpy` does the same for a cache, whose leaves both
packages keep layer-stacked: the dense KV cache ``{"k", "v"}`` of
(L, B, Hkv, S, hd) leaves, MLA's latent cache ``{"kv_c", "k_pe"}`` of
(L, B, S, kv_lora) and (L, B, S, rope) leaves, RWKV's nested state
``{"tmix": {"s", "x_prev"}, "cmix_x"}``, or Zamba2's ``{"mamba": {"h"},
"attn": {"k", "v"}}``.

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
    """The JAX package's parameter tree → the port's tree, on
    ``device``."""
    device = resolve_device(device)
    out: Dict[str, Any] = {}
    stacks = {"blocks": cfg.n_layers, "decoder": cfg.n_layers,
              "encoder": cfg.n_encoder_layers}
    for k, v in np_tree.items():
        if k in stacks:
            out[k] = [_tree(v, device, i) for i in range(stacks[k])]
        else:
            out[k] = _tree(v, device)
    return out


def cache_from_numpy(np_tree: Dict[str, Any], device="cuda"
                     ) -> Dict[str, Any]:
    """The JAX package's cache (a tree of layer-stacked leaves, as numpy)
    → the port's, on ``device``, leaf for leaf and nesting kept."""
    device = resolve_device(device)
    return _tree(np_tree, device)
