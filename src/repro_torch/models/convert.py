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

The other way, :func:`params_to_numpy` gives the port's tree back in the
JAX package's layout (each per-layer list stacked into ``(L, ...)``
leaves), as numpy; a bfloat16 tensor goes out as the 2-byte void type
(``V2``) that numpy stores the JAX package's bfloat16 leaves as.
:func:`train_state_to_numpy` / :func:`train_state_from_numpy` carry a
whole train state (``params``, ``opt.{step, mu, nu}``, ``residual``) the
same way, so either package's state converts into the other's.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..api.options import resolve_device
from .common import ArchConfig

__all__ = ["params_from_numpy", "cache_from_numpy", "tensor_from_numpy",
           "tensor_to_numpy", "tree_to_numpy", "params_to_numpy",
           "train_state_to_numpy", "train_state_from_numpy", "is_bf16_bits"]


def _depths(cfg: ArchConfig) -> Dict[str, int]:
    """The layer-stacked subtrees of a parameter tree, and their depths."""
    return {"blocks": cfg.n_layers, "decoder": cfg.n_layers,
            "encoder": cfg.n_encoder_layers}


def is_bf16_bits(a: np.ndarray) -> bool:
    """True for an array of bfloat16 values: JAX's 2-byte extension type,
    or the 2-byte void type numpy saves it as (``.npz`` leaves)."""
    return a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2")


def tensor_from_numpy(a: Any, device="cuda") -> torch.Tensor:
    """A tensor on ``device`` with ``a``'s values and dtype; bfloat16
    arrays (numpy has no such dtype of its own; JAX hands them out as a
    2-byte extension type, and ``np.savez`` stores them as 2-byte voids)
    are reinterpreted bit for bit."""
    device = resolve_device(device)
    a = np.array(a)  # an owned, writable, contiguous copy
    if is_bf16_bits(a):
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
    stacks = _depths(cfg)
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


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """``t``'s values as a numpy array on the host; bfloat16 as the 2-byte
    void type (its bits), which is how ``np.savez`` stores the JAX
    package's bfloat16 leaves."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def tree_to_numpy(tree: Any) -> Any:
    """A port tree in the JAX package's layout, as numpy: dicts and
    NamedTuples kept, a list of per-layer dicts stacked leaf by leaf into
    one dict of ``(L, ...)`` arrays, every tensor through
    :func:`tensor_to_numpy`."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_to_numpy(v) for v in tree))
    if isinstance(tree, list) and tree and isinstance(tree[0], dict):
        layers = [tree_to_numpy(v) for v in tree]
        return _stack(layers)
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tensor_to_numpy(tree)
    return tree


def _stack(layers: list) -> Any:
    if isinstance(layers[0], dict):
        return {k: _stack([lay[k] for lay in layers]) for k in layers[0]}
    return np.stack(layers)


def params_to_numpy(params: Dict[str, Any], cfg: ArchConfig
                    ) -> Dict[str, Any]:
    """The inverse of :func:`params_from_numpy`: the port's tree → the JAX
    package's, as numpy (``blocks`` / ``encoder`` / ``decoder`` stacked
    over their layers; bfloat16 as ``V2``)."""
    depth = _depths(cfg)
    for k in depth:
        if k in params and len(params[k]) != depth[k]:
            raise ValueError(f"params[{k!r}] holds {len(params[k])} layers, "
                             f"the config {depth[k]}")
    return tree_to_numpy(params)


def train_state_to_numpy(state: Any, cfg: ArchConfig) -> Any:
    """A train state of the port → the same NamedTuple of numpy trees in
    the JAX package's layout (``params``, ``opt.{step, mu, nu}``,
    ``residual``), ready for either package's ``save_checkpoint``."""
    opt = state.opt
    return type(state)(
        params=params_to_numpy(state.params, cfg),
        opt=type(opt)(step=tensor_to_numpy(opt.step),
                      mu=params_to_numpy(opt.mu, cfg),
                      nu=params_to_numpy(opt.nu, cfg)),
        residual=(() if not state.residual
                  else params_to_numpy(state.residual, cfg)))


def train_state_from_numpy(np_state: Any, cfg: ArchConfig, device="cuda"):
    """A train state as numpy in the JAX package's layout (the reference's
    ``TrainState`` through ``jax.tree.map(np.asarray, ...)``, or
    :func:`train_state_to_numpy`'s) → the port's ``TrainState`` on
    ``device``."""
    from ..optim.adamw import OptState
    from ..train.step import TrainState

    device = resolve_device(device)
    opt = np_state.opt
    residual = np_state.residual
    return TrainState(
        params=params_from_numpy(np_state.params, cfg, device),
        opt=OptState(step=tensor_from_numpy(opt.step, device),
                     mu=params_from_numpy(opt.mu, cfg, device),
                     nu=params_from_numpy(opt.nu, cfg, device)),
        residual=(() if not residual
                  else params_from_numpy(residual, cfg, device)))
