"""Shared helpers for the port's training tests (not collected by
pytest): the reduced configs of both packages over one set of weights,
batches as numpy, and trees flattened to the reference's keys."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_numpy, tree_to_numpy
from repro_torch.models.registry import get_model

B, S = 2, 32


def pair(arch_id: str, dtype: str = "f32", **over):
    """(port cfg, port model, port params, JAX cfg, JAX model, JAX params)
    at the reduced config (``over`` replaces fields in both), the port's
    weights carried from the JAX init."""
    jcfg = dataclasses.replace(jax_config(arch_id).reduced(), dtype=dtype,
                               **over)
    base = get_config(arch_id)
    cfg = dataclasses.replace(base, **{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(base)})
    jm = jax_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))  # one compiled init
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    return cfg, get_model(cfg), params, jcfg, jm, jp


def batch(cfg, rng, b: int = B, s: int = S, mask_tail: int = 0):
    """``tests/test_arch_smoke.py``'s training batch, as numpy; the last
    ``mask_tail`` positions of row 0 masked out."""
    out = {"tokens": rng.randint(0, cfg.vocab, size=(b, s)).astype(np.int32),
           "labels": rng.randint(0, cfg.vocab, size=(b, s)).astype(np.int32),
           "mask": np.ones((b, s), np.float32)}
    if mask_tail:
        out["mask"][0, -mask_tail:] = 0.0
    if cfg.family == "encdec":
        out["frames"] = rng.randn(b, cfg.encoder_len, cfg.d_model) \
            .astype(np.float32)
    if cfg.family == "vlm":
        out["image_embeds"] = rng.randn(
            b, cfg.max_image_tokens, cfg.d_model).astype(np.float32)
    return out


def seq_len(cfg) -> int:
    """S = 32, or 33 for the recurrent families, where the reference's
    forward takes its f32 sequential scans (its chunked ones, at S = 32,
    carry intermediates in bf16 even in an f32 model)."""
    return S + 1 if cfg.family in ("ssm", "hybrid") else S


def to_port(batch_np, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in batch_np.items()}


def to_jax(batch_np):
    return {k: jnp.asarray(v) for k, v in batch_np.items()}


def flat(tree, prefix=()):
    """A numpy tree's leaves by the reference's "/"-joined keys."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {"/".join(prefix): np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flat(v, prefix + (str(k),)))
    return out


def port_flat(tree):
    """A port tree (tensors, per-layer lists) in the reference's layout,
    by key, as f32 numpy."""
    return {k: f32(v) for k, v in flat(tree_to_numpy(tree)).items()}


def jax_flat(tree):
    return {k: f32(v) for k, v in flat(jax.tree.map(np.asarray, tree)).items()}


def f32(a) -> np.ndarray:
    """``a`` as f32 numpy (a bfloat16 array, JAX's type or its 2-byte
    void, by its bits)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        bits = a.view(np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32)
    return a.astype(np.float32)


def rel_max(got: np.ndarray, want: np.ndarray) -> float:
    """max|got - want| / max|want| (0 where both are 0)."""
    den = float(np.abs(want).max()) if want.size else 0.0
    num = float(np.abs(got - want).max()) if want.size else 0.0
    return num / den if den else num
