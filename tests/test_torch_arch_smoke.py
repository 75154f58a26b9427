"""The port's twin of ``tests/test_arch_smoke.py``: every ported
architecture at its reduced config on the CPU.

* **Forward** of each of the ten ported architectures (every one of the
  JAX package's): the JAX package's weights,
  carried across by ``params_from_numpy``, and the same numpy batch
  (llava with its image-token prefix, whisper with its frames): logits of
  shape (B, S [+ max_image_tokens], vocab), finite, and within 1e-5 of
  the JAX model's (the same f32 math summed in other orders; for RWKV-6
  and Zamba2 its f32 sequential path, as the test says).
* **Decode step** of tinyllama, rwkv6, zamba2, whisper and deepseek_v2
  from a zero cache at per-row fills (whisper with its encoder's
  output): logits (B, 1, vocab), finite and within 1e-5 of the JAX
  model's, and the cache's tree structure kept.  DeepSeek-V2's port
  decodes absorbed in f32; the reference's absorbed decode rounds to
  bf16 in an f32 model (ROADMAP Queue 3), so there the reference runs
  its expanded decode (``tests/test_torch_mla.py`` holds the two).
* ``ARCH_IDS`` is the JAX package's, ``NOT_PORTED`` is empty, both of
  DeepSeek-V2's names resolve to its MLA config, and the registry serves
  every family.

* **Specs** of all ten architectures: ``model.specs()`` is congruent
  with the parameter tree and no spec is longer than its leaf's rank
  (``test_specs_tree_congruent``), and every leaf's spec equals the
  reference's as a tuple of axis names (a per-layer list's element the
  reference's layer-stacked spec without its leading None), as does
  ``model.cache_specs()`` against the cache tree and the reference's.

``test_train_step_no_nans``'s twin is ``tests/test_torch_train_arch.py``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_config
from repro.models.registry import get_model as jax_model

from repro_torch.configs import ARCH_IDS, NOT_PORTED, get_config
from repro_torch.models import whisper
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import MODEL_FAMILIES, get_model

B, S = 2, 32
TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(arch_id: str):
    """(port config, port model, port params, JAX model, JAX params) at
    the reduced config, the port's weights carried from the JAX init."""
    jcfg = jax_config(arch_id).reduced()
    base = get_config(arch_id)
    cfg = dataclasses.replace(base, **{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(base)})
    assert cfg == base.reduced()
    jm = jax_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    return cfg, get_model(cfg), params, jm, jp


def _batch(cfg, rng):
    """``tests/test_arch_smoke.py``'s batch, as numpy."""
    batch = {"tokens": rng.randint(0, cfg.vocab, size=(B, S))
             .astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.randn(B, cfg.encoder_len, cfg.d_model) \
            .astype(np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.randn(
            B, cfg.max_image_tokens, cfg.d_model).astype(np.float32)
    return batch


def _port_batch(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in batch.items()}


def test_port_covers_every_architecture():
    assert sorted(ARCH_IDS) == sorted(JAX_ARCH_IDS)
    assert NOT_PORTED == {}
    assert {"encdec", "vlm", "moe"} <= set(MODEL_FAMILIES)
    assert {get_config(a).family for a in ARCH_IDS} <= set(MODEL_FAMILIES)


@pytest.mark.parametrize("arch_id", ["deepseek_v2_236b", "deepseek-v2-236b"])
def test_deepseek_is_ported(arch_id):
    cfg = get_config(arch_id)
    assert cfg is get_config("deepseek_v2_236b")
    assert (cfg.name, cfg.mla_kv_lora, cfg.mla_rope_dim) == (
        "deepseek-v2-236b", 512, 64)
    jcfg = jax_config(arch_id)
    assert all(getattr(cfg, f.name) == getattr(jcfg, f.name)
               for f in dataclasses.fields(cfg))


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_forward_shapes_and_finite(arch_id):
    cfg, model, params, _, _ = _pair(arch_id)
    batch = _batch(cfg, np.random.RandomState(42))
    logits = model.forward(params, _port_batch(batch))
    s_out = S + (cfg.max_image_tokens if cfg.family == "vlm" else 0)
    assert logits.shape == (B, s_out, cfg.vocab)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_forward_matches_jax(arch_id):
    """At S = 32 the reference's RWKV-6 and Zamba2 forwards take their
    chunked scans, which carry intermediates in bf16 even in an f32
    model (a recorded fault of the reference, ROADMAP Queue 3; twins in
    ``tests/test_torch_rwkv.py`` and ``tests/test_torch_zamba.py``).
    There the port is held to the reference's f32 sequential path: its
    forward over one more token (S = 33 takes that path), whose first 32
    positions see only the 32 tokens."""
    cfg, model, params, jm, jp = _pair(arch_id)
    batch = _batch(cfg, np.random.RandomState(42))
    got = model.forward(params, _port_batch(batch))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    if cfg.family in ("ssm", "hybrid"):
        extra = np.zeros((B, 1), np.int32)
        jbatch["tokens"] = jnp.asarray(
            np.concatenate([batch["tokens"], extra], axis=1))
    want = np.asarray(jm.forward(jp, jbatch))[:, :got.shape[1]]
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("arch_id", ["tinyllama_11b", "rwkv6_3b",
                                     "zamba2_7b", "whisper_tiny",
                                     "deepseek_v2_236b"])
def test_decode_step(arch_id, monkeypatch):
    """``tests/test_arch_smoke.py::TestDecodeSmoke``: one decode step from
    a zero cache at fills 3 and 10."""
    from repro.models import layers as jax_layers
    from repro.models import whisper as jax_whisper

    # the reference's f32 decode (its absorbed one rounds to bf16)
    monkeypatch.setattr(jax_layers, "MLA_ABSORBED_DECODE", False)

    cfg, model, params, jm, jp = _pair(arch_id)
    rng = np.random.RandomState(3)
    max_len = 64
    tokens = rng.randint(0, cfg.vocab, (B, 1)).astype(np.int32)
    lens = np.array([3, 10], np.int32)
    kw, jkw = {}, {}
    if cfg.family == "encdec":
        frames = rng.randn(B, cfg.encoder_len, cfg.d_model).astype(np.float32)
        kw["enc_out"] = whisper.encode(cfg, params, torch.from_numpy(frames))
        jkw["enc_out"] = jax_whisper.encode(jm.cfg, jp, jnp.asarray(frames))
    cache = model.init_cache(B, max_len, "cpu")
    logits, new_cache = model.decode_step(
        params, cache, torch.from_numpy(tokens).long(),
        torch.from_numpy(lens), **kw)
    assert logits.shape == (B, 1, cfg.vocab)
    assert torch.isfinite(logits).all()
    assert torch.utils._pytree.tree_structure(new_cache) == \
        torch.utils._pytree.tree_structure(cache)
    want, _ = jm.decode_step(jp, jm.init_cache(B, max_len),
                             jnp.asarray(tokens), jnp.asarray(lens), **jkw)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)


def _spec_table(tree, stacked: bool = False):
    """``{key path: spec tuple}`` of a spec tree (dicts by key, per-layer
    lists collapsed onto one stacked entry each, whose specs lose their
    leading None where ``stacked`` marks the reference's layout)."""
    from jax.sharding import PartitionSpec as JP

    from repro_torch.dist.profiles import PartitionSpec

    out = {}

    def walk(x, path, in_list):
        if isinstance(x, (JP, PartitionSpec)):
            spec = tuple(x)
            if stacked and in_list:
                assert spec[0] is None, (path, spec)
                spec = spec[1:]
            out.setdefault(path, set()).add(spec)
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, path + (str(k),), in_list)
        elif isinstance(x, list):
            for v in x:
                walk(v, path, True)
        else:
            raise TypeError(f"{path}: {type(x)}")

    walk(tree, (), False)
    return out


def _ref_spec_table(tree, stacked_keys):
    from jax.sharding import PartitionSpec as JP
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, JP))[0]:
        key = tuple(str(getattr(k, "key", k)) for k in path)
        spec = tuple(s)
        if key[0] in stacked_keys:
            assert spec[0] is None, (key, spec)
            spec = spec[1:]
        out[key] = {spec}
    return out


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_specs_tree_congruent(arch_id):
    cfg = get_config(arch_id).reduced()
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "meta")
    specs = model.specs()
    assert torch.utils._pytree.tree_structure(params) == \
        torch.utils._pytree.tree_structure(specs), \
        f"{arch_id}: params/specs trees diverge"
    for p, s in zip(torch.utils._pytree.tree_leaves(params),
                    torch.utils._pytree.tree_leaves(specs)):
        assert len(s) <= p.dim(), f"{arch_id}: spec {s} vs {p.shape}"
    cache = model.init_cache(2, 16, "meta")
    assert torch.utils._pytree.tree_structure(cache) == \
        torch.utils._pytree.tree_structure(model.cache_specs())


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_specs_equal_the_reference(arch_id):
    """Every parameter and cache leaf's logical spec is the reference's,
    as a tuple of axis names."""
    cfg = get_config(arch_id).reduced()
    jm = jax_model(jax_config(arch_id).reduced())
    model = get_model(cfg)
    stacked = {"blocks", "encoder", "decoder"}
    got = _spec_table(model.specs())
    want = _ref_spec_table(jm.specs(), stacked)
    assert got == want, arch_id
    assert _spec_table(model.cache_specs()) == \
        _ref_spec_table(jm.cache_specs(), ())
