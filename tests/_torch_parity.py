"""Shared builders for the port's parity tests (not collected by pytest).

Both packages get the same narrow TinyLlama configuration, and the port
gets the JAX package's own initialised weights through numpy (on the CPU),
so the two stacks compute the same function.  Two compositions of the
layer functions: the model's own batch-major stack (hidden states
(1, S, D)), and a token-major one (x (T, D), the residual stream kept 2-D)
whose MLP projections are plain 2-D dots, so its plan forms kDot clusters.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_config
from repro.models.registry import get_model as ref_model
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch.configs import get_config as port_config
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import get_model as port_model

NARROW = dict(d_model=256, n_heads=8, n_kv_heads=2, d_ff=704, vocab=512)


def narrow_configs(dtype: str = "f32", n_layers: int = 2):
    """TinyLlama-1.1B's config cut to narrow widths, in both packages."""
    kw = dict(NARROW, n_layers=n_layers, dtype=dtype)
    return (dataclasses.replace(ref_config("tinyllama_11b"), **kw),
            dataclasses.replace(port_config("tinyllama_11b"), **kw))


def ref_stack(cfg, params):
    """The JAX package's decoder stack, layers unrolled: hidden states →
    logits (the embedding lookup stays outside the compiled region)."""
    blocks = [jax.tree.map(lambda a, i=i: a[i], params["blocks"])
              for i in range(cfg.n_layers)]

    def fn(x):
        positions = jnp.arange(x.shape[1])[None, :]
        for bp in blocks:
            x, _ = RT.block_apply(cfg, bp, x, positions=positions, lens=None)
        x = RL.norm_apply(cfg, params["ln_f"], x)
        return RT.logits_from_hidden(cfg, params, x)

    return fn


@functools.lru_cache(maxsize=None)
def reduced_tinyllama() -> dict:
    """The JAX package's reduced TinyLlama initialised from seed 0, and
    the port's model over the same weights carried through numpy: built
    once a process for the observability and fault twins, which only
    read it."""
    rcfg = ref_config("tinyllama_11b").reduced()
    rmodel = ref_model(rcfg)
    # one compiled init, not one dispatch an op (a few seconds less)
    rparams = jax.jit(rmodel.init)(jax.random.PRNGKey(0))
    pcfg = dataclasses.replace(
        port_config("tinyllama_11b"),
        **{f.name: getattr(rcfg, f.name)
           for f in dataclasses.fields(port_config("tinyllama_11b"))})
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), pcfg,
                               device="cpu")
    return dict(cfg=pcfg, model=port_model(pcfg), params=params,
                jmodel=rmodel, jparams=rparams)


def build_pair(dtype: str = "f32", n_layers: int = 2, seed: int = 0):
    """(ref cfg, ref fn, port cfg, port fn) sharing one set of weights."""
    rcfg, pcfg = narrow_configs(dtype, n_layers)
    rparams = RT.init(rcfg, jax.random.PRNGKey(seed))
    pparams = params_from_numpy(jax.tree.map(np.asarray, rparams), pcfg,
                                device="cpu")

    def port_fn(x):
        return PT.decoder_logits(pcfg, pparams, x)

    return rcfg, ref_stack(rcfg, rparams), pcfg, port_fn


def ref_token_major(cfg, params):
    """The JAX package's layer functions over a token-major residual
    stream: x (T, D) → logits (T, V)."""
    blocks = [jax.tree.map(lambda a, i=i: a[i], params["blocks"])
              for i in range(cfg.n_layers)]

    def fn(x):
        pos = jnp.arange(x.shape[0])[None, :]
        for bp in blocks:
            h = RL.norm_apply(cfg, bp["ln1"], x)
            a, _ = RL.attn_apply(cfg, bp["attn"], h[None], positions=pos)
            x = x + a[0]
            x = x + RL.mlp_apply(cfg, bp["ffn"],
                                 RL.norm_apply(cfg, bp["ln2"], x))
        return RT.logits_from_hidden(cfg, params,
                                     RL.norm_apply(cfg, params["ln_f"], x))

    return fn


def port_token_major(cfg, params):
    """The port's counterpart of :func:`ref_token_major` (the function
    ``chip_smoke.py`` serves on its second path)."""
    def fn(x):
        pos = torch.arange(x.shape[0], dtype=torch.int32,
                           device=x.device)[None, :]
        for bp in params["blocks"]:
            h = PL.norm_apply(cfg, bp["ln1"], x)
            a, _ = PL.attn_apply(cfg, bp["attn"], h[None], positions=pos)
            x = x + a[0]
            x = x + PL.mlp_apply(cfg, bp["ffn"],
                                 PL.norm_apply(cfg, bp["ln2"], x))
        return PT.logits_from_hidden(cfg, params,
                                     PL.norm_apply(cfg, params["ln_f"], x))

    return fn


def build_token_major_pair(dtype: str = "f32", n_layers: int = 2,
                           seed: int = 0):
    """(ref cfg, ref fn, port cfg, port fn) of the token-major stack,
    sharing one set of weights."""
    rcfg, pcfg = narrow_configs(dtype, n_layers)
    rparams = RT.init(rcfg, jax.random.PRNGKey(seed))
    pparams = params_from_numpy(jax.tree.map(np.asarray, rparams), pcfg,
                                device="cpu")
    return (rcfg, ref_token_major(rcfg, rparams), pcfg,
            port_token_major(pcfg, pparams))
