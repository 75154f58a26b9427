"""Shared builders for the port's parity tests (not collected by pytest).

Both packages get the same narrow TinyLlama configuration, and the port
gets the JAX package's own initialised weights through numpy, so the two
stacks compute the same function.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as ref_config
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch.configs import get_config as port_config
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_numpy

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


def build_pair(dtype: str = "f32", n_layers: int = 2, seed: int = 0):
    """(ref cfg, ref fn, port cfg, port fn) sharing one set of weights."""
    rcfg, pcfg = narrow_configs(dtype, n_layers)
    rparams = RT.init(rcfg, jax.random.PRNGKey(seed))
    pparams = params_from_numpy(jax.tree.map(np.asarray, rparams), pcfg)

    def port_fn(x):
        return PT.decoder_logits(pcfg, pparams, x)

    return rcfg, ref_stack(rcfg, rparams), pcfg, port_fn
