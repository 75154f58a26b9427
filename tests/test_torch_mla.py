"""DeepSeek-V2's multi-head latent attention (MLA) in the port against the
JAX package, on the CPU.

* **Plain attention at MLA's shapes** (``kernels/flash_attention/ref.py``):
  ``sdpa_dense_ref``, ``sdpa_chunked_ref`` and ``sdpa_ref`` with a v head
  dim other than q / k's and an explicit ``scale``, against the
  reference's ``_sdpa_chunked`` (its ``_sdpa`` takes neither), and the
  dense form against the chunked one: the twins of
  ``tests/test_chunked_attention.py`` at dv != d, the ``q_offset`` case
  included.
* **The absorbed decode's plain version** (``mla_decode_ref``) against
  the reference's absorbed einsums (``models/layers.py:402-421``) on the
  same tensors: within 1e-5 of the einsums in f32, and at the
  reference's own tolerance of the einsums as it writes them (``q_abs``,
  the latent and P rounded to bf16).
* **``mla_apply``** against the JAX ``mla_apply`` on the same weights in
  its four modes: no cache; batched prefill against a cache (a row with
  ``lens`` 0 beside non-zero offsets); decode, expanded; decode,
  absorbed.  Within 1e-5 of max|ref| (f32 summed in other orders).  The
  port's absorbed decode stays f32 in an f32 model, where the reference's
  rounds ``q_abs`` and the latent to bf16 (its comment blames XLA:CPU;
  ROADMAP Queue 3): it is held to the reference's expanded decode
  (``MLA_ABSORBED_DECODE = False``) at 1e-5 and to its absorbed decode at
  the reference's tolerance (rtol 2e-2, atol 5e-2,
  ``tests/test_mla_absorbed.py``).
* **Reduced ``deepseek_v2_236b``** (f32, 2 layers, 4 heads of hd 16, rope
  8, latent 32, E = 4 top-2, one shared expert; the JAX parameters
  carried across by ``params_from_numpy``): the twins of
  ``tests/test_mla_absorbed.py`` port against port (decode steps equal
  the forward's logits; absorbed equals expanded) at the drop-free
  capacity_factor 8.0, held to 1e-4 of max|logit|; the port's absorbed
  rollout against the reference's expanded one at 1e-4 of max|logit| and
  against its absorbed one at its own tolerance; and the port's
  ``ServeEngine`` against the JAX one (identical token streams,
  unchunked and chunked).  The launcher refuses the full model before it
  draws a weight.
* **Card cases** (``-k on_card``): the flash-attention kernel's (192,
  128) instance (prefill, a chunk at a ``q_offset``, the expanded decode)
  and its MLA decode form at DeepSeek-V2's full widths, against their
  plain versions on the same card inputs.  They skip here and run on the
  card, where JAX is not installed (``python -m pytest -q
  tests/test_torch_mla.py -k on_card``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import Request
from repro_torch.kernels import select
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import layers as L
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.models.registry import get_model
from repro_torch.serve.engine import ServeConfig, ServeEngine

TOL = 1e-5
# the reference's absorbed decode against its expanded one
# (tests/test_mla_absorbed.py)
REF_ABSORBED = dict(rtol=2e-2, atol=5e-2)


def _close(got, want, tol=TOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: max|d| {err:.3e} > {tol} x " \
                               f"max|ref| {scale:.3e}"


def _i32(a):
    return torch.tensor(np.asarray(a), dtype=torch.int32)


def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


# -------------------------------- plain attention at MLA's shapes (CPU) --

def _qkv(b, h, hkv, sq, sk, d, dv, seed):
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((b, h, sq, d)).astype(np.float32),
            rs.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rs.standard_normal((b, hkv, sk, dv)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hkv", [4, 1])
def test_sdpa_mla_dims_match_reference(causal, hkv):
    """``tests/test_chunked_attention.py::test_chunked_matches_direct`` at
    q/k 24, v 16 and MLA's scale ``1 / sqrt(24)``: the port's dense,
    chunked and switching forms against the reference's
    ``_sdpa_chunked``, and the chunked form against the dense one at the
    twin's tolerance."""
    import jax.numpy as jnp
    from repro.models.layers import _sdpa_chunked

    b, h, s, d, dv = 2, 4, 64, 24, 16
    scale = 1.0 / math.sqrt(d)
    q, k, v = _qkv(b, h, hkv, s, s, d, dv, seed=hkv)
    lens = np.array([s, s // 3], np.int32)
    want = np.asarray(_sdpa_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        lens=jnp.asarray(lens), q_offset=0, scale=scale))
    args = [torch.from_numpy(x) for x in (q, k, v)]
    kw = dict(causal=causal, lens=_i32(lens), q_offset=0, scale=scale)
    dense = fa_ref.sdpa_dense_ref(*args, **kw)
    chunked = fa_ref.sdpa_chunked_ref(*args, **kw)
    assert dense.shape == (b, h, s, dv)
    for got in (dense, chunked, fa_ref.sdpa_ref(*args, **kw),
                fa_ops.flash_attention(*args[:3], _i32(lens), causal=causal,
                                       scale=scale)):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(chunked.numpy(), dense.numpy(), rtol=2e-4,
                               atol=2e-5)


def test_sdpa_mla_dims_with_q_offset():
    """``test_chunked_with_q_offset`` at q/k 24, v 16 and an explicit
    scale: 8 queries at offset 16 against 32 keys, scalar and per-row."""
    import jax.numpy as jnp
    from repro.models.layers import _sdpa_chunked

    q, k, v = _qkv(2, 2, 2, 8, 32, 24, 16, seed=1)
    scale = 0.3
    for off_np, off_t in ((16, 16),
                          (np.array([16, 3], np.int32), _i32([16, 3]))):
        want = np.asarray(_sdpa_chunked(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            lens=None, q_offset=jnp.asarray(off_np), scale=scale))
        args = [torch.from_numpy(x) for x in (q, k, v)]
        dense = fa_ref.sdpa_dense_ref(*args, causal=True, lens=None,
                                      q_offset=off_t, scale=scale)
        chunked = fa_ref.sdpa_chunked_ref(*args, causal=True, lens=None,
                                          q_offset=off_t, scale=scale)
        np.testing.assert_allclose(dense.numpy(), want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(chunked.numpy(), dense.numpy(),
                                   rtol=2e-4, atol=2e-5)


def test_sdpa_default_scale_unchanged():
    """Without ``scale`` (and at dv == d) the dense form is the
    reference's ``_sdpa`` as before."""
    import jax.numpy as jnp
    from repro.models.layers import _sdpa

    q, k, v = _qkv(2, 4, 2, 16, 16, 16, 16, seed=4)
    want = np.asarray(_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True, lens=None))
    got = fa_ref.sdpa_dense_ref(*[torch.from_numpy(x) for x in (q, k, v)],
                                causal=True, lens=None)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


# ------------------------------------ the absorbed decode's plain version --

def _reference_absorbed(q_abs, q_pe, kv_c, k_pe, lens, scale, rounded):
    """The reference's absorbed-decode einsums (``models/layers.py:
    402-421``) on the same tensors; ``rounded``: as it writes them (q_abs,
    the latent and P rounded to bf16), else in f32."""
    import jax
    import jax.numpy as jnp

    lo = jnp.bfloat16 if rounded else jnp.float32
    kvf = jnp.asarray(kv_c).astype(lo)
    s_nope = jnp.einsum("bqhl,bsl->bhqs", jnp.asarray(q_abs).astype(lo),
                        kvf).astype(jnp.float32)
    s_pe = jnp.einsum("bqhd,bsd->bhqs", jnp.asarray(q_pe),
                      jnp.asarray(k_pe))
    sc = (s_nope + s_pe) * scale
    k_idx = jnp.arange(kv_c.shape[1])[None, None, None, :]
    sc = jnp.where(k_idx < jnp.asarray(lens)[:, None, None, None], sc, -1e30)
    prob = jax.nn.softmax(sc, axis=-1)
    return np.asarray(jnp.einsum("bhqs,bsl->bqhl", prob.astype(lo),
                                 kvf).astype(jnp.float32))


def test_mla_decode_ref_matches_reference_einsums():
    rs = np.random.RandomState(8)
    b, h, s, lat, rdim = 3, 4, 40, 32, 8
    q_abs = rs.standard_normal((b, 1, h, lat)).astype(np.float32)
    q_pe = rs.standard_normal((b, 1, h, rdim)).astype(np.float32)
    kv_c = rs.standard_normal((b, s, lat)).astype(np.float32)
    k_pe = rs.standard_normal((b, s, rdim)).astype(np.float32)
    lens = np.array([40, 1, 17], np.int32)
    scale = 1.0 / math.sqrt(24)
    got = fa_ops.mla_decode(*[torch.from_numpy(x)
                              for x in (q_abs, q_pe, kv_c, k_pe)],
                            _i32(lens), scale)
    assert got.shape == (b, 1, h, lat) and fa_ops.LAUNCHES.launches == 0
    _close(got.numpy(), _reference_absorbed(q_abs, q_pe, kv_c, k_pe, lens,
                                            scale, rounded=False))
    np.testing.assert_allclose(
        got.numpy(), _reference_absorbed(q_abs, q_pe, kv_c, k_pe, lens,
                                         scale, rounded=True),
        **REF_ABSORBED)
    empty = fa_ops.mla_decode(*[torch.from_numpy(x)
                                for x in (q_abs, q_pe, kv_c, k_pe)],
                              _i32([0, 3, 0]), scale)
    assert not empty[0].any() and not empty[2].any()  # no valid key: 0


# -------------------------------------------------- mla_apply vs JAX --

def _jax_cfg(**over):
    from repro.configs import get_config as jax_config

    return dataclasses.replace(jax_config("deepseek_v2_236b").reduced(),
                               **over)


def _port_cfg(jcfg):
    base = get_config("deepseek_v2_236b")
    return dataclasses.replace(base, **{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(base)})


@pytest.fixture(scope="module")
def layer():
    import jax
    from repro.models import layers as RL

    jcfg = _jax_cfg()
    jp = RL.mla_init(jax.random.PRNGKey(11), jcfg)
    cfg = _port_cfg(jcfg)
    p = params_from_numpy({"attn": _np_tree(jp)}, cfg, device="cpu")["attn"]
    return jcfg, jp, cfg, p


def _cache(rs, b, lc, cfg):
    return {"kv_c": rs.standard_normal((b, lc, cfg.mla_kv_lora))
            .astype(np.float32),
            "k_pe": rs.standard_normal((b, lc, cfg.mla_rope_dim))
            .astype(np.float32)}


def _both(layer, x, positions, monkeypatch, absorbed, **kw):
    """The port's and the reference's ``mla_apply`` on the same inputs,
    each at its own ``MLA_ABSORBED_DECODE`` = ``absorbed`` (a pair:
    (port, reference))."""
    import jax.numpy as jnp
    from repro.models import layers as RL

    jcfg, jp, cfg, p = layer
    port_abs, ref_abs = absorbed
    monkeypatch.setattr(L, "MLA_ABSORBED_DECODE", port_abs)
    monkeypatch.setattr(RL, "MLA_ABSORBED_DECODE", ref_abs)

    def conv(v, fn):
        if v is None:
            return None
        if isinstance(v, dict):
            return {k: fn(a) for k, a in v.items()}
        return fn(v)

    got, gc = L.mla_apply(cfg, p, torch.from_numpy(x),
                          positions=torch.from_numpy(positions),
                          **{k: conv(v, torch.from_numpy)
                             for k, v in kw.items()})
    want, wc = RL.mla_apply(jcfg, jp, jnp.asarray(x),
                            positions=jnp.asarray(positions),
                            **{k: conv(v, jnp.asarray)
                               for k, v in kw.items()})
    return (got, gc), (np.asarray(want),
                       None if wc is None else _np_tree(wc))


def test_mla_apply_no_cache(layer, monkeypatch):
    """Causal over the sequence, keys ``< lens`` (every row keeps one)."""
    cfg = layer[2]
    rs = np.random.RandomState(0)
    x = rs.standard_normal((3, 16, cfg.d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(16, dtype=np.int32), (3, 16))
    (got, gc), (want, wc) = _both(layer, x, np.ascontiguousarray(positions),
                                  monkeypatch, (True, True),
                                  lens=np.array([16, 9, 4], np.int32))
    assert gc is None and wc is None
    _close(got.numpy(), want, what="no cache")


def test_mla_apply_batched_prefill(layer, monkeypatch):
    """A chunk of 8 against a filled cache of 24 at offsets 0, 5 and 11,
    the middle row with ``lens`` 0 (it writes nothing): outputs and both
    cache leaves."""
    cfg = layer[2]
    rs = np.random.RandomState(1)
    b, s, lc = 3, 8, 24
    x = rs.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    offsets = np.array([0, 5, 11], np.int32)
    lens = np.array([8, 0, 6], np.int32)
    positions = (offsets[:, None] + np.arange(s, dtype=np.int32)[None, :])
    cache = _cache(rs, b, lc, cfg)
    (got, gc), (want, wc) = _both(layer, x, positions, monkeypatch,
                                  (True, True), lens=lens, cache=cache,
                                  offsets=offsets)
    _close(got.numpy(), want, what="batched prefill")
    for k in ("kv_c", "k_pe"):
        _close(gc[k].numpy(), wc[k], what=k)
        assert np.array_equal(gc[k].numpy()[1], cache[k][1])  # lens 0


@pytest.mark.parametrize("mode", ["expanded", "absorbed"])
def test_mla_apply_decode(layer, monkeypatch, mode):
    """One decode step at fills 3, 23 and 0 against a filled cache of 24.
    Expanded: the reference's expanded decode.  Absorbed: the port's f32
    absorbed decode against the reference's expanded decode (1e-5) and
    against its absorbed decode, which rounds to bf16 (its tolerance)."""
    cfg = layer[2]
    rs = np.random.RandomState(2)
    b, lc = 3, 24
    x = rs.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    lens = np.array([3, 23, 0], np.int32)
    cache = _cache(rs, b, lc, cfg)
    absorbed = mode == "absorbed"
    (got, gc), (want, wc) = _both(layer, x, lens[:, None].copy(),
                                  monkeypatch, (absorbed, False),
                                  lens=lens, cache=cache)
    _close(got.numpy(), want, what=f"decode {mode}")
    for k in ("kv_c", "k_pe"):
        _close(gc[k].numpy(), wc[k], what=k)
    if absorbed:
        (got2, _), (want2, _) = _both(layer, x, lens[:, None].copy(),
                                      monkeypatch, (True, True), lens=lens,
                                      cache=cache)
        assert torch.equal(got, got2)
        np.testing.assert_allclose(got2.numpy(), want2, **REF_ABSORBED)


# ------------------------------------------ reduced deepseek_v2_236b --

@pytest.fixture(scope="module")
def deepseek():
    """The reduced DeepSeek-V2 (f32, 2 layers) initialised by the JAX
    package and carried into the port, at the drop-free capacity 8.0."""
    import jax
    from repro.models.registry import get_model as jax_model

    jcfg = _jax_cfg(capacity_factor=8.0)
    jmodel = jax_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = _port_cfg(jcfg)
    return dict(cfg=cfg, model=get_model(cfg), jcfg=jcfg, jmodel=jmodel,
                jparams=jparams,
                params=params_from_numpy(_np_tree(jparams), cfg,
                                         device="cpu"))


def _port_rollout(t, absorbed: bool, monkeypatch):
    """``tests/test_mla_absorbed.py``'s ``_rollout`` on the port: 8 tokens
    decoded one by one from a zero cache, and the forward over them."""
    monkeypatch.setattr(L, "MLA_ABSORBED_DECODE", absorbed)
    model, params = t["model"], t["params"]
    rng = np.random.RandomState(3)
    toks = rng.randint(0, t["cfg"].vocab, (1, 8)).astype(np.int32)
    full = model.forward(params, {"tokens": _i32(toks)})
    cache = model.init_cache(1, 16, "cpu")
    lens = torch.zeros((1,), dtype=torch.int32)
    outs = []
    for i in range(8):
        logits, cache = model.decode_step(params, cache,
                                          _i32(toks[:, i:i + 1]), lens)
        lens = lens + 1
        outs.append(logits[:, 0])
    return torch.stack(outs, dim=1).numpy(), full.numpy()


def _jax_rollout(t, absorbed: bool, monkeypatch):
    import jax.numpy as jnp
    from repro.models import layers as RL

    monkeypatch.setattr(RL, "MLA_ABSORBED_DECODE", absorbed)
    jm, jp = t["jmodel"], t["jparams"]
    rng = np.random.RandomState(3)
    toks = jnp.asarray(rng.randint(0, t["cfg"].vocab, (1, 8)), jnp.int32)
    cache = jm.init_cache(1, 16)
    lens = jnp.zeros((1,), jnp.int32)
    outs = []
    for i in range(8):
        logits, cache = jm.decode_step(jp, cache, toks[:, i:i + 1], lens)
        lens = lens + 1
        outs.append(np.asarray(logits[:, 0]))
    return np.stack(outs, axis=1)


def test_port_decode_matches_prefill(deepseek, monkeypatch):
    """``test_deepseek_decode_matches_prefill``, port against port: the
    absorbed decode steps' logits equal the forward's."""
    dec, full = _port_rollout(deepseek, True, monkeypatch)
    _close(dec, full, tol=1e-4)


def test_port_absorbed_equals_expanded(deepseek, monkeypatch):
    """``test_absorbed_equals_expanded_decode``, port against port."""
    dec_abs, _ = _port_rollout(deepseek, True, monkeypatch)
    dec_exp, _ = _port_rollout(deepseek, False, monkeypatch)
    _close(dec_abs, dec_exp, tol=1e-4)


def test_port_absorbed_rollout_matches_reference(deepseek, monkeypatch):
    """The port's absorbed rollout against the reference's expanded one
    (1e-4 of max|logit|) and its absorbed one (its tolerance)."""
    got, _ = _port_rollout(deepseek, True, monkeypatch)
    _close(got, _jax_rollout(deepseek, False, monkeypatch), tol=1e-4)
    np.testing.assert_allclose(got, _jax_rollout(deepseek, True,
                                                 monkeypatch),
                               **REF_ABSORBED)


def test_deepseek_decode_step_from_jax_cache(deepseek, monkeypatch):
    """One expanded decode step from the reference's warm cache (carried
    by ``cache_from_numpy``): logits and both cache leaves."""
    import jax.numpy as jnp
    from repro.models import layers as RL

    monkeypatch.setattr(L, "MLA_ABSORBED_DECODE", False)
    monkeypatch.setattr(RL, "MLA_ABSORBED_DECODE", False)
    t = deepseek
    jm = t["jmodel"]
    rng = np.random.RandomState(5)
    pre = rng.randint(0, t["cfg"].vocab, size=(3, 7)).astype(np.int32)
    _, jcache = jm.prefill(t["jparams"], jm.init_cache(3, 32),
                           jnp.asarray(pre), jnp.full((3,), 7, jnp.int32),
                           jnp.zeros((3,), jnp.int32))
    toks = np.array([[5], [200], [17]], np.int32)
    fill = np.full((3,), 7, np.int32)
    jl, jc = jm.decode_step(t["jparams"], jcache, jnp.asarray(toks),
                            jnp.asarray(fill))
    cache = cache_from_numpy(_np_tree(jcache), "cpu")
    assert set(cache) == {"kv_c", "k_pe"}
    pl, pc = t["model"].decode_step(t["params"], cache, _i32(toks),
                                    _i32(fill))
    _close(pl.numpy(), np.asarray(jl))
    for k in ("kv_c", "k_pe"):
        _close(pc[k].numpy(), np.asarray(jc[k]), what=k)


def _requests(vocab, lens, max_new=4, cls=Request):
    rng = np.random.RandomState(7)
    return [cls(rid=i, tokens=rng.randint(0, vocab, size=n).astype(np.int32),
                max_new_tokens=max_new) for i, n in enumerate(lens)]


LENS = [5, 9, 14, 40, 33, 12]


@pytest.mark.parametrize("chunk", [None, 8])
def test_deepseek_engine_matches_jax_engine(deepseek, chunk, monkeypatch):
    """Same requests through both packages' engines (the latent cache's
    (L, B, S, 32) / (L, B, S, 8) leaves through the row gathers, gates
    and the decode step's in-place copy): identical token streams and the
    same launch and compile counts.  The port decodes absorbed (in f32);
    the reference expanded, since its absorbed decode rounds to bf16 in
    an f32 model (ROADMAP Queue 3) and parts from both at a near-tie."""
    from repro.data.pipeline import Request as JaxRequest
    from repro.models import layers as RL
    from repro.serve.engine import ServeConfig as JaxConfig
    from repro.serve.engine import ServeEngine as JaxEngine

    monkeypatch.setattr(RL, "MLA_ABSORBED_DECODE", False)
    assert L.MLA_ABSORBED_DECODE
    t = deepseek
    jeng = JaxEngine(t["jmodel"], t["jparams"],
                     JaxConfig(max_batch=4, max_seq=96, prefill_chunk=chunk))
    jeng.submit(_requests(t["cfg"].vocab, LENS, cls=JaxRequest))
    want = jeng.run_until_done(max_steps=500)
    eng = ServeEngine(t["model"], t["params"],
                      ServeConfig(max_batch=4, max_seq=96, device="cpu",
                                  prefill_chunk=chunk))
    assert {k: tuple(v.shape) for k, v in eng.cache.items()} == {
        "kv_c": (2, 4, 96, 32), "k_pe": (2, 4, 96, 8)}
    eng.submit(_requests(t["cfg"].vocab, LENS))
    got = eng.run_until_done(max_steps=500)
    assert got == want
    assert len(got) == len(LENS)
    for key in ("prefill_calls", "decode_steps", "tokens_generated",
                "prefill_bucket_pairs", "prefill_chunks"):
        assert eng.stats[key] == jeng.stats[key], key
    assert eng.compile_counts() == {k: jeng.compile_counts()[k]
                                    for k in ("prefill", "decode")}


def test_launcher_serves_reduced_and_refuses_full(monkeypatch, capsys):
    """``--arch deepseek_v2_236b --reduced --device cpu`` serves (the
    plain versions); on a card the launcher refuses the full model before
    it draws a weight, stating its bytes against the card's memory, and
    takes the reduced one, whose head dims (q/k 24, v 16) and latent (32
    + 8) the kernel is built for, on to drawing its weights."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        HEAD_DIMS, MLA_DIMS)
    from repro_torch.launch import serve as launcher

    red = get_config("deepseek_v2_236b").reduced()
    assert (red.hd + red.mla_rope_dim, red.hd) in HEAD_DIMS
    assert (red.mla_kv_lora, red.mla_rope_dim) in MLA_DIMS

    launcher.main(["--arch", "deepseek_v2_236b", "--reduced", "--device",
                   "cpu", "--requests", "2", "--max-seq", "32",
                   "--max-batch", "2"])
    assert "2/2 requests" in capsys.readouterr().out

    class Props:
        total_memory = 80 * 10 ** 9

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props())

    class Drawn(Exception):
        pass

    class Gen:
        def __init__(self, device):
            pass

        def manual_seed(self, seed):
            return self

    def no_init(*a, **kw):
        raise Drawn

    monkeypatch.setattr(launcher.torch, "Generator", Gen)
    monkeypatch.setattr(launcher, "get_model",
                        lambda cfg: dataclasses.replace(get_model(cfg),
                                                        init=no_init))
    with pytest.raises(SystemExit, match="483.3 GB.*multi-GPU slice"):
        launcher.main(["--arch", "deepseek_v2_236b"])
    with pytest.raises(Drawn):
        launcher.main(["--arch", "deepseek_v2_236b", "--reduced"])


# ------------------------------------------ kernels vs plain (card) --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash-attention kernel's MLA "
                    "forms (CUDA C++) run on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


# kernel vs plain on the card, max|d|/max|ref|: f32 differs by summation
# order; bf16 / f16 by one rounding of the output where sums differ (and,
# in the tensor-core prefill, of P's hi + lo split)
CARD_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3, torch.float16: 8e-3}
DTYPES = [torch.float32, torch.bfloat16, torch.float16]
SCALE = 1.0 / math.sqrt(192)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_prefill_kernel_matches_plain_on_card(cuda, dtype):
    """The (192, 128) instance: a causal prefill, a chunk against a
    longer cache at per-row offsets (a row with ``lens`` 0), and the
    expanded decode (one query row, per-head keys), at 128 heads and
    MLA's scale."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    b, h, sq, sk = 3, 128, 200, 333

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    q = rnd(b, sq, h, 192).transpose(1, 2)  # the path's strided q
    k = rnd(b, sk, h, 192).transpose(1, 2)
    v = rnd(b, sk, h, 128).transpose(1, 2)
    off = torch.tensor([0, 70, 133], dtype=torch.int32, device=cuda)
    lens = torch.tensor([333, 150, 0], dtype=torch.int32, device=cuda)
    dec_lens = torch.tensor([1, 64, 333], dtype=torch.int32, device=cuda)
    cases = ((q, dict(lens=None, causal=True, q_offset=0)),
             (q, dict(lens=lens, causal=True, q_offset=off)),
             (q[:, :, :1], dict(lens=dec_lens, causal=False)))
    for qq, kw in cases:
        before = (fa_ops.LAUNCHES.launches,
                  fa_ops.FORM_LAUNCHES["mla"].launches)
        got = fa_ops.flash_attention(qq, k, v, scale=SCALE, **kw)
        assert (fa_ops.LAUNCHES.launches,
                fa_ops.FORM_LAUNCHES["mla"].launches) == (before[0] + 1,
                                                          before[1] + 1)
        with select.plain_versions():
            want = fa_ops.flash_attention(qq, k, v, scale=SCALE, **kw)
        torch.cuda.synchronize()
        assert got.shape == (b, h, qq.shape[2], 128) and got.dtype == dtype
        assert torch.isfinite(got).all()
        assert _rel(got, want) <= CARD_TOL[dtype], kw
        if kw["lens"] is lens:
            assert not got[2].any()         # fully masked row: 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_decode_kernel_matches_plain_on_card(cuda, dtype):
    """The absorbed decode form at DeepSeek-V2's widths (128 heads, latent
    512, rope 64) over a 2000-row cache whose leaves are layer slices of
    a stacked cache (read in place), at ``lens`` 0, 1, 31, 33, 731 and
    2000; a row with ``lens`` 0 gives 0."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    b, h, sk = 6, 128, 2000

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    q_abs, q_pe = rnd(b, 1, h, 512), rnd(b, 1, h, 64)
    kv_c, k_pe = rnd(2, b, sk, 512)[1], rnd(2, b, sk, 64)[1]
    lens = torch.tensor([0, 1, 31, 33, 731, sk], dtype=torch.int32,
                        device=cuda)
    before = (fa_ops.LAUNCHES.launches,
              fa_ops.FORM_LAUNCHES["mla_decode"].launches)
    got = fa_ops.mla_decode(q_abs, q_pe, kv_c, k_pe, lens, SCALE)
    assert (fa_ops.LAUNCHES.launches,
            fa_ops.FORM_LAUNCHES["mla_decode"].launches) == (
        before[0] + 1, before[1] + 1)
    with select.plain_versions():
        want = fa_ops.mla_decode(q_abs, q_pe, kv_c, k_pe, lens, SCALE)
    torch.cuda.synchronize()
    assert got.shape == (b, 1, h, 512) and got.dtype == dtype
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= CARD_TOL[dtype]
    assert not got[0].any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_reduced_instances_match_plain_on_card(cuda, dtype):
    """The reduced configs' instances: (24, 16) (the q/k row zero-padded
    to the mma's 32 in the tensor-core prefill) in a causal prefill, a
    chunk at per-row offsets and the expanded decode; the MLA decode at
    latent 32 + 8 with 4 heads (one block's 16 heads, 12 past H) and 20
    (a second block with 4)."""
    gen = torch.Generator(device=cuda).manual_seed(2)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    scale = 1.0 / math.sqrt(24)
    b, h, sq, sk = 3, 4, 70, 130
    q = rnd(b, sq, h, 24).transpose(1, 2)
    k, v = rnd(b, h, sk, 24), rnd(b, h, sk, 16)
    off = torch.tensor([0, 33, 60], dtype=torch.int32, device=cuda)
    lens = torch.tensor([130, 64, 0], dtype=torch.int32, device=cuda)
    dec_lens = torch.tensor([1, 65, 130], dtype=torch.int32, device=cuda)
    for qq, kw in ((q, dict(lens=None, causal=True, q_offset=0)),
                   (q, dict(lens=lens, causal=True, q_offset=off)),
                   (q[:, :, :1], dict(lens=dec_lens, causal=False))):
        before = fa_ops.FORM_LAUNCHES["mla"].launches
        got = fa_ops.flash_attention(qq, k, v, scale=scale, **kw)
        assert fa_ops.FORM_LAUNCHES["mla"].launches == before + 1
        with select.plain_versions():
            want = fa_ops.flash_attention(qq, k, v, scale=scale, **kw)
        torch.cuda.synchronize()
        assert got.shape == (b, h, qq.shape[2], 16)
        assert _rel(got, want) <= CARD_TOL[dtype], kw
    dec_lens = torch.tensor([0, 1, 33, 130], dtype=torch.int32, device=cuda)
    for h in (4, 20):
        q_abs, q_pe = rnd(4, 1, h, 32), rnd(4, 1, h, 8)
        kv_c, k_pe = rnd(2, 4, sk, 32)[1], rnd(2, 4, sk, 8)[1]
        before = fa_ops.FORM_LAUNCHES["mla_decode"].launches
        got = fa_ops.mla_decode(q_abs, q_pe, kv_c, k_pe, dec_lens, scale)
        assert fa_ops.FORM_LAUNCHES["mla_decode"].launches == before + 1
        with select.plain_versions():
            want = fa_ops.mla_decode(q_abs, q_pe, kv_c, k_pe, dec_lens,
                                     scale)
        torch.cuda.synchronize()
        assert got.shape == (4, 1, h, 32) and torch.isfinite(got).all()
        assert _rel(got, want) <= CARD_TOL[dtype], h
        assert not got[0].any()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_reduced_deepseek_kernels_match_plain_on_card(cuda, dtype):
    """The reduced DeepSeek-V2 on the card (the flash-attention kernel's
    (24, 16) instance and MLA decode, RMSNorm and the router's softmax), a
    ragged prefill and an absorbed decode step, against the same model
    inside ``plain_versions()``: f32 by summation order through two
    layers (1e-4 of max|logit|); bf16 by roundings that two layers
    amplify (5e-2)."""
    cfg = dataclasses.replace(get_config("deepseek_v2_236b").reduced(),
                              dtype=dtype)
    model = get_model(cfg)
    gen = torch.Generator(device=cuda).manual_seed(5)
    params = model.init(gen, cuda)
    tokens = torch.randint(0, cfg.vocab, (3, 40), generator=gen,
                           device=cuda, dtype=torch.int32)
    lens = torch.tensor([40, 0, 23], dtype=torch.int32, device=cuda)
    offsets = torch.zeros(3, dtype=torch.int32, device=cuda)

    def both(fn, form):
        before = fa_ops.FORM_LAUNCHES[form].launches
        got = fn()
        assert fa_ops.FORM_LAUNCHES[form].launches == before + cfg.n_layers
        with select.plain_versions():
            want = fn()
        torch.cuda.synchronize()
        return got, want

    cache = model.init_cache(3, 64, cuda)
    (pl, _), (wl, wc) = both(lambda: model.prefill(params, cache, tokens,
                                                   lens, offsets), "mla")
    tol = 1e-4 if dtype == "f32" else 5e-2
    for r in (0, 2):
        assert (pl[r] - wl[r]).abs().max() <= tol * wl[r].abs().max()
    (dl, _), (wdl, _) = both(lambda: model.decode_step(
        params, wc, tokens[:, :1], lens), "mla_decode")
    assert torch.isfinite(dl).all()
    assert (dl - wdl).abs().max() <= tol * wdl.abs().max()


def test_launcher_serves_reduced_deepseek_on_card(cuda, capsys):
    """``--arch deepseek_v2_236b --reduced`` serves on the card: every
    request done, through both MLA forms."""
    from repro_torch.launch import serve as launcher

    before = (fa_ops.FORM_LAUNCHES["mla"].launches,
              fa_ops.FORM_LAUNCHES["mla_decode"].launches)
    launcher.main(["--arch", "deepseek_v2_236b", "--reduced", "--requests",
                   "4", "--max-seq", "64", "--max-batch", "2"])
    assert "4/4 requests" in capsys.readouterr().out
    assert fa_ops.FORM_LAUNCHES["mla"].launches > before[0]
    assert fa_ops.FORM_LAUNCHES["mla_decode"].launches > before[1]
