"""The port's encoder-decoder family (whisper) against the JAX package, on
the CPU, at ``get_config("whisper_tiny").reduced()`` (2 + 2 layers, d 64,
4 heads of hd 16, 32 frames).

* The JAX package's weights carried across by ``params_from_numpy``
  (its layer-stacked ``encoder`` and ``decoder`` trees become per-layer
  lists), inputs from a numpy seed, f32 at 1e-5 (the same math summed in
  other orders): ``attn_apply`` as cross-attention (``kv_source``) and as
  the encoder's non-causal self-attention, ``encode``, ``forward`` (with
  and without ``lens``) and ``decode_step`` (logits and cache).
* ``greedy_decode``: the reference is one ``lax.while_loop`` that exits
  once every row has emitted EOS; the port runs ``max_new`` steps gated
  by a device flag, which must give the same tokens, ``n`` and cache
  with and without an early exit.  Its body reads nothing on the host
  (the ``NoRead`` guard of ``tests/test_torch_dhlo_graphs.py``), for
  whisper and RWKV-6, so that one CUDA graph can hold it.
* The twin of ``tests/test_system.py::test_whisper_single_artifact_decode``:
  the greedy decode compiled once per batch bucket on the jit pipeline.
* ``ServeEngine`` refuses the encoder-decoder, as the reference's engine
  is LM-only.  ``specs`` waits for the multi-GPU slice; the training
  loss equals the reference's.
* Card cases (``-k on_card``; no JAX there): the reduced whisper's and
  RWKV-6's single-artifact greedy decodes captured as one CUDA graph a
  batch bucket, replayed, and equal bit for bit to the same calls under
  ``eager_entries()``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import disc_torch
from disc_torch import ArgSpec, BucketPolicy, Dim, TreeSpec
from repro_torch.configs import get_config
from repro_torch.core.graphs import eager_entries
from repro_torch.models import layers as L
from repro_torch.models import whisper
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.models.registry import get_model
from repro_torch.serve.engine import ServeConfig, ServeEngine

TOL = dict(rtol=1e-5, atol=1e-5)
MAX_LEN = 32


def _i32(a):
    return torch.tensor(np.asarray(a), dtype=torch.int32)


@pytest.fixture(scope="module")
def wsp():
    """The reduced whisper-tiny, initialised by the JAX package and carried
    into the port."""
    import jax
    from repro.configs import get_config as jax_config
    from repro.models.registry import get_model as jax_model

    jcfg = jax_config("whisper_tiny").reduced()
    jmodel = jax_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    base = get_config("whisper_tiny")
    cfg = dataclasses.replace(base, **{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(base)})
    assert cfg == base.reduced()
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return dict(cfg=cfg, model=get_model(cfg), params=params, jcfg=jcfg,
                jmodel=jmodel, jparams=jparams)


def _frames(cfg, b, seed):
    return np.random.RandomState(seed).randn(
        b, cfg.encoder_len, cfg.d_model).astype(np.float32)


def _enc_out(t, frames):
    """The encoder's output from both packages on the same frames."""
    import jax.numpy as jnp
    from repro.models import whisper as jw

    return (whisper.encode(t["cfg"], t["params"], torch.from_numpy(frames)),
            jw.encode(t["jcfg"], t["jparams"], jnp.asarray(frames)))


def _leaves_close(got, want, **tol):
    import jax

    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.numpy(), np.asarray(leaf), **tol,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------- layers --

@pytest.mark.parametrize("kind", ["cross", "encoder_self"])
def test_attn_apply_matches_jax(wsp, kind):
    """Cross-attention: K and V from ``kv_source`` (24 rows against 5
    queries), no RoPE, no mask.  The encoder's self-attention: RoPE,
    non-causal."""
    import jax
    import jax.numpy as jnp
    from repro.models import layers as JL

    rng = np.random.RandomState(4)
    cfg, jcfg = wsp["cfg"], wsp["jcfg"]
    bp = wsp["params"]["decoder"][0]["cross"]
    jbp = jax.tree.map(lambda a: a[0], wsp["jparams"]["decoder"]["cross"])
    x = rng.randn(2, 5, cfg.d_model).astype(np.float32)
    src = rng.randn(2, 24, cfg.d_model).astype(np.float32)
    pos = np.arange(5)[None, :]
    kw = dict(causal=False)
    jkw = dict(causal=False)
    if kind == "cross":
        kw["kv_source"] = torch.from_numpy(src)
        jkw["kv_source"] = jnp.asarray(src)
    got, c = L.attn_apply(cfg, bp, torch.from_numpy(x),
                          positions=torch.from_numpy(pos), **kw)
    want, _ = JL.attn_apply(jcfg, jbp, jnp.asarray(x),
                            positions=jnp.asarray(pos), **jkw)
    assert c is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encode_matches_jax(wsp):
    got, want = _enc_out(wsp, _frames(wsp["cfg"], 2, 1))
    assert got.shape == (2, wsp["cfg"].encoder_len, wsp["cfg"].d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("ragged", [False, True])
def test_forward_matches_jax(wsp, ragged):
    import jax.numpy as jnp

    cfg = wsp["cfg"]
    rng = np.random.RandomState(6)
    tokens = rng.randint(0, cfg.vocab, size=(2, 11)).astype(np.int32)
    frames = _frames(cfg, 2, 2)
    lens = np.array([11, 6], np.int32) if ragged else None
    got = wsp["model"].forward(wsp["params"], {
        "tokens": torch.from_numpy(tokens).long(),
        "frames": torch.from_numpy(frames),
        "lens": None if lens is None else _i32(lens)})
    jb = {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)}
    if ragged:
        jb["lens"] = jnp.asarray(lens)
    want = wsp["jmodel"].forward(wsp["jparams"], jb)
    assert got.shape == (2, 11, cfg.vocab)
    if ragged:   # the rows' valid positions
        np.testing.assert_allclose(got.numpy()[1, :6],
                                   np.asarray(want)[1, :6], **TOL)
    np.testing.assert_allclose(got.numpy()[0], np.asarray(want)[0], **TOL)


def _warm(t, b, seed):
    """A non-zero decoder cache: the JAX model after 5 decode steps."""
    import jax.numpy as jnp

    jm = t["jmodel"]
    rng = np.random.RandomState(seed)
    _, enc = _enc_out(t, _frames(t["cfg"], b, seed))
    cache = jm.init_cache(b, MAX_LEN)
    for j in range(5):
        toks = jnp.asarray(rng.randint(0, t["cfg"].vocab, (b, 1)), jnp.int32)
        _, cache = jm.decode_step(t["jparams"], cache, toks,
                                  jnp.full((b,), j, jnp.int32), enc_out=enc)
    return cache


def test_decode_step_matches_jax(wsp):
    import jax
    import jax.numpy as jnp

    b = 3
    jcache = _warm(wsp, b, 7)
    frames = _frames(wsp["cfg"], b, 8)
    enc, jenc = _enc_out(wsp, frames)
    toks = np.random.RandomState(9).randint(
        0, wsp["cfg"].vocab, (b, 1)).astype(np.int32)
    lens = np.array([5, 2, 0], np.int32)
    want, jc = wsp["jmodel"].decode_step(
        wsp["jparams"], jcache, jnp.asarray(toks), jnp.asarray(lens),
        enc_out=jenc)
    got, c = wsp["model"].decode_step(
        wsp["params"], cache_from_numpy(jax.tree.map(np.asarray, jcache),
                                        device="cpu"),
        torch.from_numpy(toks).long(), _i32(lens), enc_out=enc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _leaves_close(c, jc, **TOL)


# ----------------------------------------------------- greedy decode --

@pytest.mark.parametrize("case", ["eos_row0", "eos_all", "no_eos"])
def test_greedy_decode_matches_jax(wsp, case):
    """Tokens, ``n`` and cache equal the JAX ``greedy_decode``'s.  EOS is
    the token row 0 emits first: with one row (``eos_all``) the loop
    exits after its first step, so the port's later gated steps must
    change nothing; with two, row 0 freezes at EOS."""
    import jax
    import jax.numpy as jnp

    b = 1 if case == "eos_all" else 2
    jm, m = wsp["jmodel"], wsp["model"]
    toks = np.array([[5], [9]], np.int32)[:b]
    lens = np.ones((b,), np.int32)
    enc, jenc = _enc_out(wsp, _frames(wsp["cfg"], b, 3))
    probe, _, _ = jm.greedy_decode(wsp["jparams"], jm.init_cache(b, MAX_LEN),
                                   jnp.asarray(toks), jnp.asarray(lens),
                                   enc_out=jenc, max_new=1, eos_id=-1)
    eos = -1 if case == "no_eos" else int(np.asarray(probe)[0, 0])
    jbuf, jn, jc = jm.greedy_decode(
        wsp["jparams"], jm.init_cache(b, MAX_LEN), jnp.asarray(toks),
        jnp.asarray(lens), enc_out=jenc, max_new=6, eos_id=eos)
    buf, n, c = m.greedy_decode(wsp["params"], m.init_cache(b, MAX_LEN, "cpu"),
                                _i32(toks), _i32(lens), enc_out=enc,
                                max_new=6, eos_id=eos)
    assert n.dtype == torch.int32 and n.dim() == 0
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    assert int(n) == int(jn)
    if case == "eos_all":
        assert int(n) == 1
    if case != "no_eos":
        assert (buf[0] == eos).all()
    _leaves_close(c, jax.tree.map(np.asarray, jc), **TOL)


def _no_read_tree(tree):
    from test_torch_dhlo_graphs import no_read

    return torch.utils._pytree.tree_map(no_read, tree)


@pytest.mark.parametrize("arch", ["whisper_tiny", "rwkv6_3b"])
def test_greedy_decode_reads_nothing_on_the_host(arch):
    """Every input of the loop a ``NoRead`` tensor (any host read of its
    value, or of a value computed from it, raises): the loop runs its
    ``max_new`` steps and returns ``n`` as a 0-d tensor, with no read.
    A loop that read its done mask on the host to exit would raise
    here."""
    from test_torch_dhlo_graphs import NoRead

    cfg = get_config(arch).reduced()
    m = get_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = m.init(gen, "cpu")
    b = 2
    kw = {}
    if arch == "whisper_tiny":
        frames = torch.from_numpy(_frames(cfg, b, 5))
        kw["enc_out"] = _no_read_tree(whisper.encode(cfg, params, frames))
    buf, n, cache = m.greedy_decode(
        params, _no_read_tree(m.init_cache(b, MAX_LEN, "cpu")),
        _no_read_tree(_i32([[3], [7]])), _no_read_tree(_i32([1, 1])),
        max_new=4, eos_id=-1, **kw)
    assert isinstance(n, NoRead) and n.dim() == 0
    assert int(n.as_subclass(torch.Tensor)) == 4
    assert buf.shape == (b, 4)


def test_single_artifact_decode_matches_jax(wsp):
    """Twin of ``tests/test_system.py::test_whisper_single_artifact_decode``:
    the whole greedy decode compiled once per batch bucket on the jit
    pipeline (the cache a ``TreeSpec`` padded along its batch axis,
    ``enc_out`` a batch-dim input), batches of 3, 4 and 2 in buckets of
    4, 4 and 2: two compiles, and the valid rows' tokens equal the JAX
    model's ``greedy_decode``."""
    import jax.numpy as jnp
    from repro.models import whisper as jw

    maxn = 4
    cfg, m, jm = wsp["cfg"], wsp["model"], wsp["jmodel"]
    cf = _artifact(cfg, m, maxn, "cpu")
    rng = np.random.RandomState(3)
    buckets = set()
    for b in (3, 4, 2):
        toks = rng.randint(1, cfg.vocab, size=(b, 1)).astype(np.int32)
        lens = np.ones((b,), np.int32)
        frames = np.zeros((b, cfg.encoder_len, cfg.d_model), np.float32)
        enc = whisper.encode(cfg, wsp["params"], torch.from_numpy(frames))
        buf, n, _ = cf(wsp["params"], m.init_cache(b, MAX_LEN, "cpu"),
                       _i32(toks), _i32(lens), enc)
        jenc = jw.encode(wsp["jcfg"], wsp["jparams"], jnp.asarray(frames))
        want, wn, _ = jm.greedy_decode(wsp["jparams"], jm.init_cache(b, MAX_LEN),
                                       jnp.asarray(toks), jnp.asarray(lens),
                                       enc_out=jenc, max_new=maxn, eos_id=-1)
        # jit pipeline: batch rows beyond b are bucket padding
        np.testing.assert_array_equal(buf.numpy()[:b], np.asarray(want))
        assert int(n) == int(wn) == maxn
        buckets.add(-(-b // 2) * 2)
    assert cf.n_compiles == len(buckets) == 2


def test_serve_engine_refuses_encdec():
    cfg = get_config("whisper_tiny").reduced()
    m = get_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="encoder-decoder"):
        ServeEngine(m, params, ServeConfig(max_batch=2, max_seq=32,
                                           device="cpu"))


def test_encdec_training_and_sharding_wait_for_their_slices(wsp):
    """Sharding still waits for the multi-GPU slice (item 10); the
    training loss has arrived: whisper's ``loss_fn`` (and the registry's
    ``model.loss``) equals the reference's on the same weights, frames,
    labels and partly masked batch, within 1e-5."""
    import jax.numpy as jnp

    cfg = wsp["cfg"]
    with pytest.raises(NotImplementedError, match="item 10"):
        whisper.specs(cfg)
    rng = np.random.RandomState(11)
    batch = {"tokens": rng.randint(0, cfg.vocab, (2, 12)).astype(np.int32),
             "labels": rng.randint(0, cfg.vocab, (2, 12)).astype(np.int32),
             "mask": np.ones((2, 12), np.float32),
             "frames": _frames(cfg, 2, 12)}
    batch["mask"][1, 7:] = 0.0
    port = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = float(wsp["jmodel"].loss(
        wsp["jparams"], {k: jnp.asarray(v) for k, v in batch.items()}))
    got = whisper.loss_fn(cfg, wsp["params"], port)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, **TOL)
    assert float(wsp["model"].loss(wsp["params"], port)) == float(got)


# --------------------------------------------------------- card cases --

def _artifact(cfg, m, maxn, device, eos_id=-1):
    """``model.greedy_decode`` compiled on the jit pipeline, one entry
    per batch bucket of 2 (``tests/test_system.py``'s specs)."""
    dim_b = Dim("B", max=8)
    specs = [None, TreeSpec({1: "B"}),
             ArgSpec((dim_b, 1), torch.int32, name="tokens"),
             ArgSpec((dim_b,), torch.int32, name="lens")]
    if cfg.family == "encdec":
        specs.append(ArgSpec((dim_b, cfg.encoder_len, cfg.d_model),
                             torch.float32, name="enc_out"))

        def step(params, cache, toks, lens, enc_out):
            return m.greedy_decode(params, cache, toks, lens,
                                   enc_out=enc_out, max_new=maxn,
                                   eos_id=eos_id)
    else:
        def step(params, cache, toks, lens):
            return m.greedy_decode(params, cache, toks, lens, max_new=maxn,
                                   eos_id=eos_id)
    return disc_torch.compile(
        step, specs=specs, pipeline="jit", name=f"{cfg.name}_greedy",
        device=device, policy=BucketPolicy(kind="multiple", granule=2))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash-attention, LayerNorm "
                    "and WKV (CUDA C++) kernels and the CUDA graphs run on "
                    "the card only")
    return torch.device("cuda")


@pytest.mark.parametrize("arch", ["whisper_tiny", "rwkv6_3b"])
def test_single_artifact_decode_graphed_on_card(cuda, arch):
    """The reduced model's greedy decode compiled on the jit pipeline on
    the card, batches 3, 4 and 2: one CUDA graph per batch bucket (two
    captures), the batch of 4 a replay of bucket 4's graph, and every
    call's tokens, ``n`` and cache equal bit for bit to the same call
    under ``eager_entries()`` (the kernels launched one by one)."""
    cfg = get_config(arch).reduced()
    m = get_model(cfg)
    params = m.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    maxn = 6
    cf = _artifact(cfg, m, maxn, "cuda")
    gen = torch.Generator(device=cuda).manual_seed(1)
    calls = []
    for b in (3, 4, 2):
        toks = torch.randint(1, cfg.vocab, (b, 1), generator=gen,
                             device=cuda, dtype=torch.int32)
        lens = torch.ones((b,), dtype=torch.int32, device=cuda)
        extra = ()
        if cfg.family == "encdec":
            frames = torch.randn((b, cfg.encoder_len, cfg.d_model),
                                 generator=gen, device=cuda)
            extra = (whisper.encode(cfg, params, frames),)
        cache = m.init_cache(b, MAX_LEN, cuda)
        calls.append((cache, toks, lens) + extra)
    got = [cf(params, *c) for c in calls]
    torch.cuda.synchronize()
    st = cf.graph_stats
    assert (st.captures, st.replays) == (2, 1)
    assert cf.n_compiles == 2
    with eager_entries():
        want = [cf(params, *c) for c in calls]
    for (buf, n, cache), (wbuf, wn, wcache) in zip(got, want):
        assert int(n) == int(wn) == maxn
        assert torch.equal(buf, wbuf)
        for a, w in zip(torch.utils._pytree.tree_leaves(cache),
                        torch.utils._pytree.tree_leaves(wcache)):
            assert torch.equal(a, w)
