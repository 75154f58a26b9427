"""The port's serving path against the JAX package's, on the CPU.

Two kinds of cases:

* **Twins** of ``tests/test_serve_batching.py``: single-pass prefill vs
  the decode-step replay, chunked vs unchunked prefill, admission order,
  O(#(B, S) buckets) compiles, §4.4 escalation, ``TreeSpec`` padding, the
  paged pool's parity with fixed rows and the documented stats keys — on
  the port's ``ServeEngine``, with the reference's tolerances (2e-4 on
  logits and cache rows).  The paged and speculative paths' own twins
  are ``tests/test_torch_paging.py``.
* **Cross-package**: the same requests through the JAX ``ServeEngine``
  and the port's, on ``get_config("tinyllama_11b").reduced()`` in f32
  with the JAX parameters carried across by ``params_from_numpy``, give
  identical token streams; prefill logits and every valid cache row
  agree within 2e-4 (the reference's own prefill-vs-replay tolerance:
  both sum in f32, in other orders).  The same on a narrow GQA variant
  (8 heads over 2 KV heads; ``reduced()`` has group 1).

On the CPU every wrapper runs its kernel's plain version; the engine's
kernels are held against those on the card by ``chip_smoke.py`` (path 3).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import disc_torch
from repro_torch.configs import get_config
from repro_torch.data.pipeline import Request
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.models.registry import get_model, replay_prefill
from repro_torch.serve.engine import STATS_KEYS, ServeConfig, ServeEngine
from repro_torch.serve.policies import (ADMISSION_POLICIES,
                                        get_admission_policy, priority_first,
                                        shortest_prompt_first)

TOL = dict(atol=2e-4, rtol=2e-4)
GQA = dict(n_heads=8, n_kv_heads=2, head_dim=8)


def _jax_model(**over):
    import jax
    from repro.configs import get_config as jax_config
    from repro.models.registry import get_model as jax_model

    cfg = dataclasses.replace(jax_config("tinyllama_11b").reduced(), **over)
    model = jax_model(cfg)
    return cfg, model, model.init(jax.random.PRNGKey(0))


def _port_cfg(jcfg):
    return dataclasses.replace(
        get_config("tinyllama_11b"),
        **{f.name: getattr(jcfg, f.name)
           for f in dataclasses.fields(get_config("tinyllama_11b"))})


def _port(jcfg, jparams):
    import jax

    cfg = _port_cfg(jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return cfg, get_model(cfg), params


@pytest.fixture(scope="module")
def tiny():
    """The reduced TinyLlama, initialised by the JAX package and carried
    into the port."""
    jcfg, jmodel, jparams = _jax_model()
    cfg, model, params = _port(jcfg, jparams)
    return dict(cfg=cfg, model=model, params=params, jcfg=jcfg,
                jmodel=jmodel, jparams=jparams)


@pytest.fixture(scope="module")
def tiny_gqa():
    jcfg, jmodel, jparams = _jax_model(**GQA)
    cfg, model, params = _port(jcfg, jparams)
    return dict(cfg=cfg, model=model, params=params, jcfg=jcfg,
                jmodel=jmodel, jparams=jparams)


def _requests(vocab, lens, max_new=4, prios=None, cls=Request):
    rng = np.random.RandomState(7)
    return [cls(rid=i, tokens=rng.randint(0, vocab, size=ln).astype(np.int32),
                max_new_tokens=max_new,
                priority=0 if prios is None else prios[i])
            for i, ln in enumerate(lens)]


def _engine(t, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq", 96)
    return ServeEngine(t["model"], t["params"],
                       ServeConfig(device="cpu", **kw))


def _i32(a):
    return torch.tensor(np.asarray(a), dtype=torch.int32)


# ----------------------------------------------------------------- parity --

class TestPrefillParity:
    @pytest.mark.parametrize("lens_set", [[5, 12, 16], [33, 20, 40]])
    def test_single_pass_matches_replay_model_level(self, tiny, lens_set):
        """model.prefill ≡ decode-step replay: logits and every valid
        cache position, across two different (B, S) shapes."""
        model, params, cfg = tiny["model"], tiny["params"], tiny["cfg"]
        b, smax = len(lens_set), max(lens_set)
        rng = np.random.RandomState(1)
        tokens = np.zeros((b, smax), np.int32)
        for r, ln in enumerate(lens_set):
            tokens[r, :ln] = rng.randint(0, cfg.vocab, size=ln)
        lens, offsets = _i32(lens_set), _i32(np.zeros(b))
        cache0 = model.init_cache(b, 96, "cpu")
        log_sp, cache_sp = model.prefill(params, cache0, _i32(tokens), lens,
                                         offsets)
        log_rp, cache_rp = replay_prefill(model.decode_step)(
            params, cache0, _i32(tokens), lens, offsets)
        np.testing.assert_allclose(log_sp.numpy(), log_rp.numpy(), **TOL)
        for k in cache_sp:
            for r, ln in enumerate(lens_set):  # (L, B, hkv, Lc, hd)
                np.testing.assert_allclose(cache_sp[k][:, r, :, :ln].numpy(),
                                           cache_rp[k][:, r, :, :ln].numpy(),
                                           **TOL)

    def test_engine_generations_match_replay(self, tiny):
        """End to end: same requests, same generated ids, while the
        batched engine launches strictly fewer prefills."""
        lens = [5, 9, 14, 40, 33, 12]  # spans S buckets 16 and 64
        outs, calls = {}, {}
        for mode in ("batched", "replay"):
            eng = _engine(tiny, prefill_mode=mode)
            eng.submit(_requests(tiny["cfg"].vocab, lens))
            outs[mode] = eng.run_until_done(max_steps=500)
            calls[mode] = eng.stats["prefill_calls"]
        assert outs["batched"] == outs["replay"]
        assert len(outs["batched"]) == len(lens)
        assert calls["batched"] < calls["replay"] == len(lens)

    def test_chunked_prefill_matches_unchunked(self, tiny):
        """Chunk-offset continuation reproduces the one-shot prefill, at
        the model level (explicit offsets) and through the engine."""
        model, params, cfg = tiny["model"], tiny["params"], tiny["cfg"]
        rng = np.random.RandomState(3)
        toks = rng.randint(0, cfg.vocab, size=(1, 24)).astype(np.int32)
        cache0 = model.init_cache(1, 96, "cpu")
        one = _i32([12])
        log_a, cache_a = model.prefill(params, cache0, _i32(toks), _i32([24]),
                                       _i32([0]))
        _, cache_h = model.prefill(params, cache0, _i32(toks[:, :12]), one,
                                   _i32([0]))
        log_b, cache_b = model.prefill(params, cache_h, _i32(toks[:, 12:]),
                                       one, _i32([12]))
        np.testing.assert_allclose(log_a.numpy(), log_b.numpy(), **TOL)
        for k in cache_a:
            np.testing.assert_allclose(cache_a[k][:, :, :, :24].numpy(),
                                       cache_b[k][:, :, :, :24].numpy(), **TOL)

        lens = [30, 22, 6, 17]
        base, chunked = {}, {}
        for chunk, sink in ((None, base), (8, chunked)):
            eng = _engine(tiny, prefill_chunk=chunk)
            eng.submit(_requests(cfg.vocab, lens))
            sink.update(eng.run_until_done(max_steps=500))
            if chunk:
                assert eng.stats["prefill_chunks"] > 0
        assert base == chunked


# -------------------------------------------------------------- admission --

class TestAdmission:
    def test_policy_orderings(self):
        reqs = _requests(64, [24, 6, 12], prios=[0, 1, 3])
        assert [r.rid for r in ADMISSION_POLICIES["fifo"](reqs)] == [0, 1, 2]
        assert [r.rid for r in shortest_prompt_first(reqs)] == [1, 2, 0]
        assert [r.rid for r in priority_first(reqs)] == [2, 1, 0]
        assert get_admission_policy(shortest_prompt_first) \
            is shortest_prompt_first
        with pytest.raises(ValueError, match="unknown admission policy"):
            get_admission_policy("nope")

    def test_overlong_prompt_rejected_at_submit(self, tiny):
        eng = _engine(tiny, max_seq=64, prefill_chunk=16)
        reqs = _requests(tiny["cfg"].vocab, [65, 8, 70, 12], max_new=2)
        eng.submit(reqs)
        assert eng.stats["rejected_requests"] == 2
        assert eng.rejected == [reqs[0].rid, reqs[2].rid]
        assert [r.rid for r in eng.queue] == [reqs[1].rid, reqs[3].rid]
        eng.run_until_done(max_steps=200)
        assert sorted(eng.done) == [reqs[1].rid, reqs[3].rid]
        assert eng.stats["requests_completed"] == 2

    def test_duplicate_rid_rejected_auto_rid_admits(self, tiny):
        vocab = tiny["cfg"].vocab
        eng = _engine(tiny, max_batch=2)
        a, b = _requests(vocab, [8, 8], max_new=2)
        b.rid = a.rid
        with pytest.raises(ValueError, match="already pending"):
            eng.submit([a, b])
        rng = np.random.RandomState(7)
        auto = [Request(tokens=rng.randint(0, vocab, size=8)
                        .astype(np.int32), max_new_tokens=2)
                for _ in range(2)]
        assert auto[0].rid != auto[1].rid
        eng.submit(auto)
        eng.run_until_done(max_steps=100)
        assert eng.stats["requests_completed"] == 2

    def test_paged_decode_parity_across_buckets(self, tiny):
        """Unconstrained-pool paged decode is bit-parity with the
        fixed-row baseline, across ≥2 (B, S) prefill buckets (short and
        long prompts, full and partial batches)."""
        lens = [5, 12, 40, 60, 9, 33]
        fixed = _engine(tiny, max_batch=3, max_seq=96)
        fixed.submit(_requests(tiny["cfg"].vocab, lens, max_new=4))
        fixed.run_until_done(max_steps=400)
        paged = _engine(tiny, max_batch=3, max_seq=96, kv_block_size=16)
        paged.submit(_requests(tiny["cfg"].vocab, lens, max_new=4))
        paged.run_until_done(max_steps=400)
        assert fixed.stats["prefill_bucket_pairs"] >= 2
        assert paged.done == fixed.done
        assert paged.stats["kv_preemptions"] == 0
        assert paged.stats["kv_blocks_in_use"] == 0
        paged.alloc.assert_consistent()

    @pytest.mark.parametrize("policy,expected", [
        ("fifo", [0, 1, 2]),
        ("shortest-prompt-first", [1, 2, 0]),
        ("priority", [2, 1, 0]),
    ])
    def test_engine_completion_order(self, tiny, policy, expected):
        """With one slot, completion order is exactly admission order."""
        eng = _engine(tiny, max_batch=1, admission=policy)
        eng.submit(_requests(tiny["cfg"].vocab, [24, 6, 12], max_new=2,
                             prios=[0, 1, 3]))
        done = eng.run_until_done(max_steps=300)
        assert list(done) == expected

    def test_replicas_route_to_least_loaded(self, tiny):
        """Two replicas: admission alternates between slot ranges, and
        the replicated engine emits the single-replica engine's tokens."""
        lens = [7, 11, 5, 9]
        one = _engine(tiny, max_batch=4)
        one.submit(_requests(tiny["cfg"].vocab, lens))
        two = _engine(tiny, max_batch=2, replicas=2)
        two.submit(_requests(tiny["cfg"].vocab, lens))
        assert two.run_until_done(max_steps=300) == \
            one.run_until_done(max_steps=300)
        assert [r["admitted"] for r in two.stats["per_replica"]] == [2, 2]


# ---------------------------------------------------------- compile counts --

class TestCompileCounts:
    def test_o_buckets_across_batch_compositions(self, tiny):
        """A mixed trace re-using (B, S) buckets never recompiles; a new
        group size does — exactly once per new pair."""
        vocab = tiny["cfg"].vocab
        eng = _engine(tiny)
        eng.submit(_requests(vocab, [9, 12, 14, 10]))   # (4, 16)
        eng.run_until_done(max_steps=300)
        first = eng.compile_counts()["prefill"]["bucket"]
        assert first == 1
        eng.submit(_requests(vocab, [13, 10, 15, 11]))  # (4, 16) again
        eng.run_until_done(max_steps=300)
        assert eng.compile_counts()["prefill"]["bucket"] == first
        eng.submit(_requests(vocab, [12, 12]))          # (2, 16): new B
        eng.run_until_done(max_steps=300)
        counts = eng.compile_counts()["prefill"]
        assert counts["bucket"] == first + 1
        assert counts["bucket"] == eng.stats["prefill_bucket_pairs"] == 2
        assert eng.compile_counts()["decode"]["total"] == 1

    def test_escalation_on_hot_batched_signature(self, tiny):
        """§4.4 on the 2-D artifact: a hot exact (B, S) signature gets an
        unpadded specialization."""
        eng = _engine(tiny, max_batch=2, max_seq=64, escalation_threshold=2)
        for _ in range(3):
            eng.submit(_requests(tiny["cfg"].vocab, [7, 5], max_new=2))
            eng.run_until_done(max_steps=200)
        assert eng.stats["prefill_escalations"] >= 1
        assert eng.stats["requests_completed"] == 6

    def test_prefill_escalates_on_hot_prompt_length(self, tiny):
        """Twin of ``test_dispatch_unification``'s serve escalation."""
        eng = _engine(tiny, max_batch=2, max_seq=64, escalation_threshold=2)
        for rid in range(3):
            eng.submit([Request(rid=rid, tokens=[2, 3, 4, 5, 6],
                                max_new_tokens=1)])
            eng.run_until_done()
        assert eng.stats["prefill_escalations"] >= 1
        assert len(eng.done) == 3

    def test_stats_keys_documented(self, tiny):
        eng = _engine(tiny)
        assert set(eng.stats) == set(STATS_KEYS)
        eng.submit(_requests(tiny["cfg"].vocab, [9, 12]))
        eng.run_until_done(max_steps=100)
        assert set(eng.stats) == set(STATS_KEYS)
        eng.reset_stats()
        assert eng.stats["tokens_generated"] == 0
        assert eng.stats["prefill_compiles"] == 1  # artifact-lifetime


# --------------------------------------------------------------- TreeSpec --

class TestTreeSpec:
    def test_pads_pytree_leaves_to_bucket(self):
        seen = []

        def f(tree, x):
            seen.append((tuple(tree["a"].shape), tuple(x.shape)))
            return tree["a"].sum() + x.sum()

        fn = disc_torch.compile(
            f, specs=[disc_torch.TreeSpec({0: "B"}),
                      disc_torch.ArgSpec(("B", 2), torch.float32)],
            options=disc_torch.CompileOptions(pipeline="jit", device="cpu"))
        assert float(fn({"a": torch.ones((3, 2))}, torch.ones((3, 2)))) \
            == 12.0
        assert seen[0] == ((16, 2), (16, 2))  # POW2 granule-16 bucket
        assert float(fn({"a": torch.ones((5, 2))}, torch.ones((5, 2)))) \
            == 20.0
        assert fn.compile_counts()["total"] == 1

    def test_tree_only_dim_is_rejected(self):
        with pytest.raises(ValueError, match="not observable"):
            disc_torch.compile(
                lambda t: t, specs=[disc_torch.TreeSpec({0: "B"})],
                options=disc_torch.CompileOptions(pipeline="jit",
                                                  device="cpu"))


# ------------------------------------------------------- the port's rules --

def test_later_slices_raise_not_implemented(tiny):
    for kw in (dict(mesh=object()), dict(sharding_profile="dp")):
        with pytest.raises(NotImplementedError, match="slice"):
            _engine(tiny, **kw)
    # replica heartbeats are ported: the option serves
    assert _engine(tiny, heartbeat_deadline_s=1.0).monitor is not None
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        disc_torch.CompileOptions(mesh=object())


@pytest.mark.parametrize("kw", [
    dict(kv_block_size=16), dict(kv_block_size=16, kv_pool_blocks=10),
    dict(speculative="ngram"), dict(speculative="ngram", speculative_k=2,
                                    kv_block_size=8, max_recomputes=3)])
def test_paged_and_speculative_options_serve(tiny, kw):
    """``kv_block_size`` / ``kv_pool_blocks`` / ``speculative`` /
    ``speculative_k`` / ``max_recomputes`` are ported: each serves the
    fixed-row engine's streams."""
    lens = [5, 12, 9]
    want = _engine(tiny)
    want.submit(_requests(tiny["cfg"].vocab, lens))
    eng = _engine(tiny, **kw)
    eng.submit(_requests(tiny["cfg"].vocab, lens))
    assert eng.run_until_done(max_steps=300) == \
        want.run_until_done(max_steps=300)
    assert eng.paged == ("kv_block_size" in kw)
    assert ("verify" in eng.compile_counts()) == ("speculative" in kw)


def test_deadline_expiry_fails_only_the_late_request(tiny):
    """A request past its ``deadline_s`` is retired FAILED with its
    reason; the rest of the batch completes."""
    eng = _engine(tiny, max_batch=2)
    now = [0.0]
    eng._clock = lambda: now[0]
    late, ok = _requests(tiny["cfg"].vocab, [8, 9], max_new=2)
    late.deadline_s = 1.0
    eng.submit([late, ok])
    now[0] = 5.0
    eng.run_until_done(max_steps=100)
    assert list(eng.failed) == [late.rid]
    assert "DeadlineExceeded" in eng.failed[late.rid]
    assert list(eng.done) == [ok.rid]
    assert eng.stats["deadline_expirations"] == 1
    assert eng.stats["failed_requests"] == 1


def test_engine_refuses_the_cpu_by_default(tiny, monkeypatch):
    """The engine runs on the card unless ``device="cpu"`` is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(disc_torch.NoDeviceError):
        ServeEngine(tiny["model"], tiny["params"], ServeConfig())


def test_dropped_engine_is_freed_without_gc(tiny):
    """A dropped engine releases its cache and parameters at once: its
    compiled entries call back into it through weak references, so no
    cycle waits for a gc pass.  (A first engine runs before gc is turned
    off: the first call of a custom op imports ``torch._dynamo``, whose
    import leaves one frame cycle holding its caller's stack.)"""
    import copy
    import gc
    import weakref

    def served():
        eng = ServeEngine(tiny["model"], copy.deepcopy(tiny["params"]),
                          ServeConfig(max_batch=2, max_seq=64, device="cpu"))
        eng.submit(_requests(tiny["cfg"].vocab, [5, 9, 20], max_new=3))
        eng.run_until_done(max_steps=100)
        return eng

    served()
    gc.collect()
    gc.disable()
    try:
        eng = served()
        refs = [weakref.ref(x) for x in (eng, eng.cache["k"],
                                          eng.params["embed"])]
        del eng
        assert [r() is None for r in refs] == [True] * 3
    finally:
        gc.enable()


# ------------------------------------------------ cross-package (JAX) --

def _jax_engine(t, lens, **kw):
    from repro.data.pipeline import Request as JaxRequest
    from repro.serve.engine import ServeConfig as JaxConfig
    from repro.serve.engine import ServeEngine as JaxEngine

    eng = JaxEngine(t["jmodel"], t["jparams"],
                    JaxConfig(max_batch=4, max_seq=96, **kw))
    eng.submit(_requests(t["cfg"].vocab, lens, cls=JaxRequest))
    return eng.run_until_done(max_steps=500), eng


@pytest.mark.parametrize("which", ["reduced", "gqa"])
@pytest.mark.parametrize("chunk", [None, 8])
def test_engine_matches_jax_engine(tiny, tiny_gqa, which, chunk):
    """Same requests through both packages' engines: identical token
    streams and the same launch and compile counts."""
    t = tiny if which == "reduced" else tiny_gqa
    lens = [5, 9, 14, 40, 33, 12]
    want, jeng = _jax_engine(t, lens, prefill_chunk=chunk)
    eng = _engine(t, prefill_chunk=chunk)
    eng.submit(_requests(t["cfg"].vocab, lens))
    assert eng.run_until_done(max_steps=500) == want
    for key in ("prefill_calls", "decode_steps", "tokens_generated",
                "prefill_bucket_pairs", "prefill_chunks"):
        assert eng.stats[key] == jeng.stats[key], key
    assert eng.compile_counts() == {k: jeng.compile_counts()[k]
                                    for k in ("prefill", "decode")}


@pytest.mark.parametrize("which", ["reduced", "gqa"])
def test_forward_matches_jax_model(tiny, tiny_gqa, which):
    """``Model.forward``, both packages: full-sequence logits with ragged
    per-row ``lens``, within the reference's tolerance."""
    import jax.numpy as jnp

    t = tiny if which == "reduced" else tiny_gqa
    rng = np.random.RandomState(5)
    tokens = rng.randint(0, t["cfg"].vocab, size=(2, 24)).astype(np.int32)
    lens = np.array([24, 17], np.int32)
    want = t["jmodel"].forward(t["jparams"], {"tokens": jnp.asarray(tokens),
                                              "lens": jnp.asarray(lens)})
    got = t["model"].forward(t["params"], {"tokens": _i32(tokens),
                                           "lens": _i32(lens)})
    for r, n in enumerate(lens):   # rows past a row's length are padding
        np.testing.assert_allclose(got[r, :n].numpy(),
                                   np.asarray(want)[r, :n], **TOL)


@pytest.mark.parametrize("which", ["reduced", "gqa"])
def test_prefill_and_decode_match_jax_model(tiny, tiny_gqa, which):
    """Model level, both packages: batched prefill at per-row offsets into
    a partly filled cache, then one decode step — logits and every valid
    cache row within the reference's tolerance."""
    import jax
    import jax.numpy as jnp

    t = tiny if which == "reduced" else tiny_gqa
    cfg, jm, m = t["cfg"], t["jmodel"], t["model"]
    rng = np.random.RandomState(11)
    lens = np.array([7, 12, 3], np.int32)
    offsets = np.array([0, 9, 30], np.int32)
    tokens = rng.randint(0, cfg.vocab, size=(3, 12)).astype(np.int32)
    jcache = jm.init_cache(3, 64)
    # rows 1 and 2 continue a prompt: fill their prefix first
    pre = rng.randint(0, cfg.vocab, size=(3, 30)).astype(np.int32)
    _, jcache = jm.prefill(t["jparams"], jcache, jnp.asarray(pre),
                           jnp.asarray(offsets), jnp.zeros(3, jnp.int32))
    cache = cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    jl, jc = jm.prefill(t["jparams"], jcache, jnp.asarray(tokens),
                        jnp.asarray(lens), jnp.asarray(offsets))
    pl, pc = m.prefill(t["params"], cache, _i32(tokens), _i32(lens),
                       _i32(offsets))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    fill = offsets + lens
    for k in pc:
        for r in range(3):
            np.testing.assert_allclose(
                pc[k][:, r, :, :fill[r]].numpy(),
                np.asarray(jc[k])[:, r, :, :fill[r]], **TOL)
    step = rng.randint(0, cfg.vocab, size=(3, 1)).astype(np.int32)
    jl, jc = jm.decode_step(t["jparams"], jc, jnp.asarray(step),
                            jnp.asarray(fill))
    pl, pc = m.decode_step(t["params"], pc, _i32(step), _i32(fill))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    for k in pc:
        for r in range(3):
            np.testing.assert_allclose(
                pc[k][:, r, :, :fill[r] + 1].numpy(),
                np.asarray(jc[k])[:, r, :, :fill[r] + 1], **TOL)


# ------------------------------------------- nested (tree) caches --

@pytest.mark.parametrize("mode", ["batched", "replay"])
def test_tree_mapped_engine_matches_jax_engine(tiny, mode):
    """The engine's row gathers, scatters, zeroing and gating map over
    cache leaves (for nested recurrent caches); on the dense KV cache,
    in both prefill modes, the streams stay the JAX engine's."""
    lens = [5, 9, 14, 40, 33, 12]
    want, jeng = _jax_engine(tiny, lens, prefill_mode=mode)
    eng = _engine(tiny, prefill_mode=mode)
    eng.submit(_requests(tiny["cfg"].vocab, lens))
    assert eng.run_until_done(max_steps=500) == want
    assert eng.stats["prefill_calls"] == jeng.stats["prefill_calls"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cache_from_numpy_round_trips_nested_cache(dtype):
    """RWKV's nested cache ``{"tmix": {"s", "x_prev"}, "cmix_x"}`` comes
    across leaf for leaf: the same nesting, shapes, dtypes and values
    (bf16 bit for bit)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_config
    from repro.models.registry import get_model as jax_model

    cfg = dataclasses.replace(jax_config("rwkv6_3b").reduced(), dtype=dtype)
    rng = np.random.RandomState(4)
    jcache = jax.tree.map(
        lambda x: jnp.asarray(rng.randn(*x.shape), x.dtype),
        jax_model(cfg).init_cache(3, 16))
    got = cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    assert set(got) == {"tmix", "cmix_x"} and set(got["tmix"]) == {"s",
                                                                 "x_prev"}
    flat = jax.tree_util.tree_flatten_with_path(jcache)[0]
    assert len(flat) == 3
    for path, leaf in flat:
        node = got
        for key in path:
            node = node[key.key]
        assert str(node.dtype) == f"torch.{leaf.dtype}"
        np.testing.assert_array_equal(node.float().numpy(),
                                      np.asarray(leaf, np.float32))
