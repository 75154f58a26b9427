"""The port's paged KV cache and speculative decoding against the JAX
package's, on the CPU.

* **Twins** of ``tests/test_serve_paging.py``, case for case, on the
  port: the block allocator's invariants under random ensure / release
  sequences (the hypothesis case through ``_hypothesis_compat``), paged
  gather / scatter against a dense numpy reference, pool-pressure
  preemption end to end, the proposers, speculative accept-or-fix parity
  on both cache layouts, and the ``verify`` ≡ decode-replay contract.
* **Cross-package**, on the same seeded numpy inputs or the same
  requests through both packages: ``paged_gather`` / ``paged_scatter``
  bit-equal to the reference's for both ``page_axes`` layouts (every
  block but the null one, whose writes race by design); the narrow
  scatter (the few positions a decode or verify launch wrote) equal to
  the full form; ``NGramProposer`` and ``BlockAllocator.table()`` equal
  to the reference's; ``transformer.verify`` logits and cache within
  1e-5 of max|ref| on the reduced TinyLlama and the reduced DeepSeek-V2
  (MLA's latent cache); and the paged and speculative engines' streams
  and counters equal to the reference engine's, the pressure run
  included.

On the CPU every kernel wrapper runs its plain version; the card's
paged and speculative runs are ``chip_smoke.py``'s path 14, and the one
card case here (``-k on_card``) holds a paged, speculative engine's CUDA
graphs to the fixed-row engine's streams.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro_torch.configs import get_config
from repro_torch.data.pipeline import Request
from repro_torch.models.layers import paged_gather, paged_scatter
from repro_torch.models.registry import get_model, replay_verify
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.paging import (NULL_BLOCK, BlockAllocator,
                                      PagedKVPool, blocks_for, pick_victim)
from repro_torch.serve.speculative import (DraftModelProposer, NGramProposer,
                                           get_proposer)

# transformer.verify against the reference's: max|d|/max|ref| (both sum in
# f32, in other orders)
TOL_VERIFY = 1e-5


@pytest.fixture(scope="module")
def tiny():
    """The reduced TinyLlama, initialised by the JAX package and carried
    into the port (one build a process, shared with the other twins)."""
    from _torch_parity import reduced_tinyllama

    t = reduced_tinyllama()
    return t["cfg"], t["model"], t["params"]


@pytest.fixture(scope="module")
def tiny_both():
    from _torch_parity import reduced_tinyllama

    return reduced_tinyllama()


def _requests(vocab, lens, max_new=4, prios=None, seed=7, cls=Request):
    rng = np.random.RandomState(seed)
    return [cls(rid=i,
                tokens=rng.randint(0, vocab, size=ln).astype(np.int32),
                max_new_tokens=max_new,
                priority=0 if prios is None else prios[i])
            for i, ln in enumerate(lens)]


def _engine(model, params, **kw):
    return ServeEngine(model, params, ServeConfig(device="cpu", **kw))


def _i32(a):
    return torch.tensor(np.asarray(a), dtype=torch.int32)


# -------------------------------------------------------------- allocator --

class TestBlockAllocator:
    def test_blocks_for(self):
        assert blocks_for(0, 16) == 0
        assert blocks_for(1, 16) == 1
        assert blocks_for(16, 16) == 1
        assert blocks_for(17, 16) == 2

    def test_ensure_is_all_or_nothing(self):
        a = BlockAllocator(4, 8, n_slots=2, max_blocks_per_slot=4)
        assert a.ensure(0, 24)           # 3 blocks
        assert not a.ensure(1, 16)       # needs 2, only 1 free
        assert a.owned(1) == []          # nothing half-allocated
        assert a.free_blocks == 1
        assert a.ensure(1, 8)
        a.assert_consistent()

    def test_ensure_respects_per_slot_cap(self):
        a = BlockAllocator(8, 8, n_slots=2, max_blocks_per_slot=2)
        assert not a.ensure(0, 24)       # 3 blocks > cap, despite 8 free
        assert a.owned(0) == []

    def test_release_returns_blocks_and_table_is_null_padded(self):
        a = BlockAllocator(4, 8, n_slots=2, max_blocks_per_slot=4)
        a.ensure(0, 20)
        t = a.table()
        assert t.shape == (2, 4) and t.dtype == np.int32
        assert NULL_BLOCK not in t[0, :3] and (t[0, 3:] == NULL_BLOCK).all()
        assert (t[1] == NULL_BLOCK).all()
        freed = a.release(0)
        assert freed == 3 and a.free_blocks == 4
        a.assert_consistent()

    @settings(max_examples=25, deadline=None)
    @given(ops=st.lists(st.tuples(st.integers(0, 3), st.integers(0, 40),
                                  st.booleans()),
                        min_size=1, max_size=40),
           n_blocks=st.integers(1, 12))
    def test_random_op_sequences_keep_invariants(self, ops, n_blocks):
        """No double-assignment, freed blocks return, owned+free is
        conserved — under arbitrary interleaved ensure/release."""
        a = BlockAllocator(n_blocks, 8, n_slots=4, max_blocks_per_slot=6)
        for slot, n_tokens, do_release in ops:
            if do_release:
                before = len(a.owned(slot))
                assert a.release(slot) == before
            else:
                before = a.owned(slot)
                ok = a.ensure(slot, n_tokens)
                if not ok:   # all-or-nothing
                    assert a.owned(slot) == before
                else:
                    assert len(a.owned(slot)) \
                        >= blocks_for(n_tokens, a.block_size)
            a.assert_consistent()

    def test_pick_victim_policy(self):
        # lowest priority first, then newest admission
        assert pick_victim([(0, 1, 5), (1, 0, 2), (2, 0, 9)]) == 2
        assert pick_victim([(0, 2, 1), (1, 1, 0)]) == 1
        assert pick_victim([]) is None

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_table_matches_reference(self, seed):
        """The same random ensure / release sequence through both
        packages' allocators: the same answers, free counts and block
        tables after every operation."""
        from repro.serve.paging import BlockAllocator as RefAllocator

        rng = np.random.RandomState(seed)
        a = BlockAllocator(10, 8, n_slots=4, max_blocks_per_slot=6)
        r = RefAllocator(10, 8, n_slots=4, max_blocks_per_slot=6)
        for _ in range(60):
            slot = int(rng.randint(4))
            if rng.rand() < 0.3:
                assert a.release(slot) == r.release(slot)
            else:
                n = int(rng.randint(0, 50))
                assert a.ensure(slot, n) == r.ensure(slot, n)
            assert a.free_blocks == r.free_blocks
            np.testing.assert_array_equal(a.table(), r.table())


# --------------------------------------------------------- gather/scatter --

LAYOUTS = [
    (1, 3, (2, 5, 3, 4, 2)),    # attention layout (L, NB, hkv, bs, hd)
    (1, 2, (2, 5, 4, 3)),       # MLA layout (L, NB, bs, lora)
]


class TestGatherScatter:
    def _ref_gather(self, pool, tables, block_axis, seq_axis):
        p = np.moveaxis(np.asarray(pool), (block_axis, seq_axis), (0, 1))
        rows = [np.concatenate([p[b] for b in row], axis=0)
                for row in tables]
        return np.moveaxis(np.stack(rows), (0, 1), (block_axis, seq_axis))

    @pytest.mark.parametrize("block_axis,seq_axis,shape", LAYOUTS)
    def test_gather_matches_dense_reference(self, block_axis, seq_axis,
                                            shape):
        rng = np.random.RandomState(0)
        pool = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        tables = _i32([[1, 3], [4, 2]])
        out = paged_gather(pool, tables, block_axis=block_axis,
                           seq_axis=seq_axis)
        ref = self._ref_gather(pool, tables.numpy(), block_axis, seq_axis)
        np.testing.assert_array_equal(out.numpy(), ref)
        assert out.is_contiguous()

    def test_scatter_roundtrip_and_null_sink(self):
        """Kept positions land in their blocks; masked writes go to the
        null block; a gather after scatter returns the dense rows."""
        rng = np.random.RandomState(1)
        pool0 = torch.from_numpy(rng.randn(2, 6, 3, 8, 2).astype(np.float32))
        tables = _i32([[2, 4], [1, 3]])
        dense = torch.from_numpy(rng.randn(2, 2, 3, 16, 2)
                                 .astype(np.float32))
        keep = torch.from_numpy(np.array([[True] * 10 + [False] * 6,
                                          [False] * 4 + [True] * 8
                                          + [False] * 4]))
        new = paged_scatter(pool0.clone(), dense, tables, keep,
                            block_axis=1, seq_axis=3)
        back = paged_gather(new, tables, block_axis=1, seq_axis=3)
        kp = keep.numpy()[None, :, None, :, None]
        np.testing.assert_array_equal(np.where(kp, back.numpy(), 0.0),
                                      np.where(kp, dense.numpy(), 0.0))
        # a block in no table row stays bit-identical (the null block,
        # id 0, absorbs the masked writes instead)
        np.testing.assert_array_equal(new.numpy()[:, 5],
                                      pool0.numpy()[:, 5])

    @pytest.mark.parametrize("block_axis,seq_axis,shape", LAYOUTS)
    def test_gather_scatter_bit_equal_to_reference(self, block_axis,
                                                   seq_axis, shape):
        """The same seeded numpy pool, tables, dense rows and keep mask
        through both packages: the gather bit for bit, the scatter bit for
        bit in every block but the null one (masked writes race into
        it)."""
        import jax.numpy as jnp
        from repro.models.layers import paged_gather as ref_gather
        from repro.models.layers import paged_scatter as ref_scatter

        rng = np.random.RandomState(5)
        pool = rng.randn(*shape).astype(np.float32)
        tables = np.array([[3, 1], [0, 4], [2, 0]], np.int32)
        dshape = list(shape)
        dshape[block_axis] = 3
        dshape[seq_axis] = 2 * shape[seq_axis]
        dense = rng.randn(*dshape).astype(np.float32)
        keep = rng.rand(3, 2 * shape[seq_axis]) < 0.6
        got = paged_gather(torch.from_numpy(pool), _i32(tables),
                           block_axis=block_axis, seq_axis=seq_axis)
        want = ref_gather(jnp.asarray(pool), jnp.asarray(tables),
                          block_axis=block_axis, seq_axis=seq_axis)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got = paged_scatter(torch.from_numpy(pool.copy()),
                            torch.from_numpy(dense), _i32(tables),
                            torch.from_numpy(keep), block_axis=block_axis,
                            seq_axis=seq_axis)
        want = np.asarray(ref_scatter(
            jnp.asarray(pool), jnp.asarray(dense), jnp.asarray(tables),
            jnp.asarray(keep), block_axis=block_axis, seq_axis=seq_axis))
        take = np.arange(1, shape[block_axis])
        np.testing.assert_array_equal(
            np.take(got.numpy(), take, axis=block_axis),
            np.take(want, take, axis=block_axis))

    @pytest.mark.parametrize("block_axis,seq_axis,shape", LAYOUTS)
    def test_narrow_scatter_equals_full_form(self, block_axis, seq_axis,
                                             shape):
        """Scattering only the written positions (a decode step's
        ``lens``, a verify's drafted chunk) leaves every real block as the
        full-width scatter of the same writes does."""
        rng = np.random.RandomState(9)
        bs = shape[seq_axis]
        pool = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        tables = _i32([[3, 1], [2, 4]])
        dshape = list(shape)
        dshape[block_axis] = 2
        dshape[seq_axis] = 2 * bs
        dense = torch.from_numpy(rng.randn(*dshape).astype(np.float32))
        start = _i32([bs - 2, 1])            # row 0 crosses a block edge
        width = 3
        j = torch.arange(width)[None, :]
        positions = start[:, None] + j
        keep = j < _i32([3, 2])[:, None]
        narrow = paged_scatter(pool.clone(), dense, tables, keep,
                               block_axis=block_axis, seq_axis=seq_axis,
                               positions=positions)
        full_keep = torch.zeros(2, 2 * bs, dtype=torch.bool)
        for r in range(2):
            full_keep[r, positions[r][keep[r]].long()] = True
        full = paged_scatter(pool.clone(), dense, tables, full_keep,
                             block_axis=block_axis, seq_axis=seq_axis)
        take = torch.arange(1, shape[block_axis])
        assert torch.equal(narrow.index_select(block_axis, take),
                           full.index_select(block_axis, take))
        assert not torch.equal(narrow, pool)


# -------------------------------------------------------------- proposers --

class TestProposers:
    def test_ngram_proposes_historical_continuation(self):
        p = NGramProposer(max_ngram=3)
        h = np.array([5, 6, 7, 8, 9, 1, 2, 5, 6, 7], np.int32)
        np.testing.assert_array_equal(p.propose(h, 2), [8, 9])
        np.testing.assert_array_equal(p.propose(h, 5), [8, 9, 1, 2, 5])

    def test_ngram_falls_back_to_shorter_grams(self):
        p = NGramProposer(max_ngram=3)
        h = np.array([1, 2, 3, 9, 3], np.int32)   # only the 1-gram matches
        np.testing.assert_array_equal(p.propose(h, 2), [9, 3])

    def test_ngram_empty_cases(self):
        p = NGramProposer()
        assert p.propose(np.array([1, 2, 3], np.int32), 0).size == 0
        assert p.propose(np.array([7], np.int32), 4).size == 0
        # no repeat anywhere -> nothing to propose
        assert p.propose(np.array([1, 2, 3, 4], np.int32), 4).size == 0
        with pytest.raises(ValueError, match="max_ngram"):
            NGramProposer(0)

    def test_draft_model_proposer_is_a_stub(self):
        p = DraftModelProposer(model=None, params=None)
        with pytest.raises(NotImplementedError):
            p.propose(np.array([1, 2], np.int32), 2)

    def test_get_proposer_resolution(self):
        assert get_proposer(None) is None
        assert isinstance(get_proposer("ngram"), NGramProposer)
        custom = NGramProposer(2)
        assert get_proposer(custom) is custom
        with pytest.raises(ValueError, match="unknown proposer"):
            get_proposer("beam")
        with pytest.raises(ValueError, match="propose"):
            get_proposer(42)

    @pytest.mark.parametrize("max_ngram", [1, 3])
    def test_ngram_matches_reference(self, max_ngram):
        """The same histories (repetitive and random, short and long)
        through both packages' proposers: the same drafts."""
        from repro.serve.speculative import NGramProposer as RefNGram

        rng = np.random.RandomState(max_ngram)
        ours, ref = NGramProposer(max_ngram), RefNGram(max_ngram)
        for n in (1, 2, 5, 17, 64, 200):
            for vocab in (3, 8, 1000):
                h = rng.randint(0, vocab, size=n).astype(np.int32)
                for k in (0, 1, 4, 7):
                    got, want = ours.propose(h, k), ref.propose(h, k)
                    assert got.dtype == want.dtype
                    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- the engine --

class TestPagedEngine:
    def test_paged_config_validation(self, tiny):
        cfg, model, params = tiny
        with pytest.raises(ValueError, match="divide"):
            _engine(model, params, max_batch=2, max_seq=96,
                    kv_block_size=13)
        with pytest.raises(ValueError, match="kv_block_size"):
            _engine(model, params, max_batch=2, max_seq=96, kv_block_size=0)

    def test_recurrent_family_has_no_paging(self):
        cfg = get_config("rwkv6_3b").reduced()
        model = get_model(cfg)
        assert model.init_block_pool is None and model.page_axes is None
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        with pytest.raises(ValueError, match="no paged-KV support"):
            _engine(model, params, max_batch=2, max_seq=32, kv_block_size=8)

    @pytest.mark.parametrize("arch", ["zamba2_7b", "rwkv6_3b"])
    def test_pool_refuses_recurrent_families(self, arch):
        """``PagedKVPool`` itself raises the reference's ``ValueError`` on
        the ``ssm`` and ``hybrid`` families (the reference pages no
        recurrent state, zamba's shared block included)."""
        model = get_model(get_config(arch).reduced())
        with pytest.raises(ValueError, match="has no paged-KV support"):
            PagedKVPool(model, n_blocks=4, block_size=8, device="cpu")

    def test_pool_lives_on_the_engine_device(self, tiny):
        cfg, model, params = tiny
        eng = _engine(model, params, max_batch=2, max_seq=32,
                      kv_block_size=8)
        assert eng.cache is None
        assert {k: (tuple(v.shape), v.device.type)
                for k, v in eng.pool.tree.items()} == {
            k: ((cfg.n_layers, 9, cfg.n_kv_heads, 8, cfg.hd), "cpu")
            for k in ("k", "v")}
        assert eng.stats["kv_pool_blocks"] == 8

    def test_pool_pressure_preempts_and_recovers(self, tiny):
        """A pool too small for all admitted slots forces preemption;
        every request still completes with its full token budget, the
        already-emitted prefix survives the requeue bit-exactly, and all
        blocks drain back to the free list."""
        cfg, model, params = tiny
        reqs = _requests(cfg.vocab, [18, 23, 17, 21], max_new=20,
                         prios=[0, 1, 0, 1], seed=1)
        eng = _engine(model, params, max_batch=4, max_seq=64,
                      kv_block_size=8, kv_pool_blocks=6)
        carried = {}
        orig = eng._preempt

        def spy(i):
            s = eng.slots[i]
            carried.setdefault(s.rid, []).append(list(s.generated))
            return orig(i)
        eng._preempt = spy
        eng.submit(reqs)
        eng.run_until_done(max_steps=2000)
        assert eng.stats["kv_preemptions"] > 0
        assert eng.stats["kv_evictions"] >= eng.stats["kv_preemptions"]
        assert sorted(eng.done) == [0, 1, 2, 3]
        for r in reqs:   # exact token budget despite recompute
            assert len(eng.done[r.rid]) == r.max_new_tokens + 1
        for rid, prefixes in carried.items():   # emitted prefix preserved
            for pre in prefixes:
                assert eng.done[rid][:len(pre)] == pre
        eng.alloc.assert_consistent()
        assert eng.alloc.used_blocks == 0
        assert eng.stats["kv_peak_occupancy"] > 0.5

    def test_speculative_parity_and_stats(self, tiny):
        """Greedy accept-or-fix emits exactly the plain-decode tokens on
        both cache layouts, accepted drafts ride a single verify launch
        (fewer decode launches), and the counters move."""
        cfg, model, params = tiny
        lens = [12, 9, 15]
        plain = _engine(model, params, max_batch=3, max_seq=64)
        plain.submit(_requests(cfg.vocab, lens, max_new=8))
        plain.run_until_done(max_steps=400)
        for kv_bs in (None, 16):
            spec = _engine(model, params, max_batch=3, max_seq=64,
                           kv_block_size=kv_bs, speculative="ngram")
            spec.submit(_requests(cfg.vocab, lens, max_new=8))
            spec.run_until_done(max_steps=400)
            assert spec.done == plain.done
            assert spec.stats["spec_drafted_tokens"] > 0
            assert 0 <= spec.stats["spec_accepted_tokens"] \
                <= spec.stats["spec_drafted_tokens"]
            assert "verify" in spec.compile_counts()
            assert spec.stats["decode_steps"] <= plain.stats["decode_steps"]

    def test_speculative_k_validation(self, tiny):
        cfg, model, params = tiny
        with pytest.raises(ValueError, match="speculative_k"):
            _engine(model, params, max_batch=2, max_seq=64,
                    speculative="ngram", speculative_k=0)

    @pytest.mark.parametrize("kv_bs", [None, 16])
    def test_oracle_and_adversary_proposers(self, tiny, kv_bs):
        """Any object with ``.propose`` serves: one drafting the plain
        run's own next tokens has every draft accepted (a multi-position
        commit a launch, a paged scatter of k + 1 positions), one drafting
        a wrong token none; both streams stay the plain run's."""
        cfg, model, params = tiny
        lens, k = [12, 9, 15], 4
        reqs = _requests(cfg.vocab, lens, max_new=12)
        plain = _engine(model, params, max_batch=3, max_seq=64)
        plain.submit(reqs)
        want = plain.run_until_done(max_steps=400)
        by_prompt = {tuple(r.tokens): want[r.rid] for r in reqs}

        class Oracle:
            def propose(self, history, k):
                for prompt, stream in by_prompt.items():
                    if tuple(history[:len(prompt)]) == prompt:
                        n = len(history) - len(prompt)
                        return np.asarray(stream[n:n + k], np.int32)
                raise AssertionError("unknown history")

        class Adversary(Oracle):
            def propose(self, history, k):
                return (super().propose(history, k) + 1) % cfg.vocab

        runs = {}
        for name, proposer in (("oracle", Oracle()),
                               ("adversary", Adversary())):
            eng = _engine(model, params, max_batch=3, max_seq=64,
                          kv_block_size=kv_bs, speculative=proposer,
                          speculative_k=k)
            eng.submit(_requests(cfg.vocab, lens, max_new=12))
            assert eng.run_until_done(max_steps=400) == want
            runs[name] = eng.stats
        assert runs["oracle"]["spec_drafted_tokens"] > 0
        assert runs["oracle"]["spec_accepted_tokens"] \
            == runs["oracle"]["spec_drafted_tokens"]
        # 12 tokens after the first: about ceil(12 / (k + 1)) launches
        assert runs["oracle"]["decode_steps"] <= -(-12 // (k + 1)) + 1
        assert runs["adversary"]["spec_drafted_tokens"] > 0
        assert runs["adversary"]["spec_accepted_tokens"] == 0


# ------------------------------------------------------------ model level --

class TestVerifyContract:
    def test_verify_matches_decode_replay(self, tiny):
        """transformer.verify (single-pass, all-position logits) must
        agree with the sequential decode-step replay it shortcuts —
        same greedy argmax at every valid position."""
        cfg, model, params = tiny
        rng = np.random.RandomState(3)
        b, s, max_len = 2, 6, 32
        tokens = _i32(rng.randint(0, cfg.vocab, size=(b, s)))
        lens = _i32([6, 4])
        offsets = _i32([0, 0])
        fast, _ = model.verify(params, model.init_cache(b, max_len, "cpu"),
                               tokens, lens, offsets)
        slow, _ = replay_verify(model.decode_step)(
            params, model.init_cache(b, max_len, "cpu"), tokens, lens,
            offsets)
        fa, sa = fast.argmax(-1).numpy(), slow.argmax(-1).numpy()
        for r, ln in enumerate([6, 4]):
            np.testing.assert_array_equal(fa[r, :ln], sa[r, :ln])

    def test_families_verify(self):
        """``verify`` is the transformer's single pass for the dense /
        MoE / vlm families, the decode-step replay for ssm and hybrid,
        and only the transformer families page."""
        for arch, paged in (("tinyllama_11b", True), ("dbrx_132b", True),
                            ("deepseek_v2_236b", True),
                            ("llava_next_34b", True), ("rwkv6_3b", False),
                            ("zamba2_7b", False), ("whisper_tiny", False)):
            m = get_model(get_config(arch).reduced())
            assert callable(m.verify)
            assert (m.init_block_pool is not None) == paged, arch
        assert get_model(get_config("deepseek_v2_236b").reduced()) \
            .page_axes() == {"kv_c": 2, "k_pe": 2}
        assert get_model(get_config("tinyllama_11b").reduced()) \
            .page_axes() == {"k": 3, "v": 3}


def _deepseek():
    import jax
    from repro.configs import get_config as jax_config
    from repro.models.registry import get_model as jax_model
    from repro_torch.models.convert import params_from_numpy

    # drop-free capacity: the reference counts padded tokens into an
    # expert's capacity, the port only valid ones (ROADMAP Queue 3)
    jcfg = dataclasses.replace(jax_config("deepseek_v2_236b").reduced(),
                               capacity_factor=8.0)
    jmodel = jax_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    base = get_config("deepseek_v2_236b")
    cfg = dataclasses.replace(base, **{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(base)})
    return dict(cfg=cfg, model=get_model(cfg), jmodel=jmodel,
                jparams=jparams,
                params=params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         cfg, device="cpu"))


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("arch", ["tinyllama", "deepseek"])
def test_verify_matches_jax_model(tiny_both, arch):
    """``model.verify`` in both packages on the same weights, a partly
    filled cache and per-row offsets (a row with ``lens`` 0 writes
    nothing): the logits at every drafted position and the whole cache
    within ``TOL_VERIFY`` of max|ref|.  DeepSeek-V2's verify runs MLA's
    batched prefill over the latent cache (at a drop-free capacity)."""
    import jax
    import jax.numpy as jnp
    from repro_torch.models.convert import cache_from_numpy

    t = tiny_both if arch == "tinyllama" else _deepseek()
    cfg, jm, m = t["cfg"], t["jmodel"], t["model"]
    rng = np.random.RandomState(13)
    b, w, max_len = 3, 5, 48
    pre = rng.randint(0, cfg.vocab, size=(b, 20)).astype(np.int32)
    fills = np.array([20, 7, 0], np.int32)
    _, jcache = jm.prefill(t["jparams"], jm.init_cache(b, max_len),
                           jnp.asarray(pre), jnp.asarray(fills),
                           jnp.zeros(b, jnp.int32))
    cache = cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    tokens = rng.randint(0, cfg.vocab, size=(b, w)).astype(np.int32)
    dlens = np.array([5, 2, 0], np.int32)
    jl, jc = jm.verify(t["jparams"], jcache, jnp.asarray(tokens),
                       jnp.asarray(dlens), jnp.asarray(fills))
    pl, pc = m.verify(t["params"], cache, _i32(tokens), _i32(dlens),
                      _i32(fills))
    assert tuple(pl.shape) == (b, w, cfg.vocab)
    for r, n in enumerate(dlens[:2]):
        assert _rel(pl[r, :n].numpy(), np.asarray(jl)[r, :n]) <= TOL_VERIFY
    assert set(pc) == set(jc)
    for k in pc:
        assert _rel(pc[k].numpy(), jc[k]) <= TOL_VERIFY, k
    # the row with dlens 0 wrote nothing
    for k in pc:
        assert torch.equal(pc[k][:, 2], cache[k][:, 2]), k


def _both_engines(t, lens, max_new=4, prios=None, seed=7, **kw):
    from repro.data.pipeline import Request as JaxRequest
    from repro.serve.engine import ServeConfig as JaxConfig
    from repro.serve.engine import ServeEngine as JaxEngine

    jeng = JaxEngine(t["jmodel"], t["jparams"], JaxConfig(**kw))
    jeng.submit(_requests(t["cfg"].vocab, lens, max_new, prios, seed,
                          cls=JaxRequest))
    jeng.run_until_done(max_steps=2000)
    eng = ServeEngine(t["model"], t["params"],
                      ServeConfig(device="cpu", **kw))
    eng.submit(_requests(t["cfg"].vocab, lens, max_new, prios, seed))
    eng.run_until_done(max_steps=2000)
    return eng, jeng


ENGINE_CASES = {
    "paged": dict(kw=dict(max_batch=3, max_seq=96, kv_block_size=16),
                  lens=[5, 12, 40, 60, 9, 33]),
    "pressure": dict(kw=dict(max_batch=4, max_seq=64, kv_block_size=8,
                             kv_pool_blocks=6),
                     lens=[18, 23, 17, 21], max_new=20, prios=[0, 1, 0, 1],
                     seed=1),
    "ngram fixed": dict(kw=dict(max_batch=3, max_seq=64,
                                speculative="ngram"),
                        lens=[12, 9, 15], max_new=8),
    "ngram paged": dict(kw=dict(max_batch=3, max_seq=64, kv_block_size=16,
                                speculative="ngram"),
                        lens=[12, 9, 15], max_new=8),
    "ngram under pressure": dict(
        kw=dict(max_batch=3, max_seq=64, kv_block_size=8, kv_pool_blocks=7,
                speculative="ngram", speculative_k=3),
        lens=[18, 23, 17], max_new=16),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_paged_engine_matches_jax_engine(tiny_both, case):
    """The same requests through both packages' engines, paged and
    speculative: identical streams, the same preemptions, evictions,
    drafted and accepted tokens and launch counts, the same compiles."""
    c = ENGINE_CASES[case]
    eng, jeng = _both_engines(tiny_both, c["lens"], c.get("max_new", 4),
                              c.get("prios"), c.get("seed", 7), **c["kw"])
    assert eng.done == jeng.done
    assert len(eng.done) == len(c["lens"]) and not eng.failed
    for key in ("kv_preemptions", "kv_evictions", "spec_drafted_tokens",
                "spec_accepted_tokens", "prefill_calls", "decode_steps",
                "tokens_generated", "kv_pool_blocks", "kv_blocks_in_use",
                "kv_peak_occupancy", "requests_completed"):
        assert eng.stats[key] == jeng.stats[key], key
    assert eng.compile_counts()["prefill"] == jeng.compile_counts()["prefill"]
    assert set(eng.compile_counts()) == set(jeng.compile_counts())
    if case == "pressure":
        assert eng.stats["kv_preemptions"] > 0
    if eng.alloc is not None:
        eng.alloc.assert_consistent()


# ----------------------------------------------------------------- card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the paged and speculative "
                    "engines' CUDA graphs and kernels run on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_paged_speculative_graphs_on_card(cuda):
    """A narrow 2-layer TinyLlama served on the card by the fixed-row
    engine, the paged one and the paged speculative one (ngram), each
    entry one CUDA graph: identical streams, captures == compiles, every
    later launch a replay, and the pool back to 0 blocks in use."""
    cfg = dataclasses.replace(get_config("tinyllama_11b"), n_layers=2,
                              d_model=256, n_heads=8, n_kv_heads=2,
                              d_ff=704, vocab=512)
    model = get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    lens = [5, 12, 40, 60, 9, 33]
    runs = {}
    for name, kw in (("fixed", {}), ("paged", dict(kv_block_size=16)),
                     ("spec", dict(kv_block_size=16, speculative="ngram"))):
        eng = ServeEngine(model, params, ServeConfig(max_batch=3, max_seq=96,
                                                     **kw))
        eng.submit(_requests(cfg.vocab, lens, max_new=8))
        runs[name] = eng.run_until_done(max_steps=400)
        fns = {"prefill": eng._prefill_fn, "decode": eng._decode_fn,
               "verify": eng._verify_fn}
        for kind, n in eng.compile_counts().items():
            if n["total"]:
                assert fns[kind].graph_stats.captures == n["total"], kind
        if eng.alloc is not None:
            assert eng.alloc.used_blocks == 0
    assert runs["paged"] == runs["fixed"]
    assert runs["spec"] == runs["fixed"]
