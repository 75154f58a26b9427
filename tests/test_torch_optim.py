"""The port's data stream, optimizer and train-step options against the
JAX package's, on the CPU: twins of ``tests/test_substrate.py``'s
``TestData`` (stream and packing) and ``TestOptim`` cases, each also held
to the reference on the same inputs.

* ``SyntheticLMStream`` and ``pack_sequences`` give the reference's
  arrays bit for bit.
* ``adamw_update`` from the same params, grads and moments equals the
  reference's at rtol 1e-6 (params, mu, nu; a bf16 param as well), in
  place or not; ``cosine_schedule`` equals it; the compression's wire
  and residual equal it (bf16 and top-k, ties included).
* The train step with ``microbatches=2``, with ``grad_compression="bf16"``
  and with ``"topk"`` on the reduced TinyLlama: loss, lr, step and every
  updated parameter against the reference's step from the same state,
  loss rtol 1e-5, params max|Δ|/max|ref| ≤ 1e-4 (top-k's threshold per
  reference leaf: one over all layers of a per-layer list).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree

from _torch_train import batch, jax_flat, pair, port_flat, rel_max, \
    to_jax, to_port
from repro.data.pipeline import SyntheticLMStream as JStream
from repro.data.pipeline import pack_sequences as j_pack
from repro.optim.adamw import adamw_init as j_adamw_init
from repro.optim.adamw import adamw_update as j_adamw_update
from repro.optim.compress import compress_grads as j_compress
from repro.optim.schedule import cosine_schedule as j_cosine
from repro.train.step import TrainConfig as JTrainConfig
from repro.train.step import TrainState as JTrainState
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.data.pipeline import SyntheticLMStream, pack_sequences
from repro_torch.optim import (OptState, adamw_init, adamw_update,
                               compress_grads, cosine_schedule,
                               decompress_grads)
from repro_torch.train.step import TrainConfig, make_train_step, \
    train_state_for


# ------------------------------------------------------------------ data --

class TestData:
    def test_deterministic_resume(self):
        s1 = SyntheticLMStream(vocab=100, batch=4, seq_len=16, seed=3)
        b5 = s1.batch_at(5)
        s2 = SyntheticLMStream(vocab=100, batch=4, seq_len=16, seed=3)
        s2.load_state_dict({"step": 5, "seed": 3})
        np.testing.assert_array_equal(b5["tokens"], s2.batch_at(5)["tokens"])
        assert s2.state_dict() == {"step": 5, "seed": 3}
        first = next(iter(s2))
        np.testing.assert_array_equal(first["labels"], b5["labels"])

    def test_learnable_structure(self):
        b = SyntheticLMStream(vocab=50, batch=8, seq_len=64,
                              seed=0).batch_at(0)
        diffs = (b["labels"] - b["tokens"]) % 50
        for row in diffs:
            assert len(np.unique(row)) <= 6

    @pytest.mark.parametrize("vocab,b,s,seed,step",
                             [(100, 4, 16, 3, 5), (32000, 2, 2048, 0, 7)])
    def test_stream_equals_reference(self, vocab, b, s, seed, step):
        got = SyntheticLMStream(vocab, b, s, seed).batch_at(step)
        want = JStream(vocab, b, s, seed).batch_at(step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])

    def test_packing_no_overlap(self):
        rng = np.random.RandomState(0)
        seqs = [rng.randint(1, 90, size=rng.randint(3, 30)).astype(np.int32)
                for _ in range(20)]
        tokens, segs, mask = pack_sequences(seqs, seq_len=64)
        assert tokens.shape == segs.shape == mask.shape
        assert int(mask.sum()) == sum(len(s) for s in seqs)
        for row in segs:
            nz = row[row > 0]
            assert (np.diff(nz) >= 0).all()
        for got, want in zip((tokens, segs, mask), j_pack(seqs, seq_len=64)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------- optim --

def _tree(rng, dtype=np.float32):
    return {"w": rng.randn(5, 7).astype(dtype),
            "blocks": {"b": rng.randn(3, 4).astype(dtype)},
            "s": rng.randn(4).astype(dtype)}


def _port(tree):
    """A copy of ``tree`` as tensors (the update writes into them)."""
    return {k: _port(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


class TestOptim:
    def test_adamw_decreases_quadratic(self):
        params = {"w": torch.tensor([5.0, -3.0])}
        st = adamw_init(params)
        for _ in range(200):
            grads = {"w": 2 * params["w"]}
            params, st, _ = adamw_update(params, grads, st, lr=0.05,
                                         weight_decay=0.0)
        assert float(params["w"].abs().max()) < 0.5
        # the reference's run, step for step
        jparams = {"w": jnp.array([5.0, -3.0])}
        jst = j_adamw_init(jparams)
        for _ in range(200):
            jparams, jst = j_adamw_update(jparams, {"w": 2 * jparams["w"]},
                                          jst, lr=0.05, weight_decay=0.0)
        np.testing.assert_allclose(params["w"].numpy(),
                                   np.asarray(jparams["w"]), rtol=1e-5,
                                   atol=1e-6)

    def test_adamw_update_equals_reference(self):
        """Three updates from the same params and moments with the same
        grads (one large enough to clip), an f32 lr tensor as the
        schedule gives it; the returned norm is the grads' global norm
        before the clip."""
        rng = np.random.RandomState(1)
        p_np = _tree(rng)
        params, jparams = _port(p_np), jax.tree.map(jnp.asarray, p_np)
        st, jst = adamw_init(params), j_adamw_init(jparams)
        for i, scale in enumerate((0.01, 3.0, 0.2)):
            g_np = jax.tree.map(lambda a: a * scale, _tree(rng))
            lr = 1e-2 * (i + 1)
            params, st, gnorm = adamw_update(
                params, _port(g_np), st, lr=torch.tensor(lr))
            want = np.sqrt(sum(np.square(a, dtype=np.float64).sum()
                               for a in jax.tree.leaves(g_np)))
            np.testing.assert_allclose(float(gnorm), want, rtol=1e-6)
            jparams, jst = j_adamw_update(
                jparams, jax.tree.map(jnp.asarray, g_np), jst,
                lr=jnp.float32(lr))
        assert int(st.step) == int(jst.step) == 3
        for got, want in ((params, jparams), (st.mu, jst.mu),
                          (st.nu, jst.nu)):
            g, w = port_flat(got), jax_flat(want)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=1e-9)

    def test_adamw_update_writes_in_place(self):
        """The update writes the params and the moments into the tensors
        passed in and returns those tensors, holding the values a step
        from clones of them gives."""
        rng = np.random.RandomState(3)
        params = _port(_tree(rng))
        st = adamw_init(params)
        g = _port(_tree(rng))
        clone = lambda t: _pytree.tree_map(torch.clone, t)
        want_p, want_st, _ = adamw_update(
            clone(params), g, OptState(st.step, clone(st.mu), clone(st.nu)),
            lr=1e-2)
        got_p, got_st, _ = adamw_update(params, g, st, lr=1e-2)
        for tree, passed, want in ((got_p, params, want_p),
                                   (got_st.mu, st.mu, want_st.mu),
                                   (got_st.nu, st.nu, want_st.nu)):
            for t, p, w in zip(_pytree.tree_leaves(tree),
                               _pytree.tree_leaves(passed),
                               _pytree.tree_leaves(want)):
                assert t is p
                torch.testing.assert_close(t, w, rtol=0, atol=0)
        assert int(got_st.step) == 1 and int(st.step) == 0

    def test_adamw_bf16_param_keeps_dtype(self):
        rng = np.random.RandomState(2)
        p32 = rng.randn(6, 8).astype(np.float32)
        g = rng.randn(6, 8).astype(np.float32)
        pb = torch.from_numpy(p32).to(torch.bfloat16)
        params, st, _ = adamw_update({"w": pb}, {"w": torch.from_numpy(g)},
                                     adamw_init({"w": pb}), lr=1e-2)
        jp = {"w": jnp.asarray(p32).astype(jnp.bfloat16)}
        jparams, jst = j_adamw_update(jp, {"w": jnp.asarray(g)},
                                      j_adamw_init(jp), lr=1e-2)
        assert params["w"].dtype == torch.bfloat16
        assert st.mu["w"].dtype == torch.float32
        np.testing.assert_array_equal(
            params["w"].float().numpy(),
            np.asarray(jparams["w"].astype(jnp.float32)))
        np.testing.assert_allclose(st.mu["w"].numpy(), np.asarray(jst.mu["w"]),
                                   rtol=1e-6)

    def test_schedule_shape(self):
        assert float(cosine_schedule(0, peak_lr=1.0, warmup=10,
                                     total=100)) == 0.0
        assert float(cosine_schedule(10, peak_lr=1.0, warmup=10, total=100)) \
            == pytest.approx(1.0)
        end = float(cosine_schedule(100, peak_lr=1.0, warmup=10, total=100))
        assert end == pytest.approx(0.1, abs=1e-3)
        for step in (0, 1, 5, 10, 11, 57, 100, 150):
            got = cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                  peak_lr=3e-4, warmup=10, total=100)
            assert got.dtype == torch.float32 and got.dim() == 0
            want = j_cosine(jnp.int32(step), peak_lr=3e-4, warmup=10,
                            total=100)
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)

    def test_compression_error_feedback_unbiased(self):
        g_np = np.random.RandomState(0).randn(256).astype(np.float32) * 1e-3
        grads = {"w": torch.from_numpy(g_np)}
        residual = None
        acc = torch.zeros(256)
        for _ in range(50):
            wire, residual = compress_grads(grads, residual)
            assert wire["w"].dtype == torch.bfloat16
            acc = acc + decompress_grads(wire)["w"]
        np.testing.assert_allclose(acc.numpy(), g_np * 50, rtol=1e-2,
                                   atol=1e-5)

    @pytest.mark.parametrize("topk_frac", [None, 0.05])
    def test_compression_equals_reference(self, topk_frac):
        """bf16 wire and f32 residual bit for bit, three rounds; top-k on
        the leaf of 300 elements (ties at the threshold kept, as ``>=``
        keeps them) and not on the one of 64."""
        rng = np.random.RandomState(4)
        big = rng.randn(300).astype(np.float32)
        big[:6] = np.abs(big).max()          # a tie at the top
        tree = {"big": big, "small": rng.randn(64).astype(np.float32)}
        res = jres = None
        for _ in range(3):
            wire, res = compress_grads(_port(tree), res, topk_frac=topk_frac)
            jwire, jres = j_compress(jax.tree.map(jnp.asarray, tree), jres,
                                     topk_frac=topk_frac)
            for k in tree:
                np.testing.assert_array_equal(
                    wire[k].float().numpy(),
                    np.asarray(jwire[k].astype(jnp.float32)))
                np.testing.assert_array_equal(res[k].numpy(),
                                              np.asarray(jres[k]))
        if topk_frac is not None:
            kept = int((wire["big"] != 0).sum())
            assert 15 <= kept < 300
            assert int((wire["small"] != 0).sum()) == 64

    def test_microbatch_accumulation_matches_full(self):
        cfg, model, params, *_ = pair("tinyllama_11b")
        rng = np.random.RandomState(0)
        bnp = {"tokens": rng.randint(0, cfg.vocab, (4, 16)).astype(np.int32),
               "labels": rng.randint(0, cfg.vocab, (4, 16)).astype(np.int32),
               "mask": np.ones((4, 16), np.float32)}
        losses = []
        for m in (1, 2):
            tcfg = TrainConfig(microbatches=m, peak_lr=1e-3, warmup=1)
            fresh = torch.utils._pytree.tree_map(torch.clone, params)
            _, metrics = make_train_step(model, tcfg)(
                train_state_for(fresh, tcfg), to_port(bnp))
            losses.append(float(metrics["loss"]))
        np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)


# ------------------------------------------------ step options vs the JAX --

@pytest.mark.parametrize("opts", [dict(microbatches=2),
                                  dict(grad_compression="bf16"),
                                  dict(grad_compression="topk",
                                       topk_frac=0.05)],
                         ids=["microbatches", "bf16", "topk"])
def test_step_options_equal_reference(opts):
    """Two steps (lr > 0 in the second) of the port's and the reference's
    step from the same TinyLlama weights and batch."""
    cfg, model, params, jcfg, jm, jp = pair("tinyllama_11b")
    bnp = batch(cfg, np.random.RandomState(5), b=4, mask_tail=3)
    tcfg = TrainConfig(peak_lr=1e-3, warmup=1, total_steps=10, **opts)
    jt = JTrainConfig(peak_lr=1e-3, warmup=1, total_steps=10, **opts)
    state = train_state_for(params, tcfg)
    jres = () if jt.grad_compression is None else jax.tree.map(
        lambda p: jnp.zeros(p.shape, jnp.float32), jp)
    jstate = JTrainState(params=jp, opt=j_adamw_init(jp), residual=jres)
    step, jstep = make_train_step(model, tcfg), jax.jit(
        j_make_train_step(jm, jt))
    for _ in range(2):
        state, metrics = step(state, to_port(bnp))
        jstate, jmetrics = jstep(jstate, to_jax(bnp))
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(jmetrics["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(metrics["lr"]),
                                   float(jmetrics["lr"]), rtol=1e-6)
        assert int(metrics["step"]) == int(jmetrics["step"])
    got, want = port_flat(state.params), jax_flat(jstate.params)
    for k in want:
        assert rel_max(got[k], want[k]) <= 1e-4, (k, rel_max(got[k], want[k]))
    if opts.get("grad_compression"):
        got, want = port_flat(state.residual), jax_flat(jstate.residual)
        assert set(got) == set(want)
