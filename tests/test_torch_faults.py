"""The port's fault plane (``repro_torch.ft``) against the JAX package's,
on the CPU.

Twins of ``tests/test_faults.py``, at the reference's reduced TinyLlama
in f32 with the JAX parameters carried across (``models/convert.py``):

* the error taxonomy and the injector, case by case, with the same
  schedules drawn through both packages' injectors;
* the compile ladder on both pipelines through ``disc_torch.compile``,
  with the same cache counters as ``disc.compile``;
* the kernel cases: the port has no per-op fallback, so where the
  reference strikes and demotes a kernel, a ``kernel.cluster`` fault
  raises a classified error, no cluster runs per op, a transient one is
  retried by the compile cache's ladder, and the next call runs the
  kernel;
* the serve engine under each fault: every surviving stream equals the
  JAX engine's fault-free stream over the same weights, token for token
  (the tolerance of ``tests/test_torch_serve.py``).

The paged-KV cases (``pool.alloc``) run on a paged pool, as the
reference's do; the mesh cases wait for their slice and skip, naming
it.
"""
from __future__ import annotations


import numpy as np
import pytest
import torch

import disc_torch
from repro_torch.data.pipeline import Request
from repro_torch.errors import (CONTROL_EXCEPTIONS, CompileError,
                                DeadlineExceeded, DiscError, LaunchError,
                                PoolExhausted, RetryPolicy,
                                classify_transient, retry_call,
                                wrap_compile_error, wrap_launch_error)
from repro_torch.ft import faults
from repro_torch.ft.faults import FaultInjector, FaultSpec
from repro_torch.serve.engine import STATS_KEYS, ServeConfig, ServeEngine

from _torch_parity import reduced_tinyllama

MESH = "SPMD serving arrives with the port's multi-GPU slice"


@pytest.fixture(scope="module")
def tiny():
    """The reduced TinyLlama, initialised by the JAX package and carried
    into the port (one build a process, shared with the other twins)."""
    return reduced_tinyllama()


@pytest.fixture(autouse=True)
def _no_injector_leak():
    """A test that leaves an injector installed would fault every test
    after it; fail loudly and clean up."""
    yield
    leaked = faults.ACTIVE is not None
    faults.clear()
    assert not leaked, "test left a FaultInjector installed"


def _requests(vocab, lens, max_new=5, rid0=0, cls=Request):
    rng = np.random.RandomState(11)
    return [cls(rid=rid0 + i,
                tokens=rng.randint(0, vocab, size=ln).astype(np.int32),
                max_new_tokens=max_new)
            for i, ln in enumerate(lens)]


def _engine(t, **kw):
    kw.setdefault("max_batch", 3)
    kw.setdefault("max_seq", 64)
    return ServeEngine(t["model"], t["params"],
                       ServeConfig(device="cpu", **kw))


def _run(t, reqs, **kw):
    eng = _engine(t, **kw)
    eng.submit(reqs)
    done = eng.run_until_done(max_steps=400)
    return eng, done


LENS = [5, 9, 12]
#: the request sets whose fault-free streams the tests hold the port to:
#: prompt lengths and first rid
SETS = {"lens": (LENS, 0), "wave2": ([7, 10], 100),
        "two_groups": ([5, 40], 0), "drain": ([6, 9], 0)}


@pytest.fixture(scope="module")
def base(tiny):
    """The JAX engine's fault-free streams of every request set, by set
    and rid, served in one run: a greedy stream follows from its prompt,
    not from the requests it shares a batch with."""
    from repro.data.pipeline import Request as JaxRequest
    from repro.serve.engine import ServeConfig as JaxConfig
    from repro.serve.engine import ServeEngine as JaxEngine

    eng = JaxEngine(tiny["jmodel"], tiny["jparams"],
                    JaxConfig(max_batch=3, max_seq=64))
    owner = []
    for name, (lens, rid0) in SETS.items():
        for r in _requests(tiny["cfg"].vocab, lens, rid0=rid0):
            eng.submit([JaxRequest(rid=len(owner), tokens=r.tokens,
                                   max_new_tokens=r.max_new_tokens)])
            owner.append((name, r.rid))
    done = eng.run_until_done(max_steps=400)
    out: dict = {name: {} for name in SETS}
    for uid, (name, rid) in enumerate(owner):
        out[name][rid] = done[uid]
    return out


# ------------------------------------------------------------- taxonomy --

class TestTaxonomy:
    def test_hierarchy_preserves_builtin_types(self):
        assert issubclass(CompileError, ValueError)
        assert issubclass(LaunchError, RuntimeError)
        assert issubclass(PoolExhausted, RuntimeError)
        assert issubclass(DeadlineExceeded, TimeoutError)
        for k in (CompileError, LaunchError, PoolExhausted,
                  DeadlineExceeded):
            assert issubclass(k, DiscError)

    def test_classify_transient(self):
        from repro_torch.core.constraints import ConstraintViolation
        from repro_torch.frontends.fx_frontend import (
            UnsupportedPrimitiveError)
        assert not classify_transient(ConstraintViolation("8 % 3"))
        assert not classify_transient(UnsupportedPrimitiveError("nope"))
        assert not classify_transient(TypeError("bad arg"))
        assert classify_transient(RuntimeError("RESOURCE_EXHAUSTED: hbm"))
        assert classify_transient(RuntimeError("CUDA out of memory"))
        assert classify_transient(MemoryError("out of memory"))
        assert classify_transient(LaunchError("x", transient=True))
        assert not classify_transient(CompileError("x", transient=False))

    def test_wrappers_chain_and_classify(self):
        src = RuntimeError("RESOURCE_EXHAUSTED while allocating")
        ce = wrap_compile_error(src, "bucket (8,)")
        assert ce.transient and ce.__cause__ is src
        assert "bucket (8,)" in str(ce)
        le = wrap_launch_error(ValueError("shape"), "decode")
        assert not le.transient and isinstance(le, LaunchError)
        assert wrap_compile_error(ce, "again") is ce
        assert wrap_launch_error(le, "again") is le

    def test_retry_call_retries_transient_only(self):
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise LaunchError("flap", transient=True)
            return "ok"

        pol = RetryPolicy(max_retries=3, backoff_s=0.0)
        assert retry_call(flaky, policy=pol, sleep=lambda s: None) == "ok"
        assert calls["n"] == 3

        def perm():
            raise LaunchError("dead", transient=False)

        with pytest.raises(LaunchError, match="dead"):
            retry_call(perm, policy=pol, sleep=lambda s: None)

    def test_control_exceptions_never_swallowed(self):
        def boom():
            raise KeyboardInterrupt
        with pytest.raises(KeyboardInterrupt):
            retry_call(boom, policy=RetryPolicy(max_retries=5,
                                                backoff_s=0.0),
                       sleep=lambda s: None)
        assert KeyboardInterrupt in CONTROL_EXCEPTIONS

    def test_backoff_is_capped_exponential(self):
        pol = RetryPolicy(max_retries=9, backoff_s=0.01, multiplier=2.0,
                          cap_s=0.04)
        assert pol.delay(0) == pytest.approx(0.01)
        assert pol.delay(1) == pytest.approx(0.02)
        assert pol.delay(5) == pytest.approx(0.04)   # capped

    @pytest.mark.parametrize("exc", [
        RuntimeError("RESOURCE_EXHAUSTED: hbm"), RuntimeError("boom"),
        MemoryError("out of memory"), TypeError("bad"),
        ValueError("OOM while planning")])
    def test_classification_matches_jax(self, exc):
        from repro.errors import classify_transient as jax_classify

        assert classify_transient(exc) == jax_classify(exc)


# ------------------------------------------------------------- injector --

class TestInjector:
    def test_unknown_site_rejected(self):
        with pytest.raises(ValueError, match="unknown fault site"):
            FaultSpec("compile.bukcet")

    def test_pool_alloc_is_live(self):
        """``pool.alloc`` has its hook (the block allocator's ``ensure``):
        every site is live, a spec naming it builds, and the chaos
        injector's default sites include it."""
        assert "pool.alloc" in faults.LIVE_SITES
        assert set(faults.LIVE_SITES) == set(faults.SITES)
        assert FaultSpec("pool.alloc", times=1).site == "pool.alloc"
        inj = FaultInjector.chaos(seed=0)
        assert "pool.alloc" in {s.site for s in inj.specs}

    def test_disabled_by_default(self):
        assert faults.ACTIVE is None

    def test_at_indexes_matching_calls(self):
        inj = FaultInjector([FaultSpec("serve.launch", match="decode",
                                       at=[0])])
        inj.suppress("serve.launch", key="prefill")
        inj.suppress("serve.launch", key="prefill")
        assert inj.suppress("serve.launch", key="decode")
        assert not inj.suppress("serve.launch", key="decode")
        assert inj.calls["serve.launch"] == 4
        assert inj.fired["serve.launch"] == 1

    def test_times_bounds_firing(self):
        inj = FaultInjector([FaultSpec("ft.heartbeat", times=2)])
        hits = [inj.suppress("ft.heartbeat") for _ in range(5)]
        assert hits == [True, True, False, False, False]

    def test_seeded_probability_is_deterministic(self):
        def schedule(seed):
            inj = FaultInjector([FaultSpec("ft.heartbeat", p=0.3)],
                                seed=seed)
            return [inj.suppress("ft.heartbeat") for _ in range(64)]
        assert schedule(7) == schedule(7)
        assert schedule(7) != schedule(8)
        assert any(schedule(7)) and not all(schedule(7))

    def test_check_raises_classified_default_errors(self):
        with faults.inject(FaultSpec("compile.bucket", transient=True),
                           FaultSpec("serve.launch")) as inj:
            with pytest.raises(CompileError, match="transient fault") as ei:
                inj.check("compile.bucket")
            assert ei.value.transient
            with pytest.raises(LaunchError, match="permanent fault") as ei:
                inj.check("serve.launch")
            assert not ei.value.transient
        assert faults.ACTIVE is None   # context manager uninstalls

    def test_chaos_injector_is_seed_deterministic(self):
        a = FaultInjector.chaos(seed=3, rate=0.5)
        b = FaultInjector.chaos(seed=3, rate=0.5)
        fires = [a.suppress("ft.heartbeat") for _ in range(32)]
        assert fires == [b.suppress("ft.heartbeat") for _ in range(32)]
        assert {s.site for s in a.specs} == set(faults.LIVE_SITES)

    @pytest.mark.parametrize("seed", [0, 3, 12])
    def test_schedules_match_jax(self, seed):
        """The same specs, keys and seed fire on the same calls in both
        packages."""
        from repro.ft import faults as jax_faults

        def fires(mod):
            inj = mod.FaultInjector(
                [mod.FaultSpec("serve.launch", match="decode", p=0.4,
                               times=5),
                 mod.FaultSpec("compile.bucket", at=[1, 4], transient=True),
                 mod.FaultSpec("ft.heartbeat", match="replica1", p=0.5),
                 mod.FaultSpec("pool.alloc", match="slot2", p=0.3,
                               times=4)],
                seed=seed)
            keys = [("serve.launch", "prefill"), ("serve.launch", "decode"),
                    ("compile.bucket", "jit:prefill (16,)"),
                    ("ft.heartbeat", "replica0"),
                    ("ft.heartbeat", "replica1"),
                    ("pool.alloc", "slot1"), ("pool.alloc", "slot2")]
            out = [inj.suppress(site, key=key)
                   for _ in range(12) for site, key in keys]
            return out, inj.calls, inj.fired

        assert fires(faults) == fires(jax_faults)


# ------------------------------------- compile ladder (both pipelines) --

def _ew(x, y):
    return torch.tanh(x) * y + torch.exp(x * 0.5)


def _cf(pipeline="dhlo", **kw):
    return disc_torch.compile(
        _ew, [disc_torch.ArgSpec(("B", 8), torch.float32)] * 2,
        pipeline=pipeline, device="cpu", **kw)


def _jax_cf(pipeline="dhlo", **kw):
    import disc
    import jax.numpy as jnp

    return disc.compile(lambda x, y: jnp.tanh(x) * y + jnp.exp(x * 0.5),
                        [disc.ArgSpec(("B", 8))] * 2, pipeline=pipeline,
                        **kw)


def _want(x):
    return _ew(x, x).numpy()


class TestCompileLadder:
    @pytest.mark.parametrize("pipeline", ["dhlo", "jit"])
    def test_transient_compile_fault_retried_invisibly(self, pipeline):
        cf = _cf(pipeline)
        x = torch.from_numpy(np.random.RandomState(0).randn(5, 8)
                             .astype(np.float32))
        with faults.inject(FaultSpec("compile.bucket", times=1,
                                     transient=True)) as inj:
            out = cf(x, x)[:len(x)]
        np.testing.assert_allclose(out.numpy(), _want(x), rtol=1e-5,
                                   atol=1e-6)
        assert cf.cache_stats()["retries"] == 1
        assert inj.fired["compile.bucket"] == 1
        assert cf.compile_counts()["total"] == 1

    @pytest.mark.parametrize("pipeline", ["dhlo", "jit"])
    def test_permanent_compile_fault_raises_then_cache_recovers(
            self, pipeline):
        cf = _cf(pipeline)
        x = torch.from_numpy(np.random.RandomState(1).randn(4, 8)
                             .astype(np.float32))
        with faults.inject(FaultSpec("compile.bucket")):
            with pytest.raises(CompileError, match="injected permanent"):
                cf(x, x)
        out = cf(x, x)[:len(x)]
        np.testing.assert_allclose(out.numpy(), _want(x), rtol=1e-5,
                                   atol=1e-6)

    def test_failed_escalation_falls_back_to_padded_bucket(self):
        cf = _cf(escalation_threshold=2)
        ref = _cf()
        x = torch.from_numpy(np.random.RandomState(2).randn(5, 8)
                             .astype(np.float32))
        with faults.inject(FaultSpec("compile.exact")):
            outs = [cf(x, x) for _ in range(5)]
        for o in outs:
            np.testing.assert_allclose(o.numpy(), ref(x, x).numpy(),
                                       rtol=1e-5, atol=1e-6)
        st = cf.cache_stats()
        assert st["escalation_failures"] == 1
        assert cf.compile_counts()["exact"] == 0

    def test_transient_escalation_failure_does_not_pin(self):
        cf = _cf(escalation_threshold=2)
        x = torch.from_numpy(np.random.RandomState(3).randn(5, 8)
                             .astype(np.float32))
        with faults.inject(FaultSpec("compile.exact", times=3,
                                     transient=True)):
            for _ in range(4):
                cf(x, x)
        assert cf.cache_stats()["escalation_failures"] == 0
        assert cf.cache_stats()["retries"] == 2
        cf(x, x)
        assert cf.compile_counts()["exact"] == 1

    @pytest.mark.parametrize("pipeline", ["dhlo", "jit"])
    @pytest.mark.parametrize("spec", [
        dict(site="compile.bucket", times=1, transient=True),
        dict(site="compile.bucket", at=[1]),
        dict(site="compile.exact", times=3, transient=True),
        dict(site="compile.exact")])
    def test_cache_counters_match_jax(self, pipeline, spec):
        """The same call sequence under the same fault through
        ``disc.compile`` and ``disc_torch.compile``: the same cache
        counters, compile counts and raised classes."""
        from repro.ft import faults as jax_faults

        sizes = (5, 5, 5, 9, 5, 20, 5)

        def drive(make, fmod, to):
            cf = make(pipeline, escalation_threshold=2)
            raised = []
            with fmod.inject(fmod.FaultSpec(**spec)):
                for s in sizes:
                    x = to(np.ones((s, 8), np.float32))
                    try:
                        cf(x, x)
                        raised.append(None)
                    except DiscError as e:
                        raised.append((type(e).__name__, e.transient))
                    except Exception as e:  # noqa: BLE001 — the JAX class
                        raised.append((type(e).__name__, e.transient))
            return raised, cf.cache_stats(), cf.compile_counts()

        got = drive(_cf, faults, torch.from_numpy)
        want = drive(_jax_cf, jax_faults, lambda a: a)
        assert got[0] == want[0]
        for k in ("hits", "misses", "escalations", "retries",
                  "escalation_failures"):
            assert got[1][k] == want[1][k], k
        assert got[2] == want[2]


# ------------------------------------------------- kernel fault ladder --

def _hopper_cf():
    return disc_torch.compile(
        _ew, [disc_torch.ArgSpec(("B", "D"), torch.float32)] * 2,
        backend="hopper", device="cpu")


class TestKernelFaults:
    """The reference demotes a failing kernel to per-op execution; the
    port has no per-op fallback, so a ``kernel.cluster`` fault raises."""

    def test_kernel_fault_raises_and_next_call_runs_the_kernel(self):
        cf = _hopper_cf()
        kern = cf.backend.cluster_kernels["kLoop"]
        rng = np.random.RandomState(4)
        runs0 = kern.runs
        with faults.inject(FaultSpec("kernel.cluster")) as inj:
            for b in (4, 17, 33):
                x = torch.from_numpy(rng.randn(b, 8).astype(np.float32))
                with pytest.raises(CompileError,
                                   match="injected permanent") as ei:
                    cf(x, x)
                assert not ei.value.transient
                assert isinstance(ei.value.__cause__, LaunchError)
        assert inj.fired["kernel.cluster"] == 3
        # no cluster ran, per op or through the kernel, and no failed
        # entry was kept or counted
        assert kern.runs == runs0
        assert cf.compile_counts()["total"] == 0 and len(cf.cache) == 0
        assert not hasattr(kern, "demoted") and not hasattr(kern, "strike")
        # the next call compiles and runs the kernel
        for b in (4, 17, 33, 65):
            x = torch.from_numpy(rng.randn(b, 8).astype(np.float32))
            np.testing.assert_allclose(cf(x, x).numpy(), _want(x),
                                       rtol=1e-5, atol=1e-6)
        assert kern.runs == runs0 + 4
        assert cf.backend.name == "hopper"

    def test_transient_kernel_fault_retried_by_cache_ladder(self):
        cf = _hopper_cf()
        kern = cf.backend.cluster_kernels["kLoop"]
        runs0 = kern.runs
        x = torch.from_numpy(np.random.RandomState(5).randn(6, 8)
                             .astype(np.float32))
        with faults.inject(FaultSpec("kernel.cluster", times=1,
                                     transient=True)) as inj:
            out = cf(x, x)
        np.testing.assert_allclose(out.numpy(), _want(x), rtol=1e-5,
                                   atol=1e-6)
        assert inj.fired["kernel.cluster"] == 1
        assert cf.cache_stats()["retries"] == 1
        assert cf.compile_counts()["total"] == 1
        assert kern.runs == runs0 + 1

    def test_kernel_faults_never_demote_the_backend(self):
        """The twin of the backend-demotion case: however many kernel
        faults, the artifact keeps its backend and the options that
        configure a demotion do not exist."""
        cf = _hopper_cf()
        rng = np.random.RandomState(6)
        with faults.inject(FaultSpec("kernel.cluster")):
            for b in (4, 17, 33):
                x = torch.from_numpy(rng.randn(b, 8).astype(np.float32))
                with pytest.raises(CompileError):
                    cf(x, x)
        assert cf.backend.name == "hopper"
        for opt in ("fallback_backend", "backend_demotion_strikes"):
            with pytest.raises(TypeError):
                disc_torch.CompileOptions(**{opt: None})
        x = torch.from_numpy(rng.randn(6, 8).astype(np.float32))
        np.testing.assert_allclose(cf(x, x).numpy(), _want(x), rtol=1e-5,
                                   atol=1e-6)

    def test_kernel_fault_site_key_is_the_template(self):
        cf = _hopper_cf()
        x = torch.ones(3, 8)
        with faults.inject(FaultSpec("kernel.cluster",
                                     match="kInput")) as inj:
            cf(x, x)        # a kLoop-only graph: the spec never matches
        assert inj.calls["kernel.cluster"] >= 1
        assert inj.fired["kernel.cluster"] == 0


# --------------------------------------------- engine differential suite --

class TestServeDifferential:
    def test_transient_launch_fault_full_parity(self, tiny, base):
        with faults.inject(FaultSpec("serve.launch", at=[0],
                                     transient=True)):
            eng, done = _run(tiny, _requests(tiny["cfg"].vocab, LENS))
        assert done == base["lens"]        # the JAX fault-free streams
        assert eng.stats["retries"] >= 1
        assert not eng.failed

    def test_permanent_decode_fault_fails_group_only(self, tiny, base):
        vocab = tiny["cfg"].vocab
        with faults.inject(FaultSpec("serve.launch", match="decode",
                                     at=[1])):
            eng = _engine(tiny)
            eng.submit(_requests(vocab, LENS))
            done = eng.run_until_done(max_steps=400)
            assert set(eng.failed) == {r.rid
                                       for r in _requests(vocab, LENS)}
            assert all("LaunchError(decode)" in v
                       for v in eng.failed.values())
            assert eng.stats["failed_requests"] == len(LENS)
            assert not done
            eng.submit(_requests(vocab, [7, 10], rid0=100))
            done2 = eng.run_until_done(max_steps=400)
        assert done2 == base["wave2"]

    def test_transient_decode_compile_fault_retried(self, tiny, base):
        """A transient compile failure of the decode bucket that outlasts
        the cache's own retries reaches the launch ladder, which retries
        it: a failed compile ran nothing, so it wrote no cache row."""
        with faults.inject(FaultSpec("compile.bucket", match="decode",
                                     at=[0, 1, 2], transient=True)) as inj:
            eng, done = _run(tiny, _requests(tiny["cfg"].vocab, LENS))
        assert inj.fired["compile.bucket"] == 3
        assert eng.stats["retries"] == 1
        assert not eng.failed
        assert done == base["lens"]        # the JAX fault-free streams

    def test_permanent_prefill_fault_spares_other_group(self, tiny, base):
        reqs = _requests(tiny["cfg"].vocab, [5, 40])
        with faults.inject(FaultSpec("serve.launch", match="prefill",
                                     at=[0])):
            eng, done = _run(tiny, reqs)
        assert len(eng.failed) == 1 and len(done) == 1
        (frid,) = eng.failed
        (orid,) = done
        assert "LaunchError(prefill)" in eng.failed[frid]
        assert done[orid] == base["two_groups"][orid]

    def test_compile_fault_during_serve_fails_group_not_engine(self, tiny):
        with faults.inject(FaultSpec("compile.bucket", match="prefill")):
            eng, done = _run(tiny, _requests(tiny["cfg"].vocab, LENS))
        assert not done
        assert set(eng.failed) and all(
            "LaunchError(prefill)" in v or "injected permanent" in v
            for v in eng.failed.values())

    def test_pool_alloc_fault_preempts_and_recovers(self, tiny, base):
        vocab = tiny["cfg"].vocab
        paged = dict(kv_block_size=16, kv_pool_blocks=12)
        _, want = _run(tiny, _requests(vocab, LENS), **paged)
        assert want == base["lens"]    # the JAX fault-free streams
        with faults.inject(FaultSpec("pool.alloc", times=2)) as inj:
            eng, done = _run(tiny, _requests(vocab, LENS), **paged)
        assert inj.fired["pool.alloc"] == 2
        assert done == want            # greedy recompute is exact
        assert not eng.failed
        eng.alloc.assert_consistent()

    def test_pool_exhaustion_bounds_recompute(self, tiny):
        vocab = tiny["cfg"].vocab
        with faults.inject(FaultSpec("pool.alloc")):   # every alloc denied
            eng, done = _run(tiny, _requests(vocab, LENS),
                             kv_block_size=16, kv_pool_blocks=12,
                             max_recomputes=2)
        # bounded recompute turns the livelock into PoolExhausted
        assert not done
        assert set(eng.failed) == {r.rid for r in _requests(vocab, LENS)}
        assert all("PoolExhausted" in v for v in eng.failed.values())
        assert not eng.queue and all(s is None for s in eng.slots)
        eng.alloc.assert_consistent()

    def test_deadline_expires_only_late_request(self, tiny):
        vocab = tiny["cfg"].vocab
        _, want = _run(tiny, _requests(vocab, LENS[:2], max_new=6))
        eng = _engine(tiny)
        t = [0.0]
        eng._clock = lambda: t[0]
        reqs = _requests(vocab, LENS, max_new=6)
        reqs[2].deadline_s = 3.0
        eng.submit(reqs)
        for _ in range(3):
            eng.step()
        t[0] = 5.0
        done = eng.run_until_done(max_steps=400)
        assert set(eng.failed) == {2}
        assert "DeadlineExceeded" in eng.failed[2]
        assert eng.stats["deadline_expirations"] == 1
        assert {k: done[k] for k in want} == want

    def test_deadline_checked_at_admission(self, tiny):
        eng = _engine(tiny, max_batch=1)
        t = [0.0]
        eng._clock = lambda: t[0]
        r = _requests(tiny["cfg"].vocab, [6], max_new=4)
        r[0].deadline_s = 1.0
        eng.submit(r)
        t[0] = 2.0
        eng.step()
        assert eng.failed[0].endswith("before completion")
        assert eng.stats["deadline_expirations"] == 1

    def test_replica_drain_preempts_and_survivors_serve(self, tiny, base):
        vocab = tiny["cfg"].vocab
        eng = _engine(tiny, max_batch=1, replicas=2,
                      heartbeat_deadline_s=5.0)
        t = [1.0]
        eng._clock = lambda: t[0]
        for r in range(2):
            eng.heartbeat(r)
        eng.submit(_requests(vocab, [6, 9]))
        for _ in range(3):
            eng.step()             # both prefilled, one decode step
        assert all(s is not None and s.generated for s in eng.slots)
        t[0] = 10.0
        eng.heartbeat(0)           # only replica 0 stays live
        done = eng.run_until_done(max_steps=400)
        assert eng.stats["replica_drains"] == 1
        assert eng._replica_alive == [True, False]
        assert not eng.failed
        # the drained request resumed through a prefill of prompt +
        # generated tokens: every stream equals the fault-free one
        assert done == base["drain"]
        assert eng.stats["per_replica"][1]["requests_completed"] == 0
        eng.heartbeat(1)
        eng.submit(_requests(vocab, [7], rid0=50))
        eng.run_until_done(max_steps=400)
        assert 50 in eng.done
        assert eng._replica_alive == [True, True]
        assert eng.stats["per_replica"][1]["admitted"] >= 1

    def test_injected_heartbeat_loss_drains_replica(self, tiny, base):
        with faults.inject(FaultSpec("ft.heartbeat", match="replica1")):
            eng = _engine(tiny, max_batch=1, replicas=2,
                          heartbeat_deadline_s=60.0)
            t = [1000.0]
            eng._clock = lambda: t[0]
            eng.heartbeat(0)
            eng.heartbeat(1)       # dropped: replica 1 last beat at init
            eng.submit(_requests(tiny["cfg"].vocab, [6, 9]))
            t[0] = 1000.0 + 61.0
            eng.heartbeat(0)
            done = eng.run_until_done(max_steps=400)
        assert eng.stats["replica_drains"] == 1
        assert eng._replica_alive == [True, False]
        assert done == base["drain"]
        assert eng.stats["per_replica"][1]["admitted"] == 0

    def test_report_health_structure(self, tiny):
        with faults.inject(FaultSpec("serve.launch", at=[0],
                                     transient=True)):
            eng, _ = _run(tiny, _requests(tiny["cfg"].vocab, [5]),
                          heartbeat_deadline_s=60.0)
        rep = eng.report()
        h = rep["health"]
        assert h["alive_replicas"] == 1
        assert h["replicas"][0]["alive"]
        assert "last_beat_age_s" in h["replicas"][0]
        assert h["counters"]["retries"] >= 1
        assert set(h["counters"]) == {"failed_requests", "retries",
                                      "kernel_demotions",
                                      "deadline_expirations",
                                      "replica_drains"}
        assert h["failed"] == {}
        assert set(h["compile"]) == {"retries", "escalation_failures"}
        assert h["kernel_demotions"] == []
        assert h["counters"]["kernel_demotions"] == 0
        assert set(rep) == {"health", "stats", "compiles"}
        assert set(rep["stats"]) == set(STATS_KEYS)

    def test_report_health_matches_jax(self, tiny):
        """The same faulted run through both engines: the same health
        structure and counters, and the same stats keys where both
        packages have them."""
        from repro.data.pipeline import Request as JaxRequest
        from repro.ft import faults as jax_faults
        from repro.serve.engine import STATS_KEYS as JAX_KEYS
        from repro.serve.engine import ServeConfig as JaxConfig
        from repro.serve.engine import ServeEngine as JaxEngine

        vocab = tiny["cfg"].vocab
        kw = dict(max_batch=1, replicas=2, max_seq=64,
                  heartbeat_deadline_s=60.0)

        def run(fmod, eng):
            eng._clock = lambda: 0.0
            for r in range(2):
                eng.heartbeat(r)
            with fmod.inject(fmod.FaultSpec("serve.launch", at=[0, 2],
                                            transient=True),
                             fmod.FaultSpec("serve.launch", match="decode",
                                            at=[3])):
                eng.submit(_requests(vocab, [5, 9],
                                     cls=JaxRequest if fmod is jax_faults
                                     else Request))
                done = eng.run_until_done(max_steps=400)
            return done, eng.report()

        done, rep = run(faults, ServeEngine(
            tiny["model"], tiny["params"], ServeConfig(device="cpu", **kw)))
        jdone, jrep = run(jax_faults, JaxEngine(
            tiny["jmodel"], tiny["jparams"], JaxConfig(**kw)))
        assert done == jdone
        assert rep["health"] == jrep["health"]
        assert set(STATS_KEYS) == set(JAX_KEYS)
        for k in ("failed_requests", "retries", "replica_drains",
                  "deadline_expirations", "prefill_calls", "decode_steps",
                  "tokens_generated"):
            assert rep["stats"][k] == jrep["stats"][k], k

    def test_failed_launch_leaves_the_engine_freeable_without_gc(
            self, tiny):
        """A permanent launch fault's error holds no cycle through the
        engine: a dropped engine frees its cache and parameters at once,
        as a fault-free one does (``tests/test_torch_serve.py``)."""
        import copy
        import gc
        import weakref

        def served():
            eng = ServeEngine(tiny["model"], copy.deepcopy(tiny["params"]),
                              ServeConfig(max_batch=2, max_seq=64,
                                          device="cpu"))
            with faults.inject(FaultSpec("serve.launch", match="decode",
                                         at=[1]),
                               FaultSpec("compile.bucket", match="prefill",
                                         at=[1])):
                eng.submit(_requests(tiny["cfg"].vocab, [5, 9, 20, 40],
                                     max_new=3))
                eng.run_until_done(max_steps=100)
            assert eng.failed
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

    def test_chaos_run_completes_every_request(self, tiny):
        """The twin of the chaos run: ``serve.launch`` and ``pool.alloc``
        on a paged pool (4-token blocks, so a request allocates at every
        few steps); every request retired done or failed, never dropped,
        and the allocator consistent."""
        reqs = _requests(tiny["cfg"].vocab, [5, 9, 12, 7], max_new=4)
        inj = FaultInjector.chaos(seed=12, rate=0.2,
                                  sites=("serve.launch", "pool.alloc"))
        with faults.inject(injector=inj):
            eng, done = _run(tiny, reqs, kv_block_size=4,
                             kv_pool_blocks=24)
        assert inj.fired["serve.launch"] >= 1
        assert inj.fired["pool.alloc"] >= 1
        assert set(done) | set(eng.failed) == {r.rid for r in reqs}
        assert not eng.queue and all(s is None for s in eng.slots)
        eng.alloc.assert_consistent()
        assert eng.alloc.used_blocks == 0

    def test_drained_requests_keep_their_priority(self, tiny):
        """A drained replica's request is requeued at its own priority, as
        the reference requeues it: under ``admission="priority"`` the
        survivors re-admit it before a lower-priority request that waited
        all along — the same completion order and streams as the JAX
        engine's."""
        from repro.data.pipeline import Request as JaxRequest
        from repro.serve.engine import ServeConfig as JaxConfig
        from repro.serve.engine import ServeEngine as JaxEngine

        vocab = tiny["cfg"].vocab
        kw = dict(max_batch=1, replicas=2, max_seq=64, admission="priority",
                  heartbeat_deadline_s=5.0)
        prios = {0: 5, 1: 1, 2: 3}

        def run(eng, cls):
            t = [1.0]
            eng._clock = lambda: t[0]
            for r in range(2):
                eng.heartbeat(r)
            eng.submit([cls(rid=r.rid, tokens=r.tokens, max_new_tokens=3,
                            priority=prios[r.rid])
                        for r in _requests(vocab, [6, 9, 7])])
            for _ in range(3):
                eng.step()         # rids 0 and 2 admitted, rid 1 waits
            t[0] = 10.0
            eng.heartbeat(0)       # replica 1 (rid 2's) is drained
            return eng.run_until_done(max_steps=400)

        done = run(ServeEngine(tiny["model"], tiny["params"],
                               ServeConfig(device="cpu", **kw)), Request)
        jdone = run(JaxEngine(tiny["jmodel"], tiny["jparams"],
                              JaxConfig(**kw)), JaxRequest)
        assert list(done) == list(jdone) == [0, 2, 1]
        assert done == jdone


# ----------------------------------------------------------- mesh (SPMD) --

class TestServeDifferentialMesh:
    @pytest.mark.skip(reason=MESH)
    def test_transient_launch_fault_parity_under_mesh(self):
        pass

    @pytest.mark.skip(reason=MESH)
    def test_replica_drain_under_mesh(self):
        pass
