"""The port's observability plane (``repro_torch.obs``) against the JAX
package's, on the CPU.

Twins of ``tests/test_observability.py`` at the reference's reduced
TinyLlama in f32 (the JAX parameters carried across by
``models/convert.py``), and the same calls through ``disc`` and
``disc_torch`` held to the same trace: span names, nesting, cats and
non-time args, event kinds, counters, collector domains and the
``report()["health"]`` keys.  Args that name a process-local thing differ
by nature and are left out of the comparison: times, the compile cache's
artifact fingerprint, and the class name of a cluster kernel (Pallas
there, Hopper here).

Cases of the port's own: a CUDA graph's capture pass records no span and
checks no fault site (a stand-in graph, as ``tests/test_torch_graphs.py``
uses), no span arg, event attr or collector value holds a tensor, and the
registry holds an engine weakly.
"""
from __future__ import annotations

import gc
import json
import weakref

import numpy as np
import pytest
import torch

import disc_torch
from repro_torch.core import graphs
from repro_torch.core.vm import NimbleVM
from repro_torch.data.pipeline import Request
from repro_torch.ft import faults
from repro_torch.ft.faults import FaultSpec
from repro_torch.ft.supervisor import HeartbeatMonitor
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.clock import CLOCK
from repro_torch.serve.engine import STATS_KEYS, ServeConfig, ServeEngine

from _torch_parity import reduced_tinyllama

PIPELINES = ("dhlo", "jit")
F32 = torch.float32


@pytest.fixture(autouse=True)
def fresh_obs():
    """Every test gets its own metrics registry in both packages and must
    not leak a tracer or an injector."""
    from repro.obs import metrics as jax_metrics
    from repro.obs import trace as jax_trace

    prev, jprev = obs_metrics.REGISTRY, jax_metrics.REGISTRY
    obs_metrics.REGISTRY = obs_metrics.MetricsRegistry()
    jax_metrics.REGISTRY = jax_metrics.MetricsRegistry()
    yield
    leaked = obs_trace.ACTIVE is not None or jax_trace.ACTIVE is not None \
        or faults.ACTIVE is not None
    obs_trace.clear()
    jax_trace.clear()
    faults.clear()
    obs_metrics.REGISTRY, jax_metrics.REGISTRY = prev, jprev
    assert not leaked, "test left a tracer or an injector installed"


@pytest.fixture(scope="module")
def tiny():
    """The reduced TinyLlama, initialised by the JAX package and carried
    into the port (one build a process, shared with the other twins)."""
    return reduced_tinyllama()


def _requests(vocab, lens, max_new=3, cls=Request):
    rng = np.random.RandomState(7)
    return [cls(rid=i,
                tokens=rng.randint(0, vocab, size=ln).astype(np.int32),
                max_new_tokens=max_new)
            for i, ln in enumerate(lens)]


def _engine(t, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq", 64)
    return ServeEngine(t["model"], t["params"],
                       ServeConfig(device="cpu", **kw))


def _jax_engine(t, **kw):
    from repro.serve.engine import ServeConfig as JaxConfig
    from repro.serve.engine import ServeEngine as JaxEngine

    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq", 64)
    return JaxEngine(t["jmodel"], t["jparams"], JaxConfig(**kw))


def _jax_requests(t, lens, **kw):
    from repro.data.pipeline import Request as JaxRequest

    return _requests(t["cfg"].vocab, lens, cls=JaxRequest, **kw)


def _artifact(pipeline, name="obs_fn", **kw):
    return disc_torch.compile(
        lambda x: torch.tanh(x) * 2.0, [disc_torch.ArgSpec(("S", 4), F32)],
        options=disc_torch.CompileOptions(pipeline=pipeline, name=name,
                                          device="cpu", **kw))


def _jax_artifact(pipeline, name="obs_fn", **kw):
    import disc
    import jax.numpy as jnp

    return disc.compile(lambda x: jnp.tanh(x) * 2.0,
                        [disc.ArgSpec(("S", 4), jnp.float32)],
                        options=disc.CompileOptions(pipeline=pipeline,
                                                    name=name, **kw))


#: args that name a process-local thing or a time
_VARYING = {"entry_seconds", "seconds", "kernel", "runs", "artifact_fp"}


def _args(e):
    out = {}
    for k, v in e["args"].items():
        if k in _VARYING:
            continue
        if k == "artifact" and (e["name"].startswith("compile")
                                or e["name"] in ("escalate",
                                                 "escalate.fail")):
            continue       # the cache's fingerprint of the artifact
        out[k] = list(v) if isinstance(v, tuple) else v
    return out


def _structure(tr, names=None):
    """A trace's events (those named ``names``) as (name, cat, phase,
    parent's name, depth, id, args), times and process-local args left
    out."""
    def parent(e):
        return tr.events[e["parent"]]["name"] if e["parent"] >= 0 else None

    return [(e["name"], e["cat"], e["ph"], parent(e), e["depth"],
             e.get("id"), _args(e))
            for e in tr.events if names is None or e["name"] in names]


def _both(run_port, run_jax, names=None):
    """The same calls traced through each package: their structures."""
    from repro.obs import trace as jax_trace

    with obs_trace.tracing() as tr:
        run_port()
    with jax_trace.tracing() as jtr:
        run_jax()
    return _structure(tr, names), _structure(jtr, names), tr, jtr


def _no_tensor(x, where="") -> None:
    if isinstance(x, torch.Tensor):
        raise AssertionError(f"a tensor at {where}")
    if isinstance(x, dict):
        for k, v in x.items():
            _no_tensor(v, f"{where}.{k}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            _no_tensor(v, f"{where}[{i}]")


# ------------------------------------------------------------- tracer ----

class TestTracer:
    def test_manual_nesting_parent_and_depth(self):
        tr = obs_trace.Tracer()
        a = tr.begin("outer")
        b = tr.begin("inner")
        tr.instant("tick")
        b.end()
        a.end(extra=1)
        outer, inner, tick = tr.events
        assert (outer["parent"], outer["depth"]) == (-1, 0)
        assert (inner["parent"], inner["depth"]) == (0, 1)
        assert (tick["parent"], tick["depth"]) == (1, 2)
        assert outer["args"] == {"extra": 1}
        assert outer["dur"] >= inner["dur"] >= 0.0

    @pytest.mark.parametrize("pipeline", PIPELINES)
    def test_dispatch_parents_compile_span(self, pipeline):
        f = _artifact(pipeline)
        with obs_trace.tracing() as tr:
            f(torch.ones((3, 4)))   # miss: compile inside dispatch
            f(torch.ones((3, 4)))   # hit: no compile child
        disp = tr.spans("dispatch")
        assert len(disp) == 2
        miss, hit = disp
        assert miss["args"]["cache_hit"] is False
        assert hit["args"]["cache_hit"] is True
        assert miss["args"]["bucket"] == (16,)  # pow2 floor bucket
        assert miss["args"]["pad_bytes"] == 13 * 16
        assert miss["args"]["entry_seconds"] > 0.0
        comp = tr.spans("compile.bucket")
        assert len(comp) == 1
        assert comp[0]["parent"] == tr.events.index(miss)
        assert comp[0]["depth"] == miss["depth"] + 1
        hit_idx = tr.events.index(hit)
        assert not [e for e in tr.events if e.get("parent") == hit_idx
                    and e["name"].startswith("compile")]

    @pytest.mark.parametrize("pipeline", PIPELINES)
    def test_dispatch_trace_matches_jax(self, pipeline):
        """The same calls (a miss, a hit, a second bucket) through
        ``disc_torch.compile`` and ``disc.compile``: the same spans,
        nesting and args, and the same lifecycle events."""
        f = _artifact(pipeline)
        j = _jax_artifact(pipeline)
        sizes = (3, 3, 20, 5)
        got, want, _, _ = _both(
            lambda: [f(torch.ones((s, 4))) for s in sizes],
            lambda: [j(np.ones((s, 4), np.float32)) for s in sizes])
        assert got == want
        assert [n for n, *_ in got].count("dispatch") == len(sizes)

    def test_lower_span_dhlo(self):
        with obs_trace.tracing() as tr:
            _artifact("dhlo", name="lower_me")
        low = tr.spans("lower")
        assert len(low) == 1
        assert low[0]["args"]["artifact"] == "lower_me"
        assert low[0]["args"]["pipeline"] == "dhlo"
        assert low[0]["cat"] == "compile"

    def test_kernel_cluster_spans_nest_in_dispatch(self):
        f = disc_torch.compile(
            lambda x, y: torch.tanh(x) * y + 1.0,
            [disc_torch.ArgSpec(("B", 8), F32)] * 2, backend="hopper",
            device="cpu")
        with obs_trace.tracing() as tr:
            f(torch.ones((3, 8)), torch.ones((3, 8)))
        clusters = tr.spans("kernel.cluster")
        assert clusters, "dhlo entry ran no cluster spans"
        disp_idx = tr.events.index(tr.spans("dispatch")[0])
        for c in clusters:
            assert c["cat"] == "backend"
            assert c["depth"] > 0
            p = c
            while p["parent"] != -1 and p["parent"] != disp_idx:
                p = tr.events[p["parent"]]
            assert p["parent"] == disp_idx
            assert c["args"]["runs"] >= 1

    def test_kernel_cluster_trace_matches_jax(self, fake):
        """The Hopper backend's cluster spans against the Pallas
        backend's on the same function, the entry a (stand-in) CUDA
        graph as on the card: the same templates, op counts and nesting,
        under the compile of a miss and none on a hit (the reference's
        fire at trace time, the port's in the entry's first call)."""
        import disc
        import jax.numpy as jnp

        f = disc_torch.compile(
            lambda x, y: torch.tanh(x) * y + 1.0,
            [disc_torch.ArgSpec(("B", 8), F32)] * 2, backend="hopper",
            device="cpu")
        j = disc.compile(lambda x, y: jnp.tanh(x) * y + 1.0,
                         [disc.ArgSpec(("B", 8), jnp.float32)] * 2,
                         options=disc.CompileOptions(backend="pallas"))
        x = np.ones((3, 8), np.float32)
        names = ("dispatch", "compile.bucket", "kernel.cluster")
        got, want, tr, _ = _both(
            lambda: [f(torch.from_numpy(x), torch.from_numpy(x))
                     for _ in range(2)],
            lambda: [j(x, x) for _ in range(2)], names)
        assert got == want
        assert len(tr.spans("kernel.cluster")) >= 1

    def test_vm_interp_span(self):
        f = _artifact("dhlo")
        vm = NimbleVM(f.graph, device="cpu")
        with obs_trace.tracing() as tr:
            vm(torch.ones((4, 4)))
        sp = tr.spans("vm.interp")
        assert len(sp) == 1
        assert sp[0]["args"]["op_dispatches"] == vm.stats.op_dispatches > 0
        assert sp[0]["cat"] == "vm"
        assert sp[0]["args"]["graph"] == f.graph.name

    def test_metrics_event_mirrors_to_instant(self):
        with obs_trace.tracing() as tr:
            obs_metrics.record_event("replica.drain", replica=1)
        inst = tr.find("replica.drain")
        assert len(inst) == 1 and inst[0]["ph"] == "i"
        tl = obs_metrics.REGISTRY.snapshot()["timeline"]
        assert tl[-1]["event"] == "replica.drain"
        assert tl[-1]["replica"] == 1

    def test_overflow_drops_not_grows(self):
        tr = obs_trace.Tracer(max_events=2)
        for _ in range(5):
            tr.instant("x")
        assert len(tr.events) == 2 and tr.dropped == 3
        sp = tr.begin("late")
        sp.end()
        assert len(tr.events) == 2
        assert tr.chrome_trace()["otherData"]["dropped"] == 4


class TestServeLifecycle:
    def test_request_async_events_and_launch_spans(self, tiny):
        eng = _engine(tiny)
        with obs_trace.tracing() as tr:
            eng.submit(_requests(tiny["cfg"].vocab, [5, 9, 12]))
            eng.run_until_done(max_steps=200)
        reqs = tr.find("request")
        begins = {e["id"] for e in reqs if e["ph"] == "b"}
        ends = {e["id"] for e in reqs if e["ph"] == "e"}
        assert begins == ends == {"0", "1", "2"}
        b0 = next(e for e in reqs if e["ph"] == "b" and e["id"] == "0")
        assert b0["args"]["prompt_len"] == 5
        e0 = next(e for e in reqs if e["ph"] == "e" and e["id"] == "0")
        assert e0["args"]["tokens"] == len(eng.done[0])
        pre = tr.spans("serve.prefill")
        dec = tr.spans("serve.decode")
        assert len(pre) == eng.stats["prefill_calls"] > 0
        assert len(dec) == eng.stats["decode_steps"] > 0
        assert all(s["args"] == {"attempts": 1, "error": False}
                   for s in pre + dec)
        disp = tr.spans("dispatch")
        assert disp and all(d["parent"] != -1 for d in disp)

    @pytest.mark.parametrize("faulted", [False, True])
    def test_serve_trace_matches_jax(self, tiny, faulted):
        """The same requests through both engines (with transient launch
        faults at the same launches, or none): the same request, launch,
        dispatch and compile events, nested alike, and the same
        timeline."""
        from repro.ft import faults as jax_faults
        from repro.obs import metrics as jax_metrics

        lens = [5, 9, 12, 30]

        def specs(mod):
            return [mod.FaultSpec("serve.launch", match="decode",
                                  at=[0, 3], transient=True),
                    mod.FaultSpec("serve.launch", match="prefill", at=[1],
                                  transient=True)] if faulted else []

        def port():
            eng = _engine(tiny)
            with faults.inject(*specs(faults)):
                eng.submit(_requests(tiny["cfg"].vocab, lens))
                return eng.run_until_done(max_steps=200)

        def jax():
            eng = _jax_engine(tiny)
            with jax_faults.inject(*specs(jax_faults)):
                eng.submit(_jax_requests(tiny, lens))
                return eng.run_until_done(max_steps=200)

        names = ("request", "serve.prefill", "serve.decode", "dispatch",
                 "compile.bucket", "compile.exact", "serve.retry")
        got, want, tr, _ = _both(port, jax, names)
        assert got == want
        assert len(tr.find("serve.retry")) == (3 if faulted else 0)
        kinds = [ev["event"] for ev in obs_metrics.REGISTRY.snapshot()
                 ["timeline"]]
        jkinds = [ev["event"] for ev in jax_metrics.REGISTRY.snapshot()
                  ["timeline"]]
        assert kinds == jkinds

    def test_failed_request_closes_async_span(self, tiny):
        eng = _engine(tiny, max_batch=1)
        eng._clock = lambda: 100.0
        with obs_trace.tracing() as tr:
            eng.submit([Request(rid=5, tokens=np.arange(4, dtype=np.int32),
                                max_new_tokens=2, deadline_s=-200.0)])
            eng.step()
        ends = [e for e in tr.find("request") if e["ph"] == "e"]
        assert len(ends) == 1 and ends[0]["args"]["failed"] is True
        assert "DeadlineExceeded" in ends[0]["args"]["reason"]
        tl = obs_metrics.REGISTRY.snapshot()["timeline"]
        assert any(ev["event"] == "deadline.expire" and ev["rid"] == 5
                   for ev in tl)

    def test_drain_events_and_resumed_request(self, tiny):
        eng = _engine(tiny, max_batch=1, replicas=2,
                      heartbeat_deadline_s=5.0)
        t = [1.0]
        eng._clock = lambda: t[0]
        for r in range(2):
            eng.heartbeat(r)
        with obs_trace.tracing() as tr:
            eng.submit(_requests(tiny["cfg"].vocab, [6, 9]))
            for _ in range(3):
                eng.step()
            t[0] = 10.0
            eng.heartbeat(0)
            eng.run_until_done(max_steps=200)
        assert [e["args"] for e in tr.find("replica.drain")] == \
            [{"replica": 1}]
        pre = [e for e in tr.find("preempt")]
        assert len(pre) == 1 and pre[0]["args"]["drain"] is True
        resumed = [e for e in tr.find("request")
                   if e["ph"] == "b" and e["args"]["resumed"]]
        assert len(resumed) == 1 and resumed[0]["args"]["replica"] == 0


# ----------------------------------------------------------- registry ----

class TestMetricsParity:
    def test_observe_snapshot_covers_every_domain(self, tiny):
        eng = _engine(tiny)
        eng.submit(_requests(tiny["cfg"].vocab, [5, 9]))
        eng.run_until_done(max_steps=200)
        snap = disc_torch.observe()
        for dom in obs_metrics.DOMAINS:
            assert dom in snap, f"missing domain {dom!r}"
        assert "engine" in snap["serve"] and "engine" in snap["health"]
        assert "prefill" in snap["dispatch"]
        assert "prefill" in snap["memory"]
        assert any(fp.startswith("serve") for fp in snap["compile"])

    def test_snapshot_structure_matches_jax(self, tiny):
        """The same engine run through both packages: the same snapshot
        sections, collector names, and keys in each."""
        import disc

        eng = _engine(tiny)
        eng.submit(_requests(tiny["cfg"].vocab, [5, 9]))
        eng.run_until_done(max_steps=200)
        jeng = _jax_engine(tiny)
        jeng.submit(_jax_requests(tiny, [5, 9]))
        jeng.run_until_done(max_steps=200)
        snap, jsnap = disc_torch.observe(), disc.observe()
        assert set(snap) == set(jsnap)
        for dom in ("compile", "dispatch", "memory", "serve", "health"):
            assert set(snap[dom]) == set(jsnap[dom]), dom
        for name in ("prefill", "decode"):
            assert set(snap["dispatch"][name]) == \
                set(jsnap["dispatch"][name])
            assert snap["dispatch"][name]["bucket_hits"] == \
                jsnap["dispatch"][name]["bucket_hits"]
            assert set(snap["memory"][name]) == set(jsnap["memory"][name])
        assert set(snap["compile"]["serve"]) == set(jsnap["compile"]["serve"])
        assert set(snap["health"]["engine"]) == \
            set(jsnap["health"]["engine"])
        assert snap["health"]["engine"]["counters"] == \
            jsnap["health"]["engine"]["counters"]
        assert set(snap["serve"]["engine"]) <= set(jsnap["serve"]["engine"])
        _no_tensor(snap, "snapshot")

    def test_engine_stats_and_health_parity(self, tiny):
        eng = _engine(tiny)
        eng.submit(_requests(tiny["cfg"].vocab, [5, 9, 12]))
        eng.run_until_done(max_steps=200)
        snap = disc_torch.observe()
        view = snap["serve"]["engine"]
        assert set(view) == set(STATS_KEYS)
        for k, v in eng.stats.items():
            assert view[k] == v, f"stats[{k!r}] diverged"
        assert snap["health"]["engine"] == eng.report()["health"]

    def test_compiled_accessor_parity(self):
        f = _artifact("jit")
        f(torch.ones((3, 4)))
        f(torch.ones((5, 4)))
        snap = disc_torch.observe()
        assert snap["dispatch"]["obs_fn"] == f.cost_report()
        fp = f.cache.fingerprint
        assert snap["compile"][fp] == dict(f.cache_stats(),
                                           entries=len(f.cache._entries))
        mem = dict(snap["memory"]["obs_fn"])
        planning = mem.pop("planning")
        assert planning is False            # jit pipeline: no buffer plan
        assert mem == f._mstats.as_dict()
        assert f.report()["dispatch_cost"] == f.cost_report()

    def test_vm_collector_parity(self):
        f = _artifact("dhlo")
        vm = NimbleVM(f.graph, device="cpu")
        vm(torch.ones((4, 4)))
        view = disc_torch.observe()["vm"]
        assert view["calls"] == vm.stats.calls == 1
        assert view["op_dispatches"] == vm.stats.op_dispatches
        assert view["interp_seconds"] > 0.0

    def test_latest_collector_wins_per_name(self, tiny):
        eng1 = _engine(tiny)
        eng2 = _engine(tiny)
        eng2.submit(_requests(tiny["cfg"].vocab, [5]))
        eng2.run_until_done(max_steps=100)
        view = disc_torch.observe()["serve"]["engine"]
        assert view["requests_completed"] == 1      # eng2, not eng1
        assert eng1.stats["requests_completed"] == 0

    def test_collectors_hold_the_engine_weakly(self, tiny):
        """A dropped engine is freed with gc off although the registry
        names it, and its collectors leave the snapshot."""
        import copy

        def served():
            eng = ServeEngine(tiny["model"], copy.deepcopy(tiny["params"]),
                              ServeConfig(max_batch=2, max_seq=64,
                                          device="cpu"))
            eng.submit(_requests(tiny["cfg"].vocab, [5, 9], max_new=2))
            eng.run_until_done(max_steps=100)
            return eng

        served()
        gc.collect()
        gc.disable()
        try:
            eng = served()
            assert "engine" in disc_torch.observe()["serve"]
            refs = [weakref.ref(x) for x in (eng, eng.cache["k"])]
            del eng
            assert [r() is None for r in refs] == [True, True]
            snap = disc_torch.observe()
            assert "engine" not in snap["serve"]
            assert "engine" not in snap["health"]
        finally:
            gc.enable()

    def test_labeled_series_and_reset(self):
        reg = obs_metrics.REGISTRY
        reg.counter("launches", kind="prefill").inc(3)
        reg.counter("launches", kind="decode").inc()
        reg.gauge("occupancy", pool="kv").set(0.5)
        h = reg.histogram("pad_waste")
        h.observe(0.25)
        h.observe(0.75)
        snap = reg.snapshot()
        assert snap["counters"]["launches{kind=prefill}"] == 3
        assert snap["counters"]["launches{kind=decode}"] == 1
        assert snap["gauges"]["occupancy{pool=kv}"] == 0.5
        assert snap["histograms"]["pad_waste"]["mean"] == 0.5
        reg.reset()
        snap = reg.snapshot()
        assert not snap["counters"] and not snap["timeline"]


# ---------------------------------------------------- cost accounting ----

class TestCostAccounting:
    @pytest.mark.parametrize("pipeline", PIPELINES)
    def test_padding_waste_and_bucket_hits(self, pipeline):
        f = _artifact(pipeline)
        f(torch.ones((3, 4)))
        f(torch.ones((20, 4)))
        f(torch.ones((20, 4)))
        cost = f.cost_report()
        assert cost["calls"] == 3
        assert cost["bucket_hits"] == {"(16,)": 1, "(32,)": 2}
        assert cost["padded_bytes"] == 80 * 16
        assert cost["true_bytes"] == 43 * 16
        assert cost["pad_waste_ratio"] == pytest.approx(37 / 80)
        pb = cost["per_bucket"]["(32,)"]
        assert pb["calls"] == 2
        assert pb["pad_waste_ratio"] == pytest.approx(24 / 64)

    def test_dispatch_overhead_timer(self):
        f = _artifact("jit")
        for _ in range(3):
            f(torch.ones((3, 4)))
        cost = f.cost_report()
        assert cost["host_dispatch_seconds"] > 0.0
        assert cost["entry_seconds"] > 0.0
        pb = cost["per_bucket"]["(16,)"]
        assert pb["host_dispatch_seconds"] > 0.0
        assert pb["entry_seconds"] > 0.0

    @pytest.mark.parametrize("pipeline", PIPELINES)
    def test_miss_compile_counts_in_host_time_as_in_jax(self, pipeline):
        """A miss's compile, held up here by the backoff of a retried
        transient fault, lands in ``host_dispatch_seconds`` through
        ``disc`` and ``disc_torch`` alike, and stays out of the port's
        ``entry_seconds``."""
        from repro.errors import RetryPolicy as JaxRetryPolicy
        from repro.ft import faults as jax_faults

        from repro_torch.errors import RetryPolicy

        backoff = 0.05
        f = _artifact(pipeline)
        j = _jax_artifact(pipeline)
        f.cache.retry_policy = RetryPolicy(backoff_s=backoff)
        j.cache.retry_policy = JaxRetryPolicy(backoff_s=backoff)
        with faults.inject(FaultSpec("compile.bucket", times=1,
                                     transient=True)):
            f(torch.ones((3, 4)))
        with jax_faults.inject(jax_faults.FaultSpec(
                "compile.bucket", times=1, transient=True)):
            j(np.ones((3, 4), np.float32))
        cost, jcost = f.cost_report(), j.cost_report()
        assert cost["host_dispatch_seconds"] >= backoff
        assert jcost["host_dispatch_seconds"] >= backoff
        assert cost["entry_seconds"] < backoff

    @pytest.mark.parametrize("pipeline", PIPELINES)
    def test_compile_and_escalation_timeline(self, pipeline):
        """The timeline of the reference's case, and the same event
        kinds and keys as ``disc.compile`` gives for the same calls."""
        from repro.obs import metrics as jax_metrics

        f = _artifact(pipeline, escalation_threshold=2)
        j = _jax_artifact(pipeline, escalation_threshold=2)
        for _ in range(3):
            f(torch.ones((5, 4)))
            j(np.ones((5, 4), np.float32))
        tl = obs_metrics.REGISTRY.snapshot()["timeline"]
        kinds = [ev["event"] for ev in tl]
        assert "compile.bucket" in kinds and "escalate" in kinds
        esc = next(ev for ev in tl if ev["event"] == "escalate")
        assert esc["key"] == "(5,)"
        jtl = jax_metrics.REGISTRY.snapshot()["timeline"]
        assert [(ev["event"], ev["key"]) for ev in tl] == \
            [(ev["event"], ev["key"]) for ev in jtl]

    def test_escalation_failure_and_promote_events(self):
        f = _artifact("dhlo", escalation_threshold=2)
        with faults.inject(FaultSpec("compile.exact")):
            for _ in range(3):
                f(torch.ones((5, 4)))
        g = disc_torch.compile(lambda x, y: x * 2.0 + y, device="cpu")
        g(torch.ones(4, 4), torch.ones(4, 4))
        g(torch.ones(4, 6), torch.ones(4, 6))   # breaks the 4 == 4 tie
        kinds = [ev["event"] for ev in
                 obs_metrics.REGISTRY.snapshot()["timeline"]]
        assert kinds.count("escalate.fail") == 1
        assert kinds.count("promote") == 1


# ------------------------------------------------- disabled == no-op -----

class TestDisabledNoOp:
    @pytest.mark.parametrize("pipeline", PIPELINES)
    def test_dispatch_source_identical_with_tracer(self, pipeline):
        off = _artifact(pipeline)
        off(torch.ones((3, 4)))
        with obs_trace.tracing():
            on = _artifact(pipeline)
            on(torch.ones((3, 4)))
        assert off.dispatch_source == on.dispatch_source
        assert "_trace.ACTIVE" in off.dispatch_source

    def test_dispatch_source_identical_with_injector(self):
        off = _artifact("dhlo", escalation_threshold=2)
        with faults.inject(FaultSpec("compile.exact", times=0)):
            on = _artifact("dhlo", escalation_threshold=2)
            on(torch.ones((3, 4)))
        assert off.dispatch_source == on.dispatch_source

    def test_no_events_recorded_when_disabled(self, tiny):
        assert obs_trace.ACTIVE is None
        eng = _engine(tiny)
        eng.submit(_requests(tiny["cfg"].vocab, [5, 9]))
        eng.run_until_done(max_steps=200)
        tr = obs_trace.install()
        try:
            assert tr.events == []
        finally:
            obs_trace.clear()

    def test_hot_path_never_grows_timeline(self, tiny):
        eng = _engine(tiny)
        eng.submit(_requests(tiny["cfg"].vocab, [5, 9]))
        eng.run_until_done(max_steps=200)
        n0 = len(obs_metrics.REGISTRY.snapshot()["timeline"])
        eng.submit(_requests(tiny["cfg"].vocab, [5, 9]))
        eng.run_until_done(max_steps=200)
        assert len(obs_metrics.REGISTRY.snapshot()["timeline"]) == n0

    def test_no_hook_records_a_tensor(self, tiny):
        """Span args, event attrs and collector values hold host values
        only: recording reads nothing back from the device and keeps no
        tensor alive."""
        eng = _engine(tiny, replicas=2, max_batch=1,
                      heartbeat_deadline_s=60.0)
        f = disc_torch.compile(
            lambda x, y: torch.tanh(x) * y + 1.0,
            [disc_torch.ArgSpec(("B", 8), F32)] * 2, backend="hopper",
            device="cpu", escalation_threshold=2)
        with obs_trace.tracing() as tr, faults.inject(
                FaultSpec("serve.launch", at=[1], transient=True)):
            eng.submit(_requests(tiny["cfg"].vocab, [5, 9, 20]))
            eng.run_until_done(max_steps=200)
            for _ in range(3):
                f(torch.ones(3, 8), torch.ones(3, 8))
        assert tr.events
        for e in tr.events:
            _no_tensor(e["args"], e["name"])
        snap = disc_torch.observe()
        _no_tensor(snap, "snapshot")
        json.dumps(tr.chrome_trace())


# ------------------------------------------------ CUDA graph capture ----

class _QuietGraph:
    """A stand-in graph whose replay runs the function with no tracer and
    no injector, as a real replay runs no Python."""

    def __init__(self, fn, args, out):
        from test_torch_graphs import _Graph

        self.inner = _Graph(fn, args, out)

    def replay(self):
        with graphs._unobserved():
            self.inner.replay()


@pytest.fixture
def fake(monkeypatch):
    from test_torch_graphs import FakeGraphs

    class Fake(FakeGraphs):
        captured = 0

        def capture(self, fn, args, pool):
            Fake.captured += 1
            # a capture pass sees no tracer and no injector
            assert obs_trace.ACTIVE is None and faults.ACTIVE is None
            g, out = super().capture(fn, args, pool)
            return _QuietGraph(g.fn, g.args, out), out

    f = Fake()
    monkeypatch.setattr(graphs, "CUDA_GRAPHS", f)
    return f


class TestGraphCapture:
    def test_capture_pass_records_nothing(self, fake):
        """Under a graphed dhlo artifact the ``kernel.cluster`` spans and
        sites come once per entry, in its first call: the capture pass
        records none and checks none, and replays run no Python."""
        f = disc_torch.compile(
            lambda x, y: torch.tanh(x) * y + 1.0,
            [disc_torch.ArgSpec(("B", 8), F32)] * 2, backend="hopper",
            device="cpu")
        x = torch.ones(3, 8)
        with obs_trace.tracing() as tr, faults.inject(
                FaultSpec("kernel.cluster", match="none")) as inj:
            for _ in range(4):
                f(x, x)
        assert type(fake).captured == 1
        assert f.graph_report()["replays"] == 3
        n = len(tr.spans("kernel.cluster"))
        assert n >= 1
        assert inj.calls["kernel.cluster"] == n
        assert len(tr.spans("dispatch")) == 4
        miss = tr.spans("dispatch")[0]
        assert all(c["depth"] > miss["depth"]
                   for c in tr.spans("kernel.cluster"))

    def test_no_fault_fires_mid_capture(self, fake):
        """A spec that would fire on the second ``kernel.cluster`` check
        never fires: the capture pass checks no site."""
        f = disc_torch.compile(
            lambda x, y: torch.tanh(x) * y + 1.0,
            [disc_torch.ArgSpec(("B", 8), F32)] * 2, backend="hopper",
            device="cpu")
        x = torch.ones(3, 8)
        with obs_trace.tracing() as tr:
            f(x, x)
        n = len(tr.spans("kernel.cluster"))
        g = disc_torch.compile(
            lambda x, y: torch.tanh(x) * y + 1.0,
            [disc_torch.ArgSpec(("B", 8), F32)] * 2, backend="hopper",
            device="cpu")
        with faults.inject(FaultSpec("kernel.cluster", at=[n])) as inj:
            for _ in range(3):
                g(x, x)
        assert inj.fired["kernel.cluster"] == 0
        assert inj.calls["kernel.cluster"] == n


# ----------------------------------------------------- typed reset -------

class TestResetStats:
    def test_reset_preserves_types(self, tiny):
        eng = _engine(tiny, replicas=2, max_batch=1)
        eng.submit(_requests(tiny["cfg"].vocab, [5, 9]))
        eng.run_until_done(max_steps=200)
        eng._refresh_stats = lambda: None
        eng.reset_stats()
        assert isinstance(eng.stats["per_replica"], list)
        assert len(eng.stats["per_replica"]) == 2
        for rep in eng.stats["per_replica"]:
            assert rep == {"admitted": 0, "tokens_generated": 0,
                           "requests_completed": 0, "occupied_slots": 0}
        for k in ("tokens_per_sec", "max_decode_gap_s"):
            assert isinstance(eng.stats[k], float)
        ints = set(STATS_KEYS) - {"per_replica", "tokens_per_sec",
                                  "max_decode_gap_s"}
        assert all(eng.stats[k] == 0 and isinstance(eng.stats[k], int)
                   for k in ints)

    def test_reset_keeps_dict_identity(self, tiny):
        eng = _engine(tiny)
        held = eng.stats
        eng.submit(_requests(tiny["cfg"].vocab, [5]))
        eng.run_until_done(max_steps=100)
        eng.reset_stats()
        assert held is eng.stats
        assert held["requests_completed"] == 0


# ------------------------------------------------------- chrome trace ----

def _validate_trace_event(ev):
    assert set(("name", "cat", "ph", "ts", "pid", "tid", "args")) <= set(ev)
    assert isinstance(ev["ts"], (int, float)) and ev["ts"] >= 0
    assert isinstance(ev["args"], dict)
    assert "parent" not in ev and "depth" not in ev
    if ev["ph"] == "X":
        assert isinstance(ev["dur"], (int, float)) and ev["dur"] >= 0
    elif ev["ph"] == "i":
        assert ev["s"] == "t"
    elif ev["ph"] in ("b", "e"):
        assert isinstance(ev["id"], str)
    else:
        assert ev["ph"] == "C"


class TestChromeExport:
    def test_schema_and_roundtrip(self, tiny, tmp_path):
        eng = _engine(tiny)
        disc_torch.observe.start_trace()
        try:
            eng.submit(_requests(tiny["cfg"].vocab, [5, 9]))
            eng.run_until_done(max_steps=200)
            path = tmp_path / "trace.json"
            disc_torch.observe.export_chrome_trace(path)
        finally:
            tr = disc_torch.observe.stop_trace()
        doc = json.loads(path.read_text())
        assert set(doc) == {"traceEvents", "displayTimeUnit", "otherData"}
        assert doc["displayTimeUnit"] == "ms"
        assert len(doc["traceEvents"]) == len(tr.events)
        phases = set()
        for ev in doc["traceEvents"]:
            _validate_trace_event(ev)
            phases.add(ev["ph"])
        assert {"X", "b", "e"} <= phases
        ts = [ev["ts"] for ev in doc["traceEvents"]]
        assert ts == sorted(ts)

    def test_export_without_tracer_raises(self, tmp_path):
        with pytest.raises(RuntimeError, match="no active tracer"):
            disc_torch.observe.export_chrome_trace(tmp_path / "x.json")


# ------------------------------------------------------------- clocks ----

class TestClocks:
    def test_clock_fixed_source(self):
        t = [10.0]
        with CLOCK.fixed(lambda: t[0]):
            assert CLOCK() == 10.0
            t[0] = 11.5
            assert CLOCK() == 11.5
        assert CLOCK() != 11.5      # perf_counter restored

    def test_heartbeat_monitor_injected_clock(self):
        t = [0.0]
        mon = HeartbeatMonitor(["h0", "h1"], deadline_s=5.0,
                               clock=lambda: t[0])
        mon.beat("h0")
        mon.beat("h1")
        t[0] = 4.0
        assert mon.dead_hosts() == []
        mon.beat("h1")
        t[0] = 6.0
        assert mon.dead_hosts() == ["h0"]

    def test_monitor_defaults_to_obs_clock(self):
        t = [100.0]
        mon = HeartbeatMonitor(["h0"], deadline_s=1.0)
        with CLOCK.fixed(lambda: t[0]):
            mon.beat("h0")
            t[0] = 102.0
            assert mon.dead_hosts() == ["h0"]

    def test_tracer_timestamps_use_injected_clock(self):
        t = [0.0]
        with CLOCK.fixed(lambda: t[0]):
            tr = obs_trace.Tracer()
            sp = tr.begin("a")
            t[0] = 0.25
            sp.end()
        ev = tr.events[0]
        assert ev["ts"] == 0.0 and ev["dur"] == 0.25

    def test_engine_reads_the_obs_clock(self, tiny):
        eng = _engine(tiny, max_batch=1)
        t = [50.0]
        with CLOCK.fixed(lambda: t[0]):
            r = _requests(tiny["cfg"].vocab, [6], max_new=4)
            r[0].deadline_s = 1.0
            eng.submit(r)
            t[0] = 52.0
            eng.step()
        assert eng.failed[0].endswith("before completion")
