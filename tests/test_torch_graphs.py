"""The jit pipeline's CUDA graph entries (``repro_torch.core.graphs``).

Two kinds of cases:

* **CPU** cases drive an entry's bookkeeping through a stand-in for
  ``torch.cuda.CUDAGraph`` (:class:`FakeGraphs`): its capture pass runs the
  function on copies of the inputs (a real capture executes nothing),
  and its replay runs the function again on the captured inputs and
  writes the results into the captured outputs, counting no launch.
  They hold: a pass-through leaf is read in place and any other leaf is
  copied into the entry's own buffer (and counted), so no call writes a
  tensor the caller passed before; a pass-through leaf that changes is
  copied from then on; launch counters count the first call's launches
  and each replay as the capture pass counted, the capture nothing; an
  output that is an input comes back as the caller's tensor, any other
  as a copy a later call leaves alone; ``plain_versions()`` and
  ``eager_entries()`` bypass the graph; a failed capture raises
  ``CompileError`` and leaves no entry (out of memory: the engine's
  retry captures anew, unless the first call wrote an argument read in
  place); an evicted entry and a dropped engine free their graphs
  without a gc pass; the serving engine with its in-place decode step
  gives the JAX engine's streams, and under the stand-in the same streams
  as eager on every family, copying only ``tokens``, ``lens`` and
  ``active`` into the decode graph.
* **Card** cases (``-k on_card``) skip without CUDA: each serve kernel's
  wrapper captured alone and replayed at new inputs equals its eager
  launch; an engine on each reduced family under graphs equals the same
  engine under ``eager_entries()``; a dropped graphed engine frees its
  card memory without gc; a body that calls ``.item()`` raises
  ``CompileError``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten, tree_map

import disc_torch
from repro_torch.configs import get_config
from repro_torch.core import graphs
from repro_torch.core.graphs import eager_entries
from repro_torch.data.pipeline import Request
from repro_torch.errors import CompileError
from repro_torch.kernels.select import plain_versions
from repro_torch.kernels.triton_build import LaunchCounter, launch_counts
from repro_torch.models.registry import get_model
from repro_torch.serve.engine import ServeConfig, ServeEngine

ARCHS = ["tinyllama_11b", "rwkv6_3b", "zamba2_7b", "dbrx_132b"]


# ----------------------------------------------------------- stand-in --

class _Graph:
    """A captured graph's stand-in: ``replay()`` runs ``fn`` on the
    captured inputs and writes the results into the captured outputs."""

    def __init__(self, fn, args, out):
        self.fn, self.args = fn, args
        self.out = tree_flatten(out)[0]
        self.replays = 0

    def replay(self):
        before = launch_counts()
        new = tree_flatten(self.fn(*self.args))[0]
        for counter, n in before.items():   # a replay runs no Python
            counter.launches = n
        for o, n in zip(self.out, new):
            if isinstance(o, torch.Tensor) and o is not n:
                o.copy_(n)
        self.replays += 1


class FakeGraphs(graphs.CudaGraphs):
    """CPU tensors count as on the card; ``fail`` makes capture raise."""

    def __init__(self, fail=None):
        super().__init__()
        self.fail = fail
        self.made = []   # weak references to every graph captured

    def on_card(self, leaves):
        return any(isinstance(x, torch.Tensor) for x in leaves)

    def warm_up(self, fn, args):
        return fn(*args)

    def capture(self, fn, args, pool):
        if self.fail is not None:
            raise self.fail
        out = fn(*tree_map(
            lambda x: x.clone() if isinstance(x, torch.Tensor) else x, args))
        g = _Graph(fn, args, out)
        self.made.append(weakref.ref(g))
        return g, out


@pytest.fixture
def fake(monkeypatch):
    f = FakeGraphs()
    monkeypatch.setattr(graphs, "CUDA_GRAPHS", f)
    return f


def _jit(fn, device="cpu", specs=None, **kw):
    return disc_torch.compile(fn, specs, options=disc_torch.CompileOptions(
        pipeline="jit", device=device, **kw))


# ---------------------------------------------------------- CPU cases --

X = disc_torch.ArgSpec((2, 4), torch.float32)


def test_captured_leaf_is_read_in_place_and_others_are_copied(fake):
    calls = []

    def f(params, x):
        calls.append(1)
        return x @ params["w"]

    params = {"w": torch.randn(4, 3)}
    w = params["w"].clone()
    g = _jit(f, specs=[None, X])
    x1, x2 = torch.randn(2, 4), torch.randn(2, 4)
    x1_0 = x1.clone()
    torch.testing.assert_close(g(params, x1), x1 @ w)
    assert len(calls) == 2            # the first call, then the capture
    st = g.graph_stats
    assert (st.captures, st.replays) == (1, 0)
    assert st.bytes_in == st.buffer_bytes == x1.nbytes
    torch.testing.assert_close(g(params, x2), x2 @ w)
    assert st.bytes_in == 2 * x1.nbytes   # the parameters stay in place
    # no call writes into a tensor the caller passed before
    torch.testing.assert_close(x1, x1_0)
    torch.testing.assert_close(params["w"], w)
    assert g.compile_counts()["total"] == st.captures == 1
    assert st.replays == 1 and len(st.capture_seconds) == 1


def test_changed_pass_through_leaf_is_copied_from_then_on(fake):
    """Another tensor where the parameters were: the entry captures anew
    with that leaf copied, and neither the old parameters nor the inputs
    of earlier calls change."""
    g = _jit(lambda params, x: x @ params["w"], specs=[None, X])
    params = {"w": torch.randn(4, 3)}
    w = params["w"].clone()
    x1, x2 = torch.randn(2, 4), torch.randn(2, 4)
    x1_0 = x1.clone()
    g(params, x1)
    w2 = {"w": params["w"] * 2}
    torch.testing.assert_close(g(w2, x2), x2 @ w2["w"])
    torch.testing.assert_close(params["w"], w)
    torch.testing.assert_close(x1, x1_0)
    st = g.graph_stats
    assert (st.captures, st.replays) == (2, 0)
    torch.testing.assert_close(g(params, x1), x1 @ w)   # copied in now
    torch.testing.assert_close(w2["w"], 2 * w)
    assert st.replays == 1 and st.captures == 2
    assert g.compile_counts()["total"] == 1


def test_launch_counters_count_each_replay_as_the_capture_did(fake):
    counter = LaunchCounter()

    def f(x):
        counter.launches += 3         # a wrapper launching three kernels
        return x + 1.0

    g = _jit(f, specs=[disc_torch.ArgSpec((2,), torch.float32)])
    g(torch.ones(2))
    assert counter.launches == 3      # the first call; capture nothing
    g(torch.zeros(2))
    g(torch.zeros(2))
    assert counter.launches == 9
    with eager_entries():             # eager: the wrapper counts itself
        g(torch.zeros(2))
    assert counter.launches == 12


def test_outputs_alias_inputs_or_are_copies(fake):
    def f(cache, x):
        cache.add_(x)
        return cache, cache * 2.0

    cache = torch.zeros(3)
    g = _jit(f, specs=[None, disc_torch.ArgSpec((3,), torch.float32)])
    c1, d1 = g(cache, torch.ones(3))
    assert c1 is cache                # the caller's own leaf
    torch.testing.assert_close(cache, torch.ones(3))   # written once
    c2, d2 = g(cache, torch.full((3,), 2.0))
    assert c2 is cache and d2 is not d1
    torch.testing.assert_close(cache, torch.full((3,), 3.0))
    torch.testing.assert_close(d1, torch.full((3,), 2.0))  # not changed
    torch.testing.assert_close(d2, torch.full((3,), 6.0))
    other = torch.full((3,), 10.0)    # another tensor in the cache's place:
    c3, _ = g(other, torch.ones(3))   # the write lands in it, not in cache
    assert c3 is other
    torch.testing.assert_close(other, torch.full((3,), 11.0))
    torch.testing.assert_close(cache, torch.full((3,), 3.0))
    c4, d4 = g(other, torch.ones(3))  # copied in and back from then on
    assert c4 is other
    torch.testing.assert_close(other, torch.full((3,), 12.0))
    torch.testing.assert_close(d4, torch.full((3,), 24.0))
    torch.testing.assert_close(cache, torch.full((3,), 3.0))
    assert g.graph_stats.bytes_out == 2 * d1.nbytes


def test_copied_leaf_written_in_place_is_written_back():
    """A copied argument the function writes: the caller's tensor gets
    the write, as the eager function gives it, and an earlier caller's
    tensor keeps its values."""
    fake = FakeGraphs()
    x = torch.arange(4.0)
    view = x[1:3]

    def f(a):
        a.mul_(10.0)
        return a

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "CUDA_GRAPHS", fake)
        g = _jit(f, specs=[disc_torch.ArgSpec((2,), torch.float32)])
        assert g(view) is view
        torch.testing.assert_close(x, torch.tensor([0.0, 10.0, 20.0, 3.0]))
        y = torch.ones(2)
        assert g(y) is y
        torch.testing.assert_close(y, torch.full((2,), 10.0))
        torch.testing.assert_close(x, torch.tensor([0.0, 10.0, 20.0, 3.0]))


@pytest.mark.parametrize("ctx", [plain_versions, eager_entries])
def test_plain_versions_and_eager_entries_bypass_the_graph(fake, ctx):
    calls = []

    def f(x):
        calls.append(1)
        return x * 2.0

    g = _jit(f, specs=[disc_torch.ArgSpec((2,), torch.float32)])
    g(torch.ones(2))
    g(torch.ones(2))
    n = len(calls)
    with ctx():
        torch.testing.assert_close(g(torch.ones(2)), torch.full((2,), 2.0))
    assert len(calls) == n + 1        # the function ran, eagerly
    assert g.graph_stats.replays == 1 and fake.made[0]().replays == 1
    # an entry compiled inside the context captures at its first call
    # outside it
    h = _jit(f, specs=[disc_torch.ArgSpec((3,), torch.float32)])
    with ctx():
        h(torch.ones(3))
    assert h.graph_stats.captures == 0
    h(torch.ones(3))
    assert h.graph_stats.captures == h.compile_counts()["total"] == 1


def test_cpu_tensors_run_eagerly():
    g = _jit(lambda x: x + 1.0)
    torch.testing.assert_close(g(torch.ones(2)), torch.full((2,), 2.0))
    assert g.graph_stats.captures == g.graph_stats.replays == 0


@pytest.mark.parametrize("msg,transient", [
    ("CUDA error: operation not permitted when stream is capturing", False),
    ("CUDA out of memory. Tried to allocate 2.00 GiB", True)])
def test_failed_capture_raises_and_leaves_no_entry(fake, msg, transient):
    counter = LaunchCounter()

    def f(x):
        counter.launches += 1
        return x + 1.0

    fake.fail = RuntimeError(msg)
    g = _jit(f, name="probe")
    with pytest.raises(CompileError, match="probe") as info:
        g(torch.ones(2))
    assert info.value.transient is transient and msg in str(info.value)
    assert len(g.cache) == 0 and g.compile_counts()["total"] == 0
    assert counter.launches == 0
    fake.fail = None                  # the next call compiles anew
    g(torch.ones(2))
    assert len(g.cache) == 1
    assert g.compile_counts()["total"] == g.graph_stats.captures == 1


def test_failed_capture_after_an_in_place_write_is_permanent(fake):
    """The first call wrote an argument read in place: a retry would
    apply the write twice, so an out-of-memory capture is not transient,
    and the write happened once."""
    def f(cache, x):
        cache.add_(x)
        return x * 2.0

    fake.fail = RuntimeError("CUDA out of memory. Tried to allocate 1 GiB")
    cache = torch.zeros(3)
    g = _jit(f, specs=[None, disc_torch.ArgSpec((3,), torch.float32)],
             name="writer")
    with pytest.raises(CompileError, match="writer") as info:
        g(cache, torch.ones(3))
    assert not info.value.transient and len(g.cache) == 0
    torch.testing.assert_close(cache, torch.ones(3))


@pytest.mark.parametrize("write", [False, True])
def test_failed_first_call_is_transient_only_before_an_in_place_write(
        fake, write):
    """An out-of-memory error in the first call is transient where the
    call wrote no argument read in place, and permanent where it did; the
    entry leaves the cache and the compile count either way."""
    def f(cache, x):
        if write:
            cache.add_(x)
        raise RuntimeError("CUDA out of memory. Tried to allocate 1 GiB")

    cache = torch.zeros(3)
    g = _jit(f, specs=[None, disc_torch.ArgSpec((3,), torch.float32)],
             name="writer")
    with pytest.raises(CompileError, match="writer") as info:
        g(cache, torch.ones(3))
    assert info.value.transient is not write
    assert len(g.cache) == 0 and g.compile_counts()["total"] == 0
    torch.testing.assert_close(cache, torch.full((3,), float(write)))


def test_out_of_memory_at_capture_takes_the_engines_retry(fake):
    """An out-of-memory error while capturing is transient: the engine's
    launch ladder retries it, the retry compiles and captures anew, and
    the run completes with captures == compiles."""
    fails = [RuntimeError("CUDA out of memory. Tried to allocate 1 GiB")]
    capture = fake.capture

    def flaky(fn, args, pool):
        if fails:
            raise fails.pop()
        return capture(fn, args, pool)

    fake.capture = flaky
    eng = _serve("tinyllama_11b", "cpu", eager=False)
    assert eng.stats["retries"] == 1 and not fails
    _graph_checks(eng)


def test_non_tensor_leaf_change_raises(fake):
    g = _jit(lambda x, k: x * k,
             specs=[disc_torch.ArgSpec((2,), torch.float32), None])
    g(torch.ones(2), 3)
    g(torch.ones(2), 3)
    with pytest.raises(ValueError, match="captured with 3"):
        g(torch.ones(2), 4)


def test_evicted_entry_frees_its_graph_without_gc(fake):
    g = _jit(lambda x: x * 2.0,
             specs=[disc_torch.ArgSpec(("S",), torch.float32)],
             policy=disc_torch.BucketPolicy(kind="pow2", granule=4),
             max_cache_entries=1)
    g(torch.ones(3))
    gc.collect()
    gc.disable()
    try:
        g(torch.ones(7))              # bucket 8 evicts bucket 4
        assert fake.made[0]() is None and fake.made[1]() is not None
    finally:
        gc.enable()


# ------------------------------------------------------ serving engine --

class _Logits(ServeEngine):
    """Records, per request and token, the logits row it came from."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.logits = {}

    def _next_tokens(self, slots, logits):
        for r, i in enumerate(slots):
            s = self.slots[i]
            self.logits[(s.rid, len(s.generated))] = logits[r].float().cpu()
        return super()._next_tokens(slots, logits)


def _requests(vocab, lens, max_new=4):
    rng = np.random.RandomState(7)
    return [Request(rid=i, tokens=rng.randint(0, vocab, size=n)
                    .astype(np.int32), max_new_tokens=max_new)
            for i, n in enumerate(lens)]


#: prompt lengths that land twice in a bucket, so buckets replay
LENS = [5, 9, 14, 40, 33, 12]


def _serve(arch, device, eager, chunk=None, params=None):
    # the reduced config at the state sizes the WKV and SSD kernels are
    # built for (N = P = 64)
    cfg = dataclasses.replace(get_config(arch).reduced(), ssm_head_dim=64,
                              ssm_state=64)
    model = get_model(cfg)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = model.init(gen, device)
    # no end token: every request decodes all its tokens
    eng = _Logits(model, params, ServeConfig(
        max_batch=4, max_seq=96, prefill_chunk=chunk, eos_id=-1,
        device=device))
    eng.submit(_requests(cfg.vocab, LENS))
    with eager_entries() if eager else contextlib.nullcontext():
        eng.run_until_done(max_steps=500)
    assert not eng.failed and len(eng.done) == len(LENS), eng.failed
    return eng


def _graph_checks(eng):
    """captures == compiles, every call after an entry's first a replay,
    and a decode step copies ≤ 1 KiB into its graph."""
    for fn, kind in ((eng._prefill_fn, "prefill"), (eng._decode_fn,
                                                    "decode")):
        st = fn.graph_stats
        assert st.captures == eng.compile_counts()[kind]["total"], kind
    dec = eng._decode_fn.graph_stats
    pre = eng._prefill_fn.graph_stats
    assert dec.replays + dec.captures == eng.stats["decode_steps"]
    assert pre.replays + pre.captures == eng.stats["prefill_calls"]
    assert dec.bytes_in <= 1024 * eng.stats["decode_steps"]


@pytest.mark.parametrize("arch", ARCHS)
def test_graphed_engine_matches_eager_engine(fake, arch):
    """Each family under the stand-in: the same streams and logits as the
    eager engine, with its in-place decode applied once per step."""
    want = _serve(arch, "cpu", eager=True, chunk=8)
    got = _serve(arch, "cpu", eager=False, chunk=8)
    assert got.done == want.done
    for key, row in want.logits.items():
        torch.testing.assert_close(got.logits[key], row, rtol=0, atol=0)
    _graph_checks(got)
    assert want._decode_fn.graph_stats.captures == 0


@pytest.fixture(scope="module")
def tiny_jax():
    """The reduced TinyLlama, initialised by the JAX package and carried
    into the port."""
    import jax
    from repro.configs import get_config as jax_config
    from repro.models.registry import get_model as jax_model

    from repro_torch.models.convert import params_from_numpy

    jcfg = jax_config("tinyllama_11b").reduced()
    jmodel = jax_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(
        get_config("tinyllama_11b"),
        **{f.name: getattr(jcfg, f.name)
           for f in dataclasses.fields(get_config("tinyllama_11b"))})
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return dict(cfg=cfg, params=params, jmodel=jmodel, jparams=jparams)


@pytest.mark.parametrize("graphed", [False, True])
@pytest.mark.parametrize("chunk", [None, 8])
def test_in_place_decode_matches_jax_engine(tiny_jax, fake, graphed, chunk):
    """The engine whose decode step writes the cache in place gives the
    JAX engine's streams, eagerly and under the stand-in, and keeps its
    cache leaves across steps."""
    from repro.data.pipeline import Request as JaxRequest
    from repro.serve.engine import ServeConfig as JaxConfig
    from repro.serve.engine import ServeEngine as JaxEngine

    reqs = _requests(tiny_jax["cfg"].vocab, LENS)
    jeng = JaxEngine(tiny_jax["jmodel"], tiny_jax["jparams"],
                     JaxConfig(max_batch=4, max_seq=96, prefill_chunk=chunk))
    jeng.submit([JaxRequest(rid=r.rid, tokens=r.tokens,
                            max_new_tokens=r.max_new_tokens) for r in reqs])
    want = jeng.run_until_done(max_steps=500)
    eng = ServeEngine(get_model(tiny_jax["cfg"]), tiny_jax["params"],
                      ServeConfig(max_batch=4, max_seq=96,
                                  prefill_chunk=chunk, device="cpu"))
    leaves = [eng.cache["k"], eng.cache["v"]]
    eng.submit(reqs)
    with contextlib.nullcontext() if graphed else eager_entries():
        assert eng.run_until_done(max_steps=500) == want
    assert eng.cache["k"] is leaves[0] and eng.cache["v"] is leaves[1]
    assert eng.compile_counts() == {k: jeng.compile_counts()[k]
                                    for k in ("prefill", "decode")}
    if graphed:
        _graph_checks(eng)


def test_dropped_graphed_engine_is_freed_without_gc(fake):
    """A graph holds its inputs (parameters, the cache); the compiled
    artifacts reach the engine and their own compile callbacks weakly, so
    a dropped engine still frees them at once."""
    def served():
        return _serve("tinyllama_11b", "cpu", eager=False)

    served()
    gc.collect()
    fake.made.clear()
    gc.disable()
    try:
        eng = served()
        refs = [weakref.ref(x) for x in (eng, eng.cache["k"],
                                          eng.params["embed"])]
        made = list(fake.made)
        assert made and all(r() is not None for r in made)
        del eng
        assert [r() is None for r in refs] == [True] * 3
        assert all(r() is None for r in made)
    finally:
        gc.enable()


# ------------------------------------------------------------ on card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the CUDA C++ "
                    "kernels run on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _wrapper_case(name, dev):
    """(function, first inputs, later inputs) for one serve wrapper: the
    later inputs carry new values and, where it takes them, new lens."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.layernorm import ops as ln
    from repro_torch.kernels.mamba2 import ops as ssd
    from repro_torch.kernels.rmsnorm import ops as rms
    from repro_torch.kernels.rwkv6 import ops as wkv
    from repro_torch.kernels.softmax import ops as sm

    g = torch.Generator(device=dev).manual_seed(3)

    def rnd(*shape, dtype=torch.float32, scale=0.5):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(dtype)

    def ints(*vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    def decay(*shape):
        return torch.sigmoid(torch.randn(shape, generator=g, device=dev))

    kind, _, rest = name.partition("_")
    if kind == "flash":
        form, hd, dt = rest.split("_")
        hd, dt = int(hd), getattr(torch, dt)
        if form == "prefill":
            def make(lens, off):
                return (rnd(2, 4, 96, hd, dtype=dt), rnd(2, 2, 200, hd,
                        dtype=dt), rnd(2, 2, 200, hd, dtype=dt), lens, off)

            return (lambda q, k, v, lens, off: fa.flash_attention(
                q, k, v, lens, causal=True, q_offset=off),
                make(ints(150, 96), ints(54, 0)),
                make(ints(200, 37), ints(104, 0)))

        def make(lens):
            return (rnd(4, 8, 1, hd, dtype=dt), rnd(4, 2, 512, hd, dtype=dt),
                    rnd(4, 2, 512, hd, dtype=dt), lens)

        return (fa.flash_decode, make(ints(46, 300, 1, 511)),
                make(ints(500, 2, 77, 260)))
    if kind == "rmsnorm":
        return (rms.rmsnorm, (rnd(8, 2048), rnd(2048)),
                (rnd(8, 2048), rnd(2048)))
    if kind == "layernorm":
        return (ln.layernorm, (rnd(8, 2560), rnd(2560), rnd(2560)),
                (rnd(8, 2560), rnd(2560), rnd(2560)))
    if kind == "softmax":
        return (lambda x: sm.masked_softmax(x, 16), (rnd(4, 16, scale=3.0),),
                (rnd(4, 16, scale=3.0),))
    t = 128 if rest == "prefill" else 1
    if kind == "wkv":
        def make(lens):
            return (rnd(2, 2, t, 64), rnd(2, 2, t, 64), rnd(2, 2, t, 64),
                    decay(2, 2, t, 64), rnd(2, 64, scale=0.1),
                    rnd(2, 2, 64, 64), lens)

        return (wkv.rwkv6, make(ints(t, t // 2)), make(ints(t // 3, t)))

    def make(lens):
        return (rnd(2, 2, t, 64), decay(2, 2, t), rnd(2, t, 64),
                rnd(2, t, 64), rnd(2, 2, 64, 64), lens)

    return (ssd.mamba2_scan, make(ints(t, t // 2)), make(ints(t // 3, t)))


WRAPPER_CASES = ["flash_prefill_64_bfloat16", "flash_prefill_112_float32",
                 "flash_prefill_128_bfloat16", "flash_decode_64_float32",
                 "flash_decode_112_bfloat16", "flash_decode_128_float32",
                 "rmsnorm", "layernorm", "softmax", "wkv_prefill",
                 "wkv_decode", "ssd_prefill", "ssd_decode"]


@pytest.mark.parametrize("name", WRAPPER_CASES)
def test_serve_wrapper_graph_matches_eager_on_card(cuda, name):
    """Each serve kernel's wrapper alone: captured at its first inputs,
    replayed at new ones (new lens where it takes them), the same bits as
    its eager launch, one counted launch a replay."""
    fn, first, later = _wrapper_case(name, cuda)
    g = _jit(fn, device="cuda", name=name,
             specs=[disc_torch.ArgSpec(tuple(x.shape), x.dtype)
                    for x in first])
    g(*first)
    before = sum(launch_counts().values())
    got = g(*later)
    torch.cuda.synchronize()
    assert sum(launch_counts().values()) == before + 1
    with eager_entries():
        want = g(*later)
    for a, b in zip(tree_flatten(got)[0], tree_flatten(want)[0]):
        assert torch.equal(a, b), name
    st = g.graph_stats
    assert (st.captures, st.replays) == (1, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_graphed_engine_matches_eager_on_card(cuda, arch):
    """Each reduced family on the card, chunked so that prefill buckets
    and the decode step replay interleaved: the graphed engine's streams
    equal the same engine's under ``eager_entries()``, every logits row
    within 1e-6 of its max|ref|."""
    want = _serve(arch, "cuda", eager=True, chunk=8)
    got = _serve(arch, "cuda", eager=False, chunk=8, params=want.params)
    assert got.done == want.done
    for key, row in want.logits.items():
        err = ((got.logits[key] - row).abs().max() / row.abs().max()).item()
        assert err <= 1e-6, (key, err)
    _graph_checks(got)
    assert got._prefill_fn.graph_stats.replays > 0


def test_changed_pass_through_leaf_captures_anew_on_card(cuda):
    """Other parameters than the captured ones: the entry captures anew
    with them copied, into the pool its first graph used, and neither
    the first parameters nor the first call's input change."""
    g = _jit(lambda p, x: x @ p["w"], device="cuda", name="params",
             specs=[None, disc_torch.ArgSpec((4, 8), torch.float32)])
    gen = torch.Generator(device=cuda).manual_seed(5)
    w1, w2, x1, x2 = (torch.randn(s, generator=gen, device=cuda)
                      for s in ((8, 3), (8, 3), (4, 8), (4, 8)))
    keep = [t.clone() for t in (w1, x1)]
    g({"w": w1}, x1)
    got = g({"w": w2}, x2)
    again = g({"w": w2}, x1)
    torch.cuda.synchronize()
    assert torch.equal(w1, keep[0]) and torch.equal(x1, keep[1])
    with eager_entries():
        assert torch.equal(got, g({"w": w2}, x2))
        assert torch.equal(again, g({"w": w2}, x1))
    st = g.graph_stats
    assert (st.captures, st.replays) == (2, 1)


def test_dropped_graphed_engine_frees_card_memory_on_card(cuda):
    """A dropped graphed engine gives back its cache, its parameters and
    its graphs' pool without a gc pass."""
    _serve("tinyllama_11b", "cuda", eager=False)
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    gc.disable()
    try:
        eng = _serve("tinyllama_11b", "cuda", eager=False)
        assert eng._decode_fn.graph_stats.captures == 1
        assert torch.cuda.memory_allocated() > mem0
        del eng
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() <= mem0
    finally:
        gc.enable()


def test_sync_in_body_raises_compile_error_on_card(cuda):
    """A body that reads a value on the host cannot be captured: the
    entry raises ``CompileError`` naming itself and leaves no entry."""
    g = _jit(lambda x: x * x.sum().item(), device="cuda", name="syncing")
    x = torch.ones(4, device=cuda)
    with pytest.raises(CompileError, match="syncing"):
        g(x)
    assert len(g.cache) == 0 and g.compile_counts()["total"] == 0
    torch.testing.assert_close((x + 1).cpu(), torch.full((4,), 2.0))
