"""Control flow on the port's pipelines, held against the JAX package.

Twins of ``tests/test_control_flow.py``: ``torch.cond`` and torch's
``while_loop`` / ``scan`` higher-order ops, compiled by
``disc_torch.compile(..., device="cpu")`` on both pipelines, against the
same functions written with ``lax`` on the same numpy inputs (run eagerly,
and compiled by the JAX package where compile counts are compared):

* the ``"dhlo"`` pipeline lowers them to the region ops ``d.while`` /
  ``d.scan`` / ``d.cond`` and runs them around their bodies: a scan over
  a dynamic length runs the padded trip count, as the reference does,
  with a device guard keeping the carry on padded-tail iterations, so a
  padded bucket never corrupts an iteration-count sensitive carry
  (forward and reverse) and nothing is read back on the host;
* compile counts equal the reference's: trip counts and branches taken
  are never bucket keys;
* nested regions, carry widening on the port's constraint store, the
  dispatch source's region header, the shape-free fingerprint, constants
  inside bodies in the artifact's cache key, and the named error for
  ``higher_order.map``;
* the reduced ``tinyllama_11b`` decoder with its layers as one
  ``d.scan`` against the JAX package's ``lax.scan`` stack compiled on
  ``"dhlo"``.

The jit pipeline's contract is "the function is lens-aware": inputs are
zero-padded to the bucket and outputs are not re-sliced, so its checks
compare the valid region and use pad-neutral bodies where trip count
matters (as the reference's do).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from torch._higher_order_ops.map import map as torch_map
from torch._higher_order_ops.scan import scan
from torch._higher_order_ops.while_loop import while_loop

import disc
import disc_torch
from _hypothesis_compat import given, settings, st
from repro_torch.api.backends import get_backend
from repro_torch.api.staged import _graph_const_token
from repro_torch.core.codegen import COND_SYNCS, WHILE_SYNCS
from repro_torch.core.constraints import (ConstraintViolation,
                                          ShapeConstraintStore)
from repro_torch.core.propagation import carry_fixed_point
from repro_torch.core.symshape import fresh_symdim
from repro_torch.frontends.fx_frontend import UnsupportedPrimitiveError

PIPELINES = ("dhlo", "jit")
# the reference's own tolerance (tests/test_control_flow.py)
TOL = dict(rtol=1e-5, atol=1e-6)


def _spec(d=4, cap=64):
    return [(disc_torch.Dim("S", max=cap), d)]


def _compile(fn, pipeline="dhlo", spec=None, **opts):
    return disc_torch.compile(fn, spec or _spec(), pipeline=pipeline,
                              device="cpu", **opts)


def _ref_compile(jfn, pipeline="dhlo"):
    return disc.compile(jfn, ((disc.Dim("S", max=64), 4),),
                        options=disc.CompileOptions(pipeline=pipeline))


def _x(s, d=4, seed=0):
    rng = np.random.RandomState(seed + s)
    return (rng.randn(s, d) * 0.1).astype(np.float32)


def _check(cf, jfn, x, pipeline):
    """The port's output against the JAX function on the same input."""
    got = cf(torch.from_numpy(x))
    want = jfn(jnp.asarray(x))
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        if pipeline == "jit" and g.shape != w.shape:
            # jit pipeline: outputs stay bucket-padded (lens-aware)
            g = g[tuple(slice(0, n) for n in w.shape)]
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


def _i32(v, like):
    return torch.tensor(v, dtype=torch.int32, device=like.device)


def _f32(v, like):
    return torch.tensor(v, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------- while --

def while_fn(x):
    def cond(i, c):
        return i < 7

    def body(i, c):
        return i + 1, c * 1.25 + x.sum()

    return while_loop(cond, body, (_i32(0, x), _f32(1.0, x)))[1]


def j_while_fn(x):
    def cond(c):
        return c[0] < 7

    def body(c):
        return (c[0] + 1, c[1] * 1.25 + x.sum())

    return lax.while_loop(cond, body, (jnp.int32(0), jnp.float32(1.0)))[1]


def trip_fn(x):
    def cond(i, c):
        return c < x[0, 0]

    def body(i, c):
        return i + 1, c * 2.0

    return while_loop(cond, body, (_i32(0, x), _f32(1.0, x)))[0]


def j_trip_fn(x):
    def cond(c):
        return c[1] < x[0, 0]

    def body(c):
        return (c[0] + 1, c[1] * 2.0)

    return lax.while_loop(cond, body, (jnp.int32(0), jnp.float32(1.0)))[0]


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_while_parity_across_buckets(pipeline):
    cf = _compile(while_fn, pipeline)
    ref = _ref_compile(j_while_fn, pipeline)
    WHILE_SYNCS.reset()
    for s in (5, 13, 37, 61):
        _check(cf, j_while_fn, _x(s), pipeline)
        ref(_x(s))
    assert cf.n_compiles == ref.n_compiles == 2
    if pipeline == "dhlo":
        # the predicate is read once per iteration, 8 times a call
        assert WHILE_SYNCS.launches == 4 * 8


def test_trip_count_does_not_multiply_compiles():
    """One entry bucket, very different trip counts: one compile."""
    cf = _compile(trip_fn)
    ref = _ref_compile(j_trip_fn)
    counts = set()
    for thresh in (1.5, 100.0, 1e6):
        x = np.ones((9, 4), np.float32)
        x[0, 0] = thresh
        got = int(cf(torch.from_numpy(x)))
        assert got == int(j_trip_fn(jnp.asarray(x))) == int(ref(x))
        counts.add(got)
    assert len(counts) == 3
    assert cf.n_compiles == ref.n_compiles == 1


# ----------------------------------------------------------------- scan --

def scan_carry_fn(x):
    """Iteration-count sensitive carry (c doubles each step)."""
    def body(c, xi):
        return c * 2.0 + xi.sum(), c.clone()

    return scan(body, _f32(1.0, x), x)[0]


def j_scan_carry_fn(x):
    def body(c, xi):
        return c * 2.0 + xi.sum(), c

    return lax.scan(body, jnp.float32(1.0), x)[0]


def scan_ys_fn(x):
    def body(c, xi):
        return c + 1.0, xi * c

    return scan(body, _f32(1.0, x), x)[1]


def j_scan_ys_fn(x):
    def body(c, xi):
        return c + 1.0, xi * c

    return lax.scan(body, jnp.float32(1.0), x)[1]


def reverse_fn(x):
    def body(c, xi):
        return c * 2.0 + xi.sum(), c + xi[0]

    return scan(body, _f32(1.0, x), x, reverse=True)


def j_reverse_fn(x):
    def body(c, xi):
        return c * 2.0 + xi.sum(), c + xi[0]

    return lax.scan(body, jnp.float32(1.0), x, reverse=True)


def test_scan_carry_exact_under_padding_dhlo():
    """S = 13 in a bucket of 16: three padded trips would scale the carry
    by 2**3; the guard keeps the carry on those trips."""
    cf = _compile(scan_carry_fn)
    for s in (5, 13, 16, 21, 37):
        _check(cf, j_scan_carry_fn, _x(s), "dhlo")


def test_scan_carry_parity_jit_pad_neutral():
    def f(x):
        def body(c, xi):
            return c + xi.sum(), c.clone()

        return scan(body, _f32(0.0, x), x)[0]

    def jf(x):
        def body(c, xi):
            return c + xi.sum(), c

        return lax.scan(body, jnp.float32(0.0), x)[0]

    cf = _compile(f, "jit")
    for s in (5, 13, 37):
        _check(cf, jf, _x(s), "jit")


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_scan_ys_outer_dim_recovered(pipeline):
    cf = _compile(scan_ys_fn, pipeline)
    for s in (7, 13, 33):
        _check(cf, j_scan_ys_fn, _x(s), pipeline)


@pytest.mark.parametrize("s", [5, 13, 16, 29])
def test_reverse_scan_parity(s):
    """A reverse scan, traced as flip → scan → flip, is one ``d.scan``
    with ``reverse`` set; at S = 13 in the bucket of 16 it starts on row
    12, not on a padded row."""
    cf = _compile(reverse_fn)
    _check(cf, j_reverse_fn, _x(s), "dhlo")
    graph = cf.lower().graph
    scans = [op for op in graph.ops if op.opcode == "d.scan"]
    assert len(scans) == 1 and scans[0].attrs["reverse"]
    assert not any(op.attrs.get("_prim") is torch.ops.aten.flip.default
                   for op in graph.ops)


def test_reverse_scan_ys_padded_rows_are_zero():
    """The executor's stacked ys at the bucket's padded shape: rows past
    the actual length are exactly zero."""
    low = _compile(reverse_fn).lower()
    x = _x(13)
    entry = get_backend("hopper").build_bucket(
        low.graph, low.plan, low.syms, {low.syms[0].uid: 16}, "cpu")
    xp = torch.zeros(16, 4)
    xp[:13] = torch.from_numpy(x)
    c, ys = entry((13,), xp)
    assert ys.shape == (16,)
    assert torch.equal(ys[13:], torch.zeros(3))
    want_c, want_ys = j_reverse_fn(jnp.asarray(x))
    np.testing.assert_allclose(ys[:13].numpy(), np.asarray(want_ys), **TOL)
    np.testing.assert_allclose(float(c), float(want_c), **TOL)


@pytest.mark.parametrize("fn,jfn", [(scan_carry_fn, j_scan_carry_fn),
                                    (reverse_fn, j_reverse_fn)],
                         ids=["forward", "reverse"])
def test_dynamic_scan_runs_the_padded_trip_count(monkeypatch, fn, jfn):
    """S = 13 in a bucket of 16 runs the body 16 times, as the
    reference's ``lax.scan`` at the padded length does, and equals it:
    the padded-tail trips keep the carry (the doubling carry would show
    any of them), forward and reverse."""
    from repro_torch.core import codegen

    trips = []
    run_body = codegen._run_body

    def counted(body, args, env, masked):
        trips.append(1)
        return run_body(body, args, env, masked)

    monkeypatch.setattr(codegen, "_run_body", counted)
    cf = _compile(fn)
    _check(cf, jfn, _x(13), "dhlo")
    assert len(trips) == 16


def test_scan_compile_count_is_O_buckets():
    cf = _compile(scan_ys_fn)
    ref = _ref_compile(j_scan_ys_fn)
    buckets = set()
    for s in (3, 5, 9, 13, 16, 19, 30, 31, 33, 50):
        cf(torch.from_numpy(_x(s)))
        ref(_x(s))
        buckets.add(16 if s <= 16 else (32 if s <= 32 else 64))
    assert cf.n_compiles == ref.n_compiles == len(buckets)


# ----------------------------------------------------------------- cond --

def cond_fn(x):
    return torch.cond(x.sum() > 0.0, lambda a: a * 2.0, lambda a: a - 1.0,
                      (x,))


def j_cond_fn(x):
    return lax.cond(x.sum() > 0.0, lambda a: a * 2.0, lambda a: a - 1.0, x)


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_cond_both_branches_both_buckets(pipeline):
    cf = _compile(cond_fn, pipeline)
    ref = _ref_compile(j_cond_fn, pipeline)
    COND_SYNCS.reset()
    for s in (9, 40):
        pos = np.abs(_x(s)) + 0.1
        for x in (pos, -pos):          # true branch, false branch
            _check(cf, j_cond_fn, x, pipeline)
            ref(x)
    assert cf.n_compiles == ref.n_compiles == 2
    if pipeline == "dhlo":
        assert COND_SYNCS.launches == 4   # one index read a call


# --------------------------------------------------------------- nested --

def nested_fn(x):
    """A while loop inside every scan iteration."""
    def body(c, xi):
        def wcond(i, s):
            return i < 3

        def wbody(i, s):
            return i + 1, s + xi.sum()

        _, acc = while_loop(wcond, wbody, (_i32(0, x), c))
        return acc.clone(), acc.clone()

    return scan(body, _f32(0.0, x), x)[1]


def j_nested_fn(x):
    def body(c, xi):
        def wcond(s):
            return s[0] < 3

        def wbody(s):
            return (s[0] + 1, s[1] + xi.sum())

        _, acc = lax.while_loop(wcond, wbody, (jnp.int32(0), c))
        return acc, acc

    return lax.scan(body, jnp.float32(0.0), x)[1]


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_while_inside_scan(pipeline):
    cf = _compile(nested_fn, pipeline)
    ref = _ref_compile(j_nested_fn, pipeline)
    for s in (6, 13, 37):
        _check(cf, j_nested_fn, _x(s), pipeline)
        ref(_x(s))
    assert cf.n_compiles == ref.n_compiles == 2


# ---------------------------------------------------- execution surfaces --

def test_dispatch_source_names_regions():
    cf = _compile(nested_fn)
    cf(torch.from_numpy(_x(5)))
    src = cf.dispatch_source
    assert "region ops" in src
    assert "d.scan(body=" in src
    assert "entry shapes only" in src
    ref = _ref_compile(j_nested_fn)
    ref(_x(5))
    # the same region line as the reference's header
    line = [ln for ln in src.splitlines() if "d.scan(body=" in ln][0]
    assert "carries=1" in line and "carries=1" in ref.dispatch_source


def test_region_attrs_fingerprint_is_shape_free():
    a = _compile(scan_ys_fn)
    b = _compile(scan_ys_fn)
    a(torch.from_numpy(_x(5)))
    b(torch.from_numpy(_x(20)))
    assert a.lower().graph.fingerprint() == b.lower().graph.fingerprint()


def _body_const_fn(k):
    def f(x):
        def body(c, xi):
            return c * _f32(k, x) + xi.sum(), c.clone()

        return scan(body, _f32(1.0, x), x)[0]

    return f


def test_constant_inside_body_keys_the_artifact():
    """Two functions that differ only in a constant tensor inside a loop
    body share a shape-free fingerprint but not a constant token, so
    they never share a cached artifact."""
    la = _compile(_body_const_fn(2.0)).lower()
    lb = _compile(_body_const_fn(3.0)).lower()
    assert la.graph.fingerprint() == lb.graph.fingerprint()
    assert _graph_const_token(la.graph) != _graph_const_token(lb.graph)
    assert la.fingerprint() != lb.fingerprint()
    same = _compile(_body_const_fn(2.0)).lower()
    assert _graph_const_token(same.graph) == _graph_const_token(la.graph)


def _trace_wrapper_in_scan_body():
    """``make_fx`` of a scan whose body calls a kernel wrapper on a tensor
    off the CPU (as on the card): dynamo captures the body."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.kernels.rmsnorm import ops as rms_ops

    def fn(x):
        def body(c, xi):
            w = torch.ones(4, device=xi.device)
            return c + rms_ops.rmsnorm(xi[None], w, eps=1e-6)[0], []

        return scan(body, torch.zeros(4, device=x.device), x)[0]

    with torch.no_grad():
        return make_fx(fn, tracing_mode="fake", _allow_non_fake_inputs=True)(
            torch.empty(5, 4, device="meta"))


def test_wrapper_in_a_traced_body_takes_its_plain_version():
    """Inside ``plain_versions()`` nothing launches while dynamo captures
    the body: the trace records the plain version, the context read from
    its module global (dynamo cannot trace the context variable)."""
    from repro_torch.kernels.select import plain_versions

    with plain_versions():
        gm = _trace_wrapper_in_scan_body()
    (body,) = [m for m in gm.children() if isinstance(m, torch.fx.GraphModule)]
    targets = {str(n.target) for n in body.graph.nodes
               if n.op == "call_function"}
    assert "aten.rsqrt.default" in targets


def _compile_wrapper_call():
    """``torch.compile`` of a kernel wrapper call on tensors off the CPU."""
    from repro_torch.kernels.rmsnorm import ops as rms_ops

    f = torch.compile(lambda x, w: rms_ops.rmsnorm(x, w, eps=1e-6),
                      backend="eager", fullgraph=True)
    return f(torch.empty(2, 4, device="meta"), torch.empty(4, device="meta"))


@pytest.mark.parametrize("capture", [_trace_wrapper_in_scan_body,
                                     _compile_wrapper_call],
                         ids=["scan_body", "torch_compile"])
def test_wrapper_compiled_outside_plain_versions_raises(capture):
    """A wrapper captured by dynamo outside ``plain_versions()`` raises: a
    compiled graph never records the plain version in the kernel's place;
    inside the context it records the plain version."""
    from repro_torch.kernels.select import plain_versions

    with pytest.raises(RuntimeError, match="rmsnorm: a kernel wrapper"):
        capture()
    with plain_versions():
        capture()


# ------------------------------------------------------- carry widening --

class TestCarryWidening:
    """The port's ``carry_fixed_point`` on its own constraint store."""

    def test_identity_rewrite_unifies_without_widening(self):
        store = ShapeConstraintStore()
        S = fresh_symdim("S", 37)
        t1 = fresh_symdim("S-1", 36)
        t2 = fresh_symdim("(S-1)+1", 37)
        de = {t1.uid: ("affine", S, 1, -1), t2.uid: ("affine", t1, 1, 1)}
        out = carry_fixed_point(store, de, (S, 4), (t2, 4))
        assert out == (S, 4)
        assert store.dims_equal(S, t2)

    def test_varying_dim_with_cap_widens_to_bounded_symbol(self):
        store = ShapeConstraintStore()
        S = fresh_symdim("S", 41)
        g = fresh_symdim("S+1", 42)
        de = {g.uid: ("affine", S, 1, 1)}
        out = carry_fixed_point(store, de, (S, 4), (g, 4),
                                bounds={"S": 64})
        w = out[0]
        assert w.uid not in (S.uid, g.uid)
        assert store.dim_bound(w) == 64
        assert store.dims_equal(S, w) and store.dims_equal(g, w)

    def test_varying_dim_without_cap_raises(self):
        store = ShapeConstraintStore()
        S = fresh_symdim("S", 43)
        g = fresh_symdim("S+1", 44)
        de = {g.uid: ("affine", S, 1, 1)}
        with pytest.raises(ConstraintViolation,
                           match="changes across loop iterations"):
            carry_fixed_point(store, de, (S, 4), (g, 4))

    def test_rank_mismatch_raises(self):
        S = fresh_symdim("S", 47)
        with pytest.raises(ConstraintViolation):
            carry_fixed_point(ShapeConstraintStore(), {}, (S, 4), (S,))

    def test_concrete_mismatch_raises(self):
        with pytest.raises(ConstraintViolation):
            carry_fixed_point(ShapeConstraintStore(), {}, (8, 4), (9, 4))

    def test_note_dim_bound_tightest_wins_across_union(self):
        store = ShapeConstraintStore()
        a = fresh_symdim("A", 37)
        b = fresh_symdim("B", 37)
        store.note_dim_bound(a, 128)
        store.note_dim_bound(b, 64)
        store.assert_dim_eq(a, b)
        assert store.dim_bound(a) == 64 and store.dim_bound(b) == 64


def test_bridged_carry_keeps_entry_dim():
    """A while loop whose carry is the dynamic (S, 4) input: the bridge's
    carry fixed point keeps the entry dim, so outputs slice back to S."""
    def f(x):
        def cond(i, h):
            return i < 3

        def body(i, h):
            return i + 1, h * 0.5 + 1.0

        return while_loop(cond, body, (_i32(0, x), x))[1]

    def jf(x):
        return lax.while_loop(lambda c: c[0] < 3,
                              lambda c: (c[0] + 1, c[1] * 0.5 + 1.0),
                              (jnp.int32(0), x))[1]

    cf = _compile(f)
    (op,) = [o for o in cf.lower().graph.ops if o.opcode == "d.while"]
    store = cf.lower().graph.store
    assert store.dims_equal(op.outputs[1].shape[0],
                            cf.lower().graph.params[0].shape[0])
    for s in (7, 21):
        _check(cf, jf, _x(s), "dhlo")


# ------------------------------------------- unsupported higher-order ops --

def test_named_error_for_higher_order_map():
    def f(x):
        return torch_map(lambda a: a * 2.0, x)

    with pytest.raises(UnsupportedPrimitiveError, match="higher_order.map"):
        _compile(f, spec=_spec(cap=32)).lower()


def test_dynamic_axis_index_zero_matches_the_jax_function():
    """``x[0]`` on the dynamic axis is valid at every length."""
    cf = _compile(lambda x: x[0] * 2.0)
    for s in (1, 5, 40):
        _check(cf, lambda x: x[0] * 2.0, _x(s), "dhlo")


@pytest.mark.parametrize("k", [1, 3, -1])
def test_dynamic_axis_index_past_zero_is_refused(k):
    """``x[k]`` for k != 0 on the dynamic axis is refused when lowered: a
    request shorter than k + 1 would read the bucket's zero padding where
    torch raises."""
    with pytest.raises(UnsupportedPrimitiveError,
                       match=f"dynamic axis at {k}"):
        _compile(lambda x: x[k] * 2.0).lower()


def test_error_is_a_not_implemented_error():
    assert issubclass(UnsupportedPrimitiveError, NotImplementedError)


# ----------------------------------------------------- property fuzzing --

_FUZZ = {}


def _fuzz_artifact(pipeline):
    if pipeline not in _FUZZ:
        _FUZZ[pipeline] = _compile(scan_ys_fn, pipeline)
    return _FUZZ[pipeline]


@settings(max_examples=12, deadline=None)
@given(s=st.integers(min_value=1, max_value=63))
def test_scan_parity_any_size(s):
    cf = _fuzz_artifact("dhlo")
    _check(cf, j_scan_ys_fn, _x(int(s)), "dhlo")
    assert cf.n_compiles <= 3


@settings(max_examples=8, deadline=None)
@given(s=st.integers(min_value=1, max_value=63))
def test_scan_parity_any_size_jit(s):
    cf = _fuzz_artifact("jit")
    _check(cf, j_scan_ys_fn, _x(int(s)), "jit")
    assert cf.n_compiles <= 3


# ---------------------------------- reduced tinyllama_11b as one d.scan --

def port_scan_stack(cfg, params):
    """The port's decoder with its layers as one ``scan`` over stacked
    weights (the reference's ``_run_blocks``), then ``ln_f`` and the
    head; the same function ``chip_smoke.py`` serves on path 7."""
    from repro_torch.models import layers as PL
    from repro_torch.models import transformer as PT

    stacked = torch.utils._pytree.tree_map(lambda *ls: torch.stack(ls),
                                           *params["blocks"])

    def fn(x):
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)[None, :]

        def body(h, bp):
            h, _ = PT.block_apply(cfg, bp, h, positions=positions)
            return h, []

        x, _ = scan(body, x, stacked)
        x = PL.norm_apply(cfg, params["ln_f"], x)
        return PT.logits_from_hidden(cfg, params, x)

    return fn


def ref_scan_stack(cfg, params):
    """The JAX package's decoder with its layers under ``lax.scan``."""
    from repro.models import layers as RL
    from repro.models import transformer as RT

    def fn(x):
        positions = jnp.arange(x.shape[1])[None, :]

        def body(h, bp):
            h, _ = RT.block_apply(cfg, bp, h, positions=positions, lens=None)
            return h, None

        x, _ = lax.scan(body, x, params["blocks"])
        x = RL.norm_apply(cfg, params["ln_f"], x)
        return RT.logits_from_hidden(cfg, params, x)

    return fn


@pytest.fixture(scope="module")
def scan_pair():
    from repro.configs import get_config as ref_config
    from repro.models import transformer as RT
    from repro_torch.configs import get_config as port_config
    from repro_torch.models.convert import params_from_numpy

    rcfg = ref_config("tinyllama_11b").reduced()
    pcfg = dataclasses.replace(port_config("tinyllama_11b"), **{
        f.name: getattr(rcfg, f.name)
        for f in dataclasses.fields(port_config("tinyllama_11b"))})
    rparams = RT.init(rcfg, jax.random.PRNGKey(0))
    pparams = params_from_numpy(jax.tree.map(np.asarray, rparams), pcfg,
                                device="cpu")
    ref = disc.compile(ref_scan_stack(rcfg, rparams),
                       [((1, disc.Dim("S", max=2048), rcfg.d_model),
                         jnp.float32)])
    port = disc_torch.compile(
        port_scan_stack(pcfg, pparams),
        [((1, disc_torch.Dim("S", max=2048), pcfg.d_model), torch.float32)],
        backend="hopper", device="cpu")
    return ref, port, pcfg


def test_tinyllama_layers_are_one_scan(scan_pair):
    ref, port, cfg = scan_pair
    for low in (port.lower(), ref.lower()):
        scans = [op for op in low.graph.ops if op.opcode == "d.scan"]
        assert len(scans) == 1
        assert scans[0].attrs["length_dim"] == cfg.n_layers
        assert scans[0].attrs["num_carry"] == 1
    # the cluster kernels outside the scan: ln_f's kLoop at least
    assert port.lower().plan.template_counts().get("kLoop", 0) >= 1


@pytest.mark.parametrize("s", [13, 37, 100])
def test_tinyllama_scan_stack_matches_reference(scan_pair, s):
    ref, port, cfg = scan_pair
    x = np.random.RandomState(s).standard_normal(
        (1, s, cfg.d_model)).astype(np.float32)
    kloop = port.backend.cluster_kernels["kLoop"]
    runs = kloop.runs
    y = port(torch.from_numpy(x)).numpy()
    y_ref = np.asarray(ref(jnp.asarray(x)))
    assert y.shape == y_ref.shape == (1, s, cfg.vocab)
    np.testing.assert_allclose(y, y_ref, atol=1e-4, rtol=0)
    assert kloop.runs > runs


def test_tinyllama_scan_compile_counts(scan_pair):
    ref, port, cfg = scan_pair
    for s in (13, 37, 100, 45):
        x = np.zeros((1, s, cfg.d_model), np.float32)
        ref(jnp.asarray(x))
        port(torch.from_numpy(x))
    assert port.compile_counts() == ref.compile_counts()
    assert port.compile_counts()["total"] == 3   # buckets 16, 64, 128
