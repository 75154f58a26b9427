"""The ``"dhlo"`` pipeline's bucket entries as CUDA graphs, against the
JAX package.

The JAX package compiles each bucket once, ahead of time, into one
executable that takes the true lengths as a device ``int32`` vector.  The
port's counterpart is one CUDA graph of the bucket's padded executor, and
a graph holds whatever the executor reads at its capture: so the executor
must read its lengths on the device and never on the host.  Three kinds
of cases:

* **No host read of a length.**  The padded executor runs with ``lens``
  (and any scalar start or padding operand) wrapped in :class:`NoRead`, a
  tensor subclass that raises on ``item``, ``__int__``, ``__index__``,
  ``__bool__``, ``__float__``, ``tolist`` and ``numpy`` and hands its type
  to every value computed from it.  A host read of any derived length, a
  sync on the card that a capture refuses, raises here.  The functions: a
  reduced TinyLlama stack over (1, S, D) (kLoop, kInput) and its
  token-major composition (kDot) on ``"hopper"`` (the kernels' plain
  versions) and ``"eager"``; a dynamic-length scan and reverse scan; a
  concat along a dynamic axis; ``dslice``, ``dynamic_update_slice`` and
  ``pad`` on hand-built graphs.  Each output's valid region is held
  against the JAX package's (``"xla"``, or its own padded executor on the
  hand-built graphs) at ``atol=1e-4`` for the model stacks (f32 sums of a
  few hundred terms in another order) and the reference's control-flow
  tolerance (``rtol=1e-5``, ``atol=1e-6``) for the rest.
* **One executor for the bucket.**  One executor and one ``lens``
  tensor, written in place between calls at S = 5, 3 and 8 of bucket 8,
  give the JAX package's output at each S.
* **Graph bookkeeping** under the stand-in :class:`FakeGraphs` of
  ``tests/test_torch_graphs.py`` (CPU tensors count as on the card): a
  dhlo artifact's captures equal its compiles and later calls in a
  bucket are replays; the bytes copied into a graph a call are the padded
  input plus ``lens`` (a static argument and the weights the function
  closes over are read in place); an artifact holding ``d.while`` or
  ``d.cond`` keeps host entries, decided before any call, and never
  captures; ``"nimble_vm"`` has no graph; a failed capture raises
  ``CompileError`` with no fallback.

**Card** cases (``-k on_card``) skip without CUDA: a path-2-shaped dhlo
artifact (the token-major stack, kDot) graphed against the same kernels
launched one by one under ``eager_entries()``, bit for bit, replays at
every length of each bucket.  The JAX package is imported by the CPU
cases only.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import disc_torch
from repro_torch.api.backends import get_backend
from repro_torch.core import graphs
from repro_torch.core.codegen import host_control_flow
from repro_torch.errors import CompileError

F32 = torch.float32
TOL = dict(rtol=1e-5, atol=1e-6)       # the reference's control-flow cases
TOL_STACK = dict(rtol=0, atol=1e-4)    # as tests/test_torch_slice.py


class HostRead(AssertionError):
    """A value derived from a length was read on the host."""


class NoRead(torch.Tensor):
    """A tensor whose value may not reach the host; every tensor computed
    from it is one too (``torch.Tensor.__torch_function__`` hands the
    subclass on)."""

    def _refuse(self, *args, **kwargs):
        raise HostRead("a length or an index was read on the host")

    item = __int__ = __index__ = __bool__ = __float__ = tolist = numpy = \
        _refuse


def no_read(x) -> torch.Tensor:
    return torch.as_tensor(x).as_subclass(NoRead)


def plain(x) -> torch.Tensor:
    return x.as_subclass(torch.Tensor)


def _padded(x: np.ndarray, axis: int, size: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[axis] = size
    out = torch.zeros(shape, dtype=torch.from_numpy(x).dtype)
    out.narrow(axis, 0, x.shape[axis]).copy_(torch.from_numpy(x))
    return out


def _executor(low, backend: str, bucket: int):
    """The bucket's padded executor, as the backend builds it."""
    return get_backend(backend).build_bucket(
        low.graph, low.plan, low.syms, {s.uid: bucket for s in low.syms},
        "cpu")


# ------------------------------------------------------------ functions --

@pytest.fixture(scope="module")
def stacks():
    """The reduced TinyLlama stack (1, S, D) and its token-major
    composition (T, D), each with the JAX package's compiled twin."""
    import disc
    import jax.numpy as jnp
    from _torch_parity import build_pair, build_token_major_pair

    out = {}
    for name, build, spec in (
            ("path1", build_pair, lambda d: (1, "S", d)),
            ("path2", build_token_major_pair, lambda d: ("S", d))):
        rcfg, ref_fn, pcfg, port_fn = build("f32")
        shape = spec(pcfg.d_model)
        ref = disc.compile(ref_fn, [(tuple(disc.Dim("S", max=64)
                                           if d == "S" else d for d in shape),
                                     jnp.float32)], backend="xla")
        port = disc_torch.compile(port_fn, [(tuple(
            disc_torch.Dim("S", max=64) if d == "S" else d for d in shape),
            F32)], device="cpu")
        out[name] = dict(ref=ref, low=port.lower(), axis=shape.index("S"),
                         shape=lambda s, shape=shape: tuple(
                             s if d == "S" else d for d in shape))
    return out


def _stack_input(stack, s):
    return np.random.RandomState(s).standard_normal(
        stack["shape"](s)).astype(np.float32)


def _region_fns():
    """(torch function, JAX function) pairs from the control-flow tests,
    and a concat along a dynamic axis."""
    import jax.numpy as jnp
    from test_torch_control_flow import (j_reverse_fn, j_scan_ys_fn,
                                         reverse_fn, scan_ys_fn)

    def cat_fn(x):
        return torch.cat([torch.tanh(x), x[:5] * 2.0], 0)

    def j_cat_fn(x):
        return jnp.concatenate([jnp.tanh(x), x[:5] * 2.0], 0)

    return {"scan": (scan_ys_fn, j_scan_ys_fn),
            "reverse_scan": (reverse_fn, j_reverse_fn),
            "concat": (cat_fn, j_cat_fn)}


def _sliced_graph(code: str):
    """``code`` on a hand-built graph over x (S, 16) in both packages:
    ``dslice`` of 4 rows and ``dynamic_update_slice`` of 4 rows at a start
    given as a scalar argument (clamped into the bucket as ``lax``
    clamps), or ``pad`` of the static axis with a padding value given as
    a scalar argument.  Returns the graphs, their symbol and the port's
    scalar argument's value."""
    import repro.core.codegen as RC
    import repro.core.dhlo as RD
    import repro.core.symshape as RS
    import repro.core.propagation as RPr
    import repro_torch.core.dhlo as PD
    import repro_torch.core.propagation as PPr
    import repro_torch.core.symshape as PS

    out = []
    for D, sym, collect, f32, i32 in (
            (RD, RS.fresh_symdim, RPr.collect_semantic_constraints,
             np.float32, np.int32),
            (PD, PS.fresh_symdim, PPr.collect_semantic_constraints,
             F32, torch.int32)):
        g = D.DGraph(code)
        S = sym("S", rep=13)
        x = g.add_param((S, 16), f32)
        t = g.add_op("tanh", [x], [(S, 16)], [f32]).outputs[0]
        if code == "dslice":
            i = g.add_param((), i32)
            o = g.add_op("dslice", [t], [(4, 16)], [f32],
                         shape_operands=[i, i]).outputs[0]
        elif code == "dynamic_update_slice":
            i = g.add_param((), i32)
            upd = g.add_param((4, 16), f32)
            o = g.add_op("dynamic_update_slice", [t, upd], [(S, 16)], [f32],
                         shape_operands=[i, i]).outputs[0]
        else:
            v = g.add_param((), f32)
            o = g.add_op("pad", [t, v], [(S, 23)], [f32],
                         attrs={"padding_config": ((0, 0, 0),
                                                   (2, 1, 1))}).outputs[0]
        g.set_outputs([g.add_op("mul", [o, o], [o.shape], [f32])
                       .outputs[0]])
        collect(g)
        out.append((g, S))
    return out, RC


# ------------------------------------------------- no host read of lens --

@pytest.mark.parametrize("backend", ["hopper", "eager"])
@pytest.mark.parametrize("path", ["path1", "path2"])
def test_padded_executor_reads_no_length_on_the_host(stacks, path,
                                                     backend):
    stack = stacks[path]
    run = _executor(stack["low"], backend, 64)
    for s in (37, 64):
        x = _stack_input(stack, s)
        (y,) = run(no_read(torch.tensor([s], dtype=torch.int32)),
                   _padded(x, stack["axis"], 64))
        assert isinstance(y, NoRead)
        y = plain(y).narrow(stack["axis"], 0, s).numpy()
        np.testing.assert_allclose(y, np.asarray(stack["ref"](x)),
                                   **TOL_STACK)


@pytest.mark.parametrize("name", ["scan", "reverse_scan", "concat"])
def test_region_and_concat_read_no_length_on_the_host(name):
    import jax.numpy as jnp

    fn, jfn = _region_fns()[name]
    low = disc_torch.compile(fn, [(disc_torch.Dim("S", max=64), 4)],
                             device="cpu").lower()
    for backend in ("hopper", "eager"):
        run = _executor(low, backend, 16)
        for s in (13, 16):
            x = (np.random.RandomState(s).randn(s, 4) * 0.1).astype(
                np.float32)
            outs = run(no_read(torch.tensor([s], dtype=torch.int32)),
                       _padded(x, 0, 16))
            want = jfn(jnp.asarray(x))
            want = want if isinstance(want, (tuple, list)) else (want,)
            for got, w in zip(outs, want):
                w = np.asarray(w)
                got = plain(got)
                if got.dim():
                    if name != "concat":
                        # stacked ys: rows past S stay exactly 0
                        assert not got[s:].any()
                    got = got[:w.shape[0]]
                np.testing.assert_allclose(got.numpy(), w, **TOL)


@pytest.mark.parametrize("code", ["dslice", "dynamic_update_slice", "pad"])
def test_slicing_ops_read_no_index_on_the_host(code):
    """The start index and the padding value are device scalars (wrapped
    like ``lens``); starts past the bucket clamp as ``lax`` clamps them."""
    import jax.numpy as jnp

    ((rg, rs), (pg, ps)), RC = _sliced_graph(code)
    from repro_torch.core.codegen import build_padded_executor

    ref = RC.build_padded_executor(rg, {rg.store.canon_dim(rs).uid: 16},
                                   [rg.store.canon_dim(rs)])
    port = build_padded_executor(pg, {pg.store.canon_dim(ps).uid: 16},
                                 [pg.store.canon_dim(ps)], device="cpu")
    rng = np.random.RandomState(3)
    upd = rng.randn(4, 16).astype(np.float32)
    for s, scalar in ((13, 2), (13, 30), (9, -3), (16, 7)):
        x = rng.randn(s, 16).astype(np.float32)
        xp = _padded(x, 0, 16)
        if code == "pad":
            extra = [np.float32(scalar * 0.25)]
        else:
            extra = [np.int32(scalar)] + ([upd] if code != "dslice" else [])
        (want,) = ref(jnp.asarray([s], jnp.int32), jnp.asarray(xp.numpy()),
                      *[jnp.asarray(e) for e in extra])
        (got,) = port(no_read(torch.tensor([s], dtype=torch.int32)), xp,
                      *[no_read(e) if np.ndim(e) == 0
                        else torch.from_numpy(e) for e in extra])
        rows = want.shape[0] if code == "dslice" else s
        np.testing.assert_allclose(plain(got)[:rows].numpy(),
                                   np.asarray(want)[:rows], **TOL)


# --------------------------------------------- one executor, one bucket --

@pytest.mark.parametrize("name", ["path1", "reverse_scan"])
def test_one_executor_and_lens_serve_the_whole_bucket(stacks, name):
    """The lengths written in place between calls, as a graph's replay
    reads them: S = 5, 3, 8 of bucket 8."""
    import jax.numpy as jnp

    if name == "path1":
        stack = stacks["path1"]
        low, axis, make = stack["low"], stack["axis"], \
            (lambda s: _stack_input(stack, s))
        want_of = (lambda x: (np.asarray(stack["ref"](x)),))
        tol = TOL_STACK
    else:
        fn, jfn = _region_fns()[name]
        low = disc_torch.compile(fn, [(disc_torch.Dim("S", max=64), 4)],
                                 device="cpu").lower()
        axis, tol = 0, TOL
        make = (lambda s: (np.random.RandomState(s).randn(s, 4) * 0.1)
                .astype(np.float32))
        want_of = (lambda x: tuple(np.asarray(w)
                                   for w in jfn(jnp.asarray(x))))
    run = _executor(low, "hopper", 8)
    lens = torch.zeros(1, dtype=torch.int32)
    xp = torch.zeros(_padded(make(8), axis, 8).shape)
    for s in (5, 3, 8):
        x = make(s)
        lens[0] = s
        xp.zero_()
        xp.narrow(axis, 0, s).copy_(torch.from_numpy(x))
        outs = run(lens, xp)
        for got, w in zip(outs, want_of(x)):
            got = got[:w.shape[0]] if name != "path1" and got.dim() \
                else got
            if name == "path1":
                got = got.narrow(axis, 0, s)
            np.testing.assert_allclose(got.numpy(), w, **tol)


# ---------------------------------------------------- graph bookkeeping --

@pytest.fixture
def fake(monkeypatch):
    from test_torch_graphs import FakeGraphs

    f = FakeGraphs()
    monkeypatch.setattr(graphs, "CUDA_GRAPHS", f)
    return f


def _mlp(x, w):
    return torch.tanh(x @ w).sum(-1) * 2.0 + x[:, 0]


def _j_mlp(x, w):
    import jax.numpy as jnp

    return jnp.tanh(x @ w).sum(-1) * 2.0 + x[:, 0]


@pytest.mark.parametrize("backend", ["hopper", "eager"])
def test_dhlo_bucket_is_captured_once_then_replayed(fake, backend):
    import jax.numpy as jnp

    w = np.random.RandomState(1).randn(8, 6).astype(np.float32)
    wt = torch.from_numpy(w)
    f = disc_torch.compile(_mlp, [(disc_torch.Dim("S", max=64), 8), (8, 6)],
                           backend=backend, device="cpu")
    sizes = (5, 13, 3, 16, 20, 33, 17)
    for i, s in enumerate(sizes):
        x = np.random.RandomState(s).randn(s, 8).astype(np.float32)
        got = f(torch.from_numpy(x), wt)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(_j_mlp(jnp.asarray(x),
                                                     jnp.asarray(w))),
                                   rtol=1e-5, atol=1e-5)
    st = f.graph_stats
    buckets = f.compile_counts()["bucket"]
    assert buckets == 3 and st.captures == buckets
    assert st.replays == len(sizes) - buckets
    rep = f.report()["graphs"]
    assert rep["graphed_entries"] == buckets and rep["host_entries"] == 0
    assert (rep["captures"], rep["replays"]) == (buckets, st.replays)


def test_bytes_into_a_graph_are_the_padded_input_and_lens(fake):
    """The static weight argument and the weights the function closes
    over are read in place: a call copies the padded input and the
    lengths into the graph's buffers, and nothing else."""
    bias = torch.randn(6)

    def fn(x, w):
        return torch.tanh(x @ w + bias)

    wt = torch.randn(8, 6)
    f = disc_torch.compile(fn, [(disc_torch.Dim("S", max=64), 8), (8, 6)],
                           device="cpu")
    f(torch.randn(5, 8), wt)            # bucket 16: the capture
    st = f.graph_stats
    per_call = 16 * 8 * 4 + 4           # padded x (16, 8) f32, lens int32
    assert st.buffer_bytes == st.bytes_in == per_call
    for s in (9, 16, 12):
        f(torch.randn(s, 8), wt)
    assert st.replays == 3 and st.bytes_in == 4 * per_call
    assert st.bytes_out == 3 * 16 * 6 * 4   # each replay's (16, 6) output


@pytest.mark.parametrize("name", ["while", "cond", "nested"])
def test_while_and_cond_keep_host_entries(fake, name):
    from test_torch_control_flow import cond_fn, nested_fn, while_fn

    fn = {"while": while_fn, "cond": cond_fn, "nested": nested_fn}[name]
    f = disc_torch.compile(fn, [(disc_torch.Dim("S", max=64), 4)],
                           device="cpu")
    found = host_control_flow(f.lower().graph)
    assert found and set(found) <= {"d.while", "d.cond"}
    for s in (5, 13, 20):
        f(torch.randn(s, 4))
    rep = f.report()["graphs"]
    assert rep["host_entries"] == f.compile_counts()["total"] == 2
    assert rep["graphed_entries"] == rep["captures"] == 0
    assert rep["host_control_flow"] == sorted(set(found))
    assert not fake.made


def test_scan_only_function_is_graphed(fake):
    from test_torch_control_flow import reverse_fn

    f = disc_torch.compile(reverse_fn, [(disc_torch.Dim("S", max=64), 4)],
                           device="cpu")
    assert host_control_flow(f.lower().graph) == []
    for s in (5, 13, 20):
        f(torch.randn(s, 4))
    assert f.graph_stats.captures == f.compile_counts()["total"] == 2
    assert f.graph_stats.replays == 1


def test_nimble_vm_is_never_captured(fake):
    f = disc_torch.compile(_mlp, [(disc_torch.Dim("S", max=64), 8), (8, 6)],
                           backend="nimble_vm", device="cpu")
    w = torch.randn(8, 6)
    for s in (5, 9, 20):
        f(torch.randn(s, 8), w)
    rep = f.report()["graphs"]
    assert rep["captures"] == rep["graphed_entries"] == 0
    assert rep["host_entries"] == 2 and not fake.made


def test_escalated_exact_entry_is_graphed(fake):
    f = disc_torch.compile(_mlp, [(disc_torch.Dim("S", max=64), 8), (8, 6)],
                           device="cpu", escalation_threshold=2)
    w = torch.randn(8, 6)
    x = torch.randn(11, 8)
    for _ in range(4):
        got = f(x, w)
    torch.testing.assert_close(got, _mlp(x, w))
    counts = f.compile_counts()
    assert counts["exact"] == 1
    assert f.graph_stats.captures == counts["total"]


def test_failed_dhlo_capture_raises_without_fallback(monkeypatch):
    from test_torch_graphs import FakeGraphs

    monkeypatch.setattr(graphs, "CUDA_GRAPHS",
                        FakeGraphs(fail=RuntimeError("operation not "
                                                     "permitted when stream "
                                                     "is capturing")))
    f = disc_torch.compile(_mlp, [(disc_torch.Dim("S", max=64), 8), (8, 6)],
                           device="cpu")
    with pytest.raises(CompileError, match="capture"):
        f(torch.randn(5, 8), torch.randn(8, 6))
    assert f.compile_counts()["total"] == 0
    assert f.report()["graphs"]["host_entries"] == 0


# --------------------------------------------------------------- card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


NARROW = dict(d_model=256, n_heads=8, n_kv_heads=2, d_ff=704, vocab=512,
              n_layers=2, dtype="f32")


def _token_major_on_card(device):
    """The token-major stack at narrow widths with weights drawn on the
    card (no JAX there)."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("tinyllama_11b"), **NARROW)
    params = T.init(cfg, torch.Generator(device=device).manual_seed(0),
                    device)

    def fn(x):
        pos = torch.arange(x.shape[0], dtype=torch.int32,
                           device=x.device)[None, :]
        for bp in params["blocks"]:
            h = L.norm_apply(cfg, bp["ln1"], x)
            a, _ = L.attn_apply(cfg, bp["attn"], h[None], positions=pos)
            x = x + a[0]
            x = x + L.mlp_apply(cfg, bp["ffn"],
                                L.norm_apply(cfg, bp["ln2"], x))
        return T.logits_from_hidden(cfg, params,
                                    L.norm_apply(cfg, params["ln_f"], x))

    return cfg, fn


def test_path2_dhlo_graph_equals_eager_entries_on_card(cuda):
    from repro_torch.kernels.matmul import ops as mm

    cfg, fn = _token_major_on_card(cuda)
    f = disc_torch.compile(fn, [(disc_torch.Dim("T", max=2048),
                                 cfg.d_model)], backend="hopper")
    gen = torch.Generator(device=cuda).manual_seed(1)
    sizes = (37, 50, 64, 100, 128, 40)
    xs = {s: torch.randn((s, cfg.d_model), generator=gen, device=cuda)
          for s in sizes}
    mm.EPILOGUE_LAUNCHES.reset()
    got = {s: f(xs[s]) for s in sizes}
    launches = mm.EPILOGUE_LAUNCHES.launches
    with graphs.eager_entries():
        want = {s: f(xs[s]) for s in sizes}
    torch.cuda.synchronize()
    st = f.graph_stats
    assert st.captures == f.compile_counts()["total"] == 2
    assert st.replays == len(sizes) - 2
    # every request launched the plan's kDots, replays included
    assert launches == 2 * cfg.n_layers * len(sizes)
    for s in sizes:
        assert torch.equal(got[s], want[s]), s
