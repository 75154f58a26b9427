"""The port's slices end to end against the JAX package, on the CPU.

The narrow 2-layer TinyLlama stack goes through ``disc.compile(...,
backend="pallas")`` (Pallas in interpret mode) and through
``disc_torch.compile(..., backend="hopper", device="cpu")`` (the kernels'
plain versions) with the same weights; outputs, compile counts and the
fused-kernel counters must agree.  Twice: the model's batch-major stack
(kLoop, kInput), and the token-major composition of the same layer
functions, whose 2-D MLP projections form kDot clusters.  The kDot cases
of ``tests/test_pallas_backend.py`` have port twins here too.

Also holds the executor's free order: a 2-D SwiGLU layer whose fusion plan
runs one consumer's cluster before another producer's.  The JAX package's
Pallas backend drops a value the later cluster still needs
(``CompileError: undefined value``); the port frees by last use in the
order it executes and matches the reference's XLA backend.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import disc
import disc_torch
from _torch_parity import build_pair, build_token_major_pair

SIZES = (37, 100, 300)


@pytest.fixture(scope="module")
def compiled_pair():
    rcfg, ref_fn, pcfg, port_fn = build_pair("f32")
    ref = disc.compile(ref_fn, [((1, disc.Dim("S", max=2048), rcfg.d_model),
                                 jnp.float32)], backend="pallas")
    port = disc_torch.compile(
        port_fn, [((1, disc_torch.Dim("S", max=2048), pcfg.d_model),
                   torch.float32)], backend="hopper", device="cpu")
    return ref, port, rcfg


@pytest.mark.parametrize("s", SIZES)
def test_stack_matches_reference(compiled_pair, s):
    ref, port, cfg = compiled_pair
    x = np.random.RandomState(s).standard_normal(
        (1, s, cfg.d_model)).astype(np.float32)
    y_ref = np.asarray(ref(jnp.asarray(x)))
    y = port(torch.from_numpy(x)).numpy()
    assert y.shape == y_ref.shape == (1, s, cfg.vocab)
    np.testing.assert_allclose(y, y_ref, atol=1e-4, rtol=0)


def test_compile_counts_and_kernel_runs(compiled_pair):
    ref, port, cfg = compiled_pair
    for s in SIZES:  # every bucket once more (cache hits)
        x = np.zeros((1, s, cfg.d_model), np.float32)
        ref(jnp.asarray(x))
        port(torch.from_numpy(x))
    assert port.compile_counts() == ref.compile_counts()
    assert port.compile_counts()["total"] == len(SIZES)
    kernels = port.backend.cluster_kernels
    assert kernels["kLoop"].runs > 0 and kernels["kInput"].runs > 0
    ref_k = ref.backend.cluster_kernels
    assert ref_k["kLoop"].runs > 0 and ref_k["kInput"].runs > 0


# ------------------------------------------------ token-major (kDot) --

@pytest.fixture(scope="module")
def token_major_pair():
    rcfg, ref_fn, pcfg, port_fn = build_token_major_pair("f32")
    ref = disc.compile(ref_fn, [((disc.Dim("T", max=2048), rcfg.d_model),
                                 jnp.float32)], backend="pallas")
    port = disc_torch.compile(
        port_fn, [((disc_torch.Dim("T", max=2048), pcfg.d_model),
                   torch.float32)], backend="hopper", device="cpu")
    return ref, port, rcfg


@pytest.mark.parametrize("t", SIZES)
def test_token_major_stack_matches_reference(token_major_pair, t):
    ref, port, cfg = token_major_pair
    x = np.random.RandomState(t).standard_normal(
        (t, cfg.d_model)).astype(np.float32)
    y_ref = np.asarray(ref(jnp.asarray(x)))
    y = port(torch.from_numpy(x)).numpy()
    assert y.shape == y_ref.shape == (t, cfg.vocab)
    np.testing.assert_allclose(y, y_ref, atol=1e-4, rtol=0)


def test_token_major_plan_counts_and_kdot_runs(token_major_pair):
    ref, port, cfg = token_major_pair
    templates = port.lower().plan.template_counts()
    assert templates == ref.lower().plan.template_counts()
    assert templates["kDot"] == 2 * cfg.n_layers  # gate·silu, out+residual
    port_k = port.backend.cluster_kernels["kDot"]
    ref_k = ref.backend.cluster_kernels["kDot"]
    before = (port_k.runs, ref_k.fallbacks)
    for t in SIZES:
        x = np.zeros((t, cfg.d_model), np.float32)
        ref(jnp.asarray(x))
        port(torch.from_numpy(x))
    assert port.compile_counts() == ref.compile_counts()
    assert port.compile_counts()["total"] == len(SIZES)
    assert port_k.runs - before[0] == templates["kDot"] * len(SIZES)
    # the reference counts traces (one per bucket, at its first call)
    assert ref_k.runs > 0 and ref_k.fallbacks == before[1]


# ----------------------------------- twins of the Pallas backend's kDot --

def _gelu_jnp(x):
    return jax.nn.gelu(x, approximate=True)


def _gelu_torch(x):  # jax.nn.gelu(approximate=True), op for op
    return x * (0.5 * (1.0 + torch.tanh(
        0.7978845608028654 * (x + 0.044715 * x ** 3))))


def _kdot_runs(port):
    return port.backend.cluster_kernels["kDot"].runs


KDOT_TWINS = {
    # bias broadcast hoisted to the prologue; gelu in the epilogue
    "dot_bias_gelu": (
        lambda x, w, b: _gelu_jnp(x @ w + b),
        lambda x, w, b: _gelu_torch(x @ w + b),
        [("B", 16), (16, 8), (8,)], [(16,), (16, 8), (8,)], (5, 21)),
    # residual extra as (M, N) tiles and two kernel outputs
    "dot_residual_multi": (
        lambda x, w, r: (lambda h: (jnp.tanh(h + r),
                                    jnp.tanh(h + r) * h))(x @ w),
        lambda x, w, r: (lambda h: (torch.tanh(h + r),
                                    torch.tanh(h + r) * h))(x @ w),
        [("B", 16), (16, 8), ("B", 8)], [(16,), (16, 8), (8,)], (6, 13)),
    # a kLoop cluster feeding the dot, sigmoid·z in its epilogue
    "mixed_graph_with_matmul": (
        lambda x, w: (lambda z: jax.nn.sigmoid(z) * z)(
            (jnp.tanh(x) * 2.0 + jnp.abs(x)) @ w),
        lambda x, w: (lambda z: torch.sigmoid(z) * z)(
            (torch.tanh(x) * 2.0 + torch.abs(x)) @ w),
        [("B", 16), (16, 8)], [(16,), (16, 8)], (5,)),
}


@pytest.mark.parametrize("name", sorted(KDOT_TWINS))
def test_kdot_twins_match_reference(name):
    jfn, tfn, spec, shapes, batches = KDOT_TWINS[name]
    port = disc_torch.compile(tfn, spec, backend="hopper", device="cpu")
    assert "kDot" in port.lower().plan.template_counts()
    before = _kdot_runs(port)
    for b in batches:
        rs = np.random.RandomState(b)
        args = [rs.standard_normal(((b,) if sp[0] == "B" else ())
                                   + shape).astype(np.float32)
                for sp, shape in zip(spec, shapes)]
        want = jfn(*[jnp.asarray(a) for a in args])
        got = port(*[torch.from_numpy(a) for a in args])
        if not isinstance(want, tuple):
            want, got = (want,), (got,)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=1e-4, atol=1e-5)
    assert _kdot_runs(port) > before


def test_kdot_dynamic_k_is_masked():
    """A dynamic contraction dim: the padded K of an upstream cluster's
    garbage (exp of the zero padding is 1) must not reach the sum."""
    def jfn(x, w):
        return jnp.tanh(jnp.exp(x) @ w) * 2.0

    def tfn(x, w):
        return torch.tanh(torch.exp(x) @ w) * 2.0

    port = disc_torch.compile(tfn, [("B", "K"), ("K", 8)],
                              backend="hopper", device="cpu")
    before = _kdot_runs(port)
    for b, k in [(3, 5), (6, 21)]:
        rs = np.random.RandomState(k)
        x = rs.standard_normal((b, k)).astype(np.float32)
        w = rs.standard_normal((k, 8)).astype(np.float32)
        np.testing.assert_allclose(
            port(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
            np.asarray(jfn(jnp.asarray(x), jnp.asarray(w))),
            rtol=1e-4, atol=1e-5)
    assert _kdot_runs(port) > before


@pytest.mark.parametrize("backend", ["eager", "hopper"])
def test_contractions_over_dynamic_dims_are_exact(backend):
    """Dots contract padded dynamic dims masked with zeros, a prefix mask
    for an input symbol and a Kronecker mask for a dim merged by a
    reshape.  Every bucket must reproduce the eager function."""
    def f(x, y):
        xf = x.reshape(-1, 8)
        gram = xf.T @ xf                              # over B*S (merged)
        att = torch.einsum("bsd,btd->bst", x, y)      # S and T free
        return gram * 2.0, att @ y                    # over T

    port = disc_torch.compile(f, [("B", "S", 8), ("B", "T", 8)],
                              backend=backend, device="cpu")
    rs = np.random.RandomState(0)
    for b, s, t in ((2, 5, 7), (3, 17, 9), (2, 30, 33), (3, 20, 20)):
        x = torch.from_numpy(rs.standard_normal((b, s, 8)).astype(np.float32))
        y = torch.from_numpy(rs.standard_normal((b, t, 8)).astype(np.float32))
        for got, want in zip(port(x, y), f(x, y)):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert port.compile_counts()["bucket"] >= 2


# ---------------------------------------------------- free-order fault --

D, F = 256, 704


def _swiglu_weights():
    rs = np.random.RandomState(7)
    w = {k: (rs.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("gate", (D, F)), ("up", (D, F)), ("down", (F, D)))}
    w["scale"] = (1.0 + 0.1 * rs.standard_normal(D)).astype(np.float32)
    return w


def _ref_layer(w):
    wj = {k: jnp.asarray(v) for k, v in w.items()}

    def f(x):  # x (S, D): Llama-shaped decoder MLP with its norm
        xf = x.astype(jnp.float32)
        h = xf * jax.lax.rsqrt((xf * xf).mean(-1, keepdims=True) + 1e-6) \
            * wj["scale"]
        g = h @ wj["gate"]
        return x + (jax.nn.silu(g) * (h @ wj["up"])) @ wj["down"]

    return f


def _port_layer(w):
    wt = {k: torch.from_numpy(v) for k, v in w.items()}

    def f(x):
        xf = x.float()
        h = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6) \
            * wt["scale"]
        g = h @ wt["gate"]
        return x + (g * torch.sigmoid(g) * (h @ wt["up"])) @ wt["down"]

    return f


@pytest.mark.parametrize("s", (37, 100))
def test_swiglu_2d_layer_frees_by_execution_order(s):
    w = _swiglu_weights()
    x = np.random.RandomState(s).standard_normal((s, D)).astype(np.float32)
    spec_ref = [((disc.Dim("S", max=512), D), jnp.float32)]
    ref_xla = disc.compile(_ref_layer(w), spec_ref, backend="xla")
    y_ref = np.asarray(ref_xla(jnp.asarray(x)))
    port = disc_torch.compile(
        _port_layer(w), [((disc_torch.Dim("S", max=512), D), torch.float32)],
        backend="hopper", device="cpu")
    y = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, y_ref, atol=1e-4, rtol=1e-5)
    assert port.backend.cluster_kernels["kLoop"].runs > 0
    # the reference's fused backend still fails on this layer: the fault
    # is recorded in ROADMAP.md Queue 3, not carried over
    ref_pallas = disc.compile(_ref_layer(w), spec_ref, backend="pallas")
    with pytest.raises(disc.CompileError, match="undefined value"):
        ref_pallas(jnp.asarray(x))
