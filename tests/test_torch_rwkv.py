"""The port's recurrent family (RWKV-6) against the JAX package, on the CPU.

* **WKV plain version** (``kernels/rwkv6/ref.py``) against the JAX
  package's Pallas kernel in interpret mode (``rwkv6_scan``) and its
  oracle (``rwkv6_ref``) at ``tests/test_kernels.py``'s shapes, and its
  ``s0`` and ``lens`` extensions against the oracle on the whole
  sequence.  f32 at 1e-5 (both sides step in f32; only the order of the
  dot over K differs).
* **The chunked WKV kernel's decomposition** (``csrc/rwkv6.cu``),
  emulated here in torch: per chunk a local scan from a zero state with
  the running decay product P, the carry S_{c+1} = P_end S_c + L_end and
  the output y += (r o P) . S_c; held against the plain version (f32 y
  and state at 1e-5; bf16, where kv is rounded, the state at 1e-5 and y
  to one rounding) and against the JAX oracle and ``_wkv_scan`` with
  ``s0``, ragged ``lens`` and T not a multiple of the chunk, at mild,
  harsh and floor decays; and ``wkv_plan``'s instances and sizes.
* **LayerNorm plain version** against the Pallas ``layernorm`` in
  interpret mode, at ``tests/test_kernels.py``'s shapes and tolerances.
* **Reduced ``rwkv6_3b``** (f32, the JAX parameters carried across by
  ``params_from_numpy``, caches by ``cache_from_numpy``): ``decode_step``,
  the port's single-pass ``prefill`` against the JAX model's
  ``replay_prefill``, ``forward`` and ``greedy_decode`` (also compiled
  whole on the jit pipeline, one artifact per batch bucket, as
  ``tests/test_system.py``'s single-artifact decode); and the port's
  ``ServeEngine`` against the JAX one (identical token streams).
  Tolerance 1e-5 on logits and every cache leaf: the same f32 math, the
  projections and the dot over K summed in other orders.
* **Card cases** (``-k on_card``): the WKV and LayerNorm kernels against
  their plain versions on the same card inputs.  They skip here and run
  on the card, where JAX is not installed (``python -m pytest -q
  tests/test_torch_rwkv.py -k on_card``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import Request
from repro_torch.kernels import select
from repro_torch.kernels.layernorm import ops as ln_ops
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6.ref import rwkv6_ref
from repro_torch.kernels.rwkv6.rwkv6 import CHUNK, DECODE_MAX_T, wkv_plan
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.models.registry import get_model, replay_prefill
from repro_torch.serve.engine import ServeConfig, ServeEngine

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _i32(a):
    return torch.tensor(np.asarray(a), dtype=torch.int32)


def _wkv_inputs(b, h, t, n, seed=12):
    """``tests/test_kernels.py``'s WKV inputs (decay in (0, 1))."""
    rng = np.random.RandomState(seed)
    r, k, v = (rng.randn(b, h, t, n).astype(np.float32) * 0.5
               for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rng.randn(b, h, t, n)))).astype(np.float32)
    u = rng.randn(h, n).astype(np.float32) * 0.1
    return r, k, v, w, u


# ------------------------------------------- WKV plain vs Pallas (CPU) --

@pytest.mark.parametrize("against", ["pallas", "oracle"])
@pytest.mark.parametrize("t", [16, 48, 100])
def test_wkv_plain_matches_reference(t, against):
    import jax.numpy as jnp
    from repro.kernels.rwkv6.ops import rwkv6_scan
    from repro.kernels.rwkv6.ref import rwkv6_ref as jax_ref

    xs = _wkv_inputs(2, 2, t, 8)
    fn = rwkv6_scan if against == "pallas" else jax_ref
    want = np.asarray(fn(*[jnp.asarray(x) for x in xs]))
    got, s = wkv_ops.rwkv6(*_t(*xs))
    assert s.dtype == torch.float32 and s.shape == (2, 2, 8, 8)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("t1", [1, 17, 48])
def test_wkv_plain_continues_from_s0(t1):
    """Split T at t1: the run over [t1, T) from the state after [0, t1)
    is the oracle's whole sequence over [t1, T), and the final states
    agree."""
    import jax.numpy as jnp
    from repro.kernels.rwkv6.ref import rwkv6_ref as jax_ref

    t = 64
    xs = _wkv_inputs(2, 3, t, 8, seed=5)
    want = np.asarray(jax_ref(*[jnp.asarray(x) for x in xs]))
    r, k, v, w, u = _t(*xs)
    _, s_whole = wkv_ops.rwkv6(r, k, v, w, u)
    y1, s1 = wkv_ops.rwkv6(r[:, :, :t1], k[:, :, :t1], v[:, :, :t1],
                           w[:, :, :t1], u)
    y2, s2 = wkv_ops.rwkv6(r[:, :, t1:], k[:, :, t1:], v[:, :, t1:],
                           w[:, :, t1:], u, s0=s1)
    np.testing.assert_allclose(y1.numpy(), want[:, :, :t1], **TOL)
    np.testing.assert_allclose(y2.numpy(), want[:, :, t1:], **TOL)
    np.testing.assert_allclose(s2.numpy(), s_whole.numpy(), **TOL)


def test_wkv_plain_lens():
    """Per-row lens: the state after ``lens[b]`` steps (a row of length 0
    keeps its initial state bit for bit), and y exactly 0 beyond."""
    t = 40
    r, k, v, w, u = _t(*_wkv_inputs(3, 2, t, 8, seed=9))
    s0 = torch.from_numpy(np.random.RandomState(3).randn(3, 2, 8, 8)
                          .astype(np.float32))
    lens = _i32([t, 13, 0])
    y, s = wkv_ops.rwkv6(r, k, v, w, u, s0=s0, lens=lens)
    for row, n in enumerate(lens.tolist()):
        sl = slice(row, row + 1)
        y_n, s_n = wkv_ops.rwkv6(r[sl, :, :n], k[sl, :, :n], v[sl, :, :n],
                                 w[sl, :, :n], u, s0=s0[sl])
        np.testing.assert_allclose(y[sl, :, :n].numpy(), y_n.numpy(), **TOL)
        np.testing.assert_allclose(s[sl].numpy(), s_n.numpy(), **TOL)
        assert not y[row, :, n:].any()
    assert torch.equal(s[2], s0[2])


# ------------------------- the chunked kernel's decomposition (CPU) --

#: decays as ``tests/test_wkv_chunked.py`` makes them (exp(-exp(x s)),
#: x standard normal, s the decay scale), and the model's floor: the
#: clamp of log(-log w) at 4 (``models/layers.py:953``), w = e^{-e^4}
DECAYS = {"mild": 0.1, "harsh": 3.0, "floor": None}


def _wkv_decay_inputs(b, h, t, n, decay, seed=21):
    rng = np.random.RandomState(seed)
    r, k, v = (rng.randn(b, h, t, n).astype(np.float32) * 0.5
               for _ in range(3))
    scale = DECAYS[decay]
    if scale is None:
        w = np.full((b, h, t, n), np.exp(-np.exp(4.0)), np.float32)
    else:
        w = np.exp(-np.exp(rng.randn(b, h, t, n) * scale)).astype(np.float32)
    u = rng.randn(h, n).astype(np.float32) * 0.1
    s0 = rng.randn(b, h, n, n).astype(np.float32)
    return r, k, v, w, u, s0


def _tf32(v):
    """v rounded to TF32 by clearing its low 13 mantissa bits."""
    return (v.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mv3(a, b):
    """The kernel's 3 x TF32 product (h, k) . (h, k, v): a_lo b_hi + a_hi
    b_lo + a_hi b_hi, hi = tf32(x), lo = tf32(x - hi)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    eq = "hk,hkv->hv"
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_hi, b_hi))


def _wkv_three_phase(r, k, v, w, u, s0=None, lens=None, chunk=CHUNK):
    """The chunked kernel's arithmetic in torch: per chunk of ``chunk``
    steps, A the recurrence from a zero state (kv formed in the input
    type, as the plain version forms it) with y_loc_t = r_t . (L_t + u
    kv_t), P_t the running product of w before step t and r_t o P_t; B
    S_{c+1} = P_end o S_c + L_end; C y_t = y_loc_t + (r_t o P_t) . S_c,
    the product by the kernel's 3 x TF32 split.  Steps past a row's
    length give y = 0 and leave the state."""
    b, h, t, n = r.shape
    y = torch.zeros((b, h, t, n), dtype=torch.float32)
    s_out = torch.zeros((b, h, n, n), dtype=torch.float32)
    uf = u.float()[:, :, None]
    for row in range(b):
        nb = t if lens is None else max(0, min(int(lens[row]), t))
        state = (torch.zeros((h, n, n)) if s0 is None
                 else s0[row].float().clone())
        for c0 in range(0, nb, chunk):
            loc = torch.zeros((h, n, n))
            p = torch.ones((h, n))
            ys, rps = [], []
            for i in range(c0, min(c0 + chunk, nb)):
                rt = r[row, :, i].float()
                kv = (k[row, :, i, :, None] * v[row, :, i, None, :]).float()
                ys.append(torch.einsum("hk,hkv->hv", rt, loc + uf * kv))
                rps.append(rt * p)
                wt = w[row, :, i].float()
                loc = wt[:, :, None] * loc + kv
                p = p * wt
            s_c = state
            state = p[:, :, None] * s_c + loc
            for j, (yl, rp) in enumerate(zip(ys, rps)):
                y[row, :, c0 + j] = yl + _mv3(rp, s_c)
        s_out[row] = state
    return y.to(r.dtype), s_out


@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_three_phase_matches_plain(dtype, decay):
    """T = 150 (chunks of 64, 64 and 22) from a state, ``lens`` T, 100
    (inside the second chunk) and 0: f32 y and state at 1e-5; bf16 (kv
    rounded per element in both) the state at 1e-5 and y within one bf16
    rounding (2^-8) of max|y|."""
    t = 150
    r, k, v, w, u, s0 = _t(*_wkv_decay_inputs(3, 2, t, 16, decay))
    r, k, v = (x.to(dtype) for x in (r, k, v))
    lens = _i32([t, 100, 0])
    y, s = _wkv_three_phase(r, k, v, w, u, s0, lens)
    y_p, s_p = rwkv6_ref(r, k, v, w, u, s0, lens)
    assert y.dtype == dtype
    np.testing.assert_allclose(s.numpy(), s_p.numpy(), **TOL)
    if dtype == torch.float32:
        np.testing.assert_allclose(y.numpy(), y_p.numpy(), **TOL)
    else:
        err = (y.float() - y_p.float()).abs().max()
        assert err <= 2.0 ** -8 * y_p.float().abs().max()
    assert not y[1, :, 100:].any() and not y[2].any()
    assert torch.equal(s[2], s0[2])


@pytest.mark.parametrize("decay", list(DECAYS))
def test_wkv_three_phase_matches_jax(decay):
    """Against the JAX oracle (``rwkv6_ref``) and ``_wkv_scan`` in f32 at
    1e-5: the whole sequence (T = 150) from a zero state; then its last
    113 steps (chunks of 64 and 49) from the state ``_wkv_scan`` reaches
    after the first 37, with ``lens`` 113 (all), 0 and 90 (inside the
    second chunk), each row against the scan over its own first 37 + lens
    steps."""
    import jax.numpy as jnp
    from repro.kernels.rwkv6.ref import rwkv6_ref as jax_ref
    from repro.models.layers import _wkv_scan

    t, t1 = 150, 37
    xs = _wkv_decay_inputs(3, 2, t, 16, decay, seed=22)[:5]
    jx = [jnp.asarray(x) for x in xs]
    r, k, v, w, u = _t(*xs)
    y, s = _wkv_three_phase(r, k, v, w, u)
    np.testing.assert_allclose(y.numpy(), np.asarray(jax_ref(*jx)), **TOL)
    y_scan, s_scan = _wkv_scan(*jx)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_scan), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_scan), **TOL)

    _, s_pre = _wkv_scan(*[x[:, :, :t1] for x in jx[:4]], jx[4])
    s0 = torch.from_numpy(np.array(s_pre))
    lens = [t - t1, 0, 90]
    y2, s2 = _wkv_three_phase(r[:, :, t1:], k[:, :, t1:], v[:, :, t1:],
                              w[:, :, t1:], u, s0, _i32(lens))
    for row, n in enumerate(lens):
        y_n, s_n = _wkv_scan(*[x[row:row + 1, :, :t1 + n] for x in jx[:4]],
                             jx[4])
        np.testing.assert_allclose(y2[row, :, :n].numpy(),
                                   np.asarray(y_n)[0, :, t1:], **TOL)
        np.testing.assert_allclose(s2[row].numpy(), np.asarray(s_n)[0],
                                   **TOL)
        assert not y2[row, :, n:].any()
    assert torch.equal(s2[1], s0[1])


@pytest.mark.parametrize("b,h,t,n", [
    (4, 40, 1, 64), (2, 3, DECODE_MAX_T, 64), (2, 3, DECODE_MAX_T + 1, 64),
    (1, 40, 2048, 64), (1, 40, 1999, 64), (2, 40, 512, 64),
    (8, 40, 4096, 64), (3, 5, 77, 16), (3, 5, 1, 16), (2, 3, 0, 64)])
def test_wkv_plan(b, h, t, n):
    """Decode up to ``DECODE_MAX_T`` steps: a block a (b, h, half of the
    columns) at N = 64, 320 blocks at B = 4, H = 40 (T = 0 copies s0);
    chunked from T = 9: a block a (b, chunk of ``CHUNK`` steps, h), a
    whole head (128 threads at N = 64, 32 at N = 16), the ring two states
    a (b, h), the ticket and a flag a (b, h)."""
    plan = wkv_plan(b, h, t, n)
    threads = 128 if n == 64 else 32
    if t <= DECODE_MAX_T:
        dthreads = min(threads, 64)
        want = ("decode", 0, 0, dthreads, b * h * threads // dthreads, 0, 0)
    else:
        nc = -(-t // CHUNK)
        want = ("chunked", CHUNK, nc, threads, b * nc * h, 2 * b * h * n * n,
                1 + b * h)
    assert tuple(plan) == want
    if (b, h, t) == (4, 40, 1):
        assert plan.blocks == 320


def test_wkv_plan_refuses_other_head_sizes():
    with pytest.raises(ValueError, match="head size 32"):
        wkv_plan(1, 1, 16, 32)


# ------------------------------------------ LayerNorm plain vs Pallas --

@pytest.mark.parametrize("shape", [(8, 64), (3, 5, 32)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layernorm_plain_matches_pallas(shape, dtype):
    """Tolerance: ``tests/test_kernels.py``'s (1e-5 f32, 2e-2 bf16)."""
    import jax.numpy as jnp
    from repro.kernels.layernorm.ops import layernorm

    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    rng = np.random.RandomState(6)
    x, g, b = (jnp.asarray(rng.randn(*s), dtype=jdt)
               for s in (shape, shape[-1:], shape[-1:]))
    want = np.asarray(layernorm(x, g, b), np.float32)
    got = ln_ops.layernorm(*[torch.tensor(np.asarray(a, np.float32))
                             .to(torch.float32 if dtype == "f32"
                                 else torch.bfloat16) for a in (x, g, b)])
    tol = TOL if dtype == "f32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


# -------------------------------------------- reduced rwkv6_3b (CPU) --

def _port_cfg(jcfg):
    base = get_config("rwkv6_3b")
    return dataclasses.replace(base, **{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(base)})


@pytest.fixture(scope="module")
def rwkv():
    """The reduced RWKV-6 3B, initialised by the JAX package and carried
    into the port."""
    import jax
    from repro.configs import get_config as jax_config
    from repro.models.registry import get_model as jax_model

    jcfg = jax_config("rwkv6_3b").reduced()
    jmodel = jax_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = _port_cfg(jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return dict(cfg=cfg, model=get_model(cfg), params=params, jcfg=jcfg,
                jmodel=jmodel, jparams=jparams)


def _leaves_close(got, want, **tol):
    import jax

    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, leaf in flat:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.numpy(), np.asarray(leaf), **tol,
                                   err_msg=jax.tree_util.keystr(path))


def _warm_cache(t, b, seed):
    """A non-zero cache: the JAX model after a prompt of 7 tokens."""
    import jax.numpy as jnp

    rng = np.random.RandomState(seed)
    pre = rng.randint(0, t["cfg"].vocab, size=(b, 7)).astype(np.int32)
    jm = t["jmodel"]
    _, jcache = jm.prefill(t["jparams"], jm.init_cache(b, 64),
                           jnp.asarray(pre), jnp.full((b,), 7, jnp.int32),
                           jnp.zeros((b,), jnp.int32))
    return jcache


def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def test_rwkv_cache_tree_matches_jax(rwkv):
    """``init_cache`` keeps the reference's nested tree, leaf for leaf."""
    import jax

    jc = rwkv["jmodel"].init_cache(3, 32)
    pc = rwkv["model"].init_cache(3, 32, "cpu")
    flat = jax.tree_util.tree_flatten_with_path(jc)[0]
    assert len(flat) == 3
    for path, leaf in flat:
        node = pc
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        assert str(node.dtype) == f"torch.{leaf.dtype}"


def test_decode_step_matches_jax(rwkv):
    """One decode step from a non-zero cache: logits and every leaf."""
    import jax.numpy as jnp

    jcache = _warm_cache(rwkv, 3, seed=2)
    toks = np.array([[5], [200], [17]], np.int32)
    fill = np.full((3,), 7, np.int32)
    jl, jc = rwkv["jmodel"].decode_step(rwkv["jparams"], jcache,
                                        jnp.asarray(toks), jnp.asarray(fill))
    pl, pc = rwkv["model"].decode_step(
        rwkv["params"], cache_from_numpy(_np_tree(jcache), "cpu"),
        _i32(toks), _i32(fill))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    _leaves_close(pc, jc, **TOL)


@pytest.mark.parametrize("lens_set,warm", [
    ([5, 12, 16], False),
    ([16, 0, 9], False),     # a row with nothing to prefill
    ([3, 16, 0], True),      # continuing prompts (offsets > 0)
    ([1, 1, 1], True),
])
def test_prefill_matches_jax_replay(rwkv, lens_set, warm):
    """The port's single-pass ``prefill`` against the JAX model's
    ``prefill`` (the registry's ``replay_prefill`` of its decode step):
    last-position logits of every row with ``lens > 0`` and every cache
    leaf (a row with ``lens = 0`` keeps its cache)."""
    import jax.numpy as jnp

    b, s = len(lens_set), max(lens_set)
    rng = np.random.RandomState(sum(lens_set))
    tokens = rng.randint(0, rwkv["cfg"].vocab, size=(b, s)).astype(np.int32)
    lens = np.asarray(lens_set, np.int32)
    offsets = np.full((b,), 7 if warm else 0, np.int32)
    jcache = (_warm_cache(rwkv, b, seed=4) if warm
              else rwkv["jmodel"].init_cache(b, 64))
    jl, jc = rwkv["jmodel"].prefill(rwkv["jparams"], jcache,
                                    jnp.asarray(tokens), jnp.asarray(lens),
                                    jnp.asarray(offsets))
    cache = cache_from_numpy(_np_tree(jcache), "cpu")
    pl, pc = rwkv["model"].prefill(rwkv["params"], cache, _i32(tokens),
                                   _i32(lens), _i32(offsets))
    rows = lens > 0
    np.testing.assert_allclose(pl.numpy()[rows], np.asarray(jl)[rows], **TOL)
    _leaves_close(pc, jc, **TOL)
    # the port's own replay (ServeConfig(prefill_mode="replay")) agrees
    rl, rc = replay_prefill(rwkv["model"].decode_step)(
        rwkv["params"], cache, _i32(tokens), _i32(lens), _i32(offsets))
    np.testing.assert_allclose(rl.numpy()[rows], pl.numpy()[rows], **TOL)
    _leaves_close(rc, jc, **TOL)


def test_forward_scan_length_matches_jax(rwkv):
    """S = 13 (not a multiple of 16): the reference takes ``_wkv_scan``
    in f32, the same recurrence as the port's kernel path."""
    import jax.numpy as jnp

    tokens = np.random.RandomState(8).randint(
        0, rwkv["cfg"].vocab, size=(2, 13)).astype(np.int32)
    want = rwkv["jmodel"].forward(rwkv["jparams"],
                                  {"tokens": jnp.asarray(tokens)})
    got = rwkv["model"].forward(rwkv["params"], {"tokens": _i32(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_chunked_length_matches_jax(rwkv):
    """S = 32: the reference takes ``_wkv_chunked``, which carries its
    intra-chunk scores, per-chunk kv products and stacked states in bf16
    even in an f32 model (``models/layers.py:839``); the port runs the
    exact f32 recurrence.  So the port is held tightly (1e-5) to the
    reference's f32 scan path over the same 32 positions (a forward at
    S = 33 takes ``_wkv_scan``; position t sees only positions <= t),
    and to the chunked forward within the reference's own
    chunked-vs-scan gap on these inputs, plus 1e-5."""
    import jax.numpy as jnp

    cfg = rwkv["cfg"]
    tokens = np.random.RandomState(9).randint(
        0, cfg.vocab, size=(2, 33)).astype(np.int32)
    scan = np.asarray(rwkv["jmodel"].forward(
        rwkv["jparams"], {"tokens": jnp.asarray(tokens)}))[:, :32]
    chunked = np.asarray(rwkv["jmodel"].forward(
        rwkv["jparams"], {"tokens": jnp.asarray(tokens[:, :32])}))
    got = rwkv["model"].forward(rwkv["params"],
                                {"tokens": _i32(tokens[:, :32])}).numpy()
    np.testing.assert_allclose(got, scan, **TOL)
    gap = np.abs(chunked - scan).max()
    assert gap > 0   # the reference's bf16 intermediates do show
    assert np.abs(got - chunked).max() <= gap + 1e-5


@pytest.mark.parametrize("case", ["eos_row0", "no_eos"])
def test_greedy_decode_matches_jax(rwkv, case):
    """Twin of ``tests/test_system.py``'s early-exit case: tokens and
    ``n_steps`` equal the JAX ``greedy_decode``'s; a row that emits EOS
    stays frozen at it."""
    import jax
    import jax.numpy as jnp

    jm, m = rwkv["jmodel"], rwkv["model"]
    b = 2
    toks = np.array([[5], [9]], np.int32)
    lens = np.ones((b,), np.int32)
    jcache = jm.init_cache(b, 32)
    probe, _, _ = jm.greedy_decode(rwkv["jparams"], jcache,
                                   jnp.asarray(toks), jnp.asarray(lens),
                                   max_new=1, eos_id=-1)
    eos = int(np.asarray(probe)[0, 0]) if case == "eos_row0" else -1
    jbuf, jn, jc = jm.greedy_decode(rwkv["jparams"], jcache,
                                    jnp.asarray(toks), jnp.asarray(lens),
                                    max_new=6, eos_id=eos)
    buf, n, c = m.greedy_decode(rwkv["params"], m.init_cache(b, 32, "cpu"),
                                _i32(toks), _i32(lens), max_new=6,
                                eos_id=eos)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    assert n == int(jn)
    if case == "eos_row0":
        assert (buf[0] == eos).all()
    _leaves_close(c, jax.tree.map(np.asarray, jc), **TOL)


def test_single_artifact_decode_matches_jax(rwkv):
    """Twin of ``tests/test_system.py``'s RWKV-6 single-artifact decode:
    the whole greedy decode compiled once per batch bucket on the port's
    jit pipeline (the cache a ``TreeSpec`` padded along its batch axis),
    batches of 3, 4 and 2 in buckets of 4, 4 and 2: two compiles, and the
    valid rows' tokens equal the JAX model's ``greedy_decode``."""
    import disc_torch
    import jax.numpy as jnp
    from disc_torch import ArgSpec, BucketPolicy, Dim, TreeSpec

    maxn = 4
    m, jm = rwkv["model"], rwkv["jmodel"]
    dim_b = Dim("B", max=8)

    def step(params, cache, toks, lens):
        return m.greedy_decode(params, cache, toks, lens, max_new=maxn,
                               eos_id=-1)

    cf = disc_torch.compile(
        step, specs=[None, TreeSpec({1: "B"}),
                     ArgSpec((dim_b, 1), torch.int32, name="tokens"),
                     ArgSpec((dim_b,), torch.int32, name="lens")],
        pipeline="jit", name="rwkv6_3b_greedy", device="cpu",
        policy=BucketPolicy(kind="multiple", granule=2))
    rng = np.random.RandomState(3)
    buckets = set()
    for b in (3, 4, 2):
        toks = rng.randint(1, rwkv["cfg"].vocab, size=(b, 1)).astype(np.int32)
        lens = np.ones((b,), np.int32)
        buf, n, _ = cf(rwkv["params"], m.init_cache(b, 32, "cpu"),
                       _i32(toks), _i32(lens))
        want, wn, _ = jm.greedy_decode(rwkv["jparams"], jm.init_cache(b, 32),
                                       jnp.asarray(toks), jnp.asarray(lens),
                                       max_new=maxn, eos_id=-1)
        # jit pipeline: batch rows beyond b are bucket padding
        np.testing.assert_array_equal(buf.numpy()[:b], np.asarray(want))
        assert n == int(wn) == maxn
        buckets.add(-(-b // 2) * 2)
    assert cf.n_compiles == len(buckets) == 2


# ------------------------------------------------- serving (CPU) --

def _requests(vocab, lens, max_new=4, cls=Request):
    rng = np.random.RandomState(7)
    return [cls(rid=i, tokens=rng.randint(0, vocab, size=n).astype(np.int32),
                max_new_tokens=max_new) for i, n in enumerate(lens)]


LENS = [5, 9, 14, 40, 33, 12]


def _jax_engine(t, **kw):
    from repro.data.pipeline import Request as JaxRequest
    from repro.serve.engine import ServeConfig as JaxConfig
    from repro.serve.engine import ServeEngine as JaxEngine

    eng = JaxEngine(t["jmodel"], t["jparams"],
                    JaxConfig(max_batch=4, max_seq=96, **kw))
    eng.submit(_requests(t["cfg"].vocab, LENS, cls=JaxRequest))
    return eng.run_until_done(max_steps=500), eng


def _port_engine(t, **kw):
    eng = ServeEngine(t["model"], t["params"],
                      ServeConfig(max_batch=4, max_seq=96, device="cpu",
                                  **kw))
    eng.submit(_requests(t["cfg"].vocab, LENS))
    return eng.run_until_done(max_steps=500), eng


@pytest.mark.parametrize("chunk", [None, 8])
def test_engine_matches_jax_engine(rwkv, chunk):
    """Same requests through both packages' engines on the reduced
    RWKV-6 3B: identical token streams, and the same launch and compile
    counts."""
    want, jeng = _jax_engine(rwkv, prefill_chunk=chunk)
    got, eng = _port_engine(rwkv, prefill_chunk=chunk)
    assert got == want
    assert len(got) == len(LENS)
    for key in ("prefill_calls", "decode_steps", "tokens_generated",
                "prefill_bucket_pairs", "prefill_chunks"):
        assert eng.stats[key] == jeng.stats[key], key
    assert eng.compile_counts() == {k: jeng.compile_counts()[k]
                                    for k in ("prefill", "decode")}


def test_engine_batched_matches_replay(rwkv):
    """The single-pass prefill and the decode-step replay serve the same
    streams; the batched engine launches fewer prefills."""
    batched, beng = _port_engine(rwkv)
    replay, reng = _port_engine(rwkv, prefill_mode="replay")
    assert batched == replay
    assert (beng.stats["prefill_calls"] < reng.stats["prefill_calls"]
            == len(LENS))


# ----------------------------------------- kernels vs plain (card) --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the WKV and LayerNorm (CUDA C++) "
                    "kernels run on the card only")
    return torch.device("cuda")


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


# kernel vs plain on the card, max|d|/max|ref|: f32 differs by the order
# of the dot over K and fused multiply-adds; bf16 by one rounding of the
# output (2^-8) where the f32 sums differ
CARD_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}


def _card_wkv(gen, b, h, t, n, dtype, dev, token_major=True,
              decay_scale=1.0):
    """r, k, v as the model's views; w = exp(-exp(x)) with x standard
    normal times ``decay_scale``, clamped to the model's [-8, 4]."""
    def proj():   # the model's (B, H, T, N) view of a (B, T, D) tensor
        x = torch.randn((b, t, h, n), generator=gen, device=dev) * 0.5
        x = x.to(dtype)
        return x.transpose(1, 2) if token_major else x.transpose(1, 2) \
            .contiguous()

    r, k, v = proj(), proj(), proj()
    w = torch.exp(-torch.exp((decay_scale * torch.randn(
        (b, t, h, n), generator=gen, device=dev)).clamp(-8, 4))) \
        .transpose(1, 2)
    u = torch.randn((h, n), generator=gen, device=dev) * 0.1
    return r, k, v, w, u


def _card_wkv_check(args, dtype, lens=None, s0=None):
    """Kernel (one launch) vs plain version on the same card inputs: y
    within CARD_TOL and the state within 1e-5 of max|ref|; y exactly 0
    past each row's length, and a row of length 0 keeps s0 bit for
    bit."""
    before = wkv_ops.LAUNCHES.launches
    y, s = wkv_ops.rwkv6(*args, s0, lens)
    assert wkv_ops.LAUNCHES.launches == before + 1
    with select.plain_versions():
        y_p, s_p = wkv_ops.rwkv6(*args, s0, lens)
    torch.cuda.synchronize()
    assert y.dtype == dtype and s.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    assert _rel(y, y_p) <= CARD_TOL[dtype]
    assert _rel(s, s_p) <= 1e-5
    if lens is not None:
        for row, n in enumerate(lens.tolist()):
            assert not y[row, :, n:].any()
            if n == 0:
                assert torch.equal(s[row], s0[row])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [64, 16])
def test_wkv_kernel_matches_plain_on_card(cuda, dtype, n):
    gen = torch.Generator(device=cuda).manual_seed(0)
    b, h, t = 3, 5, 77
    r, k, v, w, u = _card_wkv(gen, b, h, t, n, dtype, cuda)
    s0 = torch.randn((b, h, n, n), generator=gen, device=cuda)
    lens = torch.tensor([t, 40, 0], dtype=torch.int32, device=cuda)
    for args in ((None, None), (s0, lens)):
        before = wkv_ops.LAUNCHES.launches
        y, s = wkv_ops.rwkv6(r, k, v, w, u, *args)
        assert wkv_ops.LAUNCHES.launches == before + 1
        with select.plain_versions():
            y_p, s_p = wkv_ops.rwkv6(r, k, v, w, u, *args)
        torch.cuda.synchronize()
        assert y.dtype == dtype and s.dtype == torch.float32
        assert torch.isfinite(y).all() and torch.isfinite(s).all()
        assert _rel(y, y_p) <= CARD_TOL[dtype]
        assert _rel(s, s_p) <= 1e-5
        if args[1] is not None:
            assert not y[1, :, 40:].any() and not y[2].any()
            assert torch.equal(s[2], s0[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["harsh", "ragged_1999", "many_blocks",
                                  "t8", "t9"])
def test_wkv_kernel_chunked_cases_on_card(cuda, case, dtype):
    """The chunked instance's edges: harsh decays (scale 3: about a tenth
    of them at the clamp's e^{-e^4}); T = 1999 with ``lens`` ending inside
    a chunk (and a row of length 0); B = 8, T = 4096, 20480 blocks, more
    than the card holds at once, so later chunks wait on the ticket
    order; T = 8 (the decode instance's longest) and T = 9 (the chunked
    instance's shortest), from a state."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    n, h = 64, 40
    b, t, scale, lens = {
        "harsh": (2, 300, 3.0, None),
        "ragged_1999": (3, 1999, 1.0, [1999, 1000, 0]),
        "many_blocks": (8, 4096, 1.0, None),
        "t8": (4, DECODE_MAX_T, 1.0, [DECODE_MAX_T, 3, 0, 1]),
        "t9": (4, DECODE_MAX_T + 1, 1.0, [DECODE_MAX_T + 1, 3, 0, 1]),
    }[case]
    assert wkv_plan(b, h, t, n).instance == (
        "decode" if t <= DECODE_MAX_T else "chunked")
    args = _card_wkv(gen, b, h, t, n, dtype, cuda, decay_scale=scale)
    s0 = torch.randn((b, h, n, n), generator=gen, device=cuda)
    if lens is not None:
        lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    _card_wkv_check(args, dtype, lens, s0)
    if case == "many_blocks":   # and from a zero state
        _card_wkv_check(args, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_kernel_prefill_in_pieces_on_card(cuda, dtype):
    """A 1024-step prompt in one launch, and in two 512-step launches (the
    serve path's prefill chunk; the second from the first's state), give
    the same y and state bit for bit: the chunk length divides 512, so
    both meet the same chunk boundaries."""
    assert 512 % CHUNK == 0
    gen = torch.Generator(device=cuda).manual_seed(7)
    b, h, t, n = 2, 40, 1024, 64
    r, k, v, w, u = _card_wkv(gen, b, h, t, n, dtype, cuda)
    s0 = torch.randn((b, h, n, n), generator=gen, device=cuda)
    y, s = wkv_ops.rwkv6(r, k, v, w, u, s0)
    half = [x[:, :, :512] for x in (r, k, v, w)]
    y1, s1 = wkv_ops.rwkv6(*half, u, s0)
    y2, s2 = wkv_ops.rwkv6(*[x[:, :, 512:] for x in (r, k, v, w)], u, s1)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([y1, y2], dim=2), y)
    assert torch.equal(s2, s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_kernel_decode_on_card(cuda, dtype):
    """T = 1 from a state (the decode step), contiguous inputs."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    b, h, n = 4, 40, 64
    r, k, v, w, u = _card_wkv(gen, b, h, 1, n, dtype, cuda,
                              token_major=False)
    s0 = torch.randn((b, h, n, n), generator=gen, device=cuda)
    y, s = wkv_ops.rwkv6(r, k, v, w, u, s0)
    with select.plain_versions():
        y_p, s_p = wkv_ops.rwkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert _rel(y, y_p) <= CARD_TOL[dtype]
    assert _rel(s, s_p) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2048, 2560), (4, 1, 2560), (3, 7, 96)])
def test_layernorm_kernel_matches_plain_on_card(cuda, dtype, shape):
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = (torch.randn(shape, generator=gen, device=cuda) + 3.0).to(dtype)
    g = 1.0 + 0.1 * torch.randn(shape[-1], generator=gen, device=cuda)
    bias = 0.1 * torch.randn(shape[-1], generator=gen, device=cuda)
    before = ln_ops.LAUNCHES.launches
    got = ln_ops.layernorm(x, g, bias)
    assert ln_ops.LAUNCHES.launches == before + 1
    with select.plain_versions():
        want = ln_ops.layernorm(x, g, bias)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert _rel(got, want) <= CARD_TOL[dtype]
