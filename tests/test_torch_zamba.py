"""The port's hybrid family (Zamba2) against the JAX package, on the CPU.

* **SSD plain versions** (``kernels/mamba2/ref.py``: the sequential
  ``mamba2_ref`` and the chunk-parallel ``mamba2_chunked`` the wrapper
  takes) against the JAX package's Pallas kernel in interpret mode
  (``mamba2_scan``) and its sequential oracle (``mamba2_ref``) at
  ``tests/test_kernels.py``'s shapes, and their ``s0`` and ``lens``
  extensions against one long run.  The port's b and c are per row,
  (B, T, N); the JAX side gets them broadcast over heads.
* **Mamba-2 layer**: ``mamba2_apply`` without a cache against the JAX
  block, and its decode form (S = 1 from a state) against the
  reference's one-step einsums.
* **Reduced ``zamba2_7b``** (f32, 5 layers in groups [2, 3], the JAX
  parameters carried across by ``params_from_numpy`` with ``lora.b_q``
  overwritten by seeded random values on both sides, since the
  reference's zeros would hide a dropped LoRA delta): the cache tree,
  ``forward``, ``decode_step``, the port's single-pass ``prefill``
  against the JAX model's ``replay_prefill``, and the port's
  ``ServeEngine`` against the JAX one (identical token streams).
* **Attention at hd 112** (Zamba2's head dim): the plain attention
  against the reference's ``_sdpa``.
* **SSD kernel plan and arithmetic**: ``ssd_plan``'s instance by T and
  its grid, and the chunked instance's 3 x TF32 products emulated on the
  CPU (TF32 by clearing 13 mantissa bits) against the oracle and the
  Pallas kernel at N = P = 64.
* **Card cases** (``-k on_card``): the SSD kernel's instances and
  hd-112 flash attention against their plain versions on the same card
  inputs, and a chain of one-step SSD launches against one launch over
  the same steps.  They skip here and run on the card, where JAX is not
  installed (``python -m pytest -q tests/test_torch_zamba.py -k
  on_card``).

Tolerances are max|d| over max|ref| (``_close``): 1e-5 in f32, where
both sides compute in f32 and differ by summation order, by the chunked
form's products of decays, and through five layers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import Request
from repro_torch.kernels import select
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.mamba2 import ops as ssd_ops
from repro_torch.kernels.mamba2.ref import mamba2_chunked, mamba2_ref
from repro_torch.models import layers as L
from repro_torch.models import zamba
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.models.registry import get_model, replay_prefill
from repro_torch.serve.engine import ServeConfig, ServeEngine

TOL = 1e-5

SSD_VERSIONS = {"ref": mamba2_ref, "chunked": mamba2_chunked}


def _close(got, want, tol=TOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: max|d| {err:.3e} > {tol} x " \
                               f"max|ref| {scale:.3e}"


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _i32(a):
    return torch.tensor(np.asarray(a), dtype=torch.int32)


def _ssd_inputs(b, h, t, n, p, seed=13):
    """``tests/test_kernels.py``'s SSD inputs (decay in (0, 1)), with b
    and c per row: x (B, H, T, P), a (B, H, T), b, c (B, T, N)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, t, p).astype(np.float32) * 0.5
    a = (1.0 / (1.0 + np.exp(-rng.randn(b, h, t)))).astype(np.float32)
    bb = rng.randn(b, t, n).astype(np.float32) * 0.5
    c = rng.randn(b, t, n).astype(np.float32) * 0.5
    return x, a, bb, c


def _jax_ssd_args(x, a, bb, c):
    import jax.numpy as jnp

    h = x.shape[1]
    per_head = lambda m: jnp.broadcast_to(jnp.asarray(m)[:, None],
                                          (m.shape[0], h) + m.shape[1:])
    return (jnp.asarray(x), jnp.asarray(a)[..., None], per_head(bb),
            per_head(c))


# ------------------------------------------- SSD plain vs Pallas (CPU) --

@pytest.mark.parametrize("version", sorted(SSD_VERSIONS))
@pytest.mark.parametrize("against", ["pallas", "oracle"])
@pytest.mark.parametrize("t", [16, 64, 70])
def test_ssd_plain_matches_reference(t, against, version):
    from repro.kernels.mamba2.ops import mamba2_scan
    from repro.kernels.mamba2.ref import mamba2_ref as jax_ref

    xs = _ssd_inputs(2, 2, t, 8, 8)
    fn = mamba2_scan if against == "pallas" else jax_ref
    want = np.asarray(fn(*_jax_ssd_args(*xs)))
    y, s = SSD_VERSIONS[version](*_t(*xs))
    assert y.dtype == torch.float32 and s.shape == (2, 2, 8, 8)
    _close(y.numpy(), want)


@pytest.mark.parametrize("version", sorted(SSD_VERSIONS))
@pytest.mark.parametrize("t1", [1, 17, 64])
def test_ssd_plain_continues_from_s0(t1, version):
    """Split T at t1: the run over [t1, T) from the state after [0, t1)
    is the oracle's whole sequence over [t1, T), and the final states
    agree."""
    from repro.kernels.mamba2.ref import mamba2_ref as jax_ref

    t = 150
    xs = _ssd_inputs(2, 3, t, 8, 8, seed=5)
    want = np.asarray(jax_ref(*_jax_ssd_args(*xs)))
    x, a, b, c = _t(*xs)
    fn = SSD_VERSIONS[version]
    _, s_whole = mamba2_ref(x, a, b, c)
    y1, s1 = fn(x[:, :, :t1], a[:, :, :t1], b[:, :t1], c[:, :t1])
    y2, s2 = fn(x[:, :, t1:], a[:, :, t1:], b[:, t1:], c[:, t1:], s0=s1)
    _close(y1.numpy(), want[:, :, :t1])
    _close(y2.numpy(), want[:, :, t1:])
    _close(s2.numpy(), s_whole.numpy())


@pytest.mark.parametrize("version", sorted(SSD_VERSIONS))
def test_ssd_plain_lens(version):
    """Per-row lens: the state after ``lens[b]`` steps (a row of length 0
    keeps its initial state bit for bit), and y exactly 0 beyond."""
    t = 100
    x, a, b, c = _t(*_ssd_inputs(3, 2, t, 8, 8, seed=9))
    s0 = torch.from_numpy(np.random.RandomState(3).randn(3, 2, 8, 8)
                          .astype(np.float32))
    lens = _i32([t, 70, 0])
    fn = SSD_VERSIONS[version]
    y, s = fn(x, a, b, c, s0=s0, lens=lens)
    for row, n in enumerate(lens.tolist()):
        sl = slice(row, row + 1)
        y_n, s_n = mamba2_ref(x[sl, :, :n], a[sl, :, :n], b[sl, :n],
                              c[sl, :n], s0=s0[sl])
        if n:
            _close(y[sl, :, :n].numpy(), y_n.numpy())
        _close(s[sl].numpy(), s_n.numpy())
        assert not y[row, :, n:].any()
    assert torch.equal(s[2], s0[2])


def test_ssd_wrapper_takes_chunked_on_cpu():
    """On a CPU tensor (and inside ``plain_versions()``) the wrapper is
    the chunked plain version, and launches nothing."""
    xs = _t(*_ssd_inputs(2, 2, 40, 8, 8, seed=4))
    before = ssd_ops.LAUNCHES.launches
    y, s = ssd_ops.mamba2_scan(*xs)
    with select.plain_versions():
        y2, s2 = ssd_ops.mamba2_scan(*xs)
    want_y, want_s = mamba2_chunked(*xs)
    assert torch.equal(y, want_y) and torch.equal(s, want_s)
    assert torch.equal(y2, want_y) and torch.equal(s2, want_s)
    assert ssd_ops.LAUNCHES.launches == before


# ------------------------------- SSD kernel: plan, 3 x TF32 split (CPU) --

def test_ssd_plan_picks_instance_by_t():
    """T up to ``DECODE_MAX_T`` takes the decode instance (a block a (b,
    h), no scratch); longer T the chunked one, whose blocks cover every
    (b, chunk, head) and, at B = 1, T = 2048, H = 112, fill the card
    several times over (two blocks an SM)."""
    from repro_torch.kernels.mamba2.mamba2 import DECODE_MAX_T, ssd_plan

    for t in (0, 1, DECODE_MAX_T):
        plan = ssd_plan(4, 112, t)
        assert plan.instance == "decode" and plan.blocks == 4 * 112
        assert plan.work_floats == plan.sync_ints == 0
    for t in (DECODE_MAX_T + 1, 63, 64, 65, 1999, 2048):
        plan = ssd_plan(2, 112, t)
        assert plan.instance == "chunked" and plan.chunks == -(-t // 64)
    plan = ssd_plan(1, 112, 2048)
    groups = -(-112 // plan.heads_per_block)
    assert plan.blocks == 32 * groups
    assert plan.blocks * plan.heads_per_block >= 32 * 112
    assert plan.blocks >= 4 * 132
    assert plan.sync_ints == 1 + groups
    assert plan.work_floats == 2 * 112 * 64 * 64


def _tf32(v):
    """v rounded to TF32 by clearing its low 13 mantissa bits."""
    return (v.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm3(eq, a, b):
    """The kernel's 3 x TF32 product: a_lo b_hi + a_hi b_lo + a_hi b_hi,
    hi = tf32(v), lo = tf32(v - hi); an operand exact in TF32 (bf16
    values) has lo = 0."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_hi, b_hi))


def _chunked_tf32x3(x, a, b, c, s0=None, lens=None):
    """``mamba2_chunked`` as the chunked kernel computes it: its four
    products by the 3 x TF32 split, the decay between steps of different
    16-step blocks as the product of two factors through the later
    block's first step, y = g (C h_prev) + S X."""
    bs, h, t, p = x.shape
    n = b.shape[-1]
    ck = 64
    la = torch.log(a.float().clamp(min=1e-37))
    xf, bf, cf = x.float(), b.float(), c.float()
    if lens is not None:
        valid = torch.arange(t)[None, :] < lens[:, None]
        la = torch.where(valid[:, None], la, 0.0)
        xf = torch.where(valid[:, None, :, None], xf, 0.0)
        bf = torch.where(valid[..., None], bf, 0.0)
    pad = (-t) % ck
    xf, la = (torch.nn.functional.pad(xf, (0, 0, 0, pad)),
              torch.nn.functional.pad(la, (0, pad)))
    bf, cf = (torch.nn.functional.pad(v, (0, 0, 0, pad)) for v in (bf, cf))
    nc = (t + pad) // ck
    xs = xf.reshape(bs, h, nc, ck, p)
    bc, cc = bf.reshape(bs, nc, ck, n), cf.reshape(bs, nc, ck, n)
    cum = torch.cumsum(la.reshape(bs, h, nc, ck), -1)
    tt = torch.arange(ck)
    blk = tt // 16
    piv = cum[..., blk * 16]                          # cum at t's block start
    direct = torch.exp(cum[..., :, None] - cum[..., None, :])
    split = (torch.exp(cum - piv)[..., :, None]
             * torch.exp(piv[..., :, None] - cum[..., None, :]))
    decay = torch.where(blk[:, None] == blk[None, :], direct, split)
    decay = torch.where(tt[:, None] >= tt[None, :], decay, 0.0)
    scores = _mm3("bctn,bcsn->bcts", cc, bc)[:, None] * decay
    de = torch.exp(cum[..., -1:] - cum)
    bx = _mm3("bhcsn,bhcsp->bhcnp", bc[:, None] * de[..., None], xs)
    g = torch.exp(cum)
    state = torch.zeros((bs, h, n, p)) if s0 is None else s0.float()
    prevs = []
    for i in range(nc):
        prevs.append(state)
        state = g[..., i, -1, None, None] * state + bx[:, :, i]
    h_prev = torch.stack(prevs, dim=2)
    y = (g[..., None] * _mm3("bhctn,bhcnp->bhctp",
                             cc[:, None].expand(bs, h, nc, ck, n), h_prev)
         + _mm3("bhcts,bhcsp->bhctp", scores, xs))
    y = y.reshape(bs, h, nc * ck, p)[:, :, :t]
    if lens is not None:
        y = torch.where(valid[:, None, :, None], y, 0.0)
    return y, state


@pytest.mark.parametrize("inputs", ["f32", "bf16"])
@pytest.mark.parametrize("t", [1, 63, 200])
def test_ssd_tf32x3_split_holds_the_tolerance(t, inputs):
    """The chunked kernel's arithmetic, emulated on the CPU at N = P = 64:
    within 1e-5 of the sequential oracle with a state and per-row lens
    (a row of length 0 keeps its state bit for bit), and of the Pallas
    kernel (interpret mode) on its own case (zero state, every step).
    bf16 inputs are exact in TF32, so their products take no low part."""
    from repro.kernels.mamba2.ops import mamba2_scan

    x, a, b, c = _t(*_ssd_inputs(3, 3, t, 64, 64, seed=21))
    if inputs == "bf16":
        x, b, c = (v.bfloat16().float() for v in (x, b, c))
    s0 = torch.from_numpy(np.random.RandomState(8).randn(3, 3, 64, 64)
                          .astype(np.float32))
    lens = _i32([t, max(t // 2, 1), 0])
    y, s = _chunked_tf32x3(x, a, b, c, s0, lens)
    want_y, want_s = mamba2_ref(x, a, b, c, s0, lens)
    _close(y.numpy(), want_y.numpy(), what="y")
    _close(s.numpy(), want_s.numpy(), what="state")
    assert not y[2].any() and torch.equal(s[2], s0[2])
    y0, _ = _chunked_tf32x3(x, a, b, c)
    want = np.asarray(mamba2_scan(*_jax_ssd_args(*(v.numpy() for v in
                                                   (x, a, b, c)))))
    _close(y0.numpy(), want, what="vs Pallas")


# ----------------------------------------------- Mamba-2 layer (CPU) --

def _port_cfg(jcfg):
    base = get_config("zamba2_7b")
    return dataclasses.replace(base, **{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(base)})


def _jax_cfg():
    from repro.configs import get_config as jax_config

    return dataclasses.replace(jax_config("zamba2_7b").reduced(),
                               n_layers=5)


@pytest.fixture(scope="module")
def block():
    """One reduced Mamba-2 block's parameters, from the JAX package."""
    import jax
    from repro.models import layers as RL

    jcfg = _jax_cfg()
    jp = RL.mamba2_init(jax.random.PRNGKey(3), jcfg)
    # a non-zero a_log, so the decay's exp(a_log) factor shows
    jp["a_log"] = jax.numpy.asarray(
        np.random.RandomState(2).randn(*jp["a_log"].shape)
        .astype(np.float32) * 0.3)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return dict(jcfg=jcfg, cfg=_port_cfg(jcfg), jp=jp, p=p)


def _jax_sequential(jcfg, jp, x):
    """The reference block's exact recurrence over x (B, S, D): its
    decode form step by step, from a zero state."""
    import jax.numpy as jnp
    from repro.models import layers as RL

    cache = RL.mamba2_cache_init(jcfg, x.shape[0])
    outs = []
    for i in range(x.shape[1]):
        o, cache = RL.mamba2_apply(jcfg, jp, jnp.asarray(x[:, i:i + 1]),
                                   cache=cache)
        outs.append(np.asarray(o))
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("s", [13, 16, 24, 64, 128])
def test_mamba2_apply_matches_jax(block, s):
    """Without a cache.  The port runs the exact f32 recurrence: it is
    held to the reference's sequential form at 1e-5.  Where the
    reference's own forward splits S into more than one chunk (S a
    multiple of 8 and above the chunk: 24 in chunks of 8, 128 in chunks
    of 64), ``_ssd_chunked`` carries its stacked per-chunk states in
    bf16 (``models/layers.py:745``), so the port is held to that forward
    within the reference's own chunked-vs-sequential gap; elsewhere
    (one chunk) at 1e-5."""
    import jax.numpy as jnp
    from repro.models import layers as RL

    x = np.random.RandomState(s).randn(2, s, block["cfg"].d_model) \
        .astype(np.float32)
    fwd, _ = RL.mamba2_apply(block["jcfg"], block["jp"], jnp.asarray(x))
    fwd = np.asarray(fwd)
    seq = _jax_sequential(block["jcfg"], block["jp"], x)
    got, cache = L.mamba2_apply(block["cfg"], block["p"],
                                torch.from_numpy(x))
    assert cache is None
    _close(got.numpy(), seq, what="vs sequential")
    gap = np.abs(fwd - seq).max()
    if s in (24, 128):
        assert gap > TOL * np.abs(seq).max()   # the bf16 states show
        assert np.abs(got.numpy() - fwd).max() <= gap + TOL * np.abs(
            fwd).max()
    else:
        _close(got.numpy(), fwd, what="vs forward")


def test_mamba2_decode_matches_jax(block):
    """S = 1 from a non-zero state: the reference's one-step einsums."""
    import jax.numpy as jnp
    from repro.models import layers as RL

    rng = np.random.RandomState(11)
    cfg = block["cfg"]
    h = rng.randn(3, 2 * cfg.d_model // cfg.ssm_head_dim, cfg.ssm_state,
                  cfg.ssm_head_dim).astype(np.float32)
    x = rng.randn(3, 1, cfg.d_model).astype(np.float32)
    want, jc = RL.mamba2_apply(block["jcfg"], block["jp"], jnp.asarray(x),
                               cache={"h": jnp.asarray(h)})
    got, c = L.mamba2_apply(cfg, block["p"], torch.from_numpy(x),
                            cache={"h": torch.from_numpy(h)})
    _close(got.numpy(), np.asarray(want))
    _close(c["h"].numpy(), np.asarray(jc["h"]))


# -------------------------------------------- reduced zamba2_7b (CPU) --

@pytest.fixture(scope="module")
def zam():
    """The reduced Zamba2-7B (5 layers, groups [2, 3]), initialised by the
    JAX package with a seeded non-zero ``lora.b_q``, carried into the
    port."""
    import jax
    import jax.numpy as jnp
    from repro.models.registry import get_model as jax_model

    jcfg = _jax_cfg()
    jmodel = jax_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    b_q = jparams["lora"]["b_q"]
    jparams["lora"]["b_q"] = jnp.asarray(
        np.random.RandomState(1).randn(*b_q.shape).astype(np.float32) * 0.3)
    cfg = _port_cfg(jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return dict(cfg=cfg, model=get_model(cfg), params=params, jcfg=jcfg,
                jmodel=jmodel, jparams=jparams)


def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _leaves_close(got, want):
    import jax

    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, leaf in flat:
        node = got
        for key in path:
            node = node[key.key]
        _close(node.numpy(), np.asarray(leaf),
               what=jax.tree_util.keystr(path))


def _warm_cache(t, b, seed):
    """A non-zero cache: the JAX model after a prompt of 7 tokens."""
    import jax.numpy as jnp

    rng = np.random.RandomState(seed)
    pre = rng.randint(0, t["cfg"].vocab, size=(b, 7)).astype(np.int32)
    jm = t["jmodel"]
    _, jcache = jm.prefill(t["jparams"], jm.init_cache(b, 32),
                           jnp.asarray(pre), jnp.full((b,), 7, jnp.int32),
                           jnp.zeros((b,), jnp.int32))
    return jcache


def test_zamba_groups_and_cache_tree_match_jax(zam):
    """Groups [2, 3] (the remainder to the last group, as the reference
    assigns it), and ``init_cache`` keeps the reference's tree."""
    import jax
    from repro.models import zamba as jax_zamba

    assert zamba._group_sizes(zam["cfg"]) == \
        jax_zamba._group_sizes(zam["jcfg"]) == [2, 3]
    assert zamba._group_sizes(get_config("zamba2_7b")) == [6] * 12 + [9]
    jc = zam["jmodel"].init_cache(3, 32)
    pc = zam["model"].init_cache(3, 32, "cpu")
    flat = jax.tree_util.tree_flatten_with_path(jc)[0]
    assert len(flat) == 3
    for path, leaf in flat:
        node = pc
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        assert str(node.dtype) == f"torch.{leaf.dtype}"


@pytest.mark.parametrize("batch", [3, 5])
def test_zamba_cache_rows_on_axis_1(zam, batch):
    """The engine's per-row rule finds the batch on axis 1 of both
    subtrees, also where the batch equals the layer count (5)."""
    from repro_torch.models.registry import cache_batch_axis, gate_rows

    cache = zam["model"].init_cache(batch, 16, "cpu")
    for sub in cache.values():
        for leaf in sub.values():
            assert cache_batch_axis(tuple(leaf.shape), batch) == 1
    keep = torch.zeros(batch, dtype=torch.bool)
    keep[1] = True
    new = {k: {n: torch.ones_like(v) for n, v in sub.items()}
           for k, sub in cache.items()}
    gated = gate_rows(keep, new, cache)
    for k, sub in gated.items():
        for n, leaf in sub.items():
            assert leaf[:, 1].eq(1).all() and not leaf[:, 0].any(), (k, n)


@pytest.mark.parametrize("s", [13, 16])
def test_zamba_forward_matches_jax(zam, s):
    """S = 13 and 16: the reference's forward takes one SSD chunk (exact
    f32), with causal shared attention over the lens-masked keys."""
    import jax.numpy as jnp

    tokens = np.random.RandomState(8 + s).randint(
        0, zam["cfg"].vocab, size=(2, s)).astype(np.int32)
    lens = np.array([s, s - 4], np.int32)
    want = zam["jmodel"].forward(zam["jparams"],
                                 {"tokens": jnp.asarray(tokens),
                                  "lens": jnp.asarray(lens)})
    got = zam["model"].forward(zam["params"],
                               {"tokens": _i32(tokens), "lens": _i32(lens)})
    _close(got.numpy(), np.asarray(want))


def test_zamba_lora_delta_counts(zam):
    """The LoRA delta reaches the logits: zeroing ``b_q`` in the port
    alone moves them."""
    tokens = _i32(np.arange(10, dtype=np.int32)[None] % zam["cfg"].vocab)
    p0 = dict(zam["params"], lora={
        "a_q": zam["params"]["lora"]["a_q"],
        "b_q": torch.zeros_like(zam["params"]["lora"]["b_q"])})
    with_delta = zam["model"].forward(zam["params"], {"tokens": tokens})
    without = zam["model"].forward(p0, {"tokens": tokens})
    assert (with_delta - without).abs().max() > 1e-3


def test_zamba_decode_step_matches_jax(zam):
    """One decode step from a non-zero cache: logits and every leaf."""
    import jax.numpy as jnp

    jcache = _warm_cache(zam, 3, seed=2)
    toks = np.array([[5], [200], [17]], np.int32)
    fill = np.full((3,), 7, np.int32)
    jl, jc = zam["jmodel"].decode_step(zam["jparams"], jcache,
                                       jnp.asarray(toks), jnp.asarray(fill))
    pl, pc = zam["model"].decode_step(
        zam["params"], cache_from_numpy(_np_tree(jcache), "cpu"),
        _i32(toks), _i32(fill))
    _close(pl.numpy(), np.asarray(jl))
    _leaves_close(pc, jc)


@pytest.mark.parametrize("lens_set,warm", [
    ([5, 12, 16], False),
    ([16, 0, 9], False),     # a row with nothing to prefill
    ([3, 16, 0], True),      # continuing prompts (offsets > 0)
    ([1, 1, 1], True),
])
def test_zamba_prefill_matches_jax_replay(zam, lens_set, warm):
    """The port's single-pass ``prefill`` against the JAX model's
    ``prefill`` (the registry's ``replay_prefill`` of its decode step):
    last-position logits of every row with ``lens > 0`` and every cache
    leaf (a row with ``lens = 0`` keeps its cache)."""
    import jax.numpy as jnp

    b, s = len(lens_set), max(lens_set)
    rng = np.random.RandomState(sum(lens_set))
    tokens = rng.randint(0, zam["cfg"].vocab, size=(b, s)).astype(np.int32)
    lens = np.asarray(lens_set, np.int32)
    offsets = np.full((b,), 7 if warm else 0, np.int32)
    jcache = (_warm_cache(zam, b, seed=4) if warm
              else zam["jmodel"].init_cache(b, 32))
    jl, jc = zam["jmodel"].prefill(zam["jparams"], jcache,
                                   jnp.asarray(tokens), jnp.asarray(lens),
                                   jnp.asarray(offsets))
    cache = cache_from_numpy(_np_tree(jcache), "cpu")
    pl, pc = zam["model"].prefill(zam["params"], cache, _i32(tokens),
                                  _i32(lens), _i32(offsets))
    rows = lens > 0
    _close(pl.numpy()[rows], np.asarray(jl)[rows])
    _leaves_close(pc, jc)
    if warm:
        # a row with lens = 0 keeps its state bit for bit
        for r in np.flatnonzero(~rows):
            assert torch.equal(pc["mamba"]["h"][:, r],
                               cache["mamba"]["h"][:, r])
    # the port's own replay (ServeConfig(prefill_mode="replay")) agrees
    rl, rc = replay_prefill(zam["model"].decode_step)(
        zam["params"], cache, _i32(tokens), _i32(lens), _i32(offsets))
    _close(rl.numpy()[rows], pl.numpy()[rows])
    _leaves_close(rc, jc)


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
def test_zamba_engine_matches_jax_engine(zam, chunk):
    """Same requests through both packages' engines on the reduced
    Zamba2-7B: identical token streams, and the same launch and compile
    counts."""
    want, jeng = _jax_engine(zam, prefill_chunk=chunk)
    got, eng = _port_engine(zam, prefill_chunk=chunk)
    assert got == want
    assert len(got) == len(LENS)
    for key in ("prefill_calls", "decode_steps", "tokens_generated",
                "prefill_bucket_pairs", "prefill_chunks"):
        assert eng.stats[key] == jeng.stats[key], key
    assert eng.compile_counts() == {k: jeng.compile_counts()[k]
                                    for k in ("prefill", "decode")}


# ------------------------------------------- attention at hd 112 (CPU) --

@pytest.mark.parametrize("case", ["causal", "row_offsets_lens", "decode"])
def test_sdpa_hd112_matches_reference(case):
    """The plain attention the wrapper takes on the CPU, at Zamba2's head
    dim (MHA), against the reference's ``_sdpa``."""
    import jax.numpy as jnp
    from repro.models import layers as RL

    rng = np.random.RandomState(21)
    b, h, hd = 3, 4, 112
    sq, sk = {"causal": (40, 40), "row_offsets_lens": (16, 64),
              "decode": (1, 64)}[case]
    q = rng.randn(b, h, sq, hd).astype(np.float32)
    k, v = (rng.randn(b, h, sk, hd).astype(np.float32) for _ in range(2))
    lens = None if case == "causal" else np.array([64, 40, 30], np.int32)
    off = np.array([0, 20, 48], np.int32) if case == "row_offsets_lens" \
        else 0
    causal = case != "decode"
    want = RL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal,
                    lens=None if lens is None else jnp.asarray(lens),
                    q_offset=jnp.asarray(off) if case == "row_offsets_lens"
                    else 0)
    got = fa_ops.flash_attention(
        *_t(q, k, v), None if lens is None else _i32(lens), causal=causal,
        q_offset=_i32(off) if case == "row_offsets_lens" else 0)
    _close(got.numpy(), np.asarray(want))


# ----------------------------------------- kernels vs plain (card) --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the SSD and flash-attention "
                    "kernels (CUDA C++) run on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


# kernel vs plain on the card, max|d|/max|ref|: the SSD computes in f32 in
# both dtypes (inputs widened at load), so both are held to 1e-5; flash
# attention's bf16 output differs by one rounding (2^-8) where sums differ
SSD_CARD_TOL = 1e-5
FA_CARD_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}


def _card_ssd(gen, b, h, t, dtype, dev):
    """The model's views: x (B, H, T, P) of a token-major (B, T, H*P)
    projection, a (B, H, T) of a (B, T, H) decay, b and c the halves of a
    (B, T, 2N) projection."""
    x = (torch.randn((b, t, h, 64), generator=gen, device=dev) * 0.5) \
        .to(dtype).transpose(1, 2)
    a = torch.exp(-torch.nn.functional.softplus(
        torch.randn((b, t, h), generator=gen, device=dev))).transpose(1, 2)
    bc = (torch.randn((b, t, 128), generator=gen, device=dev) * 0.5) \
        .to(dtype)
    return x, a, bc[..., :64], bc[..., 64:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [200, 64, 1])
def test_ssd_kernel_matches_plain_on_card(cuda, dtype, t):
    gen = torch.Generator(device=cuda).manual_seed(0)
    b, h = 3, 5
    x, a, bm, cm = _card_ssd(gen, b, h, t, dtype, cuda)
    s0 = torch.randn((b, h, 64, 64), generator=gen, device=cuda)
    lens = torch.tensor([t, max(t // 2, 1), 0], dtype=torch.int32,
                        device=cuda)
    for args in ((None, None), (s0, lens)):
        before = ssd_ops.LAUNCHES.launches
        y, s = ssd_ops.mamba2_scan(x, a, bm, cm, *args)
        assert ssd_ops.LAUNCHES.launches == before + 1
        with select.plain_versions():
            y_p, s_p = ssd_ops.mamba2_scan(x, a, bm, cm, *args)
        torch.cuda.synchronize()
        assert y.dtype == torch.float32 and s.dtype == torch.float32
        assert torch.isfinite(y).all() and torch.isfinite(s).all()
        assert _rel(y, y_p) <= SSD_CARD_TOL
        assert _rel(s, s_p) <= SSD_CARD_TOL
        if args[1] is not None:
            n1 = int(lens[1])
            assert not y[1, :, n1:].any() and not y[2].any()
            assert torch.equal(s[2], s0[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 2, 63, 65, 2048])
def test_ssd_kernel_instances_on_card(cuda, dtype, t):
    """Both instances (decode up to ``DECODE_MAX_T`` steps, chunked past
    it) at B = 4 from a state, one row of each lens kind (all, half, 0,
    1), H = 5 (a partial head group), against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    b, h = 4, 5
    x, a, bm, cm = _card_ssd(gen, b, h, t, dtype, cuda)
    s0 = torch.randn((b, h, 64, 64), generator=gen, device=cuda)
    lens = torch.tensor([t, max(t // 2, 1), 0, 1], dtype=torch.int32,
                        device=cuda)
    for args in ((None, None), (s0, lens)):
        y, s = ssd_ops.mamba2_scan(x, a, bm, cm, *args)
        with select.plain_versions():
            y_p, s_p = ssd_ops.mamba2_scan(x, a, bm, cm, *args)
        torch.cuda.synchronize()
        assert _rel(y, y_p) <= SSD_CARD_TOL
        assert _rel(s, s_p) <= SSD_CARD_TOL
        if args[1] is not None:
            for row, n in enumerate(lens.tolist()):
                assert not y[row, :, n:].any()
            assert torch.equal(s[2], s0[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [5, 70])
def test_ssd_decode_chain_matches_one_prefill_on_card(cuda, dtype, t):
    """T one-step launches carrying the state give one launch over the T
    steps (the decode instance at T = 5, the chunked one at T = 70)."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    x, a, bm, cm = _card_ssd(gen, 2, 3, t, dtype, cuda)
    s0 = torch.randn((2, 3, 64, 64), generator=gen, device=cuda)
    y_all, s_all = ssd_ops.mamba2_scan(x, a, bm, cm, s0)
    state, ys = s0, []
    for i in range(t):
        yi, state = ssd_ops.mamba2_scan(x[:, :, i:i + 1], a[:, :, i:i + 1],
                                        bm[:, i:i + 1], cm[:, i:i + 1],
                                        state)
        ys.append(yi)
    torch.cuda.synchronize()
    assert _rel(torch.cat(ys, dim=2), y_all) <= SSD_CARD_TOL
    assert _rel(state, s_all) <= SSD_CARD_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_hd112_kernel_matches_plain_on_card(cuda, dtype):
    """Prefill (causal, per-row offsets and lens, a fully masked row) and
    decode (group 1, Zamba2's MHA) at hd 112."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    b, h, sq, sk, hd = 3, 4, 200, 333, 112
    q = torch.randn((b, sq, h, hd), generator=gen, device=cuda).to(dtype) \
        .transpose(1, 2)
    k, v = (torch.randn((b, h, sk, hd), generator=gen,
                        device=cuda).to(dtype) for _ in range(2))
    off = torch.tensor([0, 70, 133], dtype=torch.int32, device=cuda)
    lens = torch.tensor([333, 150, 0], dtype=torch.int32, device=cuda)
    for causal, ln, qo in ((True, None, off), (True, lens, off),
                           (False, lens, 0)):
        before = fa_ops.LAUNCHES.launches
        got = fa_ops.flash_attention(q, k, v, ln, causal=causal, q_offset=qo)
        assert fa_ops.LAUNCHES.launches == before + 1
        with select.plain_versions():
            want = fa_ops.flash_attention(q, k, v, ln, causal=causal,
                                          q_offset=qo)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert _rel(got, want) <= FA_CARD_TOL[dtype], (causal, ln is None)
        if ln is not None:
            assert not got[2].any()
    qd = q[:, :, :1]
    dl = torch.tensor([333, 1, 77], dtype=torch.int32, device=cuda)
    got = fa_ops.flash_decode(qd, k, v, dl)
    with select.plain_versions():
        want = fa_ops.flash_decode(qd, k, v, dl)
    torch.cuda.synchronize()
    assert _rel(got, want) <= FA_CARD_TOL[dtype]
