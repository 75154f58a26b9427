"""The port's MoE family (DBRX) and its masked softmax against the JAX
package, on the CPU.

* **Masked softmax plain version** (``kernels/softmax/ref.py``) against
  the JAX package's Pallas ``masked_softmax`` in interpret mode, at
  ``tests/test_kernels.py``'s ``TestMaskedSoftmax`` shapes and dtypes and
  at ``n_valid`` 0, 1, C // 2 + 1 and C: within the reference's ``TOL``
  (the Pallas kernel computes in x's dtype, the port in f32 with one
  rounding), padded columns exactly 0, a row without a valid column all
  0.
* **MoE layer** (``moe_apply``) against the JAX ``moe_apply`` on the same
  weights, at the default capacity_factor 1.25 where tokens drop (and
  must drop alike), without and with a shared expert.  Both compute in
  f32 and differ by summation order: 1e-5 of max|ref|.
* **Bucket invariance**: the port's prefill gives the same logits and
  cache at a prompt's exact length and padded to the bucket (capacity
  from the valid tokens, padding out of the sort); the reference's own
  difference is printed beside it (its capacity counts the padding).
* **Reduced ``dbrx_132b``** (f32, 2 layers, E = 4, top-2; the JAX
  parameters carried across by ``params_from_numpy``): ``forward``,
  ``decode_step``, and the port's ``ServeEngine`` against the JAX one at
  a drop-free capacity_factor 8.0 (identical token streams; at 1.25 the
  reference's output depends on the bucket).
* **Softmax plan**: ``softmax_plan``'s lane group, rows a block and
  grid over the row and column counts the kernel meets.
* **Card cases** (``-k on_card``): the CUDA C++ softmax kernel (also in
  f16 on strided rows at widths 1 to 4096 and ``n_valid`` 0, 1, C - 1
  and C) and the MoE layer against their plain versions on the same card
  inputs.  They skip here and run on the card, where JAX is not
  installed (``python -m pytest -q tests/test_torch_moe.py -k
  on_card``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import Request
from repro_torch.kernels import select
from repro_torch.kernels.softmax import ops as sm_ops
from repro_torch.models import layers as L
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.models.registry import get_model
from repro_torch.serve.engine import ServeConfig, ServeEngine

TOL = 1e-5
# the reference's masked softmax tolerances (tests/test_kernels.py TOL)
SOFTMAX_TOL = {"f32": dict(rtol=1e-5, atol=1e-5),
               "bf16": dict(rtol=2e-2, atol=2e-2)}


def _close(got, want, tol=TOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: max|d| {err:.3e} > {tol} x " \
                               f"max|ref| {scale:.3e}"


def _i32(a):
    return torch.tensor(np.asarray(a), dtype=torch.int32)


def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


# ------------------------------------ masked softmax plain vs Pallas --

@pytest.mark.parametrize("shape", [(8, 64), (2, 4, 128), (16, 100)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("which_n", ["zero", "one", "half", "all"])
def test_softmax_plain_matches_pallas(shape, dtype, which_n):
    import jax.numpy as jnp
    from repro.kernels.softmax.ops import masked_softmax

    c = shape[-1]
    n = {"zero": 0, "one": 1, "half": c // 2 + 1, "all": c}[which_n]
    x = np.random.RandomState(4).randn(*shape).astype(np.float32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    xj = jnp.asarray(x, jdt)
    want = np.asarray(masked_softmax(xj, n), np.float32)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.float32 if dtype == "f32" else torch.bfloat16)
    before = sm_ops.LAUNCHES.launches
    got = sm_ops.masked_softmax(xt, n)
    assert sm_ops.LAUNCHES.launches == before   # the plain version
    assert got.dtype == xt.dtype and got.shape == xt.shape
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, **SOFTMAX_TOL[dtype])
    assert not got[..., n:].any()               # padded columns exactly 0
    if n == 0:
        assert not got.any()
    else:
        np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-2 if
                                   dtype == "bf16" else 1e-6)


# ------------------------------------------------------ the MoE layer --

def _jax_cfg(**over):
    from repro.configs import get_config as jax_config

    return dataclasses.replace(jax_config("dbrx_132b").reduced(), **over)


def _port_cfg(jcfg):
    base = get_config("dbrx_132b")
    return dataclasses.replace(base, **{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(base)})


def _layer(shared: int):
    import jax
    from repro.models import layers as RL

    jcfg = _jax_cfg(n_shared_experts=shared)
    jp = RL.moe_init(jax.random.PRNGKey(7), jcfg)
    cfg = _port_cfg(jcfg)
    p = params_from_numpy({"ffn": _np_tree(jp)}, cfg, device="cpu")["ffn"]
    return jcfg, jp, cfg, p


def _tokens(rng, shape, d):
    """Hidden states sharing one offset, as a layer's tokens do: the
    router then favours some experts, and capacity 1.25 drops."""
    return (rng.randn(*shape, d) + rng.randn(d)).astype(np.float32)


def _drops(cfg, p, x):
    """(token, expert) pairs the reference's capacity drops for x."""
    t = x.shape[0] * x.shape[1]
    logits = torch.from_numpy(x).reshape(t, -1) @ p["router"]
    ids = torch.topk(torch.softmax(logits, -1), cfg.top_k, -1).indices
    cap = max(4, int(cfg.capacity_factor * t * cfg.top_k / cfg.n_experts))
    counts = torch.bincount(ids.reshape(-1), minlength=cfg.n_experts)
    return int((counts - cap).clamp(min=0).sum())


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("bs", [(2, 16), (1, 37), (4, 9)])
def test_moe_apply_matches_jax(shared, bs):
    """At capacity_factor 1.25 with every token valid (no padding), where
    the reference drops tokens: the same tokens drop and the outputs
    agree."""
    import jax.numpy as jnp
    from repro.models import layers as RL

    jcfg, jp, cfg, p = _layer(shared)
    x = _tokens(np.random.RandomState(sum(bs)), bs, cfg.d_model)
    assert _drops(cfg, p, x) > 0
    want = np.asarray(RL.moe_apply(jcfg, jp, jnp.asarray(x)))
    got = L.moe_apply(cfg, p, torch.from_numpy(x))
    _close(got.numpy(), want)


def test_moe_slots_ignore_choice_order():
    """A token picks an expert at most once, so the order within an
    expert depends on token indices only: reversing each token's k
    choices (``torch.topk`` and ``jax.lax.top_k`` may order ties
    differently) assigns the same slots and gives the same output."""
    _, _, cfg, p = _layer(0)
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(40, cfg.d_model).astype(np.float32))
    gates = torch.from_numpy(rng.rand(40, 2).astype(np.float32))
    ids = torch.stack([torch.from_numpy(rng.permutation(4)[:2])
                       for _ in range(40)])
    args = (cfg, p["w_in"], p["w_gate"], p["w_out"], x)
    a = L._moe_experts_local(*args, gates, ids, 12)
    b = L._moe_experts_local(*args, gates.flip(1), ids.flip(1), 12)
    assert torch.equal(a, b)   # k = 2: the sum of two is order-free


def test_moe_padding_takes_no_slot():
    """With ``lens``, each valid token's output equals the output of the
    same tokens without padding (flat order kept), at capacity 1.25 with
    drops: the capacity counts valid tokens, and padding takes no slot."""
    _, _, cfg, p = _layer(0)
    lens = np.array([11, 0, 16, 5], np.int32)
    x = _tokens(np.random.RandomState(9), (4, 16), cfg.d_model)
    valid = np.arange(16)[None, :] < lens[:, None]
    packed = x[valid][None]
    assert _drops(cfg, p, packed) > 0
    got = L.moe_apply(cfg, p, torch.from_numpy(x), lens=_i32(lens))
    want = L.moe_apply(cfg, p, torch.from_numpy(packed))
    _close(got.numpy()[valid], want.numpy()[0])


def test_moe_under_a_mesh_raises():
    """``mesh=`` takes a DeviceMesh: anything else raises, naming it."""
    _, _, cfg, p = _layer(0)
    with pytest.raises(TypeError, match="DeviceMesh"):
        L.moe_apply(cfg, p, torch.zeros(1, 4, cfg.d_model), mesh=object())


@pytest.fixture(scope="module")
def moe_ep():
    import _torch_dist as W
    return W.check(W.run_world(4, ["moe_ep"]), "moe_ep")


def test_moe_expert_parallel_matches_reference_mesh_branch(moe_ep):
    """The expert-parallel branch on a (2, 2) world (x data-sharded,
    experts over "model", capacity per data shard) against the
    reference's ``shard_map`` branch on a (2, 2) mesh of the forced host
    devices, no row padded: within 1e-5 of max|ref|; the same call on a
    plain x (every data rank all tokens) agrees too."""
    import jax
    import jax.numpy as jnp
    from repro.dist import use_mesh
    from repro.launch.mesh import make_mesh
    from repro.models import layers as RL

    got = moe_ep[0]
    jcfg = _jax_cfg()
    jp = jax.tree.map(jnp.asarray, got["p"])
    with use_mesh(make_mesh((2, 2), ("data", "model"))):
        want = np.asarray(RL.moe_apply(jcfg, jp, jnp.asarray(got["x"])))
    assert got["placements"] == ["S(0)", "R"]
    _close(got["y"], want, what="EP vs reference EP")
    for r in moe_ep[1:]:
        np.testing.assert_array_equal(r["y"], got["y"])


def test_moe_expert_parallel_is_bucket_invariant(moe_ep):
    """Under the mesh the capacity counts the data shard's valid tokens
    (lens): a prompt padded to a longer bucket gives its valid rows'
    outputs unchanged."""
    got = moe_ep[0]
    for r, n in enumerate(got["lens"].tolist()):
        np.testing.assert_allclose(got["b"][r, :n], got["a"][r, :n],
                                   rtol=1e-6, atol=1e-6)


def test_convert_carries_moe_leaves_in_their_dtypes():
    """A bf16 JAX tree: the router stays f32, the experts bf16."""
    import jax
    from repro.models import layers as RL

    jcfg = _jax_cfg(dtype="bf16", n_shared_experts=1)
    jp = _np_tree(RL.moe_init(jax.random.PRNGKey(1), jcfg))
    p = params_from_numpy({"ffn": jp}, _port_cfg(jcfg), device="cpu")["ffn"]
    assert p["router"].dtype == torch.float32
    for name in ("w_in", "w_gate", "w_out"):
        assert p[name].dtype == torch.bfloat16
        assert p["shared"][name].dtype == torch.bfloat16
        assert tuple(p[name].shape) == jp[name].shape
    assert torch.equal(p["w_out"].float(), torch.from_numpy(
        np.asarray(jp["w_out"], np.float32)))


# --------------------------------------------- reduced dbrx_132b (CPU) --

@pytest.fixture(scope="module")
def dbrx():
    """The reduced DBRX (2 layers, E = 4, top-2, f32), initialised by the
    JAX package and carried into the port, at capacity 1.25 and at a
    drop-free 8.0."""
    import jax
    from repro.models.registry import get_model as jax_model

    out = {}
    for cf in (1.25, 8.0):
        jcfg = _jax_cfg(capacity_factor=cf)
        jmodel = jax_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        cfg = _port_cfg(jcfg)
        out[cf] = dict(cfg=cfg, model=get_model(cfg), jcfg=jcfg,
                       jmodel=jmodel, jparams=jparams,
                       params=params_from_numpy(_np_tree(jparams), cfg,
                                                device="cpu"))
    return out


def test_dbrx_forward_matches_jax(dbrx):
    """Full-sequence logits, every token counted (``lens=None``)."""
    import jax.numpy as jnp

    t = dbrx[1.25]
    tokens = np.random.RandomState(2).randint(
        0, t["cfg"].vocab, size=(2, 24)).astype(np.int32)
    want = t["jmodel"].forward(t["jparams"], {"tokens": jnp.asarray(tokens)})
    got = t["model"].forward(t["params"], {"tokens": _i32(tokens)})
    _close(got.numpy(), np.asarray(want))


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


def test_dbrx_decode_step_matches_jax(dbrx):
    """One decode step from a warm cache at capacity 1.25: every row of
    the step counts in both packages (B = 3 tokens fit the floor of 4)."""
    import jax.numpy as jnp

    t = dbrx[1.25]
    jcache = _warm_cache(t, 3, seed=2)
    toks = np.array([[5], [200], [17]], np.int32)
    fill = np.full((3,), 7, np.int32)
    jl, jc = t["jmodel"].decode_step(t["jparams"], jcache, jnp.asarray(toks),
                                     jnp.asarray(fill))
    pl, pc = t["model"].decode_step(
        t["params"], cache_from_numpy(_np_tree(jcache), "cpu"), _i32(toks),
        _i32(fill))
    _close(pl.numpy(), np.asarray(jl))
    for k in ("k", "v"):
        _close(pc[k].numpy(), np.asarray(jc[k]), what=k)


@pytest.mark.parametrize("lens_set,ref_moves", [
    ([12, 12], True), ([3, 30, 17], True), ([1, 1, 9, 9], True),
    ([12, 7, 0], False)])
def test_dbrx_prefill_is_bucket_invariant(dbrx, lens_set, ref_moves):
    """At capacity 1.25 the port's prefill gives the same last logits and
    cache rows at a prompt's exact length S and padded to the bucket
    S = 64.  The reference's capacity counts the bucket's padding, whose
    tokens (all id 0) route alike and fill experts ahead of the later
    rows' tokens, so its logits move with the bucket: printed beside the
    port's, and shown to move where these inputs make it drop."""
    import jax.numpy as jnp

    t = dbrx[1.25]
    b, s = len(lens_set), max(lens_set)
    tokens = np.random.RandomState(0).randint(
        0, t["cfg"].vocab, size=(b, 64)).astype(np.int32)
    lens = np.asarray(lens_set, np.int32)
    tokens[np.arange(64)[None, :] >= lens[:, None]] = 0
    zeros = np.zeros((b,), np.int32)
    rows = lens > 0
    out = {}
    for width in (s, 64):
        pl, pc = t["model"].prefill(
            t["params"], t["model"].init_cache(b, 64, "cpu"),
            _i32(tokens[:, :width]), _i32(lens), _i32(zeros))
        jl, _ = t["jmodel"].prefill(
            t["jparams"], t["jmodel"].init_cache(b, 64),
            jnp.asarray(tokens[:, :width]), jnp.asarray(lens),
            jnp.asarray(zeros))
        out[width] = (pl.numpy()[rows], pc, np.asarray(jl)[rows])
    (p_s, c_s, j_s), (p_b, c_b, j_b) = out[s], out[64]
    scale = np.abs(p_s).max()
    port = np.abs(p_b - p_s).max() / scale
    ref = np.abs(j_b - j_s).max() / np.abs(j_s).max()
    print(f"lens {lens_set}: S={s} vs bucket 64, last logits "
          f"max|d|/max|ref|: port {port:.3e}, reference {ref:.3e}")
    _close(p_b, p_s, what="port, bucket vs exact")
    assert (ref > 1e-2) == ref_moves
    for k in ("k", "v"):   # positions past a row's length stay 0 in both
        _close(c_b[k].numpy(), c_s[k].numpy(), what=k)


def _requests(vocab, lens, max_new=4, cls=Request):
    rng = np.random.RandomState(7)
    return [cls(rid=i, tokens=rng.randint(0, vocab, size=n).astype(np.int32),
                max_new_tokens=max_new) for i, n in enumerate(lens)]


LENS = [5, 9, 14, 40, 33, 12]


@pytest.mark.parametrize("chunk", [None, 8])
def test_dbrx_engine_matches_jax_engine(dbrx, chunk):
    """Same requests through both packages' engines at the drop-free
    capacity_factor 8.0: identical token streams, and the same launch and
    compile counts."""
    from repro.data.pipeline import Request as JaxRequest
    from repro.serve.engine import ServeConfig as JaxConfig
    from repro.serve.engine import ServeEngine as JaxEngine

    t = dbrx[8.0]
    jeng = JaxEngine(t["jmodel"], t["jparams"],
                     JaxConfig(max_batch=4, max_seq=96, prefill_chunk=chunk))
    jeng.submit(_requests(t["cfg"].vocab, LENS, cls=JaxRequest))
    want = jeng.run_until_done(max_steps=500)
    eng = ServeEngine(t["model"], t["params"],
                      ServeConfig(max_batch=4, max_seq=96, device="cpu",
                                  prefill_chunk=chunk))
    eng.submit(_requests(t["cfg"].vocab, LENS))
    got = eng.run_until_done(max_steps=500)
    assert got == want
    assert len(got) == len(LENS)
    for key in ("prefill_calls", "decode_steps", "tokens_generated",
                "prefill_bucket_pairs", "prefill_chunks"):
        assert eng.stats[key] == jeng.stats[key], key
    assert eng.compile_counts() == {k: jeng.compile_counts()[k]
                                    for k in ("prefill", "decode")}


def test_launcher_refuses_full_dbrx_before_allocating(monkeypatch):
    """Without ``--reduced`` the launcher states the weights' bytes against
    the card's memory and refuses before it draws a weight."""
    from repro_torch.launch import serve as launcher

    class Props:
        total_memory = 80 * 10 ** 9

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props())

    def no_init(*a, **kw):
        raise AssertionError("weights drawn before the refusal")

    monkeypatch.setattr(launcher, "get_model",
                        lambda cfg: dataclasses.replace(get_model(cfg),
                                                        init=no_init))
    with pytest.raises(SystemExit, match="263.2 GB.*multi-GPU slice"):
        launcher.main(["--arch", "dbrx_132b"])


# ------------------------------------------------ softmax plan (CPU) --

@pytest.mark.parametrize("rows", [1, 4, 2048])
@pytest.mark.parametrize("cols", [1, 3, 16, 17, 32, 33, 2048, 4096])
def test_softmax_plan_covers_the_rows(cols, rows):
    """Rows of at most 32 columns: a group of the next power of two of C
    lanes, one column a lane; wider rows: 16-byte chunks where C allows
    them, a group of a warp or more.  A group holds the whole row, a block whole rows (no
    more threads than the rows need, at most 1024) and the grid every
    row."""
    from repro_torch.kernels.softmax.softmax import softmax_plan

    for elt in (4, 2):
        plan = softmax_plan(rows, cols, elt, True)
        if cols <= 32:
            assert plan.vec == 1 and plan.chunks == 1
            assert plan.group == 1 << (cols - 1).bit_length()
        else:
            wide = cols % (16 // elt) == 0
            assert plan.vec == (16 // elt if wide else 1)
            assert plan.group >= 32
        assert plan.group * plan.chunks * plan.vec >= cols
        assert plan.vec * plan.chunks <= 32
        assert plan.threads % plan.group == 0
        assert plan.rows == plan.threads // plan.group
        assert plan.threads % 32 == 0 and plan.threads <= 1024
        assert plan.threads <= max(plan.group, -(-rows * plan.group // 32)
                                   * 32)
        assert plan.grid == -(-rows // plan.rows)


def test_softmax_plan_router_and_limits():
    """The decode router (4 x 16) is one block of 64 threads, two rows a
    warp; a row that is not 16-byte readable takes one column a load (at
    most 8 a thread in registers); a row wider than registers hold (past
    ``MAX_COLS``, or past 8192 columns read one at a time) takes the loop
    instance, a block of 1024 threads a row, ``chunks`` loads a thread a
    pass: no width is refused."""
    from repro_torch.kernels.softmax.softmax import MAX_COLS, softmax_plan

    assert tuple(softmax_plan(4, 16)) == (1, 1, 16, 4, 64, 1)
    assert softmax_plan(2048, 16).grid == 256
    assert softmax_plan(2, 36, 4, False).vec == 1
    assert softmax_plan(2, 36, 4, True).vec == 4
    assert tuple(softmax_plan(1, MAX_COLS)) == (4, 8, 1024, 1, 1024, 1)
    assert tuple(softmax_plan(1, MAX_COLS + 1)) == (1, 33, 1024, 1, 1024, 1)
    assert softmax_plan(1, 8192, 4, False).chunks == 8
    assert tuple(softmax_plan(3, 8193, 4, False)) == (1, 9, 1024, 1, 1024,
                                                      3)
    assert tuple(softmax_plan(5, 65536, 2, True)) == (8, 8, 1024, 1, 1024,
                                                      5)
    assert tuple(softmax_plan(5, 65536, 4, True)) == (4, 16, 1024, 1, 1024,
                                                      5)


# ----------------------------------------- kernels vs plain (card) --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the masked softmax kernel "
                    "(CUDA C++) runs on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# kernel vs plain on the card, max|d|/max|ref|: both compute in f32 and
# differ by summation order; a bf16 output by one rounding (2^-8), an f16
# one by one rounding (2^-11)
CARD_TOL = {torch.float32: 1e-6, torch.bfloat16: 8e-3, torch.float16: 1e-3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,n", [((2048, 16), 16), ((4, 16), 16),
                                     ((3, 5, 100), 37), ((300, 2048), 1500),
                                     ((64, 16), 0),
                                     # more row blocks than the card holds
                                     # at once, a last block with rows
                                     # past R
                                     ((4099, 2048), 2047),
                                     ((20001, 128), 100),
                                     ((9001, 256), 256)])
def test_softmax_kernel_matches_plain_on_card(cuda, dtype, shape, n):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.randn(shape, generator=gen, device=cuda) * 3).to(dtype)
    before = sm_ops.LAUNCHES.launches
    got = sm_ops.masked_softmax(x, n)
    assert sm_ops.LAUNCHES.launches == before + 1
    with select.plain_versions():
        want = sm_ops.masked_softmax(x, n)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    assert not got[..., n:].any()
    if n == 0:
        assert not got.any()
    else:
        err = (got.float() - want.float()).abs().max().item()
        assert err <= CARD_TOL[dtype] * want.float().abs().max().item()


@pytest.mark.parametrize("which_n", ["zero", "one", "all"])
@pytest.mark.parametrize("cols,dtype", [(8193, torch.float32),
                                        (32769, torch.float32),
                                        (32769, torch.bfloat16),
                                        (65536, torch.float32),
                                        (65536, torch.bfloat16)])
def test_softmax_kernel_wide_rows_on_card(cuda, cols, dtype, which_n):
    """Rows past what registers hold take the loop instance: 8193 (odd,
    one column a load), 32769 and 65536 columns, with ``n_valid`` 0, 1
    and C, against the plain version."""
    from repro_torch.kernels.softmax.softmax import softmax_plan

    n = {"zero": 0, "one": 1, "all": cols}[which_n]
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = (torch.randn((3, cols), generator=gen, device=cuda) * 3).to(dtype)
    assert softmax_plan(3, cols, x.element_size(), True).group == 1024
    before = sm_ops.LAUNCHES.launches
    got = sm_ops.masked_softmax(x, n)
    assert sm_ops.LAUNCHES.launches == before + 1
    with select.plain_versions():
        want = sm_ops.masked_softmax(x, n)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    assert not got[:, n:].any()
    if n:
        err = (got.float() - want.float()).abs().max().item()
        assert err <= CARD_TOL[dtype] * want.float().abs().max().item()


@pytest.mark.parametrize("which_n", ["zero", "one", "less", "all"])
@pytest.mark.parametrize("cols", [1, 17, 32, 33, 1024, 4096])
def test_softmax_kernel_f16_strided_on_card(cuda, cols, which_n):
    """f16 rows read in place through a row stride wider than C (one row,
    and five), at every plan shape, with ``n_valid`` 0, 1, C - 1 and C."""
    n = {"zero": 0, "one": 1, "less": cols - 1, "all": cols}[which_n]
    gen = torch.Generator(device=cuda).manual_seed(2)
    for rows in (1, 5):
        base = (torch.randn((rows, cols + 8), generator=gen, device=cuda)
                * 3).half()
        x = base[:, :cols]
        before = sm_ops.LAUNCHES.launches
        got = sm_ops.masked_softmax(x, n)
        assert sm_ops.LAUNCHES.launches == before + 1
        with select.plain_versions():
            want = sm_ops.masked_softmax(x, n)
        torch.cuda.synchronize()
        assert got.dtype == torch.float16 and got.shape == x.shape
        assert not got[:, n:].any()
        if n:
            err = (got.float() - want.float()).abs().max().item()
            assert err <= CARD_TOL[torch.float16] * want.float().abs().max()


def test_moe_layer_kernels_match_plain_on_card(cuda):
    """The MoE layer on the card (the router through the softmax kernel)
    against its plain versions on the same inputs, with padding."""
    cfg = dataclasses.replace(get_config("dbrx_132b").reduced(),
                              n_shared_experts=1)
    gen = torch.Generator(device=cuda).manual_seed(3)
    p = L.moe_init(gen, cfg, cuda)
    x = torch.randn((4, 33, cfg.d_model), generator=gen, device=cuda)
    lens = torch.tensor([33, 0, 20, 7], dtype=torch.int32, device=cuda)
    before = sm_ops.LAUNCHES.launches
    got = L.moe_apply(cfg, p, x, lens=lens)
    assert sm_ops.LAUNCHES.launches == before + 1
    with select.plain_versions():
        want = L.moe_apply(cfg, p, x, lens=lens)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_reduced_dbrx_kernels_match_plain_on_card(cuda, dtype):
    """The reduced DBRX on the card (the flash-attention kernel at hd 16,
    RMSNorm and the router's softmax), a ragged prefill and a decode
    step, against the same model inside ``plain_versions()``: f32 by
    summation order through two layers (1e-4 of max|logit|); bf16 by
    roundings that two layers amplify (5e-2)."""
    cfg = dataclasses.replace(get_config("dbrx_132b").reduced(),
                              dtype=dtype)
    model = get_model(cfg)
    gen = torch.Generator(device=cuda).manual_seed(5)
    params = model.init(gen, cuda)
    tokens = torch.randint(0, cfg.vocab, (3, 40), generator=gen,
                           device=cuda, dtype=torch.int32)
    lens = torch.tensor([40, 0, 23], dtype=torch.int32, device=cuda)
    offsets = torch.zeros(3, dtype=torch.int32, device=cuda)

    def both(fn):
        before = sm_ops.LAUNCHES.launches
        got = fn()
        assert sm_ops.LAUNCHES.launches == before + cfg.n_layers
        with select.plain_versions():
            want = fn()
        torch.cuda.synchronize()
        return got, want

    cache = model.init_cache(3, 64, cuda)
    (pl, pc), (wl, wc) = both(lambda: model.prefill(params, cache, tokens,
                                                    lens, offsets))
    tol = 1e-4 if dtype == "f32" else 5e-2
    for r in (0, 2):
        assert (pl[r] - wl[r]).abs().max() <= tol * wl[r].abs().max()
    (dl, _), (wdl, _) = both(lambda: model.decode_step(
        params, wc, tokens[:, :1], lens))
    assert torch.isfinite(dl).all()
    assert (dl - wdl).abs().max() <= tol * wdl.abs().max()
