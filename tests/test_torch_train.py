"""The port's training path against the JAX package's, on the CPU.

* **Gradients against ``jax.value_and_grad``** of the reference's
  ``model.loss`` for each family (dense with RMSNorm and with LayerNorm /
  GELU, MoE with DBRX and with DeepSeek-V2's MLA, vlm, ssm, hybrid,
  encdec), same reduced weights, same batch with a partly masked row, in
  f32: loss rtol 1e-5, each grad leaf max|Δ|/max|ref| ≤ 1e-4.  RWKV-6 and
  Zamba2 run at S = 33 (``_torch_train.seq_len``), where the reference
  takes its f32 sequential scans: at S = 32 its chunked scans carry
  intermediates in bf16 even in an f32 model (ROADMAP Queue 3).  One bf16 case (TinyLlama): loss rtol
  1e-3, each leaf ≤ 5e-2 (two packages' bf16 roundings of the same
  products, ~2^-8 each, through two layers and the head).
* **The gradient helper** (``kernels/grad.py``) with stand-in kernels
  whose values differ from their plain versions: forward gives the
  stand-in's values, backward the plain version's gradient, bit for bit,
  inside ``plain_versions()``; and each of the six model-layer wrappers,
  made to take its kernel branch on the CPU, routes through it: one
  counted launch forward, none backward.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from _torch_train import (batch, jax_flat, pair, port_flat, rel_max,
                          seq_len, to_jax, to_port)
from repro_torch.kernels import grad as kgrad
from repro_torch.kernels import select
from repro_torch.train.step import value_and_grad

TOL_F32 = dict(loss=1e-5, leaf=1e-4)
TOL_BF16 = dict(loss=1e-3, leaf=5e-2)


GRAD_CASES = ["tinyllama_11b", "granite_20b", "dbrx_132b", "deepseek_v2_236b",
              "llava_next_34b", "rwkv6_3b", "zamba2_7b", "whisper_tiny"]


def _grads_vs_jax(arch_id: str, dtype: str, tol: dict, **over) -> None:
    """The port's loss and gradients against ``jax.value_and_grad`` of
    the reference's, at the reduced config (``over`` replaces fields in
    both packages)."""
    cfg, model, params, jcfg, jm, jp = pair(arch_id, dtype, **over)
    bnp = batch(cfg, np.random.RandomState(3), s=seq_len(cfg), mask_tail=5)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(jp, to_jax(bnp))
    loss, grads = value_and_grad(model.loss, params, to_port(bnp))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), float(jl), rtol=tol["loss"])
    got, want = port_flat(grads), jax_flat(jg)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert rel_max(got[k], want[k]) <= tol["leaf"], \
            (k, rel_max(got[k], want[k]))
    # grads in the params' own dtypes, as the reference's
    assert all(g.dtype == p.dtype for g, p in zip(
        torch.utils._pytree.tree_leaves(grads),
        torch.utils._pytree.tree_leaves(params)))


@pytest.mark.parametrize("arch_id", GRAD_CASES)
def test_grads_match_jax_f32(arch_id):
    _grads_vs_jax(arch_id, "f32", TOL_F32)


def test_grads_match_jax_bf16():
    _grads_vs_jax("tinyllama_11b", "bf16", TOL_BF16)


# -------------------------------------------------------------- helper --

def _plain(x, w, eps):
    assert select.in_plain_versions()
    return (x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)) * w


def _stand_in(x, w, eps):
    assert not select.in_plain_versions()
    return _plain.__wrapped__(x, w, eps) + 0.5


_plain.__wrapped__ = lambda x, w, eps: (
    x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)) * w


def test_helper_values_kernel_gradient_plain():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 16, generator=gen, requires_grad=True)
    w = torch.randn(16, generator=gen, requires_grad=True)
    out = kgrad.kernel_call(_stand_in, _plain, x, w, 1e-6)
    assert type(out.grad_fn).__name__ == "PlainGradBackward"
    want = _plain.__wrapped__(x.detach(), w.detach(), 1e-6)
    assert torch.equal(out.detach(), want + 0.5)
    g = torch.randn(out.shape, generator=gen)
    gx, gw = torch.autograd.grad(out, [x, w], g)
    xr = x.detach().requires_grad_()
    wr = w.detach().requires_grad_()
    rx, rw = torch.autograd.grad(_plain.__wrapped__(xr, wr, 1e-6), [xr, wr],
                                 g)
    assert torch.equal(gx, rx) and torch.equal(gw, rw)
    # without grad, or with no input requiring it: the kernel alone
    with torch.no_grad():
        assert kgrad.kernel_call(_stand_in, _plain, x, w, 1e-6).grad_fn \
            is None
    out = kgrad.kernel_call(_stand_in, _plain, x.detach(), w.detach(), 1e-6)
    assert out.grad_fn is None


def test_helper_tuple_outputs_and_integer_inputs():
    """Two outputs, one unused by the loss; an int tensor (``lens``) and
    None among the inputs get no gradient."""
    def plain(a, s0, lens):
        return a * 2.0, a.sum(-1)

    def kern(a, s0, lens):
        return a * 2.0 + 1.0, a.sum(-1) - 1.0

    a = torch.randn(4, 6, requires_grad=True)
    lens = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    y, s = kgrad.kernel_call(kern, plain, a, None, lens)
    assert torch.equal(y.detach(), a.detach() * 2.0 + 1.0)
    (ga,) = torch.autograd.grad(y.sum(), [a], retain_graph=True)
    assert torch.equal(ga, torch.full_like(a, 2.0))
    (ga,) = torch.autograd.grad((y.sum() + 3 * s.sum()), [a])
    assert torch.equal(ga, torch.full_like(a, 5.0))


def _through_helper(t: torch.Tensor) -> bool:
    """True when ``t``'s graph reaches the helper's node within a view or
    two (the softmax wrapper reshapes its rows back)."""
    fns = [t.grad_fn]
    for _ in range(3):
        if any(type(f).__name__ == "PlainGradBackward" for f in fns):
            return True
        fns = [n for f in fns if f is not None
               for n, _ in f.next_functions]
    return False


def _wrapper_cases():
    """(name, ops module path, kernel attribute to stand in for,
    call(inputs) -> output tensor, a maker of the inputs)"""
    def rnd(gen, *shape, grad=True):
        return torch.randn(shape, generator=gen).requires_grad_(grad)

    return [
        ("rmsnorm", "repro_torch.kernels.rmsnorm.ops", "rmsnorm_kernel",
         lambda m, a: m.rmsnorm(a[0], a[1], eps=1e-6),
         lambda g: (rnd(g, 2, 5, 32), rnd(g, 32))),
        ("layernorm", "repro_torch.kernels.layernorm.ops",
         "layernorm_kernel",
         lambda m, a: m.layernorm(a[0], a[1], a[2], eps=1e-5),
         lambda g: (rnd(g, 2, 5, 32), rnd(g, 32), rnd(g, 32))),
        ("masked_softmax", "repro_torch.kernels.softmax.softmax",
         "masked_softmax_kernel",
         lambda m, a: m.masked_softmax(a[0], 6),
         lambda g: (rnd(g, 7, 8),)),
        ("flash_attention", "repro_torch.kernels.flash_attention."
         "flash_attention", "flash_attention_kernel",
         lambda m, a: m.flash_attention(a[0], a[1], a[2], None, causal=True),
         lambda g: (rnd(g, 2, 4, 9, 16), rnd(g, 2, 2, 9, 16),
                    rnd(g, 2, 2, 9, 16))),
        ("rwkv6", "repro_torch.kernels.rwkv6.rwkv6", "rwkv6_kernel",
         lambda m, a: m.rwkv6(*a)[0],
         lambda g: (rnd(g, 2, 2, 7, 8), rnd(g, 2, 2, 7, 8),
                    rnd(g, 2, 2, 7, 8),
                    torch.sigmoid(rnd(g, 2, 2, 7, 8, grad=False))
                    .requires_grad_(), rnd(g, 2, 8))),
        ("mamba2", "repro_torch.kernels.mamba2.mamba2", "mamba2_kernel",
         lambda m, a: m.mamba2_scan(*a)[0],
         lambda g: (rnd(g, 2, 2, 9, 8),
                    torch.sigmoid(rnd(g, 2, 2, 9, grad=False))
                    .requires_grad_(), rnd(g, 2, 9, 4), rnd(g, 2, 9, 4))),
    ]


OPS = {"rmsnorm": "repro_torch.kernels.rmsnorm.ops",
       "layernorm": "repro_torch.kernels.layernorm.ops",
       "masked_softmax": "repro_torch.kernels.softmax.ops",
       "flash_attention": "repro_torch.kernels.flash_attention.ops",
       "rwkv6": "repro_torch.kernels.rwkv6.ops",
       "mamba2": "repro_torch.kernels.mamba2.ops"}


@pytest.mark.parametrize("case", _wrapper_cases(), ids=lambda c: c[0])
def test_wrappers_route_grad_through_helper(case, monkeypatch):
    """Each model-layer wrapper, told that its CPU tensor launches the
    kernel outside ``plain_versions()`` (a stand-in: the plain version's
    values plus 1), returns the stand-in's values with the helper's
    ``grad_fn``, counts one launch,
    and its gradient is the plain version's at the same inputs, bit for
    bit; the backward counts no launch."""
    import importlib

    name, kmod, attr, call, build = case
    ops = importlib.import_module(OPS[name])
    kernel_mod = importlib.import_module(kmod)
    monkeypatch.setattr(ops, "use_kernel",
                        lambda t, op: not select.in_plain_versions())

    def plain_out(inputs):
        with select.plain_versions():
            return call(ops, inputs)

    def fake_kernel(*args, **kw):
        assert not torch.is_grad_enabled()
        assert not any(isinstance(a, torch.Tensor) and a.requires_grad
                       for a in args)
        out = real_plain(*args, **kw)
        if isinstance(out, tuple):
            return tuple(o + 1.0 for o in out)
        return out + 1.0

    real_plain = {"rmsnorm": lambda x, w, eps: ops.rmsnorm_ref(x, w, eps),
                  "layernorm": lambda x, s, b, eps:
                      ops.layernorm_ref(x, s, b, eps),
                  "masked_softmax": lambda x, n: ops.masked_softmax_ref(x, n),
                  "flash_attention": lambda q, k, v, lens, qo, causal,
                      decode, scale: ops.sdpa_ref(q, k, v, causal=causal,
                                                  lens=lens, q_offset=qo,
                                                  scale=scale),
                  "rwkv6": lambda *a: ops.rwkv6_ref(*a),
                  "mamba2": lambda *a: ops.mamba2_chunked(*a)}[name]
    if name == "flash_attention":
        def fake_fa(q, k, v, lens, q_offset, *, causal, decode, scale):
            return fake_kernel(q, k, v, lens, q_offset, causal, decode,
                               scale)
        monkeypatch.setattr(kernel_mod, attr, fake_fa)
    elif name in ("rmsnorm", "layernorm"):
        monkeypatch.setattr(ops, attr, lambda *a, eps: fake_kernel(*a, eps))
    else:
        monkeypatch.setattr(kernel_mod, attr, fake_kernel)

    gen = torch.Generator().manual_seed(1)
    inputs = build(gen)
    n0 = ops.LAUNCHES.launches
    out = call(ops, inputs)
    assert ops.LAUNCHES.launches == n0 + 1
    assert _through_helper(out)
    ref = plain_out([a.detach() for a in inputs])
    assert torch.equal(out.detach(), ref + 1.0)
    g = torch.randn(out.shape, generator=gen)
    diff = [a for a in inputs if a.requires_grad]
    got = torch.autograd.grad(out, diff, g)
    assert ops.LAUNCHES.launches == n0 + 1
    leaves = [a.detach().requires_grad_(a.requires_grad) for a in inputs]
    want = torch.autograd.grad(plain_out(leaves),
                               [a for a in leaves if a.requires_grad], g)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
