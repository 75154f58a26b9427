"""The interpreted baseline of the paper's §5.2 on the port, held against
the JAX package.

Twins of ``TestNimbleVM`` (``tests/test_runtime.py``),
``TestVMExecutesPlan`` (``tests/test_memory_planning.py``) and
``test_vm_executes_region_ops`` (``tests/test_control_flow.py``):
``disc_torch.NimbleVM`` walks a lowered graph per call, one dispatch per
op, and executes the buffer plan's free lines; the ``"nimble_vm"``
backend is the per-op executor with no fusion plan.  Plus the port's
``CachedArena`` (free lists keyed by dtype, bytes and device).

Card cases (``-k on_card``; they skip without CUDA): ``sync_per_op`` on
the card, and the decoder whose layers are one ``d.scan`` (path 7 of
``chip_smoke.py``) at a small depth under ``"hopper"``, ``"nimble_vm"``
and the VM.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._higher_order_ops.scan import scan

import disc_torch
from disc_torch import ArgSpec, Dim, NimbleVM, bridge
from repro_torch.core.buffers import CachedArena

D = 32


def _softmax_fn(x, y):
    # jax.nn.softmax written out (aten._softmax has no DHLO rule)
    z = torch.exp(x) * y
    e = torch.exp(z - z.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def test_vm_matches_engine():
    """One dispatch per op, and the same values as the compiled artifact
    and the JAX function."""
    specs = [ArgSpec(("B", "S")), ArgSpec(("B", "S"))]
    g, _ = bridge(_softmax_fn, specs, device="cpu")
    vm = NimbleVM(g, device="cpu")
    eng = disc_torch.compile(_softmax_fn, specs, device="cpu")
    rng = np.random.RandomState(0)
    x = rng.randn(4, 9).astype(np.float32)
    y = rng.randn(4, 9).astype(np.float32)
    (vm_out,) = vm(torch.from_numpy(x), torch.from_numpy(y))
    want = np.asarray(jax.nn.softmax(jnp.exp(x) * y, axis=-1))
    np.testing.assert_allclose(vm_out.numpy(),
                               eng(torch.from_numpy(x),
                                   torch.from_numpy(y)).numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(vm_out.numpy(), want, rtol=1e-5, atol=1e-6)
    assert vm.stats.op_dispatches == len(g.ops)  # one launch per op
    assert vm.stats.calls == 1


def test_vm_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    g, _ = bridge(_softmax_fn, [ArgSpec(("B", "S")), ArgSpec(("B", "S"))],
                  device="cpu")
    with pytest.raises(disc_torch.NoDeviceError):
        NimbleVM(g)


# ----------------------------------------------------- the buffer plan --

def _chain(x):
    w = torch.eye(D, dtype=torch.float32, device=x.device) * 0.9
    h = torch.tanh(x @ w)
    h = h + x
    s = h.sum(dim=1, keepdim=True)
    return h * s


def _j_chain(x):
    w = jnp.eye(D, dtype=jnp.float32) * 0.9
    h = jnp.tanh(x @ w)
    h = h + x
    s = h.sum(axis=1, keepdims=True)
    return h * s


def test_planned_peak_below_naive():
    comp = disc_torch.compile(_chain, [(Dim("S", max=128), D)],
                              name="mp_vm", device="cpu")
    g = comp.lower().graph
    x = np.ones((64, D), np.float32)
    vm_on = NimbleVM(g, sync_per_op=False, memory_planning=True,
                     device="cpu")
    vm_off = NimbleVM(g, sync_per_op=False, memory_planning=False,
                      device="cpu")
    (a,), (b,) = vm_on(torch.from_numpy(x)), vm_off(torch.from_numpy(x))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_allclose(a.numpy(), np.asarray(_j_chain(x)),
                               rtol=1e-5, atol=1e-5)
    assert vm_on.stats.reuses >= 1
    assert vm_on.stats.planned_peak_bytes < vm_off.stats.naive_peak_bytes


# ---------------------------------------------------------- region ops --

def _scan_carry_fn(x):
    def body(c, xi):
        return c * 2.0 + xi.sum(), c.clone()

    return scan(body, torch.tensor(1.0, device=x.device), x)[0]


def _j_scan_carry_fn(x):
    def body(c, xi):
        return c * 2.0 + xi.sum(), c

    return jax.lax.scan(body, jnp.float32(1.0), x)[0]


def test_vm_executes_region_ops():
    """The VM runs region ops through the executor's own
    ``emit_region_op``, at the call's exact shapes."""
    cf = disc_torch.compile(_scan_carry_fn, [(Dim("S", max=64), 4)],
                            device="cpu")
    x = (np.random.RandomState(11).randn(11, 4) * 0.1).astype(np.float32)
    cf(torch.from_numpy(x))
    g = cf.lower().graph
    assert any(op.opcode == "d.scan" for op in g.ops)
    vm = NimbleVM(g, sync_per_op=False, device="cpu")
    (got,) = vm(torch.from_numpy(x))
    np.testing.assert_allclose(float(got),
                               float(_j_scan_carry_fn(jnp.asarray(x))),
                               rtol=1e-5)
    assert vm.stats.op_dispatches == len(g.ops)


# ------------------------------------------------------- "nimble_vm" --

def _cond_fn(x):
    return torch.cond(x.sum() > 0.0, lambda a: a * 2.0, lambda a: a - 1.0,
                      (x,))


@pytest.mark.parametrize("name,fn,d", [("softmax_chain", _chain, D),
                                       ("scan", _scan_carry_fn, 4),
                                       ("cond", _cond_fn, 4)])
def test_nimble_vm_backend_equals_eager_bit_for_bit(name, fn, d):
    spec = [(Dim("S", max=128), d)]
    vm = disc_torch.compile(fn, spec, backend="nimble_vm", device="cpu")
    eager = disc_torch.compile(fn, spec, backend="eager", device="cpu")
    for s in (5, 40, 100):
        x = torch.from_numpy(np.random.RandomState(s).randn(s, d)
                             .astype(np.float32))
        assert torch.equal(vm(x), eager(x))
    assert vm.compile_counts() == eager.compile_counts()
    assert vm.backend.cluster_kernels == {}


# ------------------------------------------------------ cached arena --

def test_cached_arena_reuses_by_dtype_bytes_and_device():
    arena = CachedArena()
    a = arena.alloc((64, 32), torch.float32, device="cpu")
    assert a.shape == (64, 32) and a.dtype == torch.float32
    arena.dealloc(a)
    b = arena.alloc((32, 64), torch.float32, device="cpu")  # same bytes
    assert arena.reuses == 1 and b.shape == (32, 64)
    assert b.untyped_storage().data_ptr() == a.untyped_storage().data_ptr()
    arena.dealloc(b)
    c = arena.alloc((64, 32), torch.int32, device="cpu")  # other dtype
    assert arena.reuses == 1 and arena.allocs == 2
    assert arena.peak_bytes == 2 * 64 * 32 * 4
    # the reference benchmark's pattern: recurring sizes come back
    rng = np.random.RandomState(0)
    live = [c]
    for _ in range(40):
        live.append(arena.alloc((int(rng.choice([64, 128, 256])), 64),
                                torch.float32, device="cpu"))
        if len(live) > 4:
            arena.dealloc(live.pop(0))
    assert arena.reuses > arena.allocs


# ------------------------------------------------------------ on card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: sync_per_op and the cluster "
                    "kernels run on the card only")
    return torch.device("cuda")


def test_vm_sync_per_op_on_card(cuda):
    comp = disc_torch.compile(_chain, [(Dim("S", max=128), D)])
    g = comp.lower().graph
    x = torch.ones((64, D), device=cuda)
    synced = NimbleVM(g, sync_per_op=True)
    free = NimbleVM(g, sync_per_op=False)
    (a,), (b,) = synced(x), free(x)
    assert torch.equal(a, b)
    assert torch.equal(a, comp(x))
    assert synced.stats.op_dispatches == len(g.ops)


def test_scan_stack_on_card(cuda):
    """TinyLlama's decoder at full width and 2 layers, its layers one
    ``d.scan``: ``"hopper"`` within 1e-3 of the function run eagerly with
    the plain versions, the cluster kernels outside the scan launched, and
    ``"nimble_vm"`` and the VM equal to ``"eager"``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.fused_elementwise import ops as fe
    from repro_torch.kernels.select import plain_versions
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("tinyllama_11b"), n_layers=2,
                              dtype="f32")
    params = T.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                    "cuda")
    stacked = torch.utils._pytree.tree_map(lambda *ls: torch.stack(ls),
                                           *params["blocks"])

    def fn(x):
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)[None, :]

        def body(h, bp):
            h, _ = T.block_apply(cfg, bp, h, positions=positions)
            return h, []

        x, _ = scan(body, x, stacked)
        x = L.norm_apply(cfg, params["ln_f"], x)
        return T.logits_from_hidden(cfg, params, x)

    spec = [((1, Dim("S", max=2048), cfg.d_model), torch.float32)]
    hop = disc_torch.compile(fn, spec, backend="hopper")
    vmb = disc_torch.compile(fn, spec, backend="nimble_vm")
    eager = disc_torch.compile(fn, spec, backend="eager")
    x = torch.randn((1, 200, cfg.d_model), device=cuda,
                    generator=torch.Generator(device="cuda").manual_seed(1))
    fe.LAUNCHES.reset()
    y = hop(x)
    assert fe.LAUNCHES.launches >= 1
    with plain_versions():
        ref = T.decoder_logits(cfg, params, x)
    rel = ((y - ref).abs().max() / ref.abs().max()).item()
    assert rel <= 1e-3
    e = eager(x)
    assert torch.equal(vmb(x), e)
    (v,) = NimbleVM(hop.lower().graph, sync_per_op=True)(x)
    assert ((v - e).abs().max() / e.abs().max()).item() <= 1e-5
