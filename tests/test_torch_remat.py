"""The port's rematerialisation (``cfg.remat``, ``models/common.py``
``maybe_remat``) against the JAX package's ``jax.checkpoint``, on the CPU.

Reduced configs with ``remat`` replaced in both packages, for a dense, a
MoE, an MLA, a vlm, the recurrent, the hybrid and the encoder-decoder
model (whisper forced to ``"full"``; its config says ``"none"``):

* **Against the reference**: the port's loss and every gradient leaf
  under ``"full"`` within ``tests/test_torch_train.py``'s ``TOL_F32`` of
  ``jax.value_and_grad`` of the reference's loss under ``jax.checkpoint``.
* **Against no remat**: ``"full"`` and ``"dots"`` give the loss and
  gradients of ``"none"`` bit for bit (the recompute runs the same ops
  on the same inputs).
* **What the forward keeps**: the tensors saved for the backward,
  counted with ``torch.autograd.graph.saved_tensors_hooks`` around the
  forward (parameters aside: they live anyway).  A census run with
  ``torch.utils.checkpoint.checkpoint`` replaced by a pass-through that
  tags what runs inside a block splits them into the blocks' and the
  rest, and records each block's inputs and its ``aten.mm`` outputs.
  Then ``"none"`` saves the blocks' and the rest; ``"full"`` saves the
  rest and each block's inputs (the checkpoint saves those through the
  hook, and nothing inside a block reaches it); ``"dots"`` saves the
  same, and its policy keeps exactly the blocks' ``mm`` outputs beside
  them.  The bytes under each setting are printed (``-s``).
* **Under a mesh**: the step's gradients on a gloo (2, 2) world with
  every block rematerialised, against the same step without a mesh
  (``tests/_torch_dist.py`` ``case_train_mesh_remat``), within 1e-4.
* **In the dry run**: a reduced train cell traced on a fake (2, 2) mesh
  keeps fewer bytes a rank under ``"full"`` than under ``"none"`` and
  counts more flops (the recompute), in a subprocess.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_train import batch, to_port
from repro_torch.configs import get_config
from repro_torch.models import common
from repro_torch.models.registry import get_model
from repro_torch.train.step import value_and_grad
from test_torch_train import TOL_F32, _grads_vs_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

ARCHS = ["tinyllama_11b", "dbrx_132b", "deepseek_v2_236b", "llava_next_34b",
         "rwkv6_3b", "zamba2_7b", "whisper_tiny"]


def _model(arch: str, remat: str):
    cfg = dataclasses.replace(get_config(arch).reduced(), remat=remat)
    model = get_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0), "cpu")


def _batch(cfg):
    return to_port(batch(cfg, np.random.RandomState(3), s=17, mask_tail=5))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_grads_match_jax_checkpoint(arch):
    _grads_vs_jax(arch, "f32", TOL_F32, remat="full")


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat_bit_for_bit(arch):
    cfg, model, params = _model(arch, "none")
    b = _batch(cfg)
    loss, grads = value_and_grad(model.loss, params, b)
    for remat in ("full", "dots"):
        m = get_model(dataclasses.replace(cfg, remat=remat))
        rloss, rgrads = value_and_grad(m.loss, params, b)
        assert torch.equal(rloss, loss), remat
        got, want = _pytree.tree_leaves(rgrads), _pytree.tree_leaves(grads)
        assert len(got) == len(want)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), remat


# ------------------------------------------------------------ census --

def _storage_bytes(tensors, exclude) -> int:
    """Bytes of the distinct storages behind ``tensors``, those in
    ``exclude`` (data pointers) aside."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        if st.data_ptr() not in exclude:
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


class _MmOutputs(TorchDispatchMode):
    """Records the outputs of ``aten.mm`` run while ``inside()``."""

    def __init__(self, inside):
        super().__init__()
        self.inside, self.outs = inside, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.mm.default and self.inside():
            self.outs.append(out)
        return out


def _forward_saving(model, params, b):
    """The loss's forward with every saved tensor packed into a list:
    ``(packed, leaves)``, ``leaves`` the parameters it ran on."""
    leaves, spec = _pytree.tree_flatten(params)
    xs = [p.detach().requires_grad_() for p in leaves]
    packed = []

    def pack(t):
        packed.append(t)
        return t

    with torch.enable_grad(), \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model.loss(_pytree.tree_unflatten(xs, spec), b)
    return packed, xs


def _census(arch: str, monkeypatch):
    """Bytes of: the tensors saved outside the blocks and inside them,
    the blocks' inputs and the blocks' ``mm`` outputs (the pass-through
    run), and the tensors each real setting saves through the hook, its
    ``"dots"`` policy's saved ``mm`` count."""
    from torch.utils import checkpoint as ckpt

    cfg, model, params = _model(arch, "full")
    b = _batch(cfg)
    depth = [0]
    tags, inputs = [], []

    def pass_through(fn, *args, **kwargs):
        inputs.extend(a for a in args if isinstance(a, torch.Tensor))
        depth[0] += 1
        try:
            return fn(*args)
        finally:
            depth[0] -= 1

    mm = _MmOutputs(lambda: depth[0] > 0)
    with monkeypatch.context() as m:
        m.setattr(ckpt, "checkpoint", pass_through)

        def pack(t):
            tags.append((t, depth[0] > 0))
            return t

        leaves, spec = _pytree.tree_flatten(params)
        xs = [p.detach().requires_grad_() for p in leaves]
        with torch.enable_grad(), mm, \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            model.loss(_pytree.tree_unflatten(xs, spec), b)
    own = {x.untyped_storage().data_ptr() for x in xs}
    outside = [t for t, i in tags if not i]
    out = {
        "outside": _storage_bytes(outside, own),
        "blocks": _storage_bytes([t for t, i in tags if i], own),
        "kept": _storage_bytes(outside + inputs, own),
        "mm": _storage_bytes(mm.outs, own),
        "n_mm": len(mm.outs),
    }
    saved_mm = []
    policy = common._dots_policy

    def counting(ctx, op, *args, **kwargs):
        got = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute and op is torch.ops.aten.mm.default:
            saved_mm.append(got)
        return got

    monkeypatch.setattr(common, "_dots_policy", counting)
    for remat in ("none", "full", "dots"):
        m = get_model(dataclasses.replace(cfg, remat=remat))
        packed, xs = _forward_saving(m, params, b)
        out[remat] = _storage_bytes(
            packed, {x.untyped_storage().data_ptr() for x in xs})
    out["dots_saved_mm"] = saved_mm
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_keeps_block_inputs_and_dots_keeps_mm_outputs(arch,
                                                            monkeypatch):
    from torch.utils.checkpoint import CheckpointPolicy

    c = _census(arch, monkeypatch)
    print(f"[remat census] {arch}: saved through the hook: none "
          f"{c['none']} B (inside the blocks {c['blocks']} B, outside "
          f"{c['outside']} B), full {c['full']} B, dots {c['dots']} B "
          f"and its policy's {c['n_mm']} mm outputs {c['mm']} B")
    assert c["blocks"] > 0 and c["n_mm"] > 0
    assert c["none"] == c["outside"] + c["blocks"]
    # a checkpointed block saves its inputs and nothing from inside it
    assert c["full"] == c["dots"] == c["kept"] < c["none"]
    # "dots" keeps exactly the blocks' mm outputs beside
    assert c["dots_saved_mm"] == c["n_mm"] * [CheckpointPolicy.MUST_SAVE]
    assert c["kept"] + c["mm"] < c["none"]


def test_recompute_runs_as_the_forward_ran(monkeypatch):
    """A forward inside ``plain_versions()`` whose backward runs on
    another thread, as autograd's device thread runs a CUDA tensor's,
    recomputes its blocks inside ``plain_versions()`` too (on the card
    the recompute would otherwise launch the kernels and save other
    tensors than the forward did)."""
    import threading

    from repro_torch.kernels import select
    from repro_torch.kernels.rmsnorm import ops as rms_ops

    seen = []
    plain = rms_ops.rmsnorm_ref

    def recording(*args):
        seen.append(select.in_plain_versions())
        return plain(*args)

    monkeypatch.setattr(rms_ops, "rmsnorm_ref", recording)
    cfg, model, params = _model("tinyllama_11b", "full")
    leaves, spec = _pytree.tree_flatten(params)
    xs = [p.detach().requires_grad_() for p in leaves]
    with select.plain_versions():
        loss = model.loss(_pytree.tree_unflatten(xs, spec), _batch(cfg))
    forward = len(seen)
    grads = []
    worker = threading.Thread(
        target=lambda: grads.append(torch.autograd.grad(loss, xs)))
    worker.start()
    worker.join()
    assert grads and forward == 2 * cfg.n_layers + 1
    # the blocks' two norms each, again, inside plain_versions()
    assert seen[forward:] == [True] * (2 * cfg.n_layers)


# -------------------------------------------------------------- mesh --

@pytest.fixture(scope="module")
def world4():
    import _torch_dist as W

    return W.run_world(4, ["train_mesh_remat", "remat_other_thread"])


def test_remat_step_under_a_mesh_equals_the_step_without(world4):
    import _torch_dist as W

    got = W.check(world4, "train_mesh_remat")
    for rank in got:
        assert len(rank) == len(W.TRAIN_MESH)
        for label, r in rank.items():
            np.testing.assert_allclose(r["mesh_loss"], r["loss"],
                                       rtol=1e-5, err_msg=label)
            flat = jax.tree.leaves(r["grads"])
            mflat = jax.tree.leaves(r["mesh_grads"])
            assert len(flat) == len(mflat)
            for a, m in zip(flat, mflat):
                scale = max(np.abs(a).max(), 1e-30)
                assert np.abs(m - a).max() / scale <= 1e-4, label


def test_remat_backward_on_another_thread_under_a_mesh(world4):
    """The recompute re-enters the forward's mesh scope on the backward's
    thread (autograd's device thread on the card): a dense model under
    ``tp`` and DBRX's expert-parallel branch give the gradients of a
    backward on the forward's own thread, bit for bit."""
    import _torch_dist as W

    for rank in W.check(world4, "remat_other_thread"):
        assert len(rank) == 2
        for label, r in rank.items():
            assert len(r["same"]) == len(r["other"]) > 0
            for a, b in zip(r["same"], r["other"]):
                np.testing.assert_array_equal(a, b, err_msg=label)


# ----------------------------------------------------------- dry run --

_DRYRUN_SCRIPT = textwrap.dedent("""
    import dataclasses, json
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import fake_group, lower
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shapes import ShapeCell

    out = {}
    with fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        for arch in ("tinyllama_11b", "dbrx_132b", "rwkv6_3b"):
            for remat in ("none", "full"):
                cfg = dataclasses.replace(get_config(arch).reduced(),
                                          n_layers=3, remat=remat)
                out[f"{arch}/{remat}"] = lower(
                    cfg, ShapeCell("train", 128, 8, "train"), mesh,
                    arch=arch, mesh_name="2x2")
    print(json.dumps(out))
""")


def test_remat_in_the_dry_run_trades_bytes_for_flops():
    proc = subprocess.run([sys.executable, "-c", _DRYRUN_SCRIPT], env=ENV,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    for arch in ("tinyllama_11b", "dbrx_132b", "rwkv6_3b"):
        none, full = res[f"{arch}/none"], res[f"{arch}/full"]
        print(f"[remat dry run] {arch} reduced, train S=128 B=8 on 2x2: "
              f"bytes a rank none {none['bytes_per_device']:.4e} full "
              f"{full['bytes_per_device']:.4e}; flops none "
              f"{none['hlo_flops']:.4e} full {full['hlo_flops']:.4e}")
        assert none["status"] == full["status"] == "ok"
        assert full["bytes_per_device"] < none["bytes_per_device"], arch
        assert full["hlo_flops"] > none["hlo_flops"], arch

