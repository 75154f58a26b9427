"""The port's dry run (``repro_torch.launch.{shapes,dryrun}``) against the
JAX package's.

* ``SHAPE_CELLS``, ``cells_for_arch``, ``all_cells``, every (arch x
  cell)'s ``input_specs`` shapes and dtypes, and its model flops equal
  the reference's.
* Every architecture's reduced config traces its train, prefill and
  decode cells on a fake (2, 2) mesh of CPU ranks, in a subprocess (the
  fake process group never outlives it): ``status`` ok, the reference's
  keys (and the port's three), the walk's flops at least the model's
  for train and prefill (at S = 128: the model flops count the
  embedding table, which a lookup does not multiply; not whisper's,
  whose model flops count its encoder at every text token), and the
  collective
  kinds the profile implies (``fsdp`` training gathers weights and
  reduce-scatters gradients; ``tp`` all-reduces partial sums).
* The reduced prefill walked at one rank against the reference's
  ``analyze_hlo_text`` of its own jitted forward at one host device:
  total flops within [0.8, 1.25] (the recurrent families at an odd
  length, where both run sequential scans); the flops and bytes ratios
  are printed (``-s``).
* The train step under a real mesh (a gloo world of 4 ranks): loss and
  gradients equal the step without a mesh.
* One full-size cell through the module's command line, and the two
  launchers' ``--dry-run``, in subprocesses.
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
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_config
from repro.launch import shapes as ref_shapes
from repro.roofline.hlo_cost import analyze_hlo_text
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import dryrun, shapes
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.select import plain_as_kernels, plain_versions

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

#: the reference's result keys (``src/repro/launch/dryrun.py``)
REF_KEYS = {
    "arch", "cell", "mesh", "chips", "hlo_flops", "hlo_bytes", "coll_bytes",
    "coll_breakdown", "model_flops", "t_compute_s", "t_memory_s",
    "t_collective_s", "dominant", "useful_flops_ratio", "roofline_fraction",
    "bytes_per_device", "peak_memory_per_device", "lower_seconds",
    "compile_seconds", "memory_analysis", "status"}
PORT_KEYS = {"compute_dtype", "while_loops", "traced"}
MEMORY_KEYS = {"argument_size_bytes", "output_size_bytes",
               "temp_size_bytes", "generated_code_size_bytes"}

KINDS = ("train", "prefill", "decode")
SEQ, BATCH = 128, 4


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's ``launch/dryrun.py`` (for ``_model_flops``); its
    import sets ``XLA_FLAGS`` for a 512-device host, which this process's
    JAX has already read, so the variable is put back for the
    subprocesses the suite starts later."""
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as ref
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return ref


# -------------------------------------------------------------- shapes --
def test_shape_cells_equal_the_reference():
    assert shapes.SHAPE_CELLS.keys() == ref_shapes.SHAPE_CELLS.keys()
    for name, cell in shapes.SHAPE_CELLS.items():
        assert dataclasses.astuple(cell) == \
            dataclasses.astuple(ref_shapes.SHAPE_CELLS[name])
    # the two packages list their architectures in other orders
    assert sorted(ARCH_IDS) == sorted(REF_ARCH_IDS)
    for arch in ARCH_IDS:
        assert shapes.cells_for_arch(arch) == ref_shapes.cells_for_arch(arch)
    assert sorted(shapes.all_cells()) == sorted(ref_shapes.all_cells())


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch,cell", ref_shapes.all_cells())
def test_input_specs_and_model_flops_equal_the_reference(arch, cell,
                                                         ref_dryrun):
    cfg, rcfg = get_config(arch), ref_config(arch)
    c = shapes.SHAPE_CELLS[cell]
    got = shapes.input_specs(cfg, c)
    want = ref_shapes.input_specs(rcfg, ref_shapes.SHAPE_CELLS[cell])
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert _dtype_name(got[k].dtype) == str(jnp.dtype(want[k].dtype)), k
        assert type(got[k]).__name__ == "FakeTensor"   # nothing allocated
    assert dryrun._model_flops(cfg, c) == \
        ref_dryrun._model_flops(rcfg, ref_shapes.SHAPE_CELLS[cell])


def test_depth_plan_sums_to_the_config_depth():
    """The weights of the traced depths add up to one model, and their
    layers (and Zamba2's shared-block invocations) to the config's."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        plan = dryrun.depth_plan(cfg)
        assert sum(w for _, w in plan) == pytest.approx(1.0)
        assert sum(d * w for d, w in plan) == pytest.approx(cfg.n_layers)
        if cfg.family == "hybrid":
            k = cfg.shared_attn_every
            assert sum(max(d // k, 1) * w for d, w in plan) == \
                pytest.approx(cfg.n_layers // k)


@pytest.mark.parametrize("cell", ["train_4k", "prefill_32k"])
def test_long_rwkv_recurrences_are_refused(cell):
    """RWKV-6's train and prefill cells at full size, one rank, which the
    dry run once refused: its WKV over 4096 / 32768 steps is now one
    traced op (and one more for its backward), so the cells trace in
    seconds, and the walk counts at least the model's flops."""
    res = dryrun.lower(get_config("rwkv6_3b"), shapes.SHAPE_CELLS[cell],
                       None)
    assert res["status"] == "ok" and res["chips"] == 1
    assert res["hlo_flops"] >= res["model_flops"] > 0


# ------------------------------------------------------ reduced cells --
_REDUCED_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys, traceback
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch.dryrun import fake_group, lower
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shapes import ShapeCell

    seq, batch = int(sys.argv[1]), int(sys.argv[2])
    out = {}
    with fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        for arch in ARCH_IDS:
            cfg = get_config(arch).reduced()
            for kind in ("train", "prefill", "decode"):
                s = seq
                if cfg.family == "vlm" and kind != "decode":
                    s += 576   # one whole image tile before the text
                try:
                    out[f"{arch}/{kind}"] = lower(
                        cfg, ShapeCell(kind, s, batch, kind), mesh,
                        arch=arch, mesh_name="2x2")
                except Exception:
                    out[f"{arch}/{kind}"] = {
                        "status": "FAIL", "error": traceback.format_exc()}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reduced_cells():
    proc = subprocess.run(
        [sys.executable, "-c", _REDUCED_SCRIPT, str(SEQ), str(BATCH)],
        env=ENV, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_cell_on_a_fake_mesh(arch, kind, reduced_cells):
    res = reduced_cells[f"{arch}/{kind}"]
    assert res["status"] == "ok", res.get("error")
    assert REF_KEYS <= set(res) and set(res) - REF_KEYS == PORT_KEYS
    assert set(res["memory_analysis"]) == MEMORY_KEYS
    assert res["memory_analysis"]["generated_code_size_bytes"] is None
    assert res["chips"] == 4 and res["mesh"] == "2x2"
    assert res["while_loops"] == 0
    if kind != "decode" and get_config(arch).family != "encdec":
        # (whisper's model flops, 6·N·D as the reference counts them,
        # apply its encoder's parameters to every text token, where the
        # encoder runs over its 32 frames a row)
        assert res["hlo_flops"] >= res["model_flops"]
    coll = {k for k, v in res["coll_breakdown"].items()
            if k != "count" and v > 0}
    profile = get_config(arch).sharding_profile
    if kind == "train" and profile == "fsdp":
        assert {"all-gather", "reduce-scatter"} <= coll
    else:
        # weights split over "model": partial sums all-reduced
        assert "all-reduce" in coll
    assert res["coll_bytes"] == pytest.approx(sum(
        v for k, v in res["coll_breakdown"].items() if k != "count"))
    for key in ("t_compute_s", "t_memory_s", "t_collective_s"):
        assert res[key] > 0


# ------------------------------------------- one rank vs the reference --
def _ref_prefill_cost(arch: str, s: int, b: int):
    from repro.models.registry import get_model as ref_model

    cfg = ref_config(arch).reduced()
    model = ref_model(cfg)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    batch = ref_shapes.input_specs(cfg, ref_shapes.ShapeCell("p", s, b,
                                                             "prefill"))
    text = jax.jit(model.forward).lower(params, batch).compile().as_text()
    return analyze_hlo_text(text)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_prefill_at_one_rank_against_the_reference(arch):
    cfg = get_config(arch).reduced()
    # an odd length for the recurrent families, where the reference's
    # forward takes its sequential scans (``_torch_train.seq_len``), as
    # the port's plain versions do: at S = 128 its chunked WKV scan does
    # a third more flops than the sequential one
    s = SEQ + {"vlm": 576, "ssm": 1, "hybrid": 1}.get(cfg.family, 0)
    got = dryrun.lower(cfg, shapes.ShapeCell("p", s, BATCH, "prefill"),
                       None, arch=arch)
    ref = _ref_prefill_cost(arch, s, BATCH)
    flops, nbytes = got["hlo_flops"] / ref.flops, got["hlo_bytes"] / ref.bytes
    print(f"[dryrun vs reference] {arch} reduced prefill S={s} B={BATCH}: "
          f"flops ratio {flops:.4f}, bytes ratio {nbytes:.4f}")
    assert got["chips"] == 1 and got["coll_bytes"] == 0
    assert 0.8 <= flops <= 1.25


# ------------------------------------------------- the step on a mesh --
def test_train_step_under_a_mesh_equals_the_step_without():
    import _torch_dist as W

    got = W.check(W.run_world(4, ["train_mesh"]), "train_mesh")
    for rank in got:
        for profile, r in rank.items():
            np.testing.assert_allclose(r["mesh_loss"], r["loss"],
                                       rtol=1e-5, err_msg=profile)
            flat = jax.tree.leaves(r["grads"])
            mflat = jax.tree.leaves(r["mesh_grads"])
            assert len(flat) == len(mflat)
            for a, m in zip(flat, mflat):
                scale = max(np.abs(a).max(), 1e-30)
                assert np.abs(m - a).max() / scale <= 1e-4, profile


def test_plain_as_kernels_keeps_values_and_gradients():
    """Inside ``plain_as_kernels()`` a wrapper's plain version takes the
    kernels' gradient route (``PlainGrad``): the same values and the
    same gradients as the plain version's own autograd."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 6, 32, generator=gen, requires_grad=True)
    w = torch.randn(32, generator=gen, requires_grad=True)
    want = rmsnorm_ref(x, w, 1e-6)
    gx, gw = torch.autograd.grad(want.square().sum(), (x, w))
    with plain_versions(), plain_as_kernels():
        got = rms_ops.rmsnorm(x, w, eps=1e-6)
        assert type(got.grad_fn).__name__ == "PlainGradBackward"
        hx, hw = torch.autograd.grad(got.square().sum(), (x, w))
    assert torch.equal(got, want)
    torch.testing.assert_close(hx, gx, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(hw, gw, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------- command lines --
def _run(args, timeout):
    proc = subprocess.run([sys.executable, "-m", *args], env=ENV, cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc


def test_full_size_cell_from_the_command_line():
    _run(["repro_torch.launch.dryrun", "--arch", "tinyllama_11b", "--cell",
          "decode_32k"], timeout=300)
    res = json.loads((dryrun.REPORT_DIR / "16x16"
                      / "tinyllama_11b__decode_32k.json").read_text())
    assert res["status"] == "ok" and res["chips"] == 256
    assert REF_KEYS <= set(res)
    assert res["memory_analysis"]["argument_size_bytes"] > 0
