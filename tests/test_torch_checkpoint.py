"""The port's checkpoints and train launcher on the CPU: twins of
``tests/test_substrate.py``'s ``TestCheckpoint`` cases, checkpoints across
the two packages, and ``python -m repro_torch.launch.train``.

* A checkpoint is a step directory in the reference's format (leaves by
  the reference's keys, per-layer lists stacked into ``(L, ...)``
  leaves), so a TinyLlama ``TrainState`` in f32 written by the port
  restores in the JAX package leaf for leaf, and one the JAX package
  wrote restores in the port.
* A bf16 state written by the JAX package restores in the port bit for
  bit; the JAX package's own ``restore_checkpoint`` raises ``ValueError``
  on the same file (it casts the stored 2-byte void with ``astype``:
  ROADMAP Queue 3, ``src/repro/checkpoint/checkpoint.py:137``).
* The launcher trains the reduced TinyLlama for 3 steps, checkpointing,
  and a second run resumes from the newest step; ``--dry-run`` (this
  launcher's and the serve launcher's) returns the full config's cell
  traced on the 16x16 mesh, in a subprocess.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train import f32, flat, jax_flat, pair, port_flat
from repro.checkpoint.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint.checkpoint import save_checkpoint as j_save
from repro.optim.adamw import adamw_init as j_adamw_init
from repro.train.step import TrainState as JTrainState
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint, wait_for_writers)
from repro_torch.launch import train as launcher
from repro_torch.models.convert import (train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.train.step import TrainConfig, train_state_for

ROOT = pathlib.Path(__file__).resolve().parents[1]


class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        state = {"a": torch.arange(12.0).reshape(3, 4),
                 "nested": {"b": torch.ones((2,), dtype=torch.int32)}}
        save_checkpoint(tmp_path, 7, state, journal={"data_step": 7})
        like = {"a": torch.zeros(3, 4),
                "nested": {"b": torch.zeros((2,), dtype=torch.int32)}}
        restored, journal = restore_checkpoint(tmp_path, like)
        assert torch.equal(restored["a"], state["a"])
        assert torch.equal(restored["nested"]["b"], state["nested"]["b"])
        assert restored["nested"]["b"].dtype == torch.int32
        assert journal["data_step"] == 7

    def test_latest_and_gc(self, tmp_path):
        state = {"x": torch.zeros(3)}
        for s in (1, 2, 3, 4, 5):
            save_checkpoint(tmp_path, s, state, keep=2)
        assert latest_step(tmp_path) == 5
        kept = sorted(p.name for p in tmp_path.glob("step_*"))
        assert kept == ["step_4", "step_5"]

    def test_async_save(self, tmp_path):
        state = {"x": torch.arange(5.0)}
        save_checkpoint(tmp_path, 1, state, blocking=False)
        wait_for_writers()
        assert latest_step(tmp_path) == 1
        assert not list(tmp_path.glob("*.tmp"))

    def test_elastic_restore_relayout(self, tmp_path):
        """A state saved with its layers stacked (the reference's layout)
        restores into the port's per-layer list, and back."""
        w = torch.arange(64.0).reshape(4, 4, 4)
        save_checkpoint(tmp_path, 3, {"blocks": {"w": w}})
        like = {"blocks": [{"w": torch.zeros(4, 4)} for _ in range(4)]}
        restored, _ = restore_checkpoint(tmp_path, like)
        for i in range(4):
            assert torch.equal(restored["blocks"][i]["w"], w[i])
        save_checkpoint(tmp_path, 4, restored)
        back, _ = restore_checkpoint(tmp_path, {"blocks": {"w": w * 0}})
        assert torch.equal(back["blocks"]["w"], w)


# --------------------------------------------------------- cross-package --

def _states(dtype: str):
    """A TinyLlama train state of each package after moments were set
    (mu, nu, step non-zero), over the same values."""
    cfg, model, params, jcfg, jm, jp = pair("tinyllama_11b", dtype)
    rng = np.random.RandomState(0)
    jopt = j_adamw_init(jp)
    jopt = jopt._replace(
        step=jnp.int32(7),
        mu=jax.tree.map(lambda p: jnp.asarray(rng.randn(*p.shape),
                                              jnp.float32), jp),
        nu=jax.tree.map(lambda p: jnp.asarray(rng.rand(*p.shape),
                                              jnp.float32), jp))
    jstate = JTrainState(params=jp, opt=jopt, residual=())
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                                   device="cpu")
    return cfg, state, jstate


def _like(state):
    return torch.utils._pytree.tree_map(torch.zeros_like, state)


def _jlike(jstate):
    return jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        jstate)


def _assert_same(port_state, jstate):
    got, want = port_flat(port_state), jax_flat(jstate)
    assert set(got) == set(want) and len(want) > 20
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_writes_reference_restores(tmp_path):
    cfg, state, jstate = _states("f32")
    save_checkpoint(tmp_path, 7, state, journal={"data_step": 7})
    restored, journal = j_restore(tmp_path, _jlike(jstate))
    assert journal == {"data_step": 7}
    _assert_same(state, restored)
    assert int(restored.opt.step) == 7


def test_reference_writes_port_restores(tmp_path):
    cfg, state, jstate = _states("f32")
    j_save(tmp_path, 9, jstate, journal={"data_step": 9})
    restored, journal = restore_checkpoint(tmp_path, _like(state))
    assert journal == {"data_step": 9}
    _assert_same(restored, jstate)
    assert restored.opt.step.dtype == torch.int32
    assert isinstance(restored.params["blocks"], list)


def test_bf16_state_reference_written_port_restores(tmp_path):
    cfg, state, jstate = _states("bf16")
    assert state.params["embed"].dtype == torch.bfloat16
    j_save(tmp_path, 2, jstate)
    with np.load(tmp_path / "step_2" / "leaves.npz") as z:
        assert z["params/embed"].dtype == np.dtype("V2")
    restored, _ = restore_checkpoint(tmp_path, _like(state))
    assert restored.params["embed"].dtype == torch.bfloat16
    assert restored.opt.mu["embed"].dtype == torch.float32
    _assert_same(restored, jstate)
    # the port's own bf16 checkpoint round trip, bit for bit
    save_checkpoint(tmp_path, 3, restored)
    again, _ = restore_checkpoint(tmp_path, _like(state), step=3)
    for a, b in zip(torch.utils._pytree.tree_leaves(again),
                    torch.utils._pytree.tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_reference_cannot_restore_bf16_port_can(tmp_path):
    """The recorded fault: the reference's restore of its own bf16
    checkpoint raises, where the port's restores it."""
    cfg, state, jstate = _states("bf16")
    j_save(tmp_path, 1, jstate)
    with pytest.raises(ValueError):
        j_restore(tmp_path, _jlike(jstate))
    restored, _ = restore_checkpoint(tmp_path, _like(state))
    np.testing.assert_array_equal(
        f32(train_state_to_numpy(restored, cfg).params["embed"]),
        f32(np.asarray(jstate.params["embed"])))


def test_train_state_numpy_round_trip():
    cfg, state, jstate = _states("bf16")
    np_state = train_state_to_numpy(state, cfg)
    assert np_state.params["blocks"]["attn"]["wq"].shape[0] == cfg.n_layers
    back = train_state_from_numpy(np_state, cfg, device="cpu")
    for a, b in zip(torch.utils._pytree.tree_leaves(back),
                    torch.utils._pytree.tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert set(flat(np_state)) == set(jax_flat(jstate))
    fresh = train_state_for(state.params, TrainConfig(grad_compression="bf16"))
    np_fresh = train_state_to_numpy(fresh, cfg)
    assert set(flat(np_fresh.residual)) == set(flat(np_state.params))


# --------------------------------------------------------------- launcher --

def _launch(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)


def test_launcher_trains_and_resumes(tmp_path):
    ckpt = str(tmp_path / "ck")
    common = ["--arch", "tinyllama_11b", "--reduced", "--device", "cpu",
              "--batch", "2", "--seq", "32", "--ckpt", ckpt,
              "--ckpt-every", "1"]
    out = _launch(*common, "--steps", "3")
    assert out.returncode == 0, out.stderr
    assert "step    0  loss" in out.stdout and "final loss" in out.stdout
    assert latest_step(ckpt) == 2
    out = _launch(*common, "--steps", "4")
    assert out.returncode == 0, out.stderr
    assert "resumed from step 2" in out.stdout
    final = float(out.stdout.split("final loss")[1].split()[0])
    assert np.isfinite(final)
    assert latest_step(ckpt) == 3


def test_launcher_run_returns_the_loop():
    args = launcher.parser().parse_args(
        ["--arch", "whisper_tiny", "--reduced", "--device", "cpu",
         "--steps", "2", "--batch", "2", "--seq", "16",
         "--grad-compression", "bf16", "--microbatches", "2"])
    out = launcher.run(args)
    assert len(out["losses"]) == len(out["grad_norms"]) == 2
    assert all(np.isfinite(out["losses"])) and all(
        np.isfinite(out["grad_norms"]))
    assert out["peak_bytes"] is None and out["start"] == 0
    assert int(out["state"].opt.step) == 2


def _dry_run(module: str, cell: str) -> dict:
    """``python -m <module> --arch tinyllama_11b --dry-run`` in a
    subprocess (its fake process group of 256 ranks ends with it): the
    JSON it prints last, the full config's ``cell`` on the 16x16 mesh."""
    root = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", module, "--arch", "tinyllama_11b",
         "--dry-run"], cwd=root, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["status"] == "ok" and out["cell"] == cell
    assert out["arch"] == "tinyllama_11b" and out["mesh"] == "16x16"
    assert out["chips"] == 256 and out["hlo_flops"] >= out["model_flops"] > 0
    return out


def test_launcher_dry_run_waits_for_item_12():
    """Item 12 (the dry-run launchers) is ported: ``launch/train.py
    --dry-run`` returns the ``train_4k`` cell's result, as the
    reference's launcher does, and runs no step."""
    out = _dry_run("repro_torch.launch.train", "train_4k")
    assert out["coll_breakdown"]["all-gather"] > 0     # fsdp: ZeRO-3


def test_serve_launcher_dry_run():
    """``launch/serve.py --dry-run`` returns the ``decode_32k`` cell's
    result (inference runs the fsdp config as tp, as in the reference)."""
    out = _dry_run("repro_torch.launch.serve", "decode_32k")
    assert out["coll_breakdown"]["all-reduce"] > 0


def test_elastic_restore_from_a_world_of_4_on_a_world_of_2(tmp_path):
    """The elastic restore: a parameter tree laid out by the model's tp
    specs on a (2, 2) world of gloo ranks is saved (rank 0 writes every
    leaf whole), then restored on a world of 2 with ``shardings=`` rows
    over "data": every leaf comes back a DTensor of that layout with the
    saved values, bit for bit; the JAX package restores the same
    checkpoint to the same values."""
    import _torch_dist as W

    os.environ["DISC_TORCH_DIST_CKPT"] = str(tmp_path)
    try:
        saved = W.check(W.run_world(4, ["ckpt_save"]), "ckpt_save")[0]
        got = W.check(W.run_world(2, ["ckpt_restore"]), "ckpt_restore")
    finally:
        del os.environ["DISC_TORCH_DIST_CKPT"]
    want = jax.tree.leaves(saved["params"])
    for rank in got:
        assert rank["journal"] == {"world": 4}
        assert rank["placements"] == ["(Shard(dim=0),)"]
        leaves = jax.tree.leaves(rank["params"])
        assert len(leaves) == len(want)
        for a, b in zip(leaves, want):
            np.testing.assert_array_equal(a, b)
    jstate, _ = j_restore(tmp_path, jax.tree.map(jnp.asarray,
                                                 saved["params"]))
    for a, b in zip(jax.tree.leaves(jstate), want):
        np.testing.assert_array_equal(np.asarray(a), b)
