"""The twin of ``tests/test_arch_smoke.py::test_train_step_no_nans``:
every architecture's train step on the CPU.

Each of the ten at its reduced config takes two steps of
``make_train_step`` from the JAX package's weights: the loss is finite
and equals the reference step's within 1e-5, and every parameter leaf
stays finite and changes.  RWKV-6 and Zamba2 run at S = 33
(``_torch_train.seq_len``), where the reference takes its f32 sequential
scans: at S = 32 its chunked scans carry intermediates in bf16 even in an
f32 model (ROADMAP Queue 3).
"""
from __future__ import annotations

import jax
import numpy as np
import pytest

from _torch_train import batch, pair, port_flat, seq_len, to_jax, to_port
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.optim.adamw import adamw_init as j_adamw_init
from repro.train.step import TrainConfig as JTrainConfig
from repro.train.step import TrainState as JTrainState
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs import ARCH_IDS
from repro_torch.train.step import TrainConfig, make_train_step, \
    train_state_for


def test_arch_ids_match():
    assert sorted(ARCH_IDS) == sorted(JAX_ARCH_IDS)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_train_step_no_nans(arch_id):
    cfg, model, params, jcfg, jm, jp = pair(arch_id)
    bnp = batch(cfg, np.random.RandomState(7), s=seq_len(cfg))
    before = {k: v.copy() for k, v in port_flat(params).items()}
    tcfg = TrainConfig(peak_lr=1e-3, warmup=1, total_steps=10)
    state, metrics = make_train_step(model, tcfg)(
        train_state_for(params, tcfg), to_port(bnp))
    loss = float(metrics["loss"])
    assert np.isfinite(loss), f"{arch_id}: loss={loss}"
    after = port_flat(state.params)
    assert all(np.isfinite(v).all() for v in after.values())
    # lr is 0 at step 0 of a warmup; the schedule's step 1 moves them all
    assert int(metrics["step"]) == 1 and float(metrics["lr"]) == 0.0
    state, _ = make_train_step(model, tcfg)(state, to_port(bnp))
    after = port_flat(state.params)
    assert all(not np.array_equal(after[k], before[k]) for k in before)
    # the reference's step from the same weights and batch
    jt = JTrainConfig(peak_lr=1e-3, warmup=1, total_steps=10)
    jstate = JTrainState(params=jp, opt=j_adamw_init(jp), residual=())
    _, jmetrics = jax.jit(j_make_train_step(jm, jt))(jstate, to_jax(bnp))
    np.testing.assert_allclose(loss, float(jmetrics["loss"]), rtol=1e-5)
