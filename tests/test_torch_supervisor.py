"""The port's ``ft/supervisor.py`` against the JAX package's, on the CPU.

Twins of the supervisor cases of ``tests/test_substrate.py`` (``TestFT``)
and of the clock cases of ``tests/test_observability.py``, then the same
beat / step / failure schedules through both packages'
:class:`HeartbeatMonitor` and :class:`Supervisor`: the same dead hosts,
stragglers, re-mesh plans and journal.  The supervisor is host code, so
nothing here touches a device.
"""
from __future__ import annotations

import json

import numpy as np
import pytest

from repro_torch.ft import faults
from repro_torch.ft.faults import FaultSpec
from repro_torch.ft.supervisor import ElasticPlan, HeartbeatMonitor, Supervisor
from repro_torch.obs.clock import CLOCK


@pytest.fixture(autouse=True)
def _no_injector_leak():
    yield
    leaked = faults.ACTIVE is not None
    faults.clear()
    assert not leaked, "test left a FaultInjector installed"


# ------------------------------------------------- twins of TestFT --------

class TestFT:
    def test_heartbeat_death(self):
        m = HeartbeatMonitor(["h0", "h1"], deadline_s=10)
        m.beat("h0", t=100.0)
        m.beat("h1", t=100.0)
        assert m.dead_hosts(now=105.0) == []
        m.beat("h0", t=110.0)
        assert m.dead_hosts(now=115.0) == ["h1"]

    def test_straggler_detection(self):
        m = HeartbeatMonitor(["h0", "h1", "h2", "h3"])
        for _ in range(10):
            for h in ("h0", "h1", "h2"):
                m.beat(h, step_seconds=1.0)
            m.beat("h3", step_seconds=3.5)
        assert m.stragglers() == ["h3"]

    def test_elastic_plan_keeps_model_axis(self):
        plan = ElasticPlan.plan(512 - 16, model=16, pod_size=256)
        assert plan.model == 16
        assert plan.data * plan.model * plan.pods <= 496
        assert plan.data & (plan.data - 1) == 0  # power of two

    def test_supervisor_remesh_flow(self, tmp_path):
        sup = Supervisor(tmp_path, hosts=[f"h{i}" for i in range(4)],
                         model_axis=16, deadline_s=5)
        t0 = 1000.0
        for h in ("h0", "h1", "h2", "h3"):
            sup.monitor.beat(h, t=t0)
        for h in ("h0", "h1", "h2"):
            sup.monitor.beat(h, t=t0 + 10)
        out = sup.check(chips_per_host=64, last_ckpt_step=42, now=t0 + 10)
        assert out is not None
        restore_step, plan = out
        assert restore_step == 42
        assert "h3" in plan.dropped_hosts
        assert plan.chips <= 3 * 64


# ------------------------------------------- twins of the clock cases -----

class TestClocks:
    def test_heartbeat_monitor_injected_clock(self):
        t = [0.0]
        mon = HeartbeatMonitor(["h0", "h1"], deadline_s=5.0,
                               clock=lambda: t[0])
        mon.beat("h0")
        mon.beat("h1")
        t[0] = 4.0
        assert mon.dead_hosts() == []
        mon.beat("h1")
        t[0] = 6.0
        assert mon.dead_hosts() == ["h0"]   # h1 beat at t=4, alive

    def test_monitor_defaults_to_obs_clock(self):
        t = [100.0]
        mon = HeartbeatMonitor(["h0"], deadline_s=1.0)
        with CLOCK.fixed(lambda: t[0]):
            mon.beat("h0")
            t[0] = 102.0
            assert mon.dead_hosts() == ["h0"]

    def test_injected_heartbeat_loss_drops_only_the_matched_host(self):
        mon = HeartbeatMonitor(["h0", "h1"], deadline_s=5.0)
        with faults.inject(FaultSpec("ft.heartbeat", match="h1")) as inj:
            mon.beat("h0", t=10.0)
            mon.beat("h1", t=10.0)
        assert mon.last_seen == {"h0": 10.0, "h1": 0.0}
        assert inj.calls["ft.heartbeat"] == 2
        assert inj.fired["ft.heartbeat"] == 1
        assert mon.dead_hosts(now=12.0) == ["h1"]


# --------------------------------------- held against the JAX package -----

def _schedule(seed: int):
    """A seeded trace of beats (with step times) and checks over four
    hosts: h3 goes silent halfway, h2 runs slow throughout."""
    rng = np.random.RandomState(seed)
    events = []
    t = 1000.0
    for step in range(24):
        t += float(rng.uniform(0.5, 1.5))
        for h in ("h0", "h1", "h2", "h3"):
            if h == "h3" and step >= 12:
                continue
            slow = 3.0 if h == "h2" else 1.0
            events.append(("beat", h, t,
                           slow * float(rng.uniform(0.9, 1.1))))
        if step % 4 == 3:
            events.append(("check", None, t + float(rng.uniform(0, 2)), 0))
    return events


def _drive(mod, tmp_path, events, straggler_factor):
    mon = mod.HeartbeatMonitor(["h0", "h1", "h2", "h3"], deadline_s=4.0,
                               straggler_factor=straggler_factor)
    sup = mod.Supervisor(tmp_path, hosts=["h0", "h1", "h2", "h3"],
                         model_axis=8, deadline_s=4.0)
    seen = []
    for step, (kind, host, t, secs) in enumerate(events):
        if kind == "beat":
            mon.beat(host, t=t, step_seconds=secs)
            sup.record_step(step, host, secs, t=t)
        else:
            out = sup.check(chips_per_host=16, last_ckpt_step=step, now=t)
            seen.append((mon.dead_hosts(now=t), mon.stragglers(),
                         None if out is None else
                         (out[0], out[1].data, out[1].model, out[1].pods,
                          out[1].dropped_hosts)))
    return seen, json.loads(sup.journal_path.read_text()) \
        if sup.journal_path.exists() else None


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("straggler_factor", [1.5, 2.0, 4.0])
def test_same_decisions_as_jax_supervisor(tmp_path, seed, straggler_factor):
    """The same beats, step times and checks through both packages'
    monitor and supervisor: the same dead hosts, stragglers, re-mesh
    plans and journal."""
    from repro.ft import supervisor as jax_supervisor
    from repro_torch.ft import supervisor

    events = _schedule(seed)
    want = _drive(jax_supervisor, tmp_path / "jax", events,
                  straggler_factor)
    got = _drive(supervisor, tmp_path / "port", events, straggler_factor)
    assert got == want
    assert any(plan is not None for _, _, plan in got[0])


@pytest.mark.parametrize("alive", [3, 16, 17, 255, 256, 257, 496, 1024])
@pytest.mark.parametrize("model", [1, 2, 16])
def test_elastic_plan_matches_jax(alive, model):
    from repro.ft.supervisor import ElasticPlan as JaxPlan

    if alive < model:
        with pytest.raises(RuntimeError):
            ElasticPlan.plan(alive, model=model)
        return
    got = ElasticPlan.plan(alive, model=model, dropped=["h9"])
    want = JaxPlan.plan(alive, model=model, dropped=["h9"])
    assert (got.data, got.model, got.pods, got.chips, got.dropped_hosts) == \
        (want.data, want.model, want.pods, want.chips, want.dropped_hosts)


def test_heartbeat_loss_schedule_matches_jax():
    """The same ``ft.heartbeat`` fault schedule (seeded, p < 1) drops the
    same beats in both packages."""
    from repro.ft import faults as jax_faults
    from repro.ft.supervisor import HeartbeatMonitor as JaxMonitor

    def run(fmod, mon_cls):
        mon = mon_cls(["h0", "h1", "h2"], deadline_s=2.0)
        dead = []
        with fmod.inject(fmod.FaultSpec("ft.heartbeat", p=0.3), seed=5):
            for k in range(40):
                for h in ("h0", "h1", "h2"):
                    mon.beat(h, t=float(k))
                dead.append(mon.dead_hosts(now=k + 0.5))
        return dead, dict(mon.last_seen)

    assert run(faults, HeartbeatMonitor) == run(jax_faults, JaxMonitor)
