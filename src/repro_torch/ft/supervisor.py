"""Fault tolerance: heartbeats, straggler mitigation, elastic re-mesh.

Host logic only: it reads clocks and host counters, never the card.
The serve engine's replica health (``ServeConfig(heartbeat_deadline_s=)``)
runs on :class:`HeartbeatMonitor`; the re-mesh decisions are the JAX
package's, kept so that a multi-card slice of the port plans as it does.
Components:

* :class:`HeartbeatMonitor` — per-host last-seen timestamps + deadline;
  hosts silent past the deadline are declared dead (node failure) and
  hosts whose step latency exceeds ``straggler_factor`` x the rolling
  median are flagged stragglers.
* :class:`ElasticPlan` — given the surviving host set, plans the largest
  valid (data, model) mesh that keeps the model axis intact (model
  parallelism cannot shrink without resharding weights), shrinking the
  data axis.
* :class:`Supervisor` — ties it together: journals progress, decides
  restore-step and new mesh after a failure event, applies a straggler
  policy (drop-slowest for sync training = shrink data axis; or mark for
  replacement).
"""
from __future__ import annotations

import json
import pathlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import faults
from ..obs.clock import CLOCK

__all__ = ["HeartbeatMonitor", "ElasticPlan", "Supervisor"]


class HeartbeatMonitor:
    """Per-host last-seen timestamps against a monotonic deadline.

    Timestamps default to the shared ``obs`` clock (``perf_counter``; a
    wall clock would jump under NTP adjustment and could declare every
    host dead or resurrect one).  Pass ``clock`` (or
    explicit ``t=``/``now=`` values) to drive time deterministically in
    tests.
    """

    def __init__(self, hosts: Sequence[str], *, deadline_s: float = 60.0,
                 straggler_factor: float = 2.0,
                 clock: Optional[Callable[[], float]] = None):
        self.deadline_s = deadline_s
        self.straggler_factor = straggler_factor
        self._clock: Callable[[], float] = clock or CLOCK
        self.last_seen: Dict[str, float] = {h: 0.0 for h in hosts}
        self.step_times: Dict[str, List[float]] = {h: [] for h in hosts}

    def beat(self, host: str, *, t: Optional[float] = None,
             step_seconds: Optional[float] = None) -> None:
        if faults.ACTIVE is not None and faults.ACTIVE.suppress(
                "ft.heartbeat", key=host):
            return          # injected heartbeat loss: the beat is dropped
        self.last_seen[host] = self._clock() if t is None else t
        if step_seconds is not None:
            window = self.step_times[host]
            window.append(step_seconds)
            if len(window) > 32:
                window.pop(0)

    def dead_hosts(self, *, now: Optional[float] = None) -> List[str]:
        now = self._clock() if now is None else now
        return [h for h, seen in self.last_seen.items()
                if now - seen > self.deadline_s]

    def stragglers(self) -> List[str]:
        meds = {h: float(np.median(w)) for h, w in self.step_times.items() if w}
        if len(meds) < 2:
            return []
        global_med = float(np.median(list(meds.values())))
        return [h for h, m in meds.items()
                if m > self.straggler_factor * global_med]


@dataclass(frozen=True)
class ElasticPlan:
    """A re-mesh decision after failures: keep model axis, shrink data."""

    data: int
    model: int
    pods: int = 1
    dropped_hosts: Tuple[str, ...] = ()

    @property
    def chips(self) -> int:
        return self.pods * self.data * self.model

    @staticmethod
    def plan(n_alive_chips: int, *, model: int, pod_size: int = 256,
             dropped: Sequence[str] = ()) -> "ElasticPlan":
        """Largest data axis that fits the surviving chips, model intact.

        data is kept a power of two so global batch stays divisible and
        bucketed compile caches stay valid across re-meshes."""
        if n_alive_chips < model:
            raise RuntimeError(
                f"cannot keep model={model} with {n_alive_chips} chips")
        pods = max(n_alive_chips // pod_size, 1)
        per_pod = n_alive_chips // pods
        data = 1
        while data * 2 * model <= per_pod:
            data *= 2
        return ElasticPlan(data=data, model=model, pods=pods,
                           dropped_hosts=tuple(dropped))


class Supervisor:
    """Journals steps; on failure, emits (restore_step, ElasticPlan)."""

    def __init__(self, workdir, *, hosts: Sequence[str], model_axis: int,
                 deadline_s: float = 60.0,
                 clock: Optional[Callable[[], float]] = None):
        self.workdir = pathlib.Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.monitor = HeartbeatMonitor(hosts, deadline_s=deadline_s,
                                        clock=clock)
        self.model_axis = model_axis
        self.journal_path = self.workdir / "supervisor_journal.json"
        self.events: List[Dict] = []

    def record_step(self, step: int, host: str, step_seconds: float,
                    *, t: Optional[float] = None) -> None:
        self.monitor.beat(host, t=t, step_seconds=step_seconds)
        self.events.append({"kind": "step", "step": step, "host": host,
                            "seconds": step_seconds})

    def check(self, *, chips_per_host: int, last_ckpt_step: int,
              now: Optional[float] = None) -> Optional[Tuple[int, ElasticPlan]]:
        """Returns (restore_step, plan) if the mesh must change, else None."""
        dead = self.monitor.dead_hosts(now=now)
        stragglers = self.monitor.stragglers()
        to_drop = sorted(set(dead) | set(stragglers))
        if not to_drop:
            return None
        alive = [h for h in self.monitor.last_seen if h not in to_drop]
        plan = ElasticPlan.plan(len(alive) * chips_per_host,
                                model=self.model_axis, dropped=to_drop)
        self.events.append({"kind": "remesh", "dropped": to_drop,
                            "plan": {"data": plan.data, "model": plan.model,
                                     "pods": plan.pods}})
        self._flush()
        return last_ckpt_step, plan

    def _flush(self) -> None:
        self.journal_path.write_text(json.dumps(self.events, indent=2))
