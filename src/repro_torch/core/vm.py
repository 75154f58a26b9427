"""NimbleVM — the interpreted-runtime baseline (paper §5.2 comparison).

Nimble "pre-builds runtime control as a VM ... the VM approach brings
interpretation overhead".  This module is the stand-in the JAX package
measures against, on PyTorch: a per-call interpreter over the DHLO graph
that

* walks the op list in Python for **every** invocation,
* works out every shape again from the call's input sizes,
* dispatches each op individually, with no fusion plan and no cluster
  kernels; with ``sync_per_op`` it synchronizes the card after each op
  (modeling one kernel launch per op),
* executes the lowered buffer plan's free lines for real: references are
  dropped where the plan frees them, and the byte trail (planned peak vs
  the no-liveness baseline) lands in :class:`VMStats`.

Each call is one ``vm.interp`` span (cat ``vm``, ``op_dispatches`` at its
end) when a tracer is installed, and the latest VM's :class:`VMStats` are
``disc_torch.observe()["vm"]``.

Region ops run through the executor's own :func:`emit_region_op` at the
call's exact shapes.  DISC's generated dispatcher does none of this per
call; the difference between the two is the paper's "CPU time" claim.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict

import torch

from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .buffers import plan_buffers
from .codegen import REGION_OPS, _Literals, _ShapeEnv, emit_region_op
from .dhlo import DGraph, DValue
from .emit import emit_op
from .symshape import SymDim

__all__ = ["NimbleVM", "VMStats"]


@dataclass
class VMStats:
    calls: int = 0
    op_dispatches: int = 0
    interp_seconds: float = 0.0
    # buffer-plan execution (bytes over the last call)
    planned_peak_bytes: int = 0    # peak live bytes under the plan's frees
    naive_peak_bytes: int = 0      # every value held to the end (no plan)
    reuses: int = 0                # reuse and donate lines of the plan


def _nbytes(x: Any) -> int:
    return x.numel() * x.element_size()


class NimbleVM:
    """Per-op interpreter over a DHLO graph (the Nimble-style baseline).

    ``memory_planning=False`` ignores the plan's free lines (every
    intermediate is held to the end of the call).  ``device`` is where the
    call's values live; like every entry point of the port it defaults to
    the card.
    """

    def __init__(self, graph: DGraph, sync_per_op: bool = True,
                 memory_planning: bool = True, *, device="cuda") -> None:
        from ..api.options import resolve_device

        self.graph = graph
        self.device = torch.device(resolve_device(device))
        self.sync_per_op = sync_per_op
        self.memory_planning = memory_planning
        self.buffer_plan = getattr(graph, "memory_plan", None) or \
            plan_buffers(graph, symbolic=memory_planning)
        self.stats = VMStats()
        # plan lines → op-indexed free schedule, fixed once per VM
        self._frees = self.buffer_plan.frees_after(graph) \
            if memory_planning else {}
        self._reuse_lines = sum(self.buffer_plan.reuse_counts.values())
        # the constants stay resident on the device across calls
        self._literals = _Literals(self.device)
        obs_metrics.register_collector("vm", self._obs_collect)

    def _obs_collect(self) -> Dict[str, Any]:
        """Pull collector for ``disc_torch.observe()["vm"]``."""
        s = self.stats
        return {"calls": s.calls, "op_dispatches": s.op_dispatches,
                "interp_seconds": round(s.interp_seconds, 6),
                "planned_peak_bytes": s.planned_peak_bytes,
                "naive_peak_bytes": s.naive_peak_bytes, "reuses": s.reuses}

    def __call__(self, *arrays):
        sp = (obs_trace.ACTIVE.begin("vm.interp", cat="vm",
                                     graph=self.graph.name)
              if obs_trace.ACTIVE is not None else None)
        try:
            return self._interp(arrays)
        finally:
            if sp is not None:
                sp.end(op_dispatches=self.stats.op_dispatches)

    def _interp(self, arrays):
        t0 = time.perf_counter()
        g = self.graph
        arrays = [torch.as_tensor(a, device=self.device) for a in arrays]
        bindings: Dict[int, int] = {}
        for p, a in zip(g.params, arrays):
            for d, size in zip(p.shape, a.shape):
                if isinstance(d, SymDim):
                    c = g.store.canon_dim(d)
                    if isinstance(c, SymDim):
                        bindings[c.uid] = int(size)
        env = _ShapeEnv(g, padded=bindings, actual=dict(bindings),
                        device=self.device)
        vals: Dict[int, Any] = {p.vid: a for p, a in zip(g.params, arrays)}
        param_ids = set(vals)

        def read(v: DValue):
            if v.vid in vals:
                return vals[v.vid]
            if v.literal is not None:
                return self._literals.get(v)
            raise KeyError(f"undefined value {v!r}")

        sync = self.sync_per_op and self.device.type == "cuda"
        live_peak = 0
        naive_total = 0
        for i, op in enumerate(g.ops):
            ins = [read(v) for v in op.inputs]
            ins += [read(v) for v in op.shape_operands]
            if op.opcode in REGION_OPS:
                outs = emit_region_op(op, ins, env, masked=False)
            else:
                outs = emit_op(op, ins,
                               [env.padded_shape(o.shape)
                                for o in op.outputs], self.device)
            if sync:
                torch.cuda.synchronize(self.device)  # one launch per op
            self.stats.op_dispatches += 1
            for o, val in zip(op.outputs, outs):
                vals[o.vid] = val
                naive_total += _nbytes(val)
            live_peak = max(live_peak, sum(
                _nbytes(x) for vid, x in vals.items() if vid not in param_ids))
            # execute the plan's free lines for this program point
            for vid in self._frees.get(i, ()):
                vals.pop(vid, None)

        result = [read(o) for o in g.outputs]
        self.stats.calls += 1
        self.stats.planned_peak_bytes = live_peak if self.memory_planning \
            else naive_total
        self.stats.naive_peak_bytes = naive_total
        self.stats.reuses = self._reuse_lines
        self.stats.interp_seconds += time.perf_counter() - t0
        return result
