"""Zero-dependency structured tracer with Chrome ``trace_event`` export.

Spans are emitted at the load-bearing sites of the stack — ``lower``,
per-bucket compiles (cache hit/miss annotated), the generated dispatch
entry (bucket selected, pad bytes), per-cluster kernel runs, and the
serve request lifecycle (admission → prefill → decode → retire as async
events keyed by request id).  The layer follows the same zero-overhead
discipline as ``ft/faults.py``: a module-level :data:`ACTIVE` that is
``None`` in production, so every hot site pays exactly one attribute
load and an ``is None`` test when tracing is off::

    if trace.ACTIVE is not None:
        trace.ACTIVE.instant("serve.retry", cat="serve", kind=kind)

Recorded traces export to Chrome ``trace_event`` JSON — load the file at
``ui.perfetto.dev`` or ``chrome://tracing``.

On the card every timestamp is host time (:mod:`repro_torch.obs.clock`):
a span around a launch closes when the launch is queued.  Span args
and event attrs hold host values only (ints, floats, strings, tuples),
never a tensor, so recording reads nothing back from the card.  A CUDA
graph's capture pass records nothing and a replay runs no Python
(:mod:`repro_torch.core.graphs`), so the spans of a graphed entry are
those of its first call.
"""
from __future__ import annotations

import json
import threading
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

from .clock import CLOCK, Clock


class _OpenSpan:
    """Handle returned by :meth:`Tracer.begin`; call :meth:`end` once."""

    __slots__ = ("tracer", "idx")

    def __init__(self, tracer: "Tracer", idx: Optional[int]):
        self.tracer = tracer
        self.idx = idx

    def end(self, **args: Any) -> None:
        self.tracer.end(self, **args)


class Tracer:
    """Collects span / instant / async / counter events in memory.

    Events are plain dicts with internal fields (``parent`` — index of
    the enclosing span on the same thread, ``depth`` — nesting level)
    that tests assert on; :meth:`chrome_trace` strips them down to the
    Chrome ``trace_event`` schema.  The buffer is capped at
    ``max_events``; overflow increments :attr:`dropped` instead of
    growing without bound.
    """

    def __init__(self, *, max_events: int = 200_000,
                 clock: Optional[Clock] = None):
        self.clock = clock or CLOCK
        self.max_events = max_events
        self.events: List[Dict[str, Any]] = []
        self.dropped = 0
        self._lock = threading.Lock()
        self._stacks: Dict[int, List[Optional[int]]] = {}
        self._t0 = self.clock()

    # ---- recording --------------------------------------------------
    def _stack(self) -> List[Optional[int]]:
        tid = threading.get_ident()
        st = self._stacks.get(tid)
        if st is None:
            st = self._stacks[tid] = []
        return st

    def _append(self, rec: Dict[str, Any]) -> Optional[int]:
        with self._lock:
            if len(self.events) >= self.max_events:
                self.dropped += 1
                return None
            self.events.append(rec)
            return len(self.events) - 1

    def begin(self, name: str, /, cat: str = "disc",
              **args: Any) -> _OpenSpan:
        """Open a nested span; close it with ``.end(**more_args)``."""
        st = self._stack()
        parent = next((i for i in reversed(st) if i is not None), -1)
        rec = {"name": name, "cat": cat, "ph": "X",
               "ts": self.clock() - self._t0, "dur": None,
               "tid": threading.get_ident(), "args": dict(args),
               "parent": parent, "depth": len(st)}
        idx = self._append(rec)
        st.append(idx)
        return _OpenSpan(self, idx)

    def end(self, span: _OpenSpan, **args: Any) -> None:
        st = self._stack()
        if st:
            st.pop()
        if span.idx is None:
            return
        rec = self.events[span.idx]
        rec["dur"] = self.clock() - self._t0 - rec["ts"]
        if args:
            rec["args"].update(args)

    @contextmanager
    def span(self, name: str, cat: str = "disc",
             **args: Any) -> Iterator[_OpenSpan]:
        sp = self.begin(name, cat, **args)
        try:
            yield sp
        finally:
            sp.end()

    def instant(self, name: str, /, cat: str = "disc", **args: Any) -> None:
        """A point event (``ph: "i"``) — retries, drains, promotions."""
        st = self._stack()
        parent = next((i for i in reversed(st) if i is not None), -1)
        self._append({"name": name, "cat": cat, "ph": "i",
                      "ts": self.clock() - self._t0,
                      "tid": threading.get_ident(), "args": dict(args),
                      "parent": parent, "depth": len(st)})

    def async_begin(self, name: str, id: Any, cat: str = "serve",
                    **args: Any) -> None:
        """Open an async span (``ph: "b"``) keyed by ``id`` — used for
        per-request serve lifecycles that outlive any one call stack."""
        self._append({"name": name, "cat": cat, "ph": "b",
                      "ts": self.clock() - self._t0, "id": str(id),
                      "tid": threading.get_ident(), "args": dict(args),
                      "parent": -1, "depth": 0})

    def async_end(self, name: str, id: Any, cat: str = "serve",
                  **args: Any) -> None:
        self._append({"name": name, "cat": cat, "ph": "e",
                      "ts": self.clock() - self._t0, "id": str(id),
                      "tid": threading.get_ident(), "args": dict(args),
                      "parent": -1, "depth": 0})

    def counter(self, name: str, values: Dict[str, float],
                cat: str = "disc") -> None:
        """A counter sample (``ph: "C"``) — renders as a track."""
        self._append({"name": name, "cat": cat, "ph": "C",
                      "ts": self.clock() - self._t0,
                      "tid": threading.get_ident(),
                      "args": {k: float(v) for k, v in values.items()},
                      "parent": -1, "depth": 0})

    # ---- inspection -------------------------------------------------
    def spans(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        """Finished duration spans, optionally filtered by name."""
        return [e for e in self.events
                if e["ph"] == "X" and e["dur"] is not None
                and (name is None or e["name"] == name)]

    def find(self, name: str) -> List[Dict[str, Any]]:
        """All events (any phase) with the given name."""
        return [e for e in self.events if e["name"] == name]

    # ---- export -----------------------------------------------------
    def chrome_trace(self) -> Dict[str, Any]:
        """The buffer as a Chrome ``trace_event`` JSON object."""
        out = []
        for e in self.events:
            ev: Dict[str, Any] = {
                "name": e["name"], "cat": e["cat"], "ph": e["ph"],
                "ts": round(e["ts"] * 1e6, 3), "pid": 1, "tid": e["tid"],
                "args": e["args"],
            }
            if e["ph"] == "X":
                ev["dur"] = round((e["dur"] or 0.0) * 1e6, 3)
            elif e["ph"] == "i":
                ev["s"] = "t"
            elif e["ph"] in ("b", "e"):
                ev["id"] = e["id"]
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"dropped": self.dropped}}

    def export_chrome_trace(self, path) -> str:
        """Write the Chrome trace JSON to ``path``; returns the path."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)
            f.write("\n")
        return str(path)


#: The installed tracer, or ``None`` (production).  Hot sites guard on
#: ``trace.ACTIVE is not None`` — the whole layer is a no-op when unset.
ACTIVE: Optional[Tracer] = None


def install(tracer: Optional[Tracer] = None) -> Tracer:
    """Install (and return) a tracer as the process-wide :data:`ACTIVE`."""
    global ACTIVE
    ACTIVE = tracer if tracer is not None else Tracer()
    return ACTIVE


def clear() -> None:
    """Uninstall the active tracer; hot paths revert to no-ops."""
    global ACTIVE
    ACTIVE = None


@contextmanager
def tracing(tracer: Optional[Tracer] = None) -> Iterator[Tracer]:
    """Scoped tracing: installs a tracer, restores the previous state."""
    global ACTIVE
    prev = ACTIVE
    t = install(tracer)
    try:
        yield t
    finally:
        ACTIVE = prev
