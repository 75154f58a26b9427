"""One metrics registry for the whole stack.

Runtime numbers live on five surfaces: ``ServeEngine.stats`` /
``STATS_KEYS``, ``CompileCache.stats``, the VM's ``interp_seconds``, the
dispatcher's ``mem_launch_*`` staging stats, and per-replica health
counters.  Each of those stays a view of its own, and each also
publishes into this registry, so ``disc_torch.observe()`` returns one
snapshot covering compile, dispatch, memory, serve, health and the VM.

Two mechanisms:

* **Instruments** — :class:`Counter` / :class:`Gauge` / :class:`Histogram`
  with labeled series, for code that wants to push values directly.
* **Collectors** — pull-based providers registered per ``(domain, name)``
  (e.g. ``("compile", "serve")`` for the serve engine's compile cache).
  Collectors are held by weak reference, so instrumented objects keep
  their normal lifetime (a registered serve engine or artifact, with
  its KV cache and CUDA graph pool on the card, is freed as soon as its
  owner drops it); dead collectors silently drop out of the snapshot.  Re-registering a key overwrites it — latest live object
  wins, which is what singleton domains (``serve``, ``health``, ``vm``)
  want.

A bounded **timeline** records lifecycle events (bucket compiles,
escalations and their failures, promotions, retries, preemptions,
replica drains) with timestamps from the shared ``obs`` clock.
"""
from __future__ import annotations

import weakref
from collections import deque
from typing import Any, Callable, Deque, Dict, Optional, Tuple

from . import trace
from .clock import CLOCK, Clock

#: Snapshot sections that are always present, collectors or not.
DOMAINS = ("compile", "dispatch", "memory", "serve", "health", "vm")


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-set value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Scalar distribution: count / total / min / max summary."""

    __slots__ = ("count", "total", "vmin", "vmax")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)

    def as_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "total": self.total,
                "min": self.vmin, "max": self.vmax,
                "mean": self.total / self.count if self.count else None}


def _series_key(name: str, labels: Dict[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Instruments + weakly-referenced collectors + a lifecycle timeline."""

    def __init__(self, *, clock: Optional[Clock] = None,
                 timeline_maxlen: int = 512):
        self.clock = clock or CLOCK
        self._series: Dict[Tuple[str, str], Any] = {}
        self._collectors: Dict[Tuple[str, Optional[str]], Any] = {}
        self.timeline: Deque[Dict[str, Any]] = deque(maxlen=timeline_maxlen)

    # ---- instruments ------------------------------------------------
    def _instrument(self, kind, cls, name: str, labels: Dict[str, Any]):
        key = (kind, _series_key(name, labels))
        inst = self._series.get(key)
        if inst is None:
            inst = self._series[key] = cls()
        return inst

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._instrument("counter", Counter, name, labels)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._instrument("gauge", Gauge, name, labels)

    def histogram(self, name: str, **labels: Any) -> Histogram:
        return self._instrument("histogram", Histogram, name, labels)

    # ---- timeline ---------------------------------------------------
    def event(self, kind: str, /, **attrs: Any) -> None:
        """Record a lifecycle event; mirrored to the active tracer as an
        instant so timelines and traces stay aligned.  The event name is
        positional-only so ``attrs`` may themselves contain ``kind``."""
        self.timeline.append({"t": self.clock(), "event": kind, **attrs})
        if trace.ACTIVE is not None:
            trace.ACTIVE.instant(kind, cat="lifecycle", **attrs)

    # ---- collectors -------------------------------------------------
    def register_collector(self, domain: str, fn: Callable[[], Dict],
                           name: Optional[str] = None) -> None:
        """Register a pull-based provider for ``snapshot()[domain]``.

        ``fn`` must be a bound method of the instrumented object — it is
        held via ``weakref.WeakMethod`` so registration never extends
        the object's lifetime.
        """
        self._collectors[(domain, name)] = weakref.WeakMethod(fn)

    # ---- snapshot ---------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {d: {} for d in DOMAINS}
        dead = []
        for (domain, name), ref in self._collectors.items():
            fn = ref()
            if fn is None:
                dead.append((domain, name))
                continue
            collected = fn()
            if name is None:
                out[domain] = collected
            else:
                out.setdefault(domain, {})[name] = collected
        for k in dead:
            del self._collectors[k]
        out["counters"] = {k: v.value for (kind, k), v in
                           sorted(self._series.items()) if kind == "counter"}
        out["gauges"] = {k: v.value for (kind, k), v in
                        sorted(self._series.items()) if kind == "gauge"}
        out["histograms"] = {k: v.as_dict() for (kind, k), v in
                             sorted(self._series.items())
                             if kind == "histogram"}
        out["timeline"] = list(self.timeline)
        tr = trace.ACTIVE
        out["trace"] = {"enabled": tr is not None,
                        "events": len(tr.events) if tr is not None else 0,
                        "dropped": tr.dropped if tr is not None else 0}
        return out

    def reset(self) -> None:
        """Drop instruments and the timeline (collectors stay)."""
        self._series.clear()
        self.timeline.clear()


#: The process-wide registry.  Instrumented code reaches it through the
#: module-level helpers below, so tests and docs captures can swap in a
#: fresh registry by rebinding ``metrics.REGISTRY``.
REGISTRY = MetricsRegistry()


def register_collector(domain: str, fn: Callable[[], Dict],
                       name: Optional[str] = None) -> None:
    REGISTRY.register_collector(domain, fn, name)


def record_event(kind: str, /, **attrs: Any) -> None:
    REGISTRY.event(kind, **attrs)


def snapshot() -> Dict[str, Any]:
    return REGISTRY.snapshot()
