"""``repro_torch.obs`` — the observability plane of the port.

Three pieces, all importable from anywhere in the port (``obs`` itself
imports nothing from the rest of ``repro_torch``, and nothing of torch):

* :mod:`repro_torch.obs.clock` — one injectable monotonic clock
  (``CLOCK``).
* :mod:`repro_torch.obs.trace` — structured nested spans with Chrome
  ``trace_event`` export; no-ops when no tracer is installed
  (``trace.ACTIVE is None``).
* :mod:`repro_torch.obs.metrics` — one registry of counters / gauges /
  histograms plus weakly-referenced pull collectors behind
  ``disc_torch.observe()``.

The names, sites, span names and args, event kinds and collector
domains are the JAX package's, so the same calls through ``disc`` and
``disc_torch`` give snapshots and traces of the same structure.  Spans
time the host: on the card a span around a launch measures the time to
queue it.

The public handle is :data:`observe`::

    import disc_torch

    snap = disc_torch.observe()                  # one registry snapshot
    with disc_torch.observe.trace():             # record spans...
        fast(x)
        disc_torch.observe.export_chrome_trace("trace.json")  # Perfetto
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, Iterator, Optional

from . import clock, metrics, trace  # noqa: F401
from .clock import CLOCK, Clock  # noqa: F401
from .metrics import MetricsRegistry  # noqa: F401
from .trace import Tracer  # noqa: F401


class Observe:
    """``disc_torch.observe`` — callable snapshot plus trace controls."""

    def __call__(self) -> Dict[str, Any]:
        """One snapshot of the live metrics registry (all domains)."""
        return metrics.snapshot()

    # ---- tracing controls -------------------------------------------
    def start_trace(self, **kwargs: Any) -> Tracer:
        """Install (and return) a process-wide tracer."""
        return trace.install(Tracer(**kwargs))

    def stop_trace(self) -> Optional[Tracer]:
        """Uninstall the active tracer and return it (spans intact)."""
        t = trace.ACTIVE
        trace.clear()
        return t

    @contextmanager
    def trace(self, tracer: Optional[Tracer] = None) -> Iterator[Tracer]:
        """Scoped tracing — ``with disc_torch.observe.trace() as t: ...``."""
        with trace.tracing(tracer) as t:
            yield t

    @property
    def tracer(self) -> Optional[Tracer]:
        return trace.ACTIVE

    def export_chrome_trace(self, path) -> str:
        """Export the active tracer's buffer as Chrome ``trace_event``
        JSON (loadable at ``ui.perfetto.dev``)."""
        t = trace.ACTIVE
        if t is None:
            raise RuntimeError(
                "no active tracer: call disc_torch.observe.start_trace() (or "
                "use disc_torch.observe.trace()) around the code to record "
                "first")
        return t.export_chrome_trace(path)


#: The public observability handle, re-exported as ``disc_torch.observe``.
observe = Observe()

__all__ = ["observe", "Observe", "Tracer", "MetricsRegistry", "Clock",
           "CLOCK", "clock", "metrics", "trace"]
