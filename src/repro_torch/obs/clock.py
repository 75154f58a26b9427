"""One injectable monotonic clock for every timing site of the port.

Spans, the metrics timeline, the dispatch timer, the serve engine and
the heartbeat monitor read through :data:`CLOCK`, a module-level
:class:`Clock` whose source defaults to ``time.perf_counter`` and can be
swapped for a fake in tests (``CLOCK.set_source(lambda: t[0])``) or
scoped with :meth:`Clock.fixed`.

It is host time.  A call that launches work on the card returns once
the work is queued, so a span around it measures the host's enqueue
time, not the card's execution time: nothing in ``obs`` synchronises
the device.

``obs`` imports nothing from the rest of ``repro_torch`` — instrumentation
flows inward only.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, Optional


class Clock:
    """A callable monotonic clock with a swappable source.

    Calling the instance returns seconds from an arbitrary origin
    (``time.perf_counter`` by default), so deltas are meaningful and
    immune to wall-clock adjustments.
    """

    __slots__ = ("_source",)

    def __init__(self, source: Optional[Callable[[], float]] = None):
        self._source: Callable[[], float] = source or time.perf_counter

    def __call__(self) -> float:
        return self._source()

    def set_source(self, source: Optional[Callable[[], float]] = None) -> None:
        """Swap the time source; ``None`` restores ``time.perf_counter``."""
        self._source = source or time.perf_counter

    @contextmanager
    def fixed(self, source: Callable[[], float]):
        """Scoped source swap (tests drive time deterministically)."""
        prev = self._source
        self._source = source
        try:
            yield self
        finally:
            self._source = prev


#: The process-wide clock every instrumented site reads.
CLOCK = Clock()


def now() -> float:
    """Seconds on the shared monotonic clock (module-level shorthand)."""
    return CLOCK()
