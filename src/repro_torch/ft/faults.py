"""Deterministic, seeded fault injection — the test harness for the
fault-tolerance plane.

Hot paths carry **named injection sites**; each site is a single
module-global check (``faults.ACTIVE is None`` → fall through), so the
disabled cost is one attribute load per site — nothing allocates, nothing
locks, no call is made.  Enabled, an installed :class:`FaultInjector`
decides *deterministically* (explicit call indices, or a seeded RNG)
whether each site occurrence fires.  Every site is host code that runs
before or around a launch; none reads the card.

Sites (the string is the contract; tests and ``chip_smoke.py`` key on it):

=====================  =====================================================
``compile.bucket``     :meth:`repro_torch.core.cache.CompileCache.
                       get_or_compile` — compile-of-bucket-k fails
``compile.exact``      :meth:`...get_or_compile_exact` — a §4.4 exact
                       escalation compile fails
``kernel.cluster``     :func:`repro_torch.core.codegen` cluster-kernel
                       execution — a ``ClusterKernel`` raises before its
                       launch, in an entry's first call (the port's
                       trace: a CUDA graph's capture pass checks no site
                       and a replay runs no Python)
``serve.launch``       :class:`repro_torch.serve.engine.ServeEngine`
                       artifact launches (prefill / decode)
``pool.alloc``         paged-KV block allocation — not ported yet: a spec
                       naming it raises ``NotImplementedError``
``ft.heartbeat``       :meth:`repro_torch.ft.supervisor.HeartbeatMonitor.
                       beat` — the beat is dropped (lost heartbeat)
=====================  =====================================================

Raising sites (``compile.*``, ``kernel.*``, ``serve.*``) go through
:meth:`FaultInjector.check`, which raises the spec's error.  Behavioral
sites (``pool.alloc``, ``ft.heartbeat``) go through
:meth:`FaultInjector.suppress`, which returns True when the operation
should be denied/dropped.  Both count every occurrence per site
(``injector.calls``) and every firing (``injector.fired``), so a
differential test can assert exactly N faults landed.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

from ..errors import CompileError, LaunchError

__all__ = ["FaultSpec", "FaultInjector", "install", "clear", "inject",
           "ACTIVE", "SITES", "LIVE_SITES"]

#: every named site, documented above — specs naming an unknown site are
#: rejected at construction so a typo cannot silently inject nothing
SITES: Tuple[str, ...] = (
    "compile.bucket", "compile.exact", "kernel.cluster", "serve.launch",
    "pool.alloc", "ft.heartbeat",
)

#: sites with no hook in the port yet, each with the slice that adds it;
#: a spec naming one raises rather than inject nothing in silence
_NOT_PORTED: Dict[str, str] = {
    "pool.alloc": "the pool.alloc site arrives with the port's paged-KV "
                  "slice (paged KV blocks, preemption on pool pressure)",
}

#: the sites the port checks
LIVE_SITES: Tuple[str, ...] = tuple(s for s in SITES if s not in _NOT_PORTED)


def _default_error(site: str, transient: bool) -> Exception:
    kind = "transient" if transient else "permanent"
    if site.startswith("compile."):
        return CompileError(f"injected {kind} fault at {site}",
                            transient=transient)
    return LaunchError(f"injected {kind} fault at {site}",
                       transient=transient)


@dataclass
class FaultSpec:
    """One injection rule.

    * ``site``      — a name from :data:`SITES`.
    * ``at``        — fire on exactly these 0-based call indices, counted
      over the calls this spec *matches* (site + ``match`` filter), so
      ``FaultSpec("serve.launch", match="decode", at=[0])`` fires on the
      first decode launch regardless of how many prefills came before;
      ``None`` = every eligible call.
    * ``times``     — stop firing after this many hits (``None`` =
      unbounded).
    * ``p``         — probability a call eligible under ``at``/``times``
      fires, drawn from the injector's seeded RNG (1.0 = always — fully
      deterministic; <1.0 = deterministic *given the seed*).
    * ``match``     — substring the site's key (artifact name, host,
      cluster template) must contain; ``None`` matches any key.
    * ``transient`` — classification of the injected error (raising
      sites only).
    * ``error``     — factory for the exception to raise (raising sites);
      default builds a :class:`CompileError`/:class:`LaunchError` per the
      site and ``transient``.
    """

    site: str
    at: Optional[Sequence[int]] = None
    times: Optional[int] = None
    p: float = 1.0
    match: Optional[str] = None
    transient: bool = False
    error: Optional[Callable[[], Exception]] = None
    hits: int = field(default=0, init=False)
    seen: int = field(default=0, init=False)   # matching calls observed

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; known: {list(SITES)}")
        if self.site in _NOT_PORTED:
            raise NotImplementedError(
                f"FaultSpec({self.site!r}): {_NOT_PORTED[self.site]}")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"FaultSpec(p={self.p}): need 0 <= p <= 1")


class FaultInjector:
    """A set of :class:`FaultSpec` rules plus the per-site call counters
    that make schedules deterministic."""

    def __init__(self, specs: Sequence[FaultSpec], *, seed: int = 0):
        self.specs = list(specs)
        self.seed = seed
        self._rng = random.Random(seed)
        self.calls: Dict[str, int] = {s: 0 for s in SITES}
        self.fired: Dict[str, int] = {s: 0 for s in SITES}

    # ------------------------------------------------------------ engine --
    def _pick(self, site: str, key: str) -> Optional[FaultSpec]:
        self.calls[site] += 1
        for spec in self.specs:
            if spec.site != site:
                continue
            if spec.match is not None and spec.match not in key:
                continue
            idx = spec.seen
            spec.seen = idx + 1
            if spec.at is not None and idx not in spec.at:
                continue
            if spec.times is not None and spec.hits >= spec.times:
                continue
            if spec.p < 1.0 and self._rng.random() >= spec.p:
                continue
            spec.hits += 1
            self.fired[site] += 1
            return spec
        return None

    def check(self, site: str, key: str = "") -> None:
        """Raising sites: raise the matched spec's error, else no-op."""
        spec = self._pick(site, key)
        if spec is not None:
            # raised unnamed: a local naming the error would make a cycle
            # through this frame (its traceback holds the frame), keeping
            # the caller's frames and their tensors until a gc pass
            raise (spec.error() if spec.error is not None
                   else _default_error(site, spec.transient))

    def suppress(self, site: str, key: str = "") -> bool:
        """Behavioral sites: True = deny/drop the operation."""
        return self._pick(site, key) is not None

    # ------------------------------------------------------- convenience --
    def total_fired(self) -> int:
        return sum(self.fired.values())

    @staticmethod
    def chaos(*, seed: int, rate: float = 0.05,
              sites: Sequence[str] = LIVE_SITES) -> "FaultInjector":
        """A random-schedule injector for chaos runs: every listed site
        fires with probability ``rate`` per call, transient and permanent
        faults alternating — deterministic for a fixed seed."""
        specs = []
        for k, s in enumerate(sites):
            specs.append(FaultSpec(site=s, p=rate, transient=(k % 2 == 0)))
        return FaultInjector(specs, seed=seed)


#: the installed injector; hot paths guard on ``ACTIVE is not None``
ACTIVE: Optional[FaultInjector] = None


def install(injector: FaultInjector) -> FaultInjector:
    global ACTIVE
    ACTIVE = injector
    return injector


def clear() -> None:
    global ACTIVE
    ACTIVE = None


class inject:
    """``with faults.inject(FaultSpec(...), seed=7) as inj:`` — install
    an injector for the block, always uninstalled on exit."""

    def __init__(self, *specs: FaultSpec, seed: int = 0,
                 injector: Optional[FaultInjector] = None):
        self.injector = injector or FaultInjector(specs, seed=seed)

    def __enter__(self) -> FaultInjector:
        return install(self.injector)

    def __exit__(self, *exc) -> None:
        clear()
