"""Compile cache — keyed on (pattern fingerprint, bucket signature).

DISC §2: "these fusion engines will compile and generate kernel for every
emerging shape, even though some of them share the same computation
pattern" — the cache key here deliberately contains **no concrete shapes**,
only the shape-free graph fingerprint and the bucket signature, so compile
count is O(#buckets), not O(#shapes).

Also implements §4.4's static/dynamic mix: signatures that stay hot are
*escalated* to exact-shape static specializations (better codegen: no
masking, no padding waste), bounded by an LRU budget.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Set, Tuple

from ..errors import (CONTROL_EXCEPTIONS, DEFAULT_RETRY, RetryPolicy,
                      wrap_compile_error)
from ..ft import faults
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .graphs import GraphPool

__all__ = ["CompileCache", "CacheStats"]


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    compile_seconds: float = 0.0
    escalations: int = 0
    evictions: int = 0
    # promote-on-change re-lowerings: a call broke a dim tie inferred from
    # the first call, so the artifact was re-lowered with independent dims
    promotions: int = 0
    # fault plane: transient compile failures retried with backoff, and
    # §4.4 exact escalations whose compile failed permanently (the exact
    # sig is pinned to the padded bucket path thereafter)
    retries: int = 0
    escalation_failures: int = 0

    @property
    def compiles(self) -> int:
        return self.misses

    def as_dict(self) -> Dict[str, float]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "compiles": self.compiles,
            "compile_seconds": round(self.compile_seconds, 4),
            "escalations": self.escalations,
            "evictions": self.evictions,
            "promotions": self.promotions,
            "retries": self.retries,
            "escalation_failures": self.escalation_failures,
        }


class CompileCache:
    def __init__(self, fingerprint: str, max_entries: int = 256,
                 escalation_threshold: Optional[int] = None) -> None:
        self.fingerprint = fingerprint
        self.max_entries = max_entries
        self.escalation_threshold = escalation_threshold
        self._entries: "OrderedDict[Tuple, Any]" = OrderedDict()
        self._exact_hits: Dict[Tuple, int] = {}
        # exact signatures whose escalation compile failed permanently:
        # should_escalate() answers False for them forever after, so the
        # dispatch keeps serving the padded bucket artifact instead of
        # re-attempting a compile that cannot succeed on every call
        self._failed_exact: Set[Tuple] = set()
        self.retry_policy: RetryPolicy = DEFAULT_RETRY
        self.stats = CacheStats()
        # the card memory pool that the CUDA graphs of this cache's jit
        # entries share (core/graphs.py)
        self.graph_pool = GraphPool()
        obs_metrics.register_collector("compile", self._obs_collect,
                                       name=fingerprint)

    def _obs_collect(self) -> Dict[str, Any]:
        """Pull collector for ``disc_torch.observe()["compile"]``."""
        return dict(self.stats.as_dict(), entries=len(self._entries))

    def _compile_with_retry(self, compile_fn: Callable[[], Any],
                            what: str, site: str) -> Any:
        """Run ``compile_fn`` under the taxonomy: raw errors are wrapped
        into :class:`~repro_torch.errors.CompileError` (classified transient
        or permanent), transient failures retry with capped exponential
        backoff, and the named fault site fires first in each attempt when
        an injector is installed (an injected transient is retried exactly
        as a real one)."""
        attempt = 0
        while True:
            try:
                if faults.ACTIVE is not None:
                    faults.ACTIVE.check(site, key=what)
                return compile_fn()
            except CONTROL_EXCEPTIONS:
                raise
            except Exception as e:  # noqa: BLE001 — classified below
                err = wrap_compile_error(e, what)
                if not err.transient \
                        or attempt >= self.retry_policy.max_retries:
                    # wrap_compile_error chains a new error to ``e``; an
                    # error that is ``e`` itself raises as it is (``from
                    # e`` would make it its own cause: a cycle).  No
                    # local names it past the raise either: the traceback
                    # holds this frame, whose locals (the compile callback,
                    # a first call's arguments) then need no gc pass
                    try:
                        raise err
                    finally:
                        del err
                del err     # nor a retried attempt's error
                self.stats.retries += 1
                time.sleep(self.retry_policy.delay(attempt))
                attempt += 1

    # --------------------------------------------------------- bucketed --
    def get_or_compile(self, bucket_sig: Tuple, compile_fn: Callable[[], Any],
                       fingerprint: Optional[str] = None) -> Any:
        """Look up / build the artifact for one bucket signature.

        ``fingerprint`` overrides the cache's default graph fingerprint so a
        single cache instance can be shared by several compiled artifacts
        (e.g. a serving engine's prefill + decode functions) — entries never
        collide because the fingerprint is part of the key.
        """
        key = ("bucket", fingerprint or self.fingerprint, bucket_sig)
        entry = self._entries.get(key)
        if entry is not None:
            self.stats.hits += 1
            self._entries.move_to_end(key)
            return entry
        self.stats.misses += 1
        fp = fingerprint or self.fingerprint
        sp = (obs_trace.ACTIVE.begin("compile.bucket", cat="compile",
                                     key=str(bucket_sig), artifact=fp[:40],
                                     cache_hit=False)
              if obs_trace.ACTIVE is not None else None)
        t0 = time.perf_counter()
        try:
            # the fault-site key carries the artifact fingerprint so an
            # injector can target one artifact (match="prefill") of a
            # shared cache
            entry = self._compile_with_retry(
                compile_fn, f"{fp} bucket {bucket_sig}", "compile.bucket")
        finally:
            dt = time.perf_counter() - t0
            self.stats.compile_seconds += dt
            if sp is not None:
                sp.end()
        obs_metrics.record_event("compile.bucket", key=str(bucket_sig),
                                 artifact=fp[:40], seconds=round(dt, 4))
        self._entries[key] = entry
        self._evict()
        return entry

    # ------------------------------------------------- static escalation --
    def should_escalate(self, exact_sig: Tuple,
                        fingerprint: Optional[str] = None,
                        threshold: Optional[int] = None) -> bool:
        """§4.4: route hot exact shapes to the static compiler."""
        threshold = self.escalation_threshold if threshold is None else threshold
        if threshold is None:
            return False
        key = (fingerprint or self.fingerprint, exact_sig)
        if key in self._failed_exact:
            return False
        n = self._exact_hits.get(key, 0) + 1
        self._exact_hits[key] = n
        return n >= threshold

    def note_escalation_failure(self, exact_sig: Tuple,
                                fingerprint: Optional[str] = None) -> None:
        """Record a permanently failed §4.4 escalation compile: the exact
        signature is pinned to the padded bucket path (``should_escalate``
        answers False for it from now on)."""
        self._failed_exact.add((fingerprint or self.fingerprint, exact_sig))
        self.stats.escalation_failures += 1
        obs_metrics.record_event(
            "escalate.fail", key=str(exact_sig),
            artifact=(fingerprint or self.fingerprint)[:40])

    def get_or_compile_exact(self, exact_sig: Tuple,
                             compile_fn: Callable[[], Any],
                             fingerprint: Optional[str] = None) -> Any:
        key = ("exact", fingerprint or self.fingerprint, exact_sig)
        entry = self._entries.get(key)
        if entry is not None:
            self.stats.hits += 1
            self._entries.move_to_end(key)
            return entry
        self.stats.misses += 1
        self.stats.escalations += 1
        fp = fingerprint or self.fingerprint
        sp = (obs_trace.ACTIVE.begin("compile.exact", cat="compile",
                                     key=str(exact_sig), artifact=fp[:40],
                                     cache_hit=False)
              if obs_trace.ACTIVE is not None else None)
        t0 = time.perf_counter()
        try:
            entry = self._compile_with_retry(
                compile_fn, f"{fp} exact {exact_sig}", "compile.exact")
        finally:
            dt = time.perf_counter() - t0
            self.stats.compile_seconds += dt
            if sp is not None:
                sp.end()
        obs_metrics.record_event("escalate", key=str(exact_sig),
                                 artifact=fp[:40], seconds=round(dt, 4))
        self._entries[key] = entry
        self._evict()
        return entry

    def drop_fingerprint(self, fingerprint: str) -> int:
        """Drop every entry (and escalation counter) keyed under
        ``fingerprint``.

        Used by promote-on-change: after a re-lower the old artifact's
        entries are unreachable (its fingerprint is never asked for
        again) but would otherwise pin compiled executables in the LRU
        until enough newer entries forced them out.  Returns the number
        of entries dropped.
        """
        dead = [k for k in self._entries if k[1] == fingerprint]
        for k in dead:
            del self._entries[k]
        self._exact_hits = {k: v for k, v in self._exact_hits.items()
                            if k[0] != fingerprint}
        self._failed_exact = {k for k in self._failed_exact
                              if k[0] != fingerprint}
        return len(dead)

    def discard(self, entry: Any) -> bool:
        """Take ``entry`` out of the cache (an entry whose CUDA graph
        capture failed): the next call of its signature compiles anew.
        Returns whether the cache held it."""
        # an entry may be held inside a wrapper (an SPMD entry's
        # ``entry``)
        keys = [k for k, v in self._entries.items()
                if v is entry or getattr(v, "entry", None) is entry]
        for key in keys:
            del self._entries[key]
        return bool(keys)

    def _evict(self) -> None:
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
            self.stats.evictions += 1

    def __len__(self) -> int:
        return len(self._entries)
