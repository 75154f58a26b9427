"""Bucketing policies — "compile once per fusion pattern" (DESIGN.md §2).

The port compiles **once per (pattern, bucket)** and makes each compiled
artifact *exact* for every shape ≤ bucket by threading actual lengths as
runtime scalars and masking (see ``core/codegen.py``): the generated
kernels take lengths as runtime arguments, so a new length inside a
bucket never recompiles.  Buckets bound the compile count at
O(log max_shape) instead of O(#distinct shapes).

Policies:

* ``pow2``      — round up to granule·2^k (default; log-many buckets)
* ``multiple``  — round up to a multiple of k (linear-many buckets, less
  padding waste; good when shapes cluster)
* ``exact``     — no bucketing: compile per concrete shape.  This *is* the
  static-shape-compiler baseline (the behavior the paper critiques) and is
  used as such in the benchmarks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

__all__ = ["BucketPolicy", "pow2_bucket"]


def pow2_bucket(n: int, granule: int = 1) -> int:
    if n <= granule:
        return granule
    return granule * (1 << math.ceil(math.log2(n / granule)))


@dataclass(frozen=True)
class BucketPolicy:
    kind: str = "pow2"          # "pow2" | "multiple" | "exact"
    granule: int = 16           # pow2: smallest bucket; multiple: the multiple
    # per-symbol overrides: symbol name -> (kind, granule)
    overrides: Tuple[Tuple[str, Tuple[str, int]], ...] = ()
    # per-symbol hard caps (declared ``Dim(max=...)``): buckets are clamped
    # to the cap; a value beyond the cap is a contract violation
    caps: Tuple[Tuple[str, int], ...] = ()

    def _rule(self, symbol_name: str) -> Tuple[str, int]:
        for name, rule in self.overrides:
            if name == symbol_name:
                return rule
        return (self.kind, self.granule)

    def rule(self, symbol_name: str) -> Tuple[str, int]:
        """The effective ``(kind, granule)`` for a symbol — public so the
        SPMD planner can tighten granules to mesh-axis multiples."""
        return self._rule(symbol_name)

    def cap(self, symbol_name: str) -> Optional[int]:
        for name, c in self.caps:
            if name == symbol_name:
                return c
        return None

    def bucket(self, symbol_name: str, value: int) -> int:
        kind, g = self._rule(symbol_name)
        if kind == "exact":
            b = value
        elif kind == "multiple":
            b = g * math.ceil(value / g)
        elif kind == "pow2":
            b = pow2_bucket(value, g)
        else:
            raise ValueError(f"unknown bucket kind {kind}")
        c = self.cap(symbol_name)
        if c is not None:
            if value > c:
                raise ValueError(
                    f"dim {symbol_name}={value} exceeds its declared "
                    f"max={c}")
            b = min(b, c)
        return b

    def emit_bucket_expr(self, symbol_name: str, var: str) -> Optional[str]:
        """A Python expression computing ``self.bucket(symbol_name, v)``
        for the source variable ``var`` — *sans* cap handling, which the
        dispatch emitter layers on top.

        This is how the bucket mapping gets *compiled into* the generated
        host flow (DISC §4.2) instead of living behind a per-call closure.
        Returns ``None`` for rules that cannot be inlined (the emitter
        then falls back to a bound ``bucket`` closure).  The pow2 form is
        pure integer math — ``ceil(v/g)`` rounded up to a power of two —
        and agrees with :func:`pow2_bucket` everywhere (see the
        equivalence test in ``tests/test_dispatch_unification.py``).
        """
        kind, g = self._rule(symbol_name)
        if kind == "exact":
            return var
        if kind == "multiple":
            return f"(-(-{var} // {g}) * {g})"
        if kind == "pow2":
            return (f"({g} if {var} <= {g} else "
                    f"{g} * (1 << (-(-{var} // {g}) - 1).bit_length()))")
        return None

    def max_buckets(self, symbol_name: str, max_value: int) -> int:
        """Upper bound on #buckets a symbol can produce up to max_value."""
        kind, g = self._rule(symbol_name)
        if kind == "exact":
            return max_value
        if kind == "multiple":
            return math.ceil(max_value / g)
        return int(math.ceil(math.log2(max(max_value / g, 1)))) + 1

    def padded_fraction(self, symbol_name: str, value: int) -> float:
        """Fraction of wasted (padded) elements for a value — perf metric."""
        b = self.bucket(symbol_name, value)
        return (b - value) / b if b else 0.0


EXACT = BucketPolicy(kind="exact")
POW2 = BucketPolicy(kind="pow2", granule=16)
