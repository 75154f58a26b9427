"""Symbolic dimensions and shapes — the substrate of the DHLO-style IR.

DISC (§4.1) keeps *rank* static and lets dimension *sizes* be dynamic.  We
model a dimension as either a concrete ``int`` or a :class:`SymDim` — an
interned symbol.  A :class:`SymDim` carries a *representative value* (the
concrete size used when tracing the function once); representative
values are chosen to be distinct primes so that shape re-symbolization after
shape-destroying ops (``reshape``) can recover symbol structure by
factorization (see ``frontends/fx_frontend.py``).

Tensor *sizes* (element counts) are represented canonically as
:class:`SizeExpr` — ``coeff * prod(dims^power)`` — so that DISC's
*tensor size equality* constraint (§4.2.1) is decidable by canonical-form
comparison after dim-equality canonicalization.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Tuple, Union

__all__ = [
    "SymDim",
    "Dim",
    "SymShape",
    "SizeExpr",
    "dim_value",
    "shape_value",
    "shape_is_static",
    "size_of_shape",
    "fresh_symdim",
    "shape_key",
]

_uid = itertools.count()

# Representative prime values handed out to fresh symbols (skipping tiny
# primes that collide with common static dims like 2/3 heads etc. is not
# needed — we only match *within* a trace, and the frontend assigns them).
_PRIMES = [
    3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67,
    71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127,
]
_prime_iter = itertools.count()


@dataclass(frozen=True)
class SymDim:
    """An interned symbolic dimension (static rank, dynamic size)."""

    name: str
    uid: int
    rep: int  # representative concrete value used during tracing

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"?{self.name}"

    def __hash__(self) -> int:
        return hash(self.uid)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, SymDim) and other.uid == self.uid


Dim = Union[int, SymDim]
SymShape = Tuple[Dim, ...]


def fresh_symdim(name: str, rep: Optional[int] = None) -> SymDim:
    """Create a fresh symbolic dim with a unique representative prime."""
    if rep is None:
        idx = next(_prime_iter)
        rep = _PRIMES[idx % len(_PRIMES)]
        # keep representatives distinct even past the prime table
        rep += 131 * (idx // len(_PRIMES))
    return SymDim(name=name, uid=next(_uid), rep=int(rep))


def dim_value(d: Dim) -> int:
    """Concrete (representative) value of a dim."""
    return d.rep if isinstance(d, SymDim) else int(d)


def shape_value(shape: SymShape) -> Tuple[int, ...]:
    return tuple(dim_value(d) for d in shape)


def shape_is_static(shape: SymShape) -> bool:
    return all(isinstance(d, int) for d in shape)


@dataclass(frozen=True)
class SizeExpr:
    """Canonical element-count expression: ``coeff * prod(dim^power)``.

    ``dims`` is a sorted tuple of ``(SymDim, power)`` pairs.  Canonical under
    a dim-canonicalization function supplied by the constraint store.
    """

    coeff: int
    dims: Tuple[Tuple[SymDim, int], ...]

    @staticmethod
    def from_shape(shape: SymShape) -> "SizeExpr":
        coeff = 1
        counts: Dict[SymDim, int] = {}
        for d in shape:
            if isinstance(d, SymDim):
                counts[d] = counts.get(d, 0) + 1
            else:
                coeff *= int(d)
        dims = tuple(sorted(counts.items(), key=lambda kv: kv[0].uid))
        return SizeExpr(coeff=coeff, dims=dims)

    def canonicalize(self, canon) -> "SizeExpr":
        """Re-express under dim canonicalization ``canon: SymDim -> Dim``.

        A symbol may canonicalize to another symbol *or* be refined to a
        concrete int (when the store learned its value).
        """
        coeff = self.coeff
        counts: Dict[SymDim, int] = {}
        for d, p in self.dims:
            c = canon(d)
            if isinstance(c, int):
                coeff *= c**p
            else:
                counts[c] = counts.get(c, 0) + p
        dims = tuple(sorted(counts.items(), key=lambda kv: kv[0].uid))
        return SizeExpr(coeff=coeff, dims=dims)

    def value(self) -> int:
        v = self.coeff
        for d, p in self.dims:
            v *= d.rep**p
        return v

    def is_static(self) -> bool:
        return not self.dims

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        parts = [str(self.coeff)] if self.coeff != 1 or not self.dims else []
        for d, p in self.dims:
            parts.append(f"{d!r}" + (f"^{p}" if p > 1 else ""))
        return "*".join(parts) if parts else "1"


def size_of_shape(shape: SymShape) -> SizeExpr:
    return SizeExpr.from_shape(shape)


def shape_key(shape: SymShape, canon=None) -> Tuple:
    """Hashable structural key of a shape under optional canonicalization."""
    out = []
    for d in shape:
        if isinstance(d, SymDim):
            c = canon(d) if canon is not None else d
            out.append(("sym", c.uid) if isinstance(c, SymDim) else ("int", c))
        else:
            out.append(("int", int(d)))
    return tuple(out)
