"""Shape-constraint store — DISC §4.2.1.

DISC collects two kinds of shape constraints *at compile time*, without any
concrete shape values:

* **dimension size equality** — dim ``i`` of tensor A equals dim ``j`` of
  tensor B (or another dim of A).  We keep these in a union–find over
  :class:`SymDim`; a symbol can also be *refined* to a concrete int when the
  graph proves it (e.g. equated with a static dim).
* **tensor size equality** — two tensors have the same number of elements
  (e.g. input/output of ``transpose``/``reshape``).  We keep these in a
  union–find over value ids, and additionally decide size equality
  structurally by comparing canonicalized :class:`SizeExpr` forms.

Both sources from the paper are implemented: (1) constraints implied by DHLO
op semantics (see ``propagation.py`` — e.g. ``Add`` operands/results share a
shape), and (2) constraints injected by the *frontend bridge* from high-level
framework ops whose structure is lost on lowering (e.g. ``torch.chunk`` ⇒ all
output slices share a shape; see ``frontends/hints.py``).

The store also tracks **divisibility** facts (``dim % k == 0``), which the
code-generation layer uses for vectorized load/store version selection —
DISC's "more aggressive index calculation simplification".
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple, Union

from .symshape import Dim, SizeExpr, SymDim, SymShape, shape_key, size_of_shape

__all__ = ["ShapeConstraintStore", "ConstraintViolation"]


class ConstraintViolation(Exception):
    """Two facts contradict (e.g. a symbol equated with two distinct ints)."""


class _UnionFind:
    def __init__(self) -> None:
        self.parent: Dict[int, int] = {}
        self.rank: Dict[int, int] = {}

    def find(self, x: int) -> int:
        p = self.parent.setdefault(x, x)
        if p != x:
            p = self.find(p)
            self.parent[x] = p
        return p

    def union(self, a: int, b: int) -> int:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return ra
        if self.rank.get(ra, 0) < self.rank.get(rb, 0):
            ra, rb = rb, ra
        self.parent[rb] = ra
        if self.rank.get(ra, 0) == self.rank.get(rb, 0):
            self.rank[ra] = self.rank.get(ra, 0) + 1
        return ra


class ShapeConstraintStore:
    """Union-find backed store of dim-equality / size-equality / divisibility."""

    def __init__(self) -> None:
        self._dims: Dict[int, SymDim] = {}
        self._dim_uf = _UnionFind()
        # root uid -> concrete int, when a symbol class is refined to a constant
        self._dim_const: Dict[int, int] = {}
        # tensor-size equality over value ids (declared, not only structural)
        self._size_uf = _UnionFind()
        self._value_size: Dict[int, SizeExpr] = {}
        # divisibility facts: root uid -> lcm-ish set of known divisors
        self._divisors: Dict[int, Set[int]] = {}
        # declared/widened upper bounds: root uid -> cap.  Fed by
        # ``Dim(max=...)`` contracts at bridge time and by the region-op
        # carry-widening rule (propagation.carry_fixed_point); consumed by
        # the memory planner's ``DimBounds`` and by padded codegen for
        # widened carry dims (which have no input binding — they pad to
        # the cap).
        self._dim_bounds: Dict[int, int] = {}
        # mesh-divisibility facts (SPMD plan): dim name -> (axes, multiple).
        # A *plan-time* constraint: the bucket policy was tightened so
        # every bucket of the dim is a multiple of the owning mesh axes'
        # size product (repro.dist.spmd).
        self.mesh_divisibility: Dict[str, Tuple[Tuple[str, ...], int]] = {}
        self.n_dim_constraints = 0
        self.n_size_constraints = 0

    # ------------------------------------------------------------- dims --
    def _register(self, d: SymDim) -> None:
        self._dims.setdefault(d.uid, d)

    def canon_dim(self, d: Dim) -> Dim:
        """Canonical representative of a dim: a SymDim root or a concrete int."""
        if isinstance(d, int):
            return d
        self._register(d)
        root = self._dim_uf.find(d.uid)
        if root in self._dim_const:
            return self._dim_const[root]
        return self._dims[root]

    def assert_dim_eq(self, a: Dim, b: Dim) -> None:
        """Record ``a == b`` (dimension size equality constraint)."""
        ca, cb = self.canon_dim(a), self.canon_dim(b)
        if isinstance(ca, int) and isinstance(cb, int):
            if ca != cb:
                raise ConstraintViolation(f"dim conflict: {ca} != {cb}")
            return
        self.n_dim_constraints += 1
        if isinstance(ca, int):
            ca, cb = cb, ca  # make ca symbolic
        assert isinstance(ca, SymDim)
        root = self._dim_uf.find(ca.uid)
        if isinstance(cb, int):
            prev = self._dim_const.get(root)
            if prev is not None and prev != cb:
                raise ConstraintViolation(f"dim conflict: {prev} != {cb}")
            self._dim_const[root] = cb
            return
        assert isinstance(cb, SymDim)
        rb = self._dim_uf.find(cb.uid)
        ca_const = self._dim_const.get(root)
        cb_const = self._dim_const.get(rb)
        if ca_const is not None and cb_const is not None and ca_const != cb_const:
            raise ConstraintViolation(f"dim conflict: {ca_const} != {cb_const}")
        merged_div = self._divisors.get(root, set()) | self._divisors.get(rb, set())
        bounds = [x for x in (self._dim_bounds.get(root),
                              self._dim_bounds.get(rb)) if x is not None]
        new_root = self._dim_uf.union(root, rb)
        const = ca_const if ca_const is not None else cb_const
        if const is not None:
            self._dim_const[new_root] = const
        if merged_div:
            self._divisors[new_root] = merged_div
        if bounds:
            self._dim_bounds[new_root] = min(bounds)

    def note_dim_bound(self, d: Dim, bound: int) -> None:
        """Record an upper bound ``d <= bound``.  Tightest bound wins."""
        c = self.canon_dim(d)
        if isinstance(c, int):
            if c > bound:
                raise ConstraintViolation(
                    f"dim bound conflict: {c} > declared max {bound}")
            return
        root = self._dim_uf.find(c.uid)
        prev = self._dim_bounds.get(root)
        self._dim_bounds[root] = int(bound) if prev is None else min(prev, int(bound))

    def dim_bound(self, d: Dim) -> Optional[int]:
        """Known upper bound for ``d``, or None.  Concrete dims bound themselves."""
        c = self.canon_dim(d)
        if isinstance(c, int):
            return c
        return self._dim_bounds.get(self._dim_uf.find(c.uid))

    def dims_equal(self, a: Dim, b: Dim) -> bool:
        ca, cb = self.canon_dim(a), self.canon_dim(b)
        if isinstance(ca, int) and isinstance(cb, int):
            return ca == cb
        if isinstance(ca, SymDim) and isinstance(cb, SymDim):
            return ca.uid == cb.uid
        return False

    def assert_shape_eq(self, sa: SymShape, sb: SymShape) -> None:
        if len(sa) != len(sb):
            raise ConstraintViolation(f"rank mismatch: {sa} vs {sb}")
        for da, db in zip(sa, sb):
            self.assert_dim_eq(da, db)

    # ---------------------------------------------------------- divisors --
    def assert_divisible(self, d: Dim, k: int) -> None:
        c = self.canon_dim(d)
        if isinstance(c, int):
            if c % k != 0:
                raise ConstraintViolation(f"{c} not divisible by {k}")
            return
        self._divisors.setdefault(self._dim_uf.find(c.uid), set()).add(int(k))

    def known_divisors(self, d: Dim) -> Set[int]:
        c = self.canon_dim(d)
        if isinstance(c, int):
            return {k for k in range(1, min(c, 1025)) if c % k == 0}
        return set(self._divisors.get(self._dim_uf.find(c.uid), set())) | {1}

    def note_mesh_divisible(self, name: str,
                            axes: Tuple[str, ...], k: int) -> None:
        """Record an SPMD mesh constraint: dim ``name`` is sharded over
        mesh ``axes`` whose size product is ``k``, and every *bucket* of
        it is a multiple of ``k`` (the planner tightened the policy).

        Deliberately NOT recorded as an ``assert_divisible`` fact on the
        dim itself: the divisibility theorem holds for padded buckets,
        not for the dim's runtime values — the §4.4 escalation path
        compiles exact (possibly non-divisible) shapes, and a false
        divisor fact would mislead vectorization decisions keyed on
        ``known_divisors``."""
        self.mesh_divisibility[name] = (tuple(axes), int(k))

    def is_divisible(self, d: Dim, k: int) -> bool:
        c = self.canon_dim(d)
        if isinstance(c, int):
            return c % k == 0
        divs = self._divisors.get(self._dim_uf.find(c.uid), set())
        return any(known % k == 0 for known in divs)

    # -------------------------------------------------------------- sizes --
    def note_value_size(self, value_id: int, shape: SymShape) -> None:
        self._value_size[value_id] = size_of_shape(shape)

    def assert_size_eq(self, va: int, vb: int) -> None:
        """Record tensor-size equality between two value ids (§4.2.1)."""
        self.n_size_constraints += 1
        self._size_uf.union(va, vb)

    def size_expr(self, value_id: int) -> Optional[SizeExpr]:
        e = self._value_size.get(value_id)
        return e.canonicalize(self.canon_dim) if e is not None else None

    def sizes_equal(self, va: int, vb: int) -> bool:
        """Decide tensor-size equality: declared classes OR structural match."""
        if self._size_uf.find(va) == self._size_uf.find(vb):
            return True
        ea, eb = self.size_expr(va), self.size_expr(vb)
        return ea is not None and eb is not None and ea == eb

    def shapes_equal(self, sa: SymShape, sb: SymShape) -> bool:
        if len(sa) != len(sb):
            return False
        return all(self.dims_equal(a, b) for a, b in zip(sa, sb))

    # ---------------------------------------------------------- summaries --
    def shape_class_key(self, shape: SymShape) -> Tuple:
        """Hashable per-shape key under canonicalization — used by fusion."""
        return shape_key(shape, canon=self.canon_dim)

    def size_class_key(self, value_id: int) -> Tuple:
        root = self._size_uf.find(value_id)
        e = self.size_expr(value_id)
        if e is not None and e.is_static():
            return ("static", e.coeff)
        if e is not None:
            return ("expr", e.coeff, tuple((d.uid, p) for d, p in e.dims))
        return ("class", root)

    def stats(self) -> Dict[str, int]:
        return {
            "dim_constraints": self.n_dim_constraints,
            "size_constraints": self.n_size_constraints,
            "dim_symbols": len(self._dims),
            "mesh_constraints": len(self.mesh_divisibility),
        }
