"""Symbolic-shape memory planning — DISC §4.2.2 / BladeDISC++.

    "With emitted codes calculating shapes of each buffer at runtime, DISC
     is able to manage the buffer dynamically by emitting alloc and dealloc
     instructions ... 1) Based on shape constraint in the IR, performing
     buffer liveness analysis and optimization; 2) Lowering the alloc and
     dealloc with a cached allocator."

The planner here is *bucket-generic*: liveness intervals are expressed in
``Dim`` symbols and the reuse/donation assignment is decided once at
``lower()`` time, then holds for **every** bucket of the artifact.  Three
layers:

* :func:`liveness` + :func:`plan_buffers` — compile-time liveness analysis
  over the DHLO graph.  Reuse fires when interval byte-sizes are related
  under the symbolic comparison lattice (:func:`compare_sizes`): ``eq``
  when the canonical :class:`ByteSize` forms match, ``le`` when ``Dim.max``
  caps and ``multiple_of``/divisibility facts *prove* one size fits inside
  the other for every admissible binding, ``unknown`` otherwise.  In-place
  consumers (``dynamic_update_slice``/``scatter_add``) *donate* the dying
  operand's slot to their result.
* The plan compiles to an explicit wrapper IR —
  :class:`AllocLine`/:class:`ReuseLine`/:class:`DonateLine`/
  :class:`FreeLine` (inductor's ``MemoryPlanningLine`` shape) — which the
  dispatch emitter renders into generated source, the interpreted VM
  and the executor realizes by dropping each dead value's last
  reference (``BufferPlan.frees_after``), so PyTorch's caching allocator
  hands the storage to the next allocation of that size.
* :class:`CachedArena` — the runtime cached allocator of §4.2.2: free
  lists keyed by dtype, byte size and device, so an alloc of a recurring
  size is O(1).  It is the JAX package's API twin only: no executor of
  the port allocates through it, since dropping a value's last reference
  already hands its storage to PyTorch's caching allocator.

``plan_report`` quantifies peak memory over the program (per binding),
counting a donated output and its donor as *one* buffer — graph outputs
produced by an in-place consumer are not double-counted as live-to-end.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from .dhlo import DGraph, DValue
from .dtypes import as_torch, dtype_key
from .dtypes import itemsize as _itemsize
from .symshape import SizeExpr, SymDim

__all__ = ["liveness", "plan_buffers", "plan_report", "BufferPlan",
           "ByteSize", "DimBounds", "compare_sizes", "CachedArena",
           "MemoryPlanningLine", "AllocLine", "ReuseLine", "DonateLine",
           "FreeLine"]

# ops whose result may take over an operand's storage in place (when the
# operand is dead or donated)
_DONATING_OPS = {"dynamic_update_slice": 0, "scatter_add": 0}


def liveness(graph: DGraph) -> Dict[int, Tuple[int, int]]:
    """value id -> (def index, last-use index) over the topological op list."""
    spans: Dict[int, Tuple[int, int]] = {}
    for p in graph.params:
        spans[p.vid] = (-1, -1)
    for i, op in enumerate(graph.ops):
        for v in op.all_operands():
            if v.vid in spans:
                d, _ = spans[v.vid]
                spans[v.vid] = (d, i)
            else:  # constant
                spans[v.vid] = (-1, i)
        for o in op.outputs:
            spans[o.vid] = (i, i)
    n = len(graph.ops)
    for o in graph.outputs:
        if o.vid in spans:
            d, _ = spans[o.vid]
            spans[o.vid] = (d, n)  # outputs live past the end
    return spans


# ------------------------------------------------------- size lattice --

@dataclass(frozen=True)
class ByteSize:
    """Canonical symbolic byte size: ``coeff * prod(dim^power)`` bytes.

    ``dims`` is sorted by symbol *name* (stable across processes — uids
    are process-local counters) and derived product dims are expanded to
    their base symbols where the frontend recorded a ``("mul", ...)``
    expression, so ``reshape(B, S) -> (B*S,)`` compares equal.
    """

    coeff: int
    dims: Tuple[Tuple[SymDim, int], ...]

    def render(self) -> str:
        parts = ([str(self.coeff)]
                 if self.coeff != 1 or not self.dims else [])
        for d, p in self.dims:
            parts.append(d.name + (f"^{p}" if p > 1 else ""))
        return "*".join(parts) if parts else "1"

    def eval(self, bindings: Dict[int, int], graph: DGraph) -> int:
        from ..frontends.fx_frontend import eval_dim
        v = self.coeff
        for d, p in self.dims:
            v *= eval_dim(graph, d, bindings) ** p
        return v

    def is_static(self) -> bool:
        return not self.dims


def _value_byte_size(graph: DGraph, v: DValue) -> ByteSize:
    """Canonical symbolic byte size of one value (dtype folded in)."""
    store = graph.store
    dim_exprs = getattr(graph, "dim_exprs", {})
    itemsize = _itemsize(v.dtype) if v.dtype is not None else 4
    coeff = itemsize
    counts: Dict[SymDim, int] = {}

    def add(d, power: int) -> None:
        nonlocal coeff
        c = store.canon_dim(d) if isinstance(d, SymDim) else d
        if isinstance(c, int):
            coeff *= c ** power
            return
        expr = dim_exprs.get(c.uid)
        if expr is not None and expr[0] == "mul":
            for x in expr[1]:
                add(x, power)
            return
        counts[c] = counts.get(c, 0) + power

    for d in v.shape:
        add(d, 1)
    dims = tuple(sorted(counts.items(), key=lambda kv: (kv[0].name, kv[0].uid)))
    return ByteSize(coeff=coeff, dims=dims)


class DimBounds:
    """Provable per-dim bounds, the facts feeding the ``le`` proofs.

    * upper bounds come from ``Dim(max=...)`` caps on the bucket policy
      (runtime values beyond the cap are a contract violation, and
      buckets clamp there) and from constants the store refined;
    * lower bounds come from divisibility facts (``dim % k == 0`` with
      sizes >= 1 implies ``dim >= k``) — ``multiple_of`` contracts land
      in the store as divisors via the frontend/policy;
    * derived dims bound through their recorded ``dim_exprs``.
    """

    def __init__(self, graph: DGraph, policy: Optional[Any] = None) -> None:
        self.graph = graph
        self.store = graph.store
        self.dim_exprs = getattr(graph, "dim_exprs", {})
        # canonical uid -> cap, from every named member of the class
        self._caps: Dict[int, int] = {}
        if policy is not None:
            for d in self.store._dims.values():
                cap = policy.cap(d.name)
                if cap is None:
                    continue
                c = self.store.canon_dim(d)
                if isinstance(c, SymDim):
                    prev = self._caps.get(c.uid)
                    self._caps[c.uid] = cap if prev is None else min(prev, cap)

    def ub(self, d) -> Optional[int]:
        """Provable upper bound of a dim, or None."""
        if isinstance(d, int):
            return d
        c = self.store.canon_dim(d)
        if isinstance(c, int):
            return c
        # bounds recorded in the store (Dim.max declarations, region-op
        # carry widening) combine with policy caps: tightest wins
        cands = [x for x in (self._caps.get(c.uid), self.store.dim_bound(c))
                 if x is not None]
        if cands:
            return min(cands)
        expr = self.dim_exprs.get(c.uid)
        if expr is None:
            return None
        tag = expr[0]
        if tag == "mul":
            v = 1
            for x in expr[1]:
                u = self.ub(x)
                if u is None:
                    return None
                v *= u
            return v
        if tag == "sum":
            v = 0
            for x in expr[1]:
                u = self.ub(x)
                if u is None:
                    return None
                v += u
            return v
        if tag == "affine":  # a*base + b
            _, base, a, b = expr
            u = self.ub(base) if a > 0 else self.lb(base)
            if u is None:
                return None
            return a * u + b
        if tag == "div":
            _, base, k = expr
            u = self.ub(base)
            return None if u is None else u // k
        return None

    def lb(self, d) -> int:
        """Provable lower bound of a dim (>= 1: extents are positive)."""
        if isinstance(d, int):
            return d
        c = self.store.canon_dim(d)
        if isinstance(c, int):
            return c
        divs = self.store.known_divisors(c)
        lo = max(divs) if divs else 1
        expr = self.dim_exprs.get(c.uid)
        if expr is not None:
            tag = expr[0]
            if tag == "mul":
                v = 1
                for x in expr[1]:
                    v *= self.lb(x)
                lo = max(lo, v)
            elif tag == "sum":
                lo = max(lo, sum(self.lb(x) for x in expr[1]))
            elif tag == "affine":
                _, base, a, b = expr
                if a > 0:
                    lo = max(lo, a * self.lb(base) + b)
        return max(lo, 1)


def compare_sizes(a: ByteSize, b: ByteSize, bounds: DimBounds) -> str:
    """The symbolic size lattice: ``"eq"`` / ``"le"`` (a <= b for every
    admissible binding) / ``"unknown"``.

    ``le`` is proved by cancelling shared factors, upper-bounding ``a``'s
    surplus dims with their caps and lower-bounding ``b``'s surplus dims
    with their divisibility facts: ``a <= b`` iff
    ``a.coeff * prod(ub(d)^p_surplus_a) <= b.coeff * prod(lb(d)^p_surplus_b)``.
    """
    if a == b:
        return "eq"
    pa = {d.uid: (d, p) for d, p in a.dims}
    pb = {d.uid: (d, p) for d, p in b.dims}
    lhs, rhs = a.coeff, b.coeff
    for uid in set(pa) | set(pb):
        da, xa = pa.get(uid, (None, 0))
        db, xb = pb.get(uid, (None, 0))
        if xa > xb:  # surplus on a's side: needs a cap
            u = bounds.ub(da)
            if u is None:
                return "unknown"
            lhs *= u ** (xa - xb)
        elif xb > xa:  # surplus on b's side: its lower bound helps
            rhs *= bounds.lb(db) ** (xb - xa)
    return "le" if lhs <= rhs else "unknown"


# ----------------------------------------------------------- wrapper IR --

@dataclass(frozen=True)
class MemoryPlanningLine:
    """One step of the memory plan (inductor-wrapper-IR shape): executed
    around op ``index`` — alloc/reuse/donate before the op runs, free
    after it."""

    index: int
    vid: int
    slot: int


@dataclass(frozen=True)
class AllocLine(MemoryPlanningLine):
    size: ByteSize = None  # type: ignore[assignment]


@dataclass(frozen=True)
class ReuseLine(MemoryPlanningLine):
    kind: str = "eq"            # "eq" | "le"
    size: ByteSize = None       # type: ignore[assignment]
    slot_size: ByteSize = None  # type: ignore[assignment]


@dataclass(frozen=True)
class DonateLine(MemoryPlanningLine):
    src_vid: int = -1
    opcode: str = ""


@dataclass(frozen=True)
class FreeLine(MemoryPlanningLine):
    pass


# ----------------------------------------------------------------- plan --

@dataclass
class BufferPlan:
    """Static slot assignment: value id -> slot id (+ the wrapper IR).

    ``symbolic=True`` plans fire ``le`` reuse and donation on top of the
    exact size-class (``eq``) rule; ``symbolic=False`` reproduces the
    per-bucket baseline (each value its own slot, no reuse at all).
    """

    slot_of: Dict[int, int]
    n_slots: int
    n_values: int
    # per-slot size-class key (shape-compatibility class used for reuse)
    slot_class: Dict[int, Tuple]
    # wrapper IR, ordered by op index then kind
    lines: Tuple[MemoryPlanningLine, ...] = ()
    # symbolic byte size of every planned value / of every slot (max member)
    value_size: Dict[int, ByteSize] = field(default_factory=dict)
    slot_size: Dict[int, ByteSize] = field(default_factory=dict)
    reuse_counts: Dict[str, int] = field(default_factory=dict)
    # param indices proven dead before the graph ends (safe donate_argnums)
    donatable_args: Tuple[int, ...] = ()
    # vid -> donor vid for in-place donations
    donated_from: Dict[int, int] = field(default_factory=dict)
    spans: Dict[int, Tuple[int, int]] = field(default_factory=dict)
    symbolic: bool = True

    # ------------------------------------------------------- reporting --
    def report(self, graph: DGraph, bindings: Dict[int, int],
               itemsize: int = 4) -> Dict[str, int]:
        """Concrete total bytes with/without reuse for given dim bindings
        (sum over all values/slots — see :func:`plan_report` for the
        peak-over-time view)."""
        from ..frontends.fx_frontend import eval_dim

        def nbytes(v: DValue) -> int:
            n = 1
            for d in v.shape:
                n *= eval_dim(graph, d, bindings) if not isinstance(d, int) else d
            return n * itemsize

        vals = {v.vid: v for op in graph.ops for v in op.outputs}
        no_reuse = sum(nbytes(v) for v in vals.values())
        slot_bytes: Dict[int, int] = {}
        for vid, v in vals.items():
            s = self.slot_of.get(vid)
            if s is None:
                continue
            slot_bytes[s] = max(slot_bytes.get(s, 0), nbytes(v))
        return {
            "bytes_no_reuse": no_reuse,
            "bytes_with_reuse": sum(slot_bytes.values()),
            "slots": self.n_slots,
            "values": self.n_values,
        }

    def _value_labels(self, graph: DGraph) -> Dict[int, str]:
        """Deterministic per-graph labels (vids are process-local)."""
        labels: Dict[int, str] = {}
        for i, p in enumerate(graph.params):
            labels[p.vid] = f"%p{i}"
        n = 0
        for op in graph.ops:
            for o in op.outputs:
                labels[o.vid] = f"%t{n}"
                n += 1
        return labels

    def render_lines(self, graph: DGraph) -> List[str]:
        """The plan as alloc/reuse/donate/free text — what the dispatch
        emitter embeds in generated source (deterministic: names only)."""
        lab = self._value_labels(graph)
        out: List[str] = []
        for ln in self.lines:
            v = lab.get(ln.vid, f"%{ln.vid}")
            if isinstance(ln, AllocLine):
                out.append(f"op{ln.index}: alloc  {v} -> slot{ln.slot}"
                           f"  [{ln.size.render()} B]")
            elif isinstance(ln, ReuseLine):
                proof = (f"eq {ln.size.render()}" if ln.kind == "eq" else
                         f"le {ln.size.render()} <= {ln.slot_size.render()}")
                out.append(f"op{ln.index}: reuse  {v} -> slot{ln.slot}"
                           f"  ({proof})")
            elif isinstance(ln, DonateLine):
                src = lab.get(ln.src_vid, f"%{ln.src_vid}")
                out.append(f"op{ln.index}: donate {src} -> {v}"
                           f"  (in-place {ln.opcode}, slot{ln.slot})")
            elif isinstance(ln, FreeLine):
                out.append(f"op{ln.index}: free   {v}  (slot{ln.slot})")
        return out

    def frees_after(self, graph: DGraph) -> Dict[int, List[int]]:
        """op index -> vids whose storage dies once that op ran (free +
        donate lines) — the executors drop these references for real."""
        out: Dict[int, List[int]] = defaultdict(list)
        for ln in self.lines:
            if isinstance(ln, FreeLine):
                out[ln.index].append(ln.vid)
            elif isinstance(ln, DonateLine):
                out[ln.index].append(ln.src_vid)
        return dict(out)

    # ----------------------------------------------------- peak algebra --
    def _slot_intervals(self) -> Dict[int, Tuple[int, int]]:
        """slot -> (first def, last live point) over its member values."""
        iv: Dict[int, Tuple[int, int]] = {}
        for vid, s in self.slot_of.items():
            d, l = self.spans[vid]
            if s in iv:
                d0, l0 = iv[s]
                iv[s] = (min(d0, d), max(l0, l))
            else:
                iv[s] = (d, l)
        return iv

    @staticmethod
    def _render_sum(terms: List[ByteSize]) -> str:
        """Σ of byte sizes as a canonical polynomial string (names only —
        deterministic across processes)."""
        acc: Dict[Tuple, int] = {}
        for x in terms:
            k = tuple((d.name, p) for d, p in x.dims)
            acc[k] = acc.get(k, 0) + x.coeff
        parts = []
        for k in sorted(acc, key=lambda k: (-len(k), k)):
            parts.append(ByteSize(acc[k], tuple(
                (SymDim(name=nm, uid=-1, rep=1), p) for nm, p in k)).render())
        return " + ".join(parts) if parts else "0"

    def symbolic_peak(self) -> str:
        """Arena footprint with reuse, as an exact symbolic expression:
        Σ over slots of the slot's (proven-max) byte size.  Holds for
        every bucket — this is what the slot arena keeps resident."""
        return self._render_sum(list(self.slot_size.values()))

    def symbolic_peak_no_reuse(self) -> str:
        """Baseline footprint without liveness analysis: every value its
        own allocation, held to the end (Σ over all values)."""
        return self._render_sum(list(self.value_size.values()))

    def concrete_peaks(self, graph: DGraph,
                       bindings: Dict[int, int]) -> Dict[str, int]:
        """Concrete byte numbers at one binding:

        * ``peak_bytes``     — peak over program points of live *slot*
          bytes (liveness frees applied; donation merges the in-place
          pair into one buffer);
        * ``arena_bytes``    — Σ slot maxes: the resident footprint of a
          slot arena that keeps buffers cached between calls
          (steady-state serving);
        * ``no_reuse_bytes`` — Σ all values: the per-bucket baseline with
          no liveness analysis (alloc per value, free at graph end).
        """
        n = max(len(graph.ops), 1)
        slot_iv = self._slot_intervals()
        slot_b = {s: max(self.value_size[vid].eval(bindings, graph)
                         for vid, sl in self.slot_of.items() if sl == s)
                  for s in slot_iv}
        peak = 0
        for t in range(n):
            live = sum(b for s, b in slot_b.items()
                       if slot_iv[s][0] <= t <= slot_iv[s][1])
            peak = max(peak, live)
        no_reuse = sum(self.value_size[vid].eval(bindings, graph)
                       for vid in self.slot_of)
        return {"peak_bytes": peak,
                "arena_bytes": sum(slot_b.values()),
                "no_reuse_bytes": no_reuse}


def plan_buffers(graph: DGraph, policy: Optional[Any] = None, *,
                 symbolic: bool = True, donation: bool = True) -> BufferPlan:
    """Greedy interval coloring over symbolic liveness intervals.

    Reuse fires on ``eq`` size classes, on ``le``-provable fits (caps +
    divisibility, via :func:`compare_sizes`), and through in-place
    donation — all decided once, holding for every bucket.  With
    ``symbolic=False`` the planner degrades to the per-bucket baseline:
    one slot per value, no sharing (the planning-off contrast used by
    ``benchmarks/bench_buffers.py``); ``donation=False`` additionally
    disables the in-place realization and reports no donatable params.
    """
    spans = liveness(graph)
    store = graph.store
    bounds = DimBounds(graph, policy)
    interm = [o for op in graph.ops for o in op.outputs]
    n_ops = len(graph.ops)
    out_ids = {o.vid for o in graph.outputs}

    slot_of: Dict[int, int] = {}
    slot_class: Dict[int, Tuple] = {}
    value_size: Dict[int, ByteSize] = {}
    slot_size: Dict[int, ByteSize] = {}
    lines: List[MemoryPlanningLine] = []
    reuse_counts = {"eq": 0, "le": 0, "donated": 0}
    donated_from: Dict[int, int] = {}
    free_slots: List[int] = []                     # dead, reusable
    expiry: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    next_slot = 0

    for v in interm:
        value_size[v.vid] = _value_byte_size(graph, v)

    for i, op in enumerate(graph.ops):
        for s, vid in expiry.pop(i, []):
            free_slots.append(s)
            lines.append(FreeLine(index=i - 1, vid=vid, slot=s))

        # in-place donation: the dying operand's slot becomes the result's
        donor_slot: Optional[int] = None
        donor_vid: Optional[int] = None
        if symbolic and donation and op.opcode in _DONATING_OPS and op.outputs:
            cand = op.inputs[_DONATING_OPS[op.opcode]] if op.inputs else None
            if (cand is not None and cand.vid in slot_of
                    and spans[cand.vid][1] == i
                    and cand.vid not in out_ids
                    and value_size[cand.vid] == value_size[op.outputs[0].vid]):
                donor_slot, donor_vid = slot_of[cand.vid], cand.vid
                # the donor's pending expiry would free the slot out from
                # under the result — the donation subsumes it
                expiry[i + 1] = [(s, vid) for s, vid in expiry[i + 1]
                                 if vid != donor_vid]

        for oi, o in enumerate(op.outputs):
            sz = value_size[o.vid]
            key = store.size_class_key(o.vid)
            if oi == 0 and donor_slot is not None:
                s = donor_slot
                donated_from[o.vid] = donor_vid
                reuse_counts["donated"] += 1
                lines.append(DonateLine(index=i, vid=o.vid, slot=s,
                                        src_vid=donor_vid, opcode=op.opcode))
            elif not symbolic:
                s = next_slot
                next_slot += 1
                slot_class[s] = key
                slot_size[s] = sz
                lines.append(AllocLine(index=i, vid=o.vid, slot=s, size=sz))
            else:
                s = None
                for cand in free_slots:           # first pass: exact class
                    if slot_size[cand] == sz:
                        s, kind = cand, "eq"
                        break
                if s is None:                     # second pass: provable fit
                    best_waste = None
                    for cand in free_slots:
                        if compare_sizes(sz, slot_size[cand], bounds) != "le":
                            continue
                        u = bounds.ub(slot_size[cand].dims[0][0]) \
                            if slot_size[cand].dims else None
                        waste = slot_size[cand].coeff * (u or 1)
                        if best_waste is None or waste < best_waste:
                            s, kind, best_waste = cand, "le", waste
                if s is not None:
                    free_slots.remove(s)
                    reuse_counts[kind] += 1
                    lines.append(ReuseLine(index=i, vid=o.vid, slot=s,
                                           kind=kind, size=sz,
                                           slot_size=slot_size[s]))
                    if kind == "eq":
                        slot_size[s] = sz  # identical class, keep fresh form
                else:
                    s = next_slot
                    next_slot += 1
                    slot_class[s] = key
                    slot_size[s] = sz
                    lines.append(AllocLine(index=i, vid=o.vid, slot=s,
                                           size=sz))
            slot_of[o.vid] = s
            _, last = spans[o.vid]
            if last < n_ops:
                expiry[last + 1].append((s, o.vid))

    for s, vid in expiry.pop(n_ops, []):  # died at the last op
        lines.append(FreeLine(index=n_ops - 1, vid=vid, slot=s))

    # params proven dead before the graph ends: safe donation targets
    donatable = tuple(
        pi for pi, p in enumerate(graph.params)
        if -1 < spans[p.vid][1] < n_ops and p.vid not in out_ids) \
        if donation else ()

    plan = BufferPlan(slot_of=slot_of, n_slots=next_slot,
                      n_values=len(interm), slot_class=slot_class,
                      lines=tuple(lines), value_size=value_size,
                      slot_size=slot_size, reuse_counts=reuse_counts,
                      donatable_args=donatable, donated_from=donated_from,
                      spans=spans, symbolic=symbolic)
    plan._bounds = bounds  # symbolic-peak rendering reuses the fact base
    return plan


def plan_report(graph: DGraph, plan: BufferPlan,
                bindings: Dict[int, int]) -> Dict[str, Any]:
    """Peak-memory report for one concrete binding.

    Donated outputs share their donor's slot interval, so a graph output
    produced by an in-place consumer is charged **once** — the earlier
    planner double-counted the donated operand as live-to-end alongside
    its consumer, overstating reported peaks.
    """
    return {
        **plan.concrete_peaks(graph, bindings),
        "symbolic_peak": plan.symbolic_peak(),
        "symbolic_peak_no_reuse": plan.symbolic_peak_no_reuse(),
        "slots": plan.n_slots,
        "values": plan.n_values,
        "reuse_counts": dict(plan.reuse_counts),
    }


# ----------------------------------------------------------- allocator --

class CachedArena:
    """Runtime cached allocator: free lists keyed by (dtype, nbytes,
    device).  ``peak_bytes`` is the most storage it ever allocated.  An
    API twin of the JAX package's; no code path of the port uses it."""

    def __init__(self) -> None:
        self._free: Dict[Tuple[str, int, str], List[torch.Tensor]] = \
            defaultdict(list)
        self.allocs = 0
        self.reuses = 0
        self.peak_bytes = 0
        self._live_bytes = 0

    @staticmethod
    def _key(dtype, nbytes: int, device) -> Tuple[str, int, str]:
        return (dtype_key(dtype), int(nbytes), str(torch.device(device)))

    def alloc(self, shape: Tuple[int, ...], dtype, *,
              device) -> torch.Tensor:
        dt = as_torch(dtype)
        n = 1
        for d in shape:
            n *= int(d)
        nbytes = n * dt.itemsize
        pool = self._free.get(self._key(dt, nbytes, device))
        if pool:
            self.reuses += 1
            return pool.pop().view(tuple(shape))
        self.allocs += 1
        self._live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self._live_bytes)
        return torch.empty(tuple(shape), dtype=dt, device=device)

    def dealloc(self, buf: torch.Tensor) -> None:
        key = self._key(buf.dtype, buf.numel() * buf.element_size(),
                        buf.device)
        self._free[key].append(buf.reshape(-1))
