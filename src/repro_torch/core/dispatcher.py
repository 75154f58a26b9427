"""Host-dispatch code generation — DISC §4.2 "generated runtime flow".

    "Rather than using an interpreter, DISC compiles and generates the code
     of computations on both host and device side, and also runtime flows
     (buffer management, kernel launch, et al.)."

:func:`generate_dispatch` *generates Python source* for the host-side
dispatch of one compiled artifact — shape extraction, bucket mapping,
cache lookup, padding plan, device invocation, output recovery — and
``exec``s it once.  The per-call path is straight-line host code
specialized to the artifact: no graph walking, no per-op interpretation.

One emitter serves both public pipelines.  Everything pipeline-specific
is factored into a :class:`DispatchLens` — *how* dynamic sizes are
observed, *which* arguments get bucket-padded, and *whether* outputs need
recovery:

* :func:`dhlo_lens` views a DHLO graph (``pipeline="dhlo"``): symbols are
  canonicalized through the constraint store, the true lengths are
  threaded to the masked executor as an ``int32`` tensor on the
  artifact's device (one small host-to-device copy from pinned memory a
  call, no synchronisation; the executor reads it on the device only),
  and outputs are sliced back to their true (possibly derived, §4.2.1)
  shapes on the host, from the host's own lengths.
* :func:`jit_lens` views a spec signature over a plain PyTorch function
  (``pipeline="jit"``): declared dynamic args are bucket-padded, ``None``
  args pass through untouched, ``TreeSpec`` pytrees are leaf-padded, and
  the function's own outputs are returned as-is (jit-pipeline functions
  are lens-aware).

The generated skeleton includes the §4.4 static-escalation branch (hot
exact signatures route to an unpadded specialization) and the tie guards
that back promote-on-change: when a symbol is observable at several
argument sites, the emitter checks the sites still agree and either
re-lowers through ``on_tie_break`` (inferred specs) or raises a contract
error (declared specs).

Padding runs with torch on each argument's own device: a padded bucket is
``torch.zeros`` of the bucket shape on that device with the argument
copied into its leading corner.

This module is pure mechanism: *what* gets compiled per bucket is
supplied by the caller via ``compile_bucket`` / ``compile_exact``
callbacks — the public API layer (``repro_torch.api``) wires those to the
backend registry.

Every call opens a ``dispatch`` span (cat ``dispatch``; args
``artifact``, ``bucket``, ``pad_bytes``, ``cache_hit``, and at its end
``entry_seconds`` or ``error``) when a tracer is installed.  The hook is
emitted unconditionally, so the generated source is the same with and
without a tracer; with none it costs one attribute load and an ``is
None`` test.  ``entry_seconds`` is host time from the entry call to its
return: on the card that is the time to queue the launches (or to
replay the entry's CUDA graph), not the card's execution time.  A
miss's compile counts in the host time before it (``host_seconds``),
as in the JAX package; on the dhlo pipeline that compile includes the
entry's first call (``first_call_compiles``), whose entry window is
then empty.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import torch

from ..errors import CompileError
from ..frontends.fx_frontend import TreeSpec, eval_dim
from ..obs import trace as obs_trace
from ..obs.clock import CLOCK as _obs_clock
from .bucketing import BucketPolicy
from .cache import CompileCache
from .dhlo import DGraph
from .dtypes import as_torch, itemsize
from .symshape import SymDim

__all__ = ["DynAxis", "ArgPlan", "DispatchLens", "DispatchMemStats",
           "dhlo_lens", "jit_lens", "generate_dispatch"]


class DispatchMemStats:
    """Host staging-buffer accounting for one artifact's dispatch.

    The padding plan zero-fills each dynamic argument into a
    bucket-shaped staging buffer on the argument's own device; this
    object tracks those launch bytes per call.  ``cap_bytes`` is the worst
    case (every symbol at its ``Dim.max`` cap) fixed at emit time, so
    ``saved_bytes`` accumulates how much bucketing under-shot the caps.
    The generated flow drops each staging reference right after the entry
    call, and this object keeps the byte trail.

    On top of the staging-byte trail it carries the dynamic-shape cost
    accounting (always on — a handful of dict/int ops per call): a
    per-bucket hit histogram, padded vs *true* element bytes per launch
    (the padding-waste ratio), and the host-dispatch vs entry-call wall
    split (the dispatch-overhead timer).  ``as_dict()`` keeps its
    original staging-only schema (docs capture it); the cost accounting
    is exposed separately via :meth:`cost_dict`.
    """

    __slots__ = ("calls", "last_bytes", "peak_bytes", "total_bytes",
                 "cap_bytes", "saved_bytes", "true_last_bytes",
                 "true_total_bytes", "host_seconds", "entry_seconds",
                 "per_bucket")

    def __init__(self, cap_bytes: Optional[int] = None) -> None:
        self.calls = 0
        self.last_bytes = 0
        self.peak_bytes = 0
        self.total_bytes = 0
        self.cap_bytes = cap_bytes
        self.saved_bytes = 0
        self.true_last_bytes = 0
        self.true_total_bytes = 0
        self.host_seconds = 0.0
        self.entry_seconds = 0.0
        # bucket key -> [calls, padded_bytes, true_bytes,
        #               host_seconds, entry_seconds]
        self.per_bucket: Dict[Tuple, list] = {}

    def note(self, nbytes: int) -> None:
        self.calls += 1
        self.last_bytes = nbytes
        if nbytes > self.peak_bytes:
            self.peak_bytes = nbytes
        self.total_bytes += nbytes
        if self.cap_bytes is not None:
            self.saved_bytes += self.cap_bytes - nbytes

    def note_call(self, key: Tuple, nbytes: int, true_nbytes: int) -> None:
        """One bucketed launch: padded staging bytes vs true bytes."""
        self.note(nbytes)
        self.true_last_bytes = true_nbytes
        self.true_total_bytes += true_nbytes
        pb = self.per_bucket.get(key)
        if pb is None:
            pb = self.per_bucket[key] = [0, 0, 0, 0.0, 0.0]
        pb[0] += 1
        pb[1] += nbytes
        pb[2] += true_nbytes

    def note_times(self, key: Tuple, host_s: float, entry_s: float) -> None:
        """Wall split for one launch: generated host flow vs entry call."""
        self.host_seconds += host_s
        self.entry_seconds += entry_s
        pb = self.per_bucket.get(key)
        if pb is not None:
            pb[3] += host_s
            pb[4] += entry_s

    def as_dict(self) -> Dict[str, Optional[int]]:
        return {"calls": self.calls, "last_bytes": self.last_bytes,
                "peak_bytes": self.peak_bytes,
                "total_bytes": self.total_bytes,
                "cap_bytes": self.cap_bytes,
                "saved_bytes": self.saved_bytes}

    def cost_dict(self) -> Dict[str, Any]:
        """The dynamic-shape cost view: bucket-hit histogram, padding
        waste, and the host-dispatch / entry-call wall split."""
        waste = (1.0 - self.true_total_bytes / self.total_bytes) \
            if self.total_bytes else 0.0
        return {
            "calls": self.calls,
            "bucket_hits": {str(k): v[0]
                            for k, v in sorted(self.per_bucket.items())},
            "pad_waste_ratio": round(waste, 4),
            "padded_bytes": self.total_bytes,
            "true_bytes": self.true_total_bytes,
            "host_dispatch_seconds": round(self.host_seconds, 6),
            "entry_seconds": round(self.entry_seconds, 6),
            "per_bucket": {
                str(k): {"calls": v[0], "padded_bytes": v[1],
                         "true_bytes": v[2],
                         "pad_waste_ratio": round(
                             1.0 - v[2] / v[1], 4) if v[1] else 0.0,
                         "host_dispatch_seconds": round(v[3], 6),
                         "entry_seconds": round(v[4], 6)}
                for k, v in sorted(self.per_bucket.items())},
        }



# ------------------------------------------------------------------ lens --

@dataclass(frozen=True)
class DynAxis:
    """A dynamic axis inside an :class:`ArgPlan`, bound to symbol ``sym``
    (an index into :attr:`DispatchLens.sym_names`)."""

    sym: int


@dataclass(frozen=True)
class ArgPlan:
    """Pad plan for one positional argument.

    ``shape`` entries are ints (static) or :class:`DynAxis` (zero-pad to
    the symbol's bucket).  ``shape=None`` — or a shape with no dynamic
    axis — marks a pass-through argument (e.g. pytrees in the jit
    pipeline): it reaches the entry untouched, with no copy.

    ``tree_axes`` marks a *pytree* argument instead (jit-pipeline
    :class:`~repro_torch.frontends.fx_frontend.TreeSpec`): every tensor
    leaf is zero-padded along each ``(axis, sym)`` pair to the symbol's
    bucket, on the leaf's device.  Such an argument contributes no
    extraction sites or tie guards — a pytree has no single shape to
    observe.
    """

    shape: Optional[Tuple[Union[int, DynAxis], ...]] = None
    dtype: Any = None
    tree_axes: Optional[Tuple[Tuple[int, int], ...]] = None

    @property
    def dynamic(self) -> bool:
        return self.shape is not None and any(
            isinstance(d, DynAxis) for d in self.shape)


@dataclass(frozen=True)
class DispatchLens:
    """Everything graph-specific the dispatch emitter consumes.

    * ``sym_names`` — dynamic symbols, in bucket-key order.
    * ``sym_sites`` — per symbol, every ``(arg, axis)`` where its value is
      observable.  The first site is the extraction site; the rest become
      tie guards (two sites of one symbol must agree at call time).
    * ``args``      — per positional argument, the :class:`ArgPlan`.
    * ``outputs``   — per output, per-axis recovery: ``None`` (keep the
      axis), an int symbol index (slice back to the true length), or a
      callable ``exact -> int`` evaluating a derived dim (§4.2.1 host
      shape calculation).  ``outputs=None`` disables recovery entirely:
      the entry's result is returned as-is.
    * ``pass_lens`` — prepend the true lengths to the entry call, as an
      ``int32`` tensor (DHLO masked executors take it; jit-pipeline
      functions carry lengths as ordinary arguments).
    * ``regions``   — one-line summaries of the artifact's region ops
      (``d.while`` / ``d.scan`` / ``d.cond``), a header of the generated
      dispatch source.
    """

    name: str
    sym_names: Tuple[str, ...]
    sym_sites: Tuple[Tuple[Tuple[int, int], ...], ...]
    args: Tuple[ArgPlan, ...]
    outputs: Optional[Tuple[Tuple[Any, ...], ...]] = ()
    pass_lens: bool = True
    regions: Tuple[str, ...] = ()


def dhlo_lens(graph: DGraph, syms: Sequence[SymDim]) -> DispatchLens:
    """View a DHLO graph through the emitter's lens.

    Symbols are resolved through the constraint store's canonical map, so
    two spec dims the propagation pass proved equal share one extraction
    site + tie guard.
    """
    store = graph.store
    syms = list(syms)
    sym_index = {s.uid: i for i, s in enumerate(syms)}

    sites: List[List[Tuple[int, int]]] = [[] for _ in syms]
    args: List[ArgPlan] = []
    for pi, p in enumerate(graph.params):
        shape: List[Union[int, DynAxis]] = []
        for ax, d in enumerate(p.shape):
            c = store.canon_dim(d) if isinstance(d, SymDim) else d
            if isinstance(c, SymDim):
                sites[sym_index[c.uid]].append((pi, ax))
                shape.append(DynAxis(sym_index[c.uid]))
            else:
                shape.append(int(c))
        args.append(ArgPlan(tuple(shape), as_torch(p.dtype)))

    for i, s in enumerate(syms):
        if not sites[i]:
            raise ValueError(
                f"dynamic symbol {s.name!r} is not observable from any "
                f"input argument; cannot generate dispatch for "
                f"{graph.name!r}")

    dim_exprs = getattr(graph, "dim_exprs", {})
    outputs: List[Tuple[Any, ...]] = []
    for o in graph.outputs:
        axes: List[Any] = []
        for d in o.shape:
            c = store.canon_dim(d) if isinstance(d, SymDim) else d
            if isinstance(c, SymDim):
                if c.uid in sym_index:
                    axes.append(sym_index[c.uid])
                elif dim_exprs.get(c.uid) is None \
                        and dim_exprs.get(d.uid) is None:
                    # bounded dim with no derived expr: keep the padded axis
                    axes.append(None)
                else:
                    axes.append(_derived_dim_evaluator(graph, syms, d))
            else:
                axes.append(None)
        outputs.append(tuple(axes))

    regions: List[str] = []
    for op in graph.ops:
        if op.opcode == "d.while":
            regions.append(
                f"d.while(cond={len(op.attrs['cond_graph'].ops)} ops, "
                f"body={len(op.attrs['body_graph'].ops)} ops)")
        elif op.opcode == "d.scan":
            regions.append(
                f"d.scan(body={len(op.attrs['body_graph'].ops)} ops, "
                f"carries={op.attrs['num_carry']})")
        elif op.opcode == "d.cond":
            regions.append(
                f"d.cond(branches={len(op.attrs['branch_graphs'])})")

    return DispatchLens(
        name=graph.name, sym_names=tuple(s.name for s in syms),
        sym_sites=tuple(tuple(s) for s in sites), args=tuple(args),
        outputs=tuple(outputs), regions=tuple(regions))


def jit_lens(specs: Sequence[Any], sym_names: Sequence[str],
             name: str = "disc") -> DispatchLens:
    """View a spec signature (``pipeline="jit"``) through the emitter's
    lens: string dims are the symbols, ``None`` specs pass through,
    ``TreeSpec`` pytrees are leaf-padded, and outputs need no recovery
    (the function is lens-aware)."""
    sym_names = list(sym_names)
    sym_index = {n: i for i, n in enumerate(sym_names)}
    sites: List[List[Tuple[int, int]]] = [[] for _ in sym_names]
    args: List[ArgPlan] = []
    for ai, spec in enumerate(specs):
        if spec is None:
            args.append(ArgPlan())
            continue
        if isinstance(spec, TreeSpec):
            args.append(ArgPlan(tree_axes=tuple(
                (axis, sym_index[d]) for axis, d in spec.axes)))
            continue
        shape: List[Union[int, DynAxis]] = []
        for ax, d in enumerate(spec.shape):
            if isinstance(d, str):
                sites[sym_index[d]].append((ai, ax))
                shape.append(DynAxis(sym_index[d]))
            else:
                shape.append(int(d))
        if any(isinstance(d, DynAxis) for d in shape):
            args.append(ArgPlan(tuple(shape), as_torch(spec.dtype)))
        else:
            args.append(ArgPlan())  # fully static: no copy needed
    for i, n in enumerate(sym_names):
        if not sites[i]:
            raise ValueError(
                f"dynamic symbol {n!r} is not observable from any "
                f"argument spec; cannot generate dispatch for {name!r}")
    return DispatchLens(
        name=name, sym_names=tuple(sym_names),
        sym_sites=tuple(tuple(s) for s in sites), args=tuple(args),
        outputs=None, pass_lens=False)


def _derived_dim_evaluator(graph: DGraph, syms: Sequence[SymDim], dim):
    """Host-side shape calculation for a derived output dim (§4.2.1)."""
    syms = list(syms)

    def _eval(exact: Tuple[int, ...]) -> int:
        binds = {s.uid: v for s, v in zip(syms, exact)}
        return eval_dim(graph, dim, binds)

    return _eval


def _tie_error(name: str, site_a: Tuple[int, int], va: int,
               site_b: Tuple[int, int], vb: int):
    raise ValueError(
        f"dim {name!r} is tied across arguments (declared with one symbol, "
        f"or inferred equal from the first call), but this call breaks the "
        f"tie: arrays[{site_a[0]}].shape[{site_a[1]}] == {va} vs "
        f"arrays[{site_b[0]}].shape[{site_b[1]}] == {vb}")


def _cap_error(name: str, value: int, cap: int):
    raise ValueError(f"dim {name}={value} exceeds its declared max={cap}")


def _lens_maker(device) -> Callable[[List[int]], torch.Tensor]:
    """The true lengths of a call as an ``int32`` tensor on ``device``:
    on a card staged in pinned memory and copied without synchronising
    (the caching host allocator keeps the staging block until the copy
    is done)."""
    device = torch.device(device)
    if device.type != "cuda":
        return lambda vals: torch.tensor(vals, dtype=torch.int32,
                                         device=device)

    def make(vals):
        return torch.tensor(vals, dtype=torch.int32, pin_memory=True).to(
            device, non_blocking=True)

    return make


def _tree_padder(tree_axes: Tuple[Tuple[int, int], ...]) -> Callable:
    """Bucket-pad every tensor leaf of a pytree argument (``TreeSpec``):
    a zero tensor of the bucket shape on the leaf's own device, with the
    leaf copied into its leading corner (the leaves are typically
    resident card tensors, e.g. gathered KV-cache rows)."""
    def pad_leaf(x, key):
        shape = getattr(x, "shape", None)
        if shape is None:
            return x
        want = list(shape)
        for axis, sym in tree_axes:
            if axis < len(want) and want[axis] < key[sym]:
                want[axis] = key[sym]
        if want == list(shape):
            return x
        buf = x.new_zeros(want)
        buf[tuple(slice(0, n) for n in shape)] = x
        return buf

    def pad(tree, key):
        return torch.utils._pytree.tree_map(lambda x: pad_leaf(x, key),
                                            tree)

    return pad



# --------------------------------------------------------------- emitter --

def generate_dispatch(
    lens: DispatchLens,
    policy: BucketPolicy,
    cache: CompileCache,
    compile_bucket: Callable[[Tuple[int, ...]], Any],
    compile_exact: Optional[Callable[[], Callable]] = None,
    *,
    fingerprint: Optional[str] = None,
    escalation_threshold: Optional[int] = None,
    on_tie_break: Optional[Callable[[Sequence[Any]], Any]] = None,
    memory_plan: Optional[Any] = None,
    lens_device: Any = "cpu",
    first_call_compiles: bool = False,
    sharding: Optional[Any] = None,
    gather: Optional[Callable[[Sequence[Any]], List[Any]]] = None,
) -> Tuple[Callable, str]:
    """Generate the per-call host flow for one artifact, seen through
    ``lens``.

    Returns ``(dispatch, source)`` where ``dispatch(arrays)`` is the
    compiled host function returning the list of recovered outputs and
    ``source`` the generated Python text (kept as an inspectable artifact
    on the public ``Compiled`` object).

    ``fingerprint`` defaults to ``cache.fingerprint``; pass the artifact's
    own fingerprint when several artifacts share one cache.  The §4.4
    escalation branch is emitted when an ``escalation_threshold`` (or the
    cache's default) and ``compile_exact`` are given.  ``on_tie_break``
    handles a call that breaks a multi-site symbol tie (promote-on-change
    re-lowering); without it such a call raises a contract error.

    ``memory_plan`` is the lowered artifact's
    :class:`~repro_torch.core.buffers.BufferPlan`: its bucket-generic
    alloc/reuse/free lines are emitted into the generated source as the
    memory-plan block, and the per-call staging accounting
    (``dispatch._mstats``, a :class:`DispatchMemStats`) is recorded
    against the plan's worst-case cap bytes.

    ``lens_device`` is where the entry reads the true lengths
    (``lens.pass_lens``): an ``int32`` tensor made there each call,
    through pinned memory and a copy that does not synchronise on a
    card.

    ``first_call_compiles`` makes a new entry's first call part of its
    compile, inside the compile cache's retry ladder: ``compile_bucket``
    then takes ``(key, args)`` and ``compile_exact`` ``(args)``, and each
    returns the entry with the outputs of its first call on ``args``.
    The dhlo pipeline asks for it: that call is the port's trace, as the
    JAX package's ``jit(...).lower(...).compile()`` is (it runs the
    cluster kernels for the first time, the ``kernel.cluster`` site, and
    captures the CUDA graph), and writes none of its arguments, so a
    transient failure there is retried as a failed compile is.  The jit
    pipeline's functions may write their pass-through arguments in
    place (a KV cache), so their first call stays outside the ladder,
    in the entry window, where the JAX package's lazy ``jax.jit`` traces.

    ``sharding`` is an SPMD :class:`~repro_torch.dist.spmd.ShardingPlan`:
    the generated flow then lays every padded bucket buffer out as a
    DTensor with its planned placements (``_put{i}``: each rank keeps its
    slice of the buffer all ranks hold, buckets dividing the mesh axes
    evenly by the plan's tightened policy), static arguments per the
    profile's weight layout, pytree arguments through the plan's per-leaf
    sharder; the lens vector stays replicated, and the escalation branch
    re-fits the layouts to the exact shapes.  ``gather`` (the dhlo
    pipeline's) turns the entry's DTensor outputs into whole tensors
    before they are sliced back to their true shapes.
    """
    fingerprint = fingerprint or cache.fingerprint
    if escalation_threshold is None:
        escalation_threshold = cache.escalation_threshold
    if compile_exact is None:
        escalation_threshold = None
    n_syms = len(lens.sym_names)

    # --- staging-byte accounting: padded launch bytes per call ---------
    byte_terms: List[str] = []
    true_terms: List[str] = []
    cap_bytes: Optional[int] = 0
    for ap in lens.args:
        if not ap.dynamic:
            continue
        isz = itemsize(ap.dtype)
        parts, true_parts, cap_prod = [], [], isz
        for d in ap.shape:
            if isinstance(d, DynAxis):
                parts.append(f"key[{d.sym}]")
                true_parts.append(f"s_{d.sym}")
                cap = policy.cap(lens.sym_names[d.sym])
                cap_prod = None if (cap is None or cap_prod is None) \
                    else cap_prod * cap
            else:
                parts.append(str(d))
                true_parts.append(str(d))
                if cap_prod is not None:
                    cap_prod *= d
        byte_terms.append(f"{isz}*" + "*".join(parts))
        true_terms.append(f"{isz}*" + "*".join(true_parts))
        cap_bytes = None if (cap_bytes is None or cap_prod is None) \
            else cap_bytes + cap_prod
    mstats = DispatchMemStats(cap_bytes=cap_bytes or None)
    bytes_expr = " + ".join(byte_terms) if byte_terms else "0"
    true_bytes_expr = " + ".join(true_terms) if true_terms else "0"

    # --- region-op block: control flow runs inside the bucket's entry -----
    header: List[str] = []
    if lens.regions:
        header.append("# -- region ops (control flow traced INTO the "
                      "bucketed artifact; the")
        header.append("#    bucket key below is entry shapes only — "
                      "iteration-varying shapes")
        header.append("#    never multiply compile counts) --")
        for r in lens.regions:
            header.append(f"#   {r}")

    # --- memory-plan block: the wrapper-IR view of the buffer plan -----
    if memory_plan is not None and getattr(memory_plan, "lines_text", None):
        rc = dict(memory_plan.reuse_counts)
        header.append("# -- memory plan (bucket-generic, symbolic; every "
                      "bucket entry realizes it) --")
        header.append(f"#   slots={memory_plan.n_slots} "
                      f"values={memory_plan.n_values} reuse={rc}")
        header.append(f"#   peak = {memory_plan.symbolic_peak()}  "
                      f"(no reuse: {memory_plan.symbolic_peak_no_reuse()})")
        for ln in memory_plan.lines_text:
            header.append(f"#   {ln}")

    lines: List[str] = ["def _dispatch(arrays):"]
    w = lines.append
    ns: Dict[str, Any] = {
        "_torch": torch,
        "_fp": fingerprint,
        "_esc": escalation_threshold,
        "_cache": cache,
        "_clk": _obs_clock,
        "_trace": obs_trace,
        "_name": lens.name,
    }

    # dispatch-overhead timer (always on): host flow vs entry call
    w("    _t0 = _clk()")

    # --- dynamic-size extraction: one site per symbol, straight-line ---
    for i in range(n_syms):
        pi, ax = lens.sym_sites[i][0]
        w(f"    s_{i} = arrays[{pi}].shape[{ax}]")

    # --- tie guards: remaining sites of a symbol must agree -----------
    any_guard = False
    for i, name in enumerate(lens.sym_names):
        first = lens.sym_sites[i][0]
        for (pi, ax) in lens.sym_sites[i][1:]:
            any_guard = True
            w(f"    if arrays[{pi}].shape[{ax}] != s_{i}:")
            if on_tie_break is not None:
                w("        return _tie_break(arrays)")
            else:
                w(f"        _tie_error({name!r}, {first!r}, s_{i}, "
                  f"{(pi, ax)!r}, arrays[{pi}].shape[{ax}])")
    if any_guard:
        if on_tie_break is not None:
            ns["_tie_break"] = on_tie_break
        else:
            ns["_tie_error"] = _tie_error

    # --- bucket key: inlined bucket math where the policy supports it --
    key_parts: List[str] = []
    for i, name in enumerate(lens.sym_names):
        expr = policy.emit_bucket_expr(name, f"s_{i}")
        cap = policy.cap(name)
        if expr is None:
            # opaque rule: fall back to a bound closure (cap included)
            ns[f"_b{i}"] = (lambda v, _p=policy, _n=name: _p.bucket(_n, int(v)))
            key_parts.append(f"_b{i}(s_{i})")
            continue
        if cap is not None:
            w(f"    if s_{i} > {cap}:")
            w(f"        _cap_error({name!r}, s_{i}, {cap})")
            ns["_cap_error"] = _cap_error
            expr = f"min({expr}, {cap})"
        key_parts.append(expr)
    if n_syms:
        w("    key = (" + ", ".join(key_parts) + ",)")
        w("    exact = (" + ", ".join(f"s_{i}" for i in range(n_syms)) + ",)")
    else:
        w("    key = ()")
        w("    exact = ()")

    # --- §4.4 static escalation: hot exact signatures go unpadded ------
    if escalation_threshold is not None:
        # degradation ladder: a failed escalation compile falls back to
        # the padded bucket artifact below — permanent failures pin the
        # exact sig (should_escalate answers False thereafter), transient
        # ones may escalate again on a later call
        w("    if _cache.should_escalate(exact, _fp, _esc):")
        if sharding is not None:
            # under a mesh, exact shapes need not divide the axes:
            # re-fit the planned layouts to the concrete shapes per arg
            w("        arrays = _put_exact(arrays)")
            ns["_put_exact"] = sharding.put_exact
        w("        try:")
        w("            fn, outs = _exact(exact, arrays)")
        w("        except _CompileError as _ce:")
        w("            fn = None")
        w("            if not _ce.transient:")
        w("                _cache.note_escalation_failure(exact, _fp)")
        w("        if fn is not None:")
        w("            if outs is None:")
        w("                outs = fn(*arrays)")
        if lens.outputs is None:
            w("            return outs")
        elif gather is not None:
            w("            return _gather(outs)")
        else:
            w("            return list(outs)")
        ns["_CompileError"] = CompileError

    w(f"    _pb = {bytes_expr}")
    w(f"    _tb = {true_bytes_expr}")
    w("    _mstats.note_call(key, _pb, _tb)")
    ns["_mstats"] = mstats
    w("    entry = _get(('bucket', _fp, key))")
    # the span hook is emitted unconditionally (the source is identical
    # whether tracing is on or off): one attribute load and an `is None`
    # test when it is off
    w("    _tr = _trace.ACTIVE")
    w("    _sp = _tr.begin('dispatch', cat='dispatch', artifact=_name, "
      "bucket=key, pad_bytes=_pb - _tb, cache_hit=entry is not None) "
      "if _tr is not None else None")
    if lens.pass_lens:
        w("    lens = _lens([" + ", ".join(f"s_{i}" for i in range(n_syms))
          + "])")
        ns["_lens"] = _lens_maker(lens_device)

    # --- padding plan: unrolled per argument (device-side zero-fill) ---
    call_args: List[str] = []
    for ai, ap in enumerate(lens.args):
        if ap.tree_axes:
            # pytree argument (TreeSpec): leaf-pad to the bucket key
            w(f"    x{ai} = _padtree{ai}(arrays[{ai}], key)")
            ns[f"_padtree{ai}"] = _tree_padder(ap.tree_axes)
            sharder = (sharding.tree_sharder(ai) if sharding is not None
                       else None)
            if sharder is not None:
                w(f"    x{ai} = _shardtree{ai}(x{ai})")
                ns[f"_shardtree{ai}"] = sharder
            call_args.append(f"x{ai}")
            continue
        put = (sharding.arg_put(ai, static=not ap.dynamic)
               if sharding is not None else None)
        if not ap.dynamic:
            if put is not None:
                # static argument: the profile's weight layout, fitted
                # at plan time
                w(f"    x{ai} = _put{ai}(arrays[{ai}])")
                ns[f"_put{ai}"] = put
                call_args.append(f"x{ai}")
            else:
                call_args.append(f"arrays[{ai}]")
            continue
        shape_expr = [f"key[{d.sym}]" if isinstance(d, DynAxis) else str(d)
                      for d in ap.shape]
        pshape = ("(" + ", ".join(shape_expr)
                  + ("," if len(shape_expr) == 1 else "") + ")")
        var = f"x{ai}"
        w(f"    {var} = arrays[{ai}]")
        w(f"    if tuple({var}.shape) != {pshape}:")
        w(f"        _buf = _torch.zeros({pshape}, dtype=_dt{ai}, "
          f"device={var}.device)")
        idx = ", ".join(
            (f":{var}.shape[{ax}]" if isinstance(d, DynAxis) else ":")
            for ax, d in enumerate(ap.shape))
        w(f"        _buf[{idx}] = {var}")
        w(f"        {var} = _buf")
        ns[f"_dt{ai}"] = as_torch(ap.dtype)
        if put is not None:
            # padded bucket → its planned layout (buckets are mesh-axis
            # multiples by the tightened policy: the split is even)
            w(f"    {var} = _put{ai}({var})")
            ns[f"_put{ai}"] = put
        call_args.append(var)

    entry_args = ", ".join((["lens"] if lens.pass_lens else []) + call_args)
    args_tuple = f"({entry_args},)" if entry_args else "()"
    # a miss compiles in the host window, as the JAX package's does; on
    # the dhlo pipeline its compile includes the entry's first call
    w("    outs = None")
    w("    if entry is None:")
    w("        try:")
    w(f"            entry, outs = _compile(key, {args_tuple})")
    w("        except BaseException:")
    w("            if _sp is not None:")
    w("                _sp.end(error=True)")
    w("            raise")
    w("    _t1 = _clk()")
    w("    try:")
    w("        if outs is None:")
    w(f"            outs = entry({entry_args})")
    w("    except BaseException:")
    w("        if _sp is not None:")
    w("            _sp.end(error=True)")
    w("        raise")
    w("    _t2 = _clk()")
    w("    _mstats.note_times(key, _t1 - _t0, _t2 - _t1)")
    w("    if _sp is not None:")
    w("        _sp.end(entry_seconds=_t2 - _t1)")
    # staging buffers: drop each reference right after the entry call —
    # the plan's free discipline applied to the host flow
    for var in call_args:
        if not var.startswith("arrays["):
            w(f"    {var} = None  # plan: free staging")

    # --- output recovery: slice back to true shapes (dhlo only) --------
    if lens.outputs is None:
        w("    return outs")
    elif gather is not None:
        # DTensor outputs → whole tensors (the output gather)
        w("    outs = _gather(outs)")
        ns["_gather"] = gather
    out_exprs = []
    for oi, axes in enumerate(lens.outputs or ()):
        idx_parts = []
        needs_slice = False
        for ax, a in enumerate(axes):
            if a is None:
                idx_parts.append(":")
            elif isinstance(a, int):
                idx_parts.append(f":s_{a}")
                needs_slice = True
            else:  # derived-dim evaluator (host shape calc, §4.2.1)
                idx_parts.append(f":_od{oi}_{ax}(exact)")
                ns[f"_od{oi}_{ax}"] = a
                needs_slice = True
        if needs_slice:
            out_exprs.append(f"outs[{oi}][{', '.join(idx_parts)}]")
        else:
            out_exprs.append(f"outs[{oi}]")
    if lens.outputs is not None:
        w("    return [" + ", ".join(out_exprs) + "]")

    src = "\n".join(header + lines)

    # namespace bound once at generation time (compiled host flow)
    _entries_get = cache._entries.get
    _move_to_end = cache._entries.move_to_end
    _stats = cache.stats

    def _get(key):
        e = _entries_get(key)
        if e is not None:
            _stats.hits += 1
            _move_to_end(key)  # keep hot buckets at the LRU tail
        return e

    def _ladder(get: Callable[[Callable[[], Any]], Any],
                build: Callable[[], Tuple[Any, Any]]):
        """``get(compile_fn)``'s entry where ``build`` returns an entry with
        its first call's outputs, and those outputs (``None`` where the
        entry came out of the cache)."""
        out: List[Any] = []

        def compile_fn():
            entry, outs = build()
            out.append(outs)
            return entry

        return get(compile_fn), (out[-1] if out else None)

    if first_call_compiles:
        def _compile(key, args):
            return _ladder(lambda f: cache.get_or_compile(
                key, f, fingerprint=fingerprint),
                lambda: compile_bucket(key, args))

        def _exact(sig, arrays):
            return _ladder(lambda f: cache.get_or_compile_exact(
                sig, f, fingerprint), lambda: compile_exact(arrays))
    else:
        def _compile(key, args):
            return cache.get_or_compile(key, lambda: compile_bucket(key),
                                        fingerprint=fingerprint), None

        def _exact(sig, arrays):
            return cache.get_or_compile_exact(sig, compile_exact,
                                              fingerprint), None

    ns["_get"] = _get
    ns["_compile"] = _compile
    ns["_exact"] = _exact

    exec(compile(src, f"<disc-dispatch:{lens.name}>", "exec"), ns)
    # out of its own globals: a function in the namespace it reads is a
    # cycle, which would keep the cache's entries until a gc pass
    dispatch = ns.pop("_dispatch")
    dispatch._mstats = mstats          # staging accounting (report)
    dispatch._memory_plan = memory_plan
    return dispatch, src
