"""Per-op shape-propagation table — DISC §4.3 "shape hints collection".

    "DISC maintains a table to indicate the propagation property of each op.
     Some ops may have the same shape propagation property, like Add and Sub.
     We classify ops according to their shape propagation properties in the
     table to avoid repeated enumeration."

Every DHLO opcode is registered once with:

* ``prop``  — its *shape propagation class* (how shapes relate between its
  operands and results).  Fusion and constraint collection dispatch on the
  class, never on individual opcodes.
* ``cost``  — compute-intensive (GEMM/conv — routed to the static-shape
  library, §4.5) vs memory-intensive (fusion targets) vs shape-calculation
  (host-placed, §4.2.1).
* ``pad_identity`` — the value with which a *padded* tail must be filled so
  bucketed execution is exact for ops that mix positions (reductions).

``collect_semantic_constraints`` is the paper's first constraint source:
walking the graph once and asserting the constraints implied by each op's
semantics into the graph's :class:`ShapeConstraintStore`.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from typing import Dict, Optional

from .constraints import ConstraintViolation, ShapeConstraintStore
from .dhlo import DGraph, DOp
from .symshape import SymDim, fresh_symdim

__all__ = [
    "PropClass",
    "CostClass",
    "OpInfo",
    "OP_TABLE",
    "op_info",
    "collect_semantic_constraints",
    "carry_fixed_point",
]


class PropClass(enum.Enum):
    ELEMENTWISE = "elementwise"          # all non-scalar operands/results same shape
    BROADCAST = "broadcast"              # dims map via broadcast_dimensions
    RESHAPE = "reshape"                  # tensor-size preserving, dims remixed
    TRANSPOSE = "transpose"              # size preserving + dim permutation
    REDUCE = "reduce"                    # kept dims equal input dims
    SLICE = "slice"                      # output dims from sizes (static or operand)
    CONCAT = "concat"                    # non-concat dims equal
    DOT = "dot"                          # batch/contracting equality
    GATHER = "gather"                    # indexed
    UPDATE = "update"                    # dynamic_update_slice: result == operand shape
    IOTA = "iota"
    OPAQUE = "opaque"


class CostClass(enum.Enum):
    MEMORY = "memory"      # fusion targets (paper's focus)
    COMPUTE = "compute"    # GEMM/conv: library calls, never fused into loops
    SHAPE = "shape"        # scalar/index math: host-placed


@dataclass(frozen=True)
class OpInfo:
    prop: PropClass
    cost: CostClass = CostClass.MEMORY
    pad_identity: Optional[float] = None  # fill value making padded reduce exact


_E = PropClass.ELEMENTWISE
_M = CostClass.MEMORY

OP_TABLE: Dict[str, OpInfo] = {}


def _reg(names, info: OpInfo) -> None:
    for n in names:
        OP_TABLE[n] = info


# one table row per *propagation class*, exactly as the paper describes
_reg(
    [
        "add", "sub", "mul", "div", "rem", "pow", "max", "min", "and", "or",
        "xor", "shift_left", "shift_right_logical", "shift_right_arithmetic",
        "atan2", "nextafter",
        "lt", "gt", "le", "ge", "eq", "ne",
    ],
    OpInfo(_E, _M),
)
_reg(
    [
        "neg", "exp", "expm1", "log", "log1p", "tanh", "logistic", "sqrt",
        "rsqrt", "cbrt", "abs", "sign", "floor", "ceil", "round", "erf",
        "erfc", "erf_inv", "sin", "cos", "tan", "asin", "acos", "atan",
        "sinh", "cosh", "exp2", "not", "is_finite", "integer_pow",
        "stop_gradient", "copy", "real", "imag", "square",
    ],
    OpInfo(_E, _M),
)
_reg(["select"], OpInfo(_E, _M))
_reg(["convert"], OpInfo(_E, _M))
_reg(["broadcast_in_dim"], OpInfo(PropClass.BROADCAST, _M))
_reg(["reshape"], OpInfo(PropClass.RESHAPE, _M))
_reg(["transpose"], OpInfo(PropClass.TRANSPOSE, _M))
_reg(["rev"], OpInfo(PropClass.TRANSPOSE, _M))
_reg(["reduce_sum"], OpInfo(PropClass.REDUCE, _M, pad_identity=0.0))
_reg(["reduce_max", "argmax"], OpInfo(PropClass.REDUCE, _M, pad_identity=-math.inf))
_reg(["reduce_min", "argmin"], OpInfo(PropClass.REDUCE, _M, pad_identity=math.inf))
_reg(["reduce_prod"], OpInfo(PropClass.REDUCE, _M, pad_identity=1.0))
_reg(["reduce_and"], OpInfo(PropClass.REDUCE, _M, pad_identity=1.0))
_reg(["reduce_or"], OpInfo(PropClass.REDUCE, _M, pad_identity=0.0))
_reg(["cumsum", "cummax", "cumprod"], OpInfo(PropClass.ELEMENTWISE, _M, pad_identity=0.0))
_reg(["dot_general"], OpInfo(PropClass.DOT, CostClass.COMPUTE))
_reg(["conv"], OpInfo(PropClass.OPAQUE, CostClass.COMPUTE))
_reg(["slice"], OpInfo(PropClass.SLICE, _M))
_reg(["dslice"], OpInfo(PropClass.SLICE, _M))          # DHLO dynamic slice
_reg(["dynamic_update_slice"], OpInfo(PropClass.UPDATE, _M))
_reg(["concatenate"], OpInfo(PropClass.CONCAT, _M))
_reg(["pad"], OpInfo(PropClass.SLICE, _M))
_reg(["iota"], OpInfo(PropClass.IOTA, _M))
_reg(["gather", "take"], OpInfo(PropClass.GATHER, _M))
_reg(["scatter_add"], OpInfo(PropClass.UPDATE, _M))
_reg(["sort"], OpInfo(PropClass.ELEMENTWISE, _M))
# region ops (d.* control flow): bodies are nested DGraphs in attrs.
# COMPUTE keeps them out of fusion clusters — a region executes as one
# opaque step (codegen.emit_region_op runs it on the host); its shape
# behavior is captured by the carry fixed-point rule below, not by a
# propagation class.
_reg(["d.while", "d.scan", "d.cond"],
     OpInfo(PropClass.OPAQUE, CostClass.COMPUTE))
# shape-calculation ops (host-placed by the placer, §4.2.1)
_reg(["shape_of", "dim_size", "index_add", "index_mul"], OpInfo(PropClass.OPAQUE, CostClass.SHAPE))


def op_info(opcode: str) -> OpInfo:
    try:
        return OP_TABLE[opcode]
    except KeyError:
        return OpInfo(PropClass.OPAQUE, CostClass.MEMORY)


# --------------------------------------------------------------------------
# Constraint source #1: op semantics (§4.2.1 "captured by the DHLO op
# semantic" — e.g. Transpose preserves tensor size; Add operands share shape)
# --------------------------------------------------------------------------

def collect_semantic_constraints(graph: DGraph) -> None:
    store = graph.store
    for op in graph.ops:
        info = op_info(op.opcode)
        p = info.prop
        if p is PropClass.ELEMENTWISE:
            # elementwise: non-scalar operands/results share a shape, except
            # size-1 dims (the frontends keep implicit rank-equal broadcast
            # in binary ops — a broadcast dim carries no equality
            # information)
            shapes = [v.shape for v in op.inputs if v.rank > 0]
            shapes += [v.shape for v in op.outputs if v.rank > 0]
            for a, b in zip(shapes, shapes[1:]):
                if len(a) != len(b):
                    continue
                for da, db in zip(a, b):
                    if (isinstance(da, int) and da == 1) or \
                       (isinstance(db, int) and db == 1):
                        continue
                    store.assert_dim_eq(da, db)
        elif p is PropClass.BROADCAST:
            bdims = op.attrs.get("broadcast_dimensions", ())
            (out,) = op.outputs
            src = op.inputs[0]
            for in_ax, out_ax in enumerate(bdims):
                d = src.shape[in_ax]
                if not (isinstance(d, int) and d == 1):
                    store.assert_dim_eq(d, out.shape[out_ax])
        elif p in (PropClass.RESHAPE, PropClass.TRANSPOSE):
            (out,) = op.outputs
            src = op.inputs[0]
            store.assert_size_eq(src.vid, out.vid)
            if p is PropClass.TRANSPOSE and "permutation" in op.attrs:
                perm = op.attrs["permutation"]
                for out_ax, in_ax in enumerate(perm):
                    store.assert_dim_eq(src.shape[in_ax], out.shape[out_ax])
            if op.opcode == "rev":
                store.assert_shape_eq(src.shape, out.shape)
        elif p is PropClass.REDUCE:
            (out,) = op.outputs
            src = op.inputs[0]
            axes = set(op.attrs.get("axes", ()))
            kept = [i for i in range(src.rank) if i not in axes]
            if out.rank == len(kept):  # keepdims=False form
                for o_ax, i_ax in enumerate(kept):
                    store.assert_dim_eq(src.shape[i_ax], out.shape[o_ax])
        elif p is PropClass.CONCAT:
            (out,) = op.outputs
            axis = op.attrs.get("dimension", 0)
            for src in op.inputs:
                for ax in range(src.rank):
                    if ax != axis:
                        store.assert_dim_eq(src.shape[ax], out.shape[ax])
        elif p is PropClass.UPDATE:
            (out,) = op.outputs
            store.assert_shape_eq(op.inputs[0].shape, out.shape)
        elif p is PropClass.DOT:
            (out,) = op.outputs
            lhs, rhs = op.inputs[0], op.inputs[1]
            dnums = op.attrs.get("dimension_numbers")
            if dnums is not None:
                (lc, rc), (lb, rb) = dnums
                for a, b in zip(lc, rc):
                    store.assert_dim_eq(lhs.shape[a], rhs.shape[b])
                for a, b in zip(lb, rb):
                    store.assert_dim_eq(lhs.shape[a], rhs.shape[b])


# --------------------------------------------------------------------------
# Carry fixed-point rule for region ops (d.while / d.scan)
# --------------------------------------------------------------------------

def _expr_leaves(dim_exprs, d, acc) -> None:
    if isinstance(d, int):
        return
    expr = dim_exprs.get(d.uid)
    if expr is None:
        acc[d.uid] = d
        return
    tag = expr[0]
    if tag in ("mul", "sum"):
        for x in expr[1]:
            _expr_leaves(dim_exprs, x, acc)
    elif tag in ("affine", "div"):
        _expr_leaves(dim_exprs, expr[1], acc)


def _expr_eval(dim_exprs, d, env):
    if isinstance(d, int):
        return d
    expr = dim_exprs.get(d.uid)
    if expr is None:
        return env[d.uid]
    tag = expr[0]
    if tag == "mul":
        v = 1
        for x in expr[1]:
            v *= _expr_eval(dim_exprs, x, env)
        return v
    if tag == "sum":
        return sum(_expr_eval(dim_exprs, x, env) for x in expr[1])
    if tag == "affine":
        _, base, a, b = expr
        return a * _expr_eval(dim_exprs, base, env) + b
    if tag == "div":
        _, base, k = expr
        return _expr_eval(dim_exprs, base, env) // k
    raise ValueError(f"unknown dim expr {expr}")


def _provably_equal(store: ShapeConstraintStore, dim_exprs, da, db) -> bool:
    """Can ``da == db`` be proved for every admissible symbol binding?

    Structural canonical equality first; otherwise the derived exprs of
    both dims are evaluated at two distinct leaf assignments (the trace
    reps, then reps shifted by per-leaf offsets).  Identity-preserving
    rewrites like ``(S-1)+1`` agree at both points; genuinely varying
    dims (``S//2*2``) disagree at the shifted point.
    """
    if store.dims_equal(da, db):
        return True
    ca = store.canon_dim(da)
    cb = store.canon_dim(db)
    leaves: Dict[int, SymDim] = {}
    try:
        _expr_leaves(dim_exprs, ca, leaves)
        _expr_leaves(dim_exprs, cb, leaves)
        ordered = sorted(leaves.values(), key=lambda s: s.uid)
        p1 = {s.uid: s.rep for s in ordered}
        p2 = {s.uid: s.rep + 16 + 13 * i for i, s in enumerate(ordered)}
        return (_expr_eval(dim_exprs, ca, p1) == _expr_eval(dim_exprs, cb, p1)
                and _expr_eval(dim_exprs, ca, p2)
                == _expr_eval(dim_exprs, cb, p2))
    except (KeyError, ValueError):
        return False


def carry_fixed_point(store: ShapeConstraintStore, dim_exprs,
                      entry_shape, out_shape, *,
                      bounds: Optional[Dict[str, int]] = None,
                      label: str = "carry"):
    """Resolve a loop carry's shape across iterations (d.while / d.scan).

    JAX's trace already guarantees the *representative* sizes of a carry
    and its body output agree; this rule decides what that means
    symbolically, per dim:

    * provably equal (canonically unified, or their derived expressions
      agree at two distinct bindings) — the dims are merged in the store
      and the entry dim is kept;
    * two plain symbols that merely coincide — the function *requires*
      the equality to stay traceable, so it is asserted as a constraint;
    * a derived dim that genuinely varies across iterations — the carry
      **widens** to a fresh bounded symbol carrying the dim's declared
      ``Dim(max=...)`` cap (looked up in ``bounds`` by symbol name, or in
      the store's recorded bounds).  With no cap to widen to, the loop's
      shape behavior is unbounded and a :class:`ConstraintViolation` is
      raised naming the carry.

    Returns the resolved symbolic shape for the region op's output.
    """
    if len(entry_shape) != len(out_shape):
        raise ConstraintViolation(
            f"{label}: rank changes across iterations "
            f"({len(entry_shape)} -> {len(out_shape)})")
    bounds = bounds or {}
    resolved = []
    for i, (din, dout) in enumerate(zip(entry_shape, out_shape)):
        if isinstance(din, int) and isinstance(dout, int):
            if din != dout:
                raise ConstraintViolation(
                    f"{label}: dim {i} changes across iterations "
                    f"({din} -> {dout})")
            resolved.append(din)
            continue
        if _provably_equal(store, dim_exprs, din, dout):
            store.assert_dim_eq(din, dout)
            resolved.append(din)
            continue
        def _plain_symbol(d):
            return (isinstance(d, SymDim)
                    and dim_exprs.get(d.uid) is None
                    and isinstance(store.canon_dim(d), SymDim))

        if _plain_symbol(din) and _plain_symbol(dout):
            # two independent input symbols in a carry position: the loop
            # itself requires them equal (jax re-checks the carry aval on
            # every trace), so the tie is a real constraint, not a widen
            store.assert_dim_eq(din, dout)
            resolved.append(din)
            continue
        cap = None
        for d in (din, dout):
            if isinstance(d, SymDim):
                cap = bounds.get(d.name) if cap is None else cap
                cap = store.dim_bound(d) if cap is None else cap
        if cap is None:
            raise ConstraintViolation(
                f"{label}: dim {i} changes across loop iterations "
                f"({din!r} -> {dout!r}) with no declared bound — give the "
                f"dim a Dim(max=...) contract so it can widen to a "
                f"bounded symbol")
        base = din if isinstance(din, SymDim) else dout
        widened = fresh_symdim(f"{base.name}^", rep=base.rep)
        store.note_dim_bound(widened, int(cap))
        store.assert_dim_eq(din, widened)
        store.assert_dim_eq(dout, widened)
        resolved.append(widened)
    return tuple(resolved)
