"""Computation-graph bridging: ATen FX graph → DHLO — DISC §3 / §4.1 / §4.4.

The counterpart of the JAX package's ``jaxpr_frontend.py``.  Any function
of tensors is bridged by

    graph, specs = bridge(fn, [ArgSpec(("B", "S", 512), torch.float32), ...])

Symbolic dims are declared by naming them in :class:`ArgSpec` shapes.  The
bridge traces the function once with ``make_fx(tracing_mode="fake")`` at
*representative* concrete sizes (the same distinct primes per symbol as the
JAX bridge), through PyTorch's core ATen decompositions, and walks the
resulting FX graph.  Nothing is computed: a full-width model traces on fake
tensors.  Symbolic output shapes are rebuilt per op; where an op's output
sizes are only known concretely (reshape, expand, iota), representative-
prime matching recovers symbol structure by factorization.

ATen ops map onto the DHLO opcode names the IR was built around (the lax
names), so ``propagation.OP_TABLE`` and the fusion rules apply unchanged.
The mapping mirrors how ``jax.numpy`` lowers the same source-level code:

* binary ops promote their operands to one dtype with explicit
  ``convert`` ops and lift lower-rank operands with ``broadcast_in_dim``
  (rank-equal size-1 broadcasting stays implicit); Python numbers become
  rank-0 literals weakly typed to their tensor operand;
* ``unsqueeze``/``expand`` chains become one ``broadcast_in_dim``,
  ``where`` broadcasts every operand to the result shape;
* ``x @ w`` with a rank-3 ``x`` — traced as ``view → mm → view`` — becomes
  one rank-3 ``dot_general``, as ``jnp.matmul`` does; batched contractions
  are written with :func:`repro_torch.core.primitives.dot_general`;
* ``mean`` is ``reduce_sum`` then ``div``; ``chunk``/``split`` become
  independent ``slice`` ops plus the frontend's equal-shape hints.

Control flow traces (``make_fx``) into ``torch.ops.higher_order`` nodes
whose bodies are ``get_attr`` GraphModules.  ``while_loop``, ``scan`` and
``cond`` lower to the region ops ``d.while`` / ``d.scan`` / ``d.cond``,
each body a nested ``DGraph`` sharing the parent's constraint store and
derived-dim table (:func:`_bridge_region`), its operands laid out as the
JAX bridge lays them out: loop-invariant operands first, then the carry,
then the scanned slices.  A reverse scan traces as ``flip → scan → flip``
and is folded back into one ``d.scan(reverse=True)``.

Every op records its ATen overload and its non-tensor arguments in
``attrs["_prim"]`` / ``attrs["_params"]``.  An ATen op with no rule, and
any other higher-order op, raises :class:`UnsupportedPrimitiveError`,
naming it.
"""
from __future__ import annotations

import itertools
import operator
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.fx.experimental.proxy_tensor import make_fx

from ..core.dhlo import DGraph, DValue
from ..core.dtypes import as_torch
from ..core.primitives import DOT_GENERAL_OP
from ..core.propagation import carry_fixed_point, collect_semantic_constraints
from ..core.symshape import Dim, SymDim, SymShape, dim_value, fresh_symdim

__all__ = ["ArgSpec", "TreeSpec", "UnsupportedPrimitiveError", "bridge",
           "eval_dim"]

aten = torch.ops.aten


class UnsupportedPrimitiveError(NotImplementedError):
    """An ATen or higher-order op the bridge cannot lower to DHLO.

    Raised (naming the op) instead of guessing: an op traced at
    representative shapes and replayed blindly at another bucket would
    silently compute garbage.
    """


@dataclass(frozen=True)
class ArgSpec:
    """Shape spec with named symbolic dims, e.g. ``(("B", "S", 512), f32)``."""

    shape: Tuple[Union[int, str], ...]
    dtype: Any = torch.float32
    name: str = ""


class TreeSpec:
    """Spec for a pytree argument whose tensor leaves share bucketed axes
    (``pipeline="jit"`` only).

    ``axes`` maps a leaf axis index to a symbolic dim (a name string, or a
    ``Dim`` at the public-API layer): the generated dispatch zero-pads
    every tensor leaf of the argument along those axes to the dim's
    current bucket, on the leaf's own device.  The dim itself must also be
    declared on some :class:`ArgSpec` argument — a pytree has no single
    ``.shape`` to extract the symbol from.  The serving engine uses this
    to thread a gathered batch of KV-cache rows through a
    ``Dim("B")``-bucketed prefill artifact.
    """

    def __init__(self, axes):
        items = sorted(axes.items()) if isinstance(axes, dict) else list(axes)
        self.axes: Tuple[Tuple[int, Any], ...] = tuple(
            (int(a), d) for a, d in items)

    def __repr__(self) -> str:
        return f"TreeSpec({dict(self.axes)!r})"

    def __eq__(self, other) -> bool:
        return isinstance(other, TreeSpec) and self.axes == other.axes

    def __hash__(self) -> int:
        return hash(self.axes)


# representative primes for symbols — the JAX bridge's table, so a symbol
# gets the same representative size in both packages
_REPS = [37, 41, 43, 47, 53, 59, 61, 67, 71, 73, 79, 83, 89, 97, 101, 103]


# ------------------------------------------------------------------ dims --

def eval_dim(graph: DGraph, d: Dim, bindings: Dict[int, int]) -> int:
    """Evaluate a (possibly derived) dim given input-symbol bindings.

    This is the *specification* of the host-side shape calculation; the
    dispatcher generates straight-line code equivalent to it (§4.2
    'generated runtime flow'), this interpreter is kept as the oracle.
    """
    if isinstance(d, int):
        return d
    if d.uid in bindings:
        return bindings[d.uid]
    expr = getattr(graph, "dim_exprs", {}).get(d.uid)
    if expr is None:
        raise KeyError(f"unbound symbolic dim {d!r}")
    tag = expr[0]
    if tag == "mul":
        v = 1
        for x in expr[1]:
            v *= eval_dim(graph, x, bindings)
        return v
    if tag == "sum":
        return sum(eval_dim(graph, x, bindings) for x in expr[1])
    if tag == "affine":  # a*d + b
        _, base, a, b = expr
        return a * eval_dim(graph, base, bindings) + b
    if tag == "div":  # exact division
        _, base, k = expr
        v = eval_dim(graph, base, bindings)
        return v // k
    raise ValueError(f"unknown dim expr {expr}")


class _Bridge:
    def __init__(self, name: str) -> None:
        self.graph = DGraph(name=name)
        self.graph.dim_exprs = {}
        self.env: Dict[torch.fx.Node, Any] = {}
        # declared Dim(max=...) caps by symbol name: a loop carry whose dim
        # varies across iterations widens to a symbol with this bound
        self.bounds: Dict[str, int] = {}
        # scan nodes traced as flip -> scan -> flip (see _reverse_scans)
        self.reverse_scans: set = set()
        self.symbols: Dict[str, SymDim] = {}
        # representative value -> SymDim, for resymbolization
        self.rep_to_dim: Dict[int, SymDim] = {}
        self._rep_iter = itertools.count()

    # ------------------------------------------------------------ symbols
    def symbol(self, name: str) -> SymDim:
        if name not in self.symbols:
            idx = next(self._rep_iter)
            rep = _REPS[idx % len(_REPS)] + 131 * (idx // len(_REPS))
            d = fresh_symdim(name, rep=rep)
            self.symbols[name] = d
            self.rep_to_dim[d.rep] = d
        return self.symbols[name]

    def derived(self, name: str, rep: int, expr: Tuple) -> SymDim:
        d = fresh_symdim(name, rep=rep)
        self.graph.dim_exprs[d.uid] = expr
        self.rep_to_dim.setdefault(rep, d)
        return d

    def resymbolize(self, size: int, local_dims: Sequence[Dim]) -> Dim:
        """Map a concrete traced size back to symbolic structure."""
        # 1. exact match against this op's input dims (shape propagation)
        for d in local_dims:
            if isinstance(d, SymDim) and d.rep == size:
                return d
        # 2. exact match against any known symbol
        if size in self.rep_to_dim:
            return self.rep_to_dim[size]
        # 3. product of two known local symbolic dims (reshape merge)
        syms = [d for d in local_dims if isinstance(d, SymDim)]
        for i, a in enumerate(syms):
            for b in syms[i:]:
                if a.rep * b.rep == size:
                    return self.derived(
                        f"{a.name}*{b.name}", size, ("mul", (a, b)))
            # symbol * static factor (e.g. merge of (S, 128) -> S*128)
            if size % a.rep == 0:
                k = size // a.rep
                return self.derived(f"{a.name}*{k}", size, ("mul", (a, k)))
        # 4. genuinely static
        return int(size)

    # -------------------------------------------------------------- values
    def const(self, value, dtype) -> DValue:
        """A rank-0 literal from a Python number, weakly typed ``dtype``."""
        if isinstance(value, bool):
            payload = torch.tensor(value)
        elif isinstance(value, int):
            payload = torch.tensor(value, dtype=torch.int64)
        else:
            payload = torch.tensor(float(value), dtype=torch.float64)
        return self.graph.add_const(payload, dtype=dtype)

    def emit(self, opcode: str, node, inputs, out_shapes, out_dtypes,
             extra_attrs=None, shape_operands=()):
        attrs = {"_prim": node.target, "_params": _params_of(node)}
        if extra_attrs:
            attrs.update(extra_attrs)
        op = self.graph.add_op(opcode, inputs, out_shapes, out_dtypes,
                               shape_operands=shape_operands, attrs=attrs)
        return op.outputs

    def emit1(self, opcode, node, inputs, out_shape, dtype, **extra):
        return self.emit(opcode, node, inputs, [tuple(out_shape)], [dtype],
                         extra_attrs=extra or None)[0]


def _params_of(node) -> Dict[str, Any]:
    """Non-tensor arguments of an FX node (recorded for re-emission and
    folded into the shape-free fingerprint)."""
    def plain(a):
        if isinstance(a, torch.fx.Node):
            return None
        if isinstance(a, (list, tuple)):
            if any(isinstance(x, torch.fx.Node) for x in a):
                return None
            return tuple(a)
        if isinstance(a, (torch.device, torch.layout, torch.memory_format)):
            return None
        return a

    params: Dict[str, Any] = {}
    for i, a in enumerate(node.args):
        p = plain(a)
        if p is not None:
            params[f"arg{i}"] = p
    for k, a in node.kwargs.items():
        p = plain(a)
        if p is not None and k not in ("device", "pin_memory", "layout"):
            params[k] = p
    return params


def _meta(node) -> torch.Tensor:
    return node.meta["val"]


def _shape(node) -> Tuple[int, ...]:
    return tuple(int(s) for s in _meta(node).shape)


# ------------------------------------------------------------ operands --

_COMPARE = {"eq", "ne", "lt", "gt", "le", "ge"}


def _probe(a):
    """A stand-in with ``a``'s dtype and dimensionedness (promotion treats
    0-dim tensors and Python numbers as weaker than dimensioned tensors)."""
    if isinstance(a, torch.fx.Node):
        m = _meta(a)
        return torch.empty((0,) if m.dim() else (), dtype=m.dtype)
    return a


def _compute_dtype(a, c) -> torch.dtype:
    """The dtype a comparison computes in (PyTorch type promotion)."""
    return torch.result_type(_probe(a), _probe(c))


def _lift(b: _Bridge, v: DValue, rank: int, node) -> DValue:
    """jnp-style rank promotion: (..., d) -> (1, ..., 1, ..., d)."""
    if v.rank == 0 or v.rank == rank:
        return v
    k = rank - v.rank
    return b.emit1("broadcast_in_dim", node, [v], (1,) * k + tuple(v.shape),
                   v.dtype, broadcast_dimensions=tuple(range(k, rank)))


def _convert(b: _Bridge, v: DValue, dtype, node) -> DValue:
    if as_torch(v.dtype) == dtype:
        return v
    if v.literal is not None and v.rank == 0:
        return b.graph.add_const(v.literal, dtype=dtype)
    return b.emit1("convert", node, [v], v.shape, dtype, new_dtype=dtype)


def _operands(b: _Bridge, node, args, dtype) -> List[DValue]:
    out = []
    for a in args:
        if isinstance(a, torch.fx.Node):
            out.append(_convert(b, b.env[a], dtype, node))
        else:
            out.append(b.const(a, dtype))
    return out


def _sym_out_shape_ew(b: _Bridge, in_vals: List[DValue], shape) -> SymShape:
    """Elementwise result: shape of the highest-rank symbolic operand."""
    for v in in_vals:
        if v.rank == len(shape) and tuple(
                dim_value(d) for d in v.shape) == tuple(shape):
            return v.shape
    out = []
    for ax, size in enumerate(shape):
        cands = [v.shape[ax] for v in in_vals if v.rank == len(shape)
                 and dim_value(v.shape[ax]) == size]
        out.append(cands[0] if cands else b.resymbolize(
            size, [d for v in in_vals for d in v.shape]))
    return tuple(out)


# ------------------------------------------------------------- handlers --

_EW_BINARY = {
    "add": "add", "sub": "sub", "mul": "mul", "div": "div",
    "maximum": "max", "minimum": "min", "pow": "pow", "atan2": "atan2",
    "fmod": "rem", "remainder": "rem",
    "bitwise_and": "and", "bitwise_or": "or", "bitwise_xor": "xor",
    "logical_and": "and", "logical_or": "or", "logical_xor": "xor",
    "eq": "eq", "ne": "ne", "lt": "lt", "gt": "gt", "le": "le", "ge": "ge",
}

_EW_UNARY = {
    "neg": "neg", "sign": "sign", "floor": "floor", "ceil": "ceil",
    "round": "round", "exp": "exp", "exp2": "exp2", "expm1": "expm1",
    "log": "log", "log1p": "log1p", "tanh": "tanh", "sigmoid": "logistic",
    "sqrt": "sqrt", "rsqrt": "rsqrt", "abs": "abs", "erf": "erf",
    "erfc": "erfc", "erfinv": "erf_inv", "sin": "sin", "cos": "cos",
    "tan": "tan", "asin": "asin", "acos": "acos", "atan": "atan",
    "sinh": "sinh", "cosh": "cosh", "logical_not": "not",
    "bitwise_not": "not", "isfinite": "is_finite",
}

# ops that are value identities in DHLO (values are immutable)
_IDENTITY = {"clone", "alias", "detach", "detach_", "lift_fresh_copy",
             "contiguous", "lift_fresh", "_conj", "resolve_conj",
             "resolve_neg"}

_VIEWS = {"view", "_unsafe_view", "reshape"}
_BROADCASTS = {"unsqueeze", "expand"}


def _binary(b: _Bridge, node, opcode: str, args) -> DValue:
    out_meta = _meta(node)
    dtype = _compute_dtype(*args) if opcode in _COMPARE \
        or out_meta.dtype == torch.bool else out_meta.dtype
    vals = _operands(b, node, args, dtype)
    rank = out_meta.dim()
    vals = [_lift(b, v, rank, node) for v in vals]
    shape = _sym_out_shape_ew(b, vals, _shape(node))
    return b.emit1(opcode, node, vals, shape, out_meta.dtype)


def _unary(b: _Bridge, node, opcode: str, x) -> DValue:
    out_meta = _meta(node)
    # predicates (isfinite, logical_not) keep their operand's dtype
    dtype = _meta(x).dtype if out_meta.dtype == torch.bool \
        else out_meta.dtype
    (v,) = _operands(b, node, [x], dtype)
    return b.emit1(opcode, node, [v], v.shape, out_meta.dtype)


def _broadcast_to(b: _Bridge, v: DValue, shape: SymShape, node) -> DValue:
    if tuple(v.shape) == tuple(shape):
        return v
    k = len(shape) - v.rank
    return b.emit1("broadcast_in_dim", node, [v], shape, v.dtype,
                   broadcast_dimensions=tuple(range(k, len(shape))))


def _where(b: _Bridge, node, cond, x, y) -> DValue:
    out_meta = _meta(node)
    pred = b.env[cond]
    vals = _operands(b, node, [y, x], out_meta.dtype)  # select_n order
    shape = _sym_out_shape_ew(b, [pred] + vals, _shape(node))
    pred, on_false, on_true = (_broadcast_to(b, v, shape, node)
                               for v in [pred] + vals)
    return b.emit1("select", node, [pred, on_false, on_true], shape,
                   out_meta.dtype)


def _reduce(b: _Bridge, node, opcode: str, x, dims, keepdim: bool,
            dtype=None) -> DValue:
    out_dtype = _meta(node).dtype
    src = _convert(b, b.env[x], dtype or out_dtype, node)
    rank = src.rank
    if dims is None or (isinstance(dims, (list, tuple)) and len(dims) == 0):
        axes = tuple(range(rank))
    else:
        dims = dims if isinstance(dims, (list, tuple)) else [dims]
        axes = tuple(sorted(int(d) % max(rank, 1) for d in dims))
    kept = tuple(d for i, d in enumerate(src.shape) if i not in set(axes))
    out = b.emit1(opcode, node, [src], kept, out_dtype, axes=axes)
    if keepdim:
        shape = tuple(1 if i in set(axes) else d
                      for i, d in enumerate(src.shape))
        bdims = tuple(i for i in range(rank) if i not in set(axes))
        out = b.emit1("broadcast_in_dim", node, [out], shape, out.dtype,
                      broadcast_dimensions=bdims)
    return out


def _mean(b: _Bridge, node, x, dims, keepdim=False, dtype=None) -> DValue:
    src = b.env[x]
    total = _reduce(b, node, "reduce_sum", x, dims, keepdim, dtype)
    axes = range(src.rank) if not dims else \
        [int(d) % src.rank for d in dims]
    n = 1
    for a in set(axes):
        n *= dim_value(src.shape[a])
    if any(not isinstance(src.shape[a], int) for a in set(axes)):
        raise UnsupportedPrimitiveError(
            "mean over a dynamic axis: write sum() / the length instead")
    return b.emit1("div", node, [total, b.const(n, total.dtype)],
                   total.shape, total.dtype)


def _reshape(b: _Bridge, node, x) -> DValue:
    src = b.env[x]
    out = tuple(b.resymbolize(s, list(src.shape)) for s in _shape(node))
    if tuple(out) == tuple(src.shape):
        return src
    return b.emit1("reshape", node, [src], out, src.dtype)


def _unsqueeze_chain(b: _Bridge, node) -> Tuple[DValue, Tuple[int, ...]]:
    """Fold a chain of unsqueeze/expand nodes (each the sole user of the
    previous) into one ``(source, broadcast_dimensions)`` pair: ``x[None,
    :, None]`` is one ``broadcast_in_dim`` in jax, too."""
    chain = [node]
    cur = node.args[0]
    while _folded_broadcast(cur):
        chain.append(cur)
        cur = cur.args[0]
    src = b.env[cur]
    bdims = list(range(src.rank))
    for n in reversed(chain):
        if _packet(n) == "unsqueeze":
            r = _meta(n.args[0]).dim()  # rank before this unsqueeze
            ax = int(n.args[1]) % (r + 1)
            bdims = [d + 1 if d >= ax else d for d in bdims]
        else:  # expand: new leading dims
            k = _meta(n).dim() - _meta(n.args[0]).dim()
            bdims = [d + k for d in bdims]
    return src, tuple(bdims)


def _folded_broadcast(node) -> bool:
    """An unsqueeze/expand whose only user is another one, which folds it."""
    if not (isinstance(node, torch.fx.Node) and node.op == "call_function"
            and _packet(node) in _BROADCASTS and len(node.users) == 1):
        return False
    (user,) = node.users
    return (user.op == "call_function" and _packet(user) in _BROADCASTS
            and user.args[0] is node)


def _broadcast_node(b: _Bridge, node) -> DValue:
    src, bdims = _unsqueeze_chain(b, node)
    out_sizes = _shape(node)
    out: List[Dim] = []
    for ax, size in enumerate(out_sizes):
        if ax in bdims:
            d = src.shape[bdims.index(ax)]
            if not (isinstance(d, int) and d == 1 and size != 1):
                out.append(d)
                continue
        out.append(b.resymbolize(size, list(src.shape)))
    if tuple(out) == tuple(src.shape):
        return src
    return b.emit1("broadcast_in_dim", node, [src], tuple(out), src.dtype,
                   broadcast_dimensions=bdims)


def _slice_dims(b: _Bridge, src: DValue, starts, limits, strides):
    out_shape: List[Dim] = []
    for ax, (s, l, st) in enumerate(zip(starts, limits, strides)):
        d = src.shape[ax]
        if isinstance(d, SymDim) and st == 1 and l == d.rep:
            if s == 0:
                out_shape.append(d)
            else:
                out_shape.append(b.derived(f"{d.name}-{s}", d.rep - s,
                                           ("affine", d, 1, -s)))
        else:
            out_shape.append(int(-(-(l - s) // st)))
    return tuple(out_shape)


def _slice(b: _Bridge, node, x, dim=0, start=None, end=None, step=1):
    src = b.env[x]
    rank = src.rank
    dim = int(dim) % rank
    size = dim_value(src.shape[dim])
    s = 0 if start is None else int(start)
    e = size if end is None else int(end)
    s = max(0, s + size if s < 0 else s)
    e = min(size, e + size if e < 0 else e)
    if s == 0 and e == size and step == 1:
        return src
    starts = tuple(s if ax == dim else 0 for ax in range(rank))
    limits = tuple(e if ax == dim else dim_value(src.shape[ax])
                   for ax in range(rank))
    strides = tuple(int(step) if ax == dim else 1 for ax in range(rank))
    shape = _slice_dims(b, src, starts, limits, strides)
    return b.emit1("slice", node, [src], shape, src.dtype,
                   start_indices=starts, limit_indices=limits,
                   strides=strides)


def _split(b: _Bridge, node, x, sizes, dim=0):
    """``split``/``chunk``: independent static ``slice`` ops, plus the
    equal-shape hint for even splits (TF.SplitOp → DHLO.SliceOp, §4.2.1)."""
    src = b.env[x]
    axis = int(dim) % src.rank
    total = dim_value(src.shape[axis])
    if isinstance(sizes, int):
        sizes = [min(sizes, total - o) for o in range(0, total, sizes)]
    outs: List[DValue] = []
    offset = 0
    for size in sizes:
        starts = tuple(offset if ax == axis else 0 for ax in range(src.rank))
        limits = tuple((offset + size) if ax == axis
                       else dim_value(src.shape[ax])
                       for ax in range(src.rank))
        shape = tuple(size if ax == axis else src.shape[ax]
                      for ax in range(src.rank))
        outs.append(b.emit1("slice", node, [src], shape, src.dtype,
                            start_indices=starts, limit_indices=limits,
                            strides=(1,) * src.rank))
        offset += size
    if len(set(sizes)) == 1:
        for o in outs[1:]:
            b.graph.store.assert_shape_eq(outs[0].shape, o.shape)
            b.graph.store.assert_size_eq(outs[0].vid, o.vid)
    return tuple(outs)


def _concat(b: _Bridge, node, tensors, dim=0):
    vals = [b.env[t] for t in tensors]
    dtype = _meta(node).dtype
    vals = [_convert(b, v, dtype, node) for v in vals]
    axis = int(dim) % vals[0].rank
    parts = [v.shape[axis] for v in vals]
    if all(isinstance(p, int) for p in parts):
        cat: Dim = sum(parts)  # type: ignore[assignment]
    else:
        rep = sum(dim_value(p) for p in parts)
        cat = b.derived("+".join(getattr(p, "name", str(p)) for p in parts),
                        rep, ("sum", tuple(parts)))
    shape = tuple(cat if ax == axis else vals[0].shape[ax]
                  for ax in range(vals[0].rank))
    return b.emit1("concatenate", node, vals, shape, dtype, dimension=axis)


def _iota(b: _Bridge, node, start, end, step) -> DValue:
    meta = _meta(node)
    n = int(meta.shape[0])
    dt = meta.dtype
    out = b.emit1("iota", node, [], (b.resymbolize(n, []),), dt, dimension=0,
                  iota_dtype=dt)
    if step != 1:
        out = b.emit1("mul", node, [out, b.const(step, dt)], out.shape, dt)
    if start != 0:
        out = b.emit1("add", node, [out, b.const(start, dt)], out.shape, dt)
    return out


def _full(b: _Bridge, node, value) -> DValue:
    meta = _meta(node)
    c = b.const(value, meta.dtype)
    shape = tuple(b.resymbolize(s, []) for s in _shape(node))
    if not shape:
        return c
    return b.emit1("broadcast_in_dim", node, [c], shape, meta.dtype,
                   broadcast_dimensions=())


def _dot(b: _Bridge, node, lhs: DValue, rhs: DValue, dn) -> DValue:
    (lc, rc), (lb, rb) = dn
    lc, rc, lb, rb = (tuple(int(i) for i in t) for t in (lc, rc, lb, rb))
    batch = [lhs.shape[i] for i in lb]
    lfree = [d for i, d in enumerate(lhs.shape) if i not in set(lc) | set(lb)]
    rfree = [d for i, d in enumerate(rhs.shape) if i not in set(rc) | set(rb)]
    return b.emit1("dot_general", node, [lhs, rhs],
                   tuple(batch + lfree + rfree), _meta(node).dtype,
                   dimension_numbers=((lc, rc), (lb, rb)))


def _packet(node) -> str:
    t = node.target
    if isinstance(t, torch._ops.OpOverload):
        return t.overloadpacket.__name__
    return getattr(t, "__name__", str(t))


# ------------------------------------------------------ matmul peephole --

def _matmul_folds(gm: torch.fx.GraphModule):
    """``x @ w`` on a rank-3+ ``x`` traces as ``view(x, [M, K]) → mm →
    view(.., x.shape[:-1] + [N])``.  Fold such chains back to one
    ``dot_general`` over ``x``'s last axis (what ``jnp.matmul`` emits).

    Returns ``(mm -> (x, out_view), views to skip)``."""
    folds: Dict[torch.fx.Node, Tuple[torch.fx.Node, torch.fx.Node]] = {}
    for n in gm.graph.nodes:
        if n.op != "call_function" or n.target is not aten.mm.default:
            continue
        a = n.args[0]
        if not (isinstance(a, torch.fx.Node) and a.op == "call_function"
                and _packet(a) in _VIEWS):
            continue
        x = a.args[0]
        if not isinstance(x, torch.fx.Node):
            continue
        xs = _shape(x)
        if len(xs) < 3 or len(n.users) != 1:
            continue
        (user,) = n.users
        if not (user.op == "call_function" and _packet(user) in _VIEWS):
            continue
        if _shape(user) != xs[:-1] + (_shape(n)[1],):
            continue
        folds[n] = (x, user)
    skip = {n.args[0] for n in folds
            if all(u in folds for u in n.args[0].users)}
    return folds, skip


# ---------------------------------------------------------- region ops --

def _hop_name(node) -> Optional[str]:
    t = node.target if isinstance(node, torch.fx.Node) else None
    if isinstance(t, torch._ops.HigherOrderOperator):
        return t.name()
    return None


def _is_flip0(node) -> bool:
    return (isinstance(node, torch.fx.Node) and node.op == "call_function"
            and node.target is aten.flip.default
            and [int(d) for d in node.args[1]] == [0])


def _reverse_scans(gm: torch.fx.GraphModule):
    """``scan(..., reverse=True)`` traces as ``flip(xs, [0]) → scan →
    flip(ys, [0])``.  Fold the pattern back into one reverse scan, as
    :func:`_matmul_folds` folds ``view → mm → view``: unfolded, the flip
    of a zero-padded dynamic axis would move the bucket's padding to the
    front, and the scan would start on padded rows.

    A scan folds when every ``xs`` operand is a flip over axis 0 used by
    the scan alone and every used ``ys`` output feeds only such flips.
    Returns ``(scans, xs flips to skip, {ys flip: scan output})``."""
    scans, skip, alias = set(), set(), {}
    for n in gm.graph.nodes:
        if _hop_name(n) != "scan" or len(n.args) != 4:
            continue
        ncar, xs = len(n.args[1]), list(n.args[2])
        if not xs or not all(_is_flip0(x) and len(x.users) == 1
                             for x in xs):
            continue
        outs = {}
        for g in n.users:
            if g.target is not operator.getitem:
                break
            if int(g.args[1]) < ncar:
                continue
            if not all(_is_flip0(u) for u in g.users):
                break
            outs.update({u: g for u in g.users})
        else:
            scans.add(n)
            skip.update(xs)
            alias.update(outs)
    return scans, skip, alias


def _bridge_region(b: _Bridge, gm: torch.fx.GraphModule, params, order,
                   name: str) -> DGraph:
    """Lower a traced body into a nested region ``DGraph``.

    The body *shares* the parent's constraint store and derived-dim table
    (one symbolic universe, so shapes keep their identity across the
    region boundary); only the value environment is scoped.  ``params``
    are the body's ``(shape, dtype)`` pairs in DHLO order, and ``order``
    gives, for each placeholder of ``gm`` in turn, its param's index."""
    outer_graph, outer_env = b.graph, b.env
    sub = DGraph(name=name)
    sub.store = outer_graph.store
    sub.dim_exprs = outer_graph.dim_exprs
    b.graph, b.env = sub, {}
    try:
        vals = [sub.add_param(tuple(sh), dt) for sh, dt in params]
        placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
        if len(placeholders) != len(order):
            raise UnsupportedPrimitiveError(
                f"{name}: the body takes {len(placeholders)} operands, the "
                f"op passes {len(order)}")
        for node, i in zip(placeholders, order):
            b.env[node] = vals[i]
        sub.set_outputs(_walk(b, gm))
    finally:
        b.graph, b.env = outer_graph, outer_env
    # op-semantic constraints of the body land in the shared store now
    # (the top-level pass does not descend into regions), so the carry
    # fixed point that runs next sees them
    collect_semantic_constraints(sub)
    return sub


def _tensor_operands(b: _Bridge, node, seq) -> List[DValue]:
    out = []
    for a in seq:
        if not isinstance(a, torch.fx.Node):
            raise UnsupportedPrimitiveError(
                f"higher-order op {node.target.name()!r}: non-tensor "
                f"operand {a!r}")
        out.append(b.env[a])
    return out


def _carry_shapes(b: _Bridge, carry, outs, what: str):
    g = b.graph
    return [carry_fixed_point(g.store, g.dim_exprs, cv.shape, ov.shape,
                              bounds=b.bounds, label=f"{what} carry {i}")
            for i, (cv, ov) in enumerate(zip(carry, outs))]


def _bridge_while(b: _Bridge, node) -> None:
    """``while_loop(cond, body, carried, additional)`` → ``d.while``.

    Both traced bodies take ``(*carried, *additional)``; the region op
    takes the JAX bridge's layout ``cond_consts + body_consts + carry``
    with ``additional`` as the consts of both bodies (so it appears
    twice among the operands), and its bodies' params are reordered to
    ``consts + carry`` to match."""
    cond_gm, body_gm, carried, additional = node.args
    g = b.graph
    carry = _tensor_operands(b, node, carried)
    consts = _tensor_operands(b, node, additional)
    params = [(v.shape, v.dtype) for v in consts + carry]
    nc, ncar = len(consts), len(carry)
    order = [nc + k for k in range(ncar)] + list(range(nc))
    cond_graph = _bridge_region(b, b.env[cond_gm], params, order,
                                f"{g.name}.while.cond")
    body_graph = _bridge_region(b, b.env[body_gm], params, order,
                                f"{g.name}.while.body")
    out_shapes = _carry_shapes(b, carry, body_graph.outputs, "while")
    op = g.add_op("d.while", consts + consts + carry, out_shapes,
                  [v.dtype for v in carry],
                  attrs={"cond_graph": cond_graph, "body_graph": body_graph,
                         "cond_nconsts": nc, "body_nconsts": nc})
    b.env[node] = tuple(op.outputs)


def _bridge_scan(b: _Bridge, node) -> None:
    """``scan(combine, init, xs, additional)`` → ``d.scan`` over axis 0 of
    ``xs``, its length the dim of ``xs[0]``; the ys get that axis in
    front.  The combine body takes ``(*carry, *x_slices, *additional)``;
    its params are reordered to the JAX bridge's ``consts + carry + xs``."""
    combine, init, xs_nodes, additional = node.args
    g = b.graph
    reverse = node in b.reverse_scans
    if reverse:
        xs_nodes = [x.args[0] for x in xs_nodes]
    carry = _tensor_operands(b, node, init)
    xs = _tensor_operands(b, node, xs_nodes)
    consts = _tensor_operands(b, node, additional)
    nc, ncar, nx = len(consts), len(carry), len(xs)
    if not xs:
        raise UnsupportedPrimitiveError("scan over no xs has no length")
    length_dim = xs[0].shape[0]
    params = ([(v.shape, v.dtype) for v in consts + carry]
              + [(tuple(v.shape[1:]), v.dtype) for v in xs])
    order = [nc + k for k in range(ncar + nx)] + list(range(nc))
    body = _bridge_region(b, b.env[combine], params, order,
                          f"{g.name}.scan.body")
    out_shapes = _carry_shapes(b, carry, body.outputs[:ncar], "scan")
    out_shapes += [(length_dim,) + tuple(y.shape)
                   for y in body.outputs[ncar:]]
    op = g.add_op("d.scan", consts + carry + xs, out_shapes,
                  [v.dtype for v in body.outputs],
                  attrs={"body_graph": body, "num_consts": nc,
                         "num_carry": ncar, "length_dim": length_dim,
                         "reverse": reverse, "unroll": 1})
    b.env[node] = tuple(op.outputs)


def _bridge_cond(b: _Bridge, node) -> None:
    """``cond(pred, true_fn, false_fn, operands)`` → ``d.cond`` over the
    branch graphs ``(false, true)``, indexed by ``pred`` converted to
    int32: how ``lax.cond`` lowers to the JAX bridge's ``d.cond``."""
    pred, true_gm, false_gm, operands = node.args
    g = b.graph
    p = b.env[pred]   # a constant predicate never reaches the trace
    index = g.add_op("convert", [p], [p.shape], [torch.int32],
                     attrs={"new_dtype": torch.int32}).outputs[0]
    ops = _tensor_operands(b, node, operands)
    params = [(v.shape, v.dtype) for v in ops]
    order = list(range(len(ops)))
    branches = tuple(
        _bridge_region(b, b.env[gm], params, order, f"{g.name}.cond.br{i}")
        for i, gm in enumerate((false_gm, true_gm)))
    base = branches[0]
    for a, o in zip(base.outputs, branches[1].outputs):
        g.store.assert_shape_eq(a.shape, o.shape)
    op = g.add_op("d.cond", [index] + ops, [v.shape for v in base.outputs],
                  [v.dtype for v in base.outputs],
                  attrs={"branch_graphs": branches})
    b.env[node] = tuple(op.outputs)


_REGION_BRIDGES = {"while_loop": _bridge_while, "scan": _bridge_scan,
                   "cond": _bridge_cond}


def _bridge_higher_order(b: _Bridge, node) -> None:
    name = node.target.name()
    lower = _REGION_BRIDGES.get(name)
    if lower is None:
        bodies = [i for i, a in enumerate(node.args)
                  if isinstance(a, torch.fx.Node) and a.op == "get_attr"]
        raise UnsupportedPrimitiveError(
            f"higher-order op 'torch.ops.higher_order.{name}' (traced "
            f"bodies in args {bodies}) is not supported by the DHLO bridge; "
            f"supported region ops are while_loop/scan/cond")
    if len(node.args) != 4 or node.kwargs:
        # the form torch 2.11 to 2.13 traces: (body or bodies, operands)
        raise UnsupportedPrimitiveError(
            f"higher-order op {name!r} traced with {len(node.args)} args "
            f"and kwargs {sorted(node.kwargs)}; the bridge reads 4 "
            f"positional args")
    lower(b, node)


# ------------------------------------------------------------- the walk --

def _bridge_node(b: _Bridge, node, folds, skip, fold_out) -> None:
    if node in skip:
        return
    if node in fold_out:  # the view closing a folded matmul
        b.env[node] = b.env[fold_out[node]]
        return
    target = node.target
    args, kwargs = node.args, node.kwargs
    if target is operator.getitem:
        b.env[node] = b.env[args[0]][args[1]]
        return
    if isinstance(target, torch._ops.HigherOrderOperator):
        _bridge_higher_order(b, node)
        return
    if target is DOT_GENERAL_OP:
        lhs, rhs = b.env[args[0]], b.env[args[1]]
        b.env[node] = _dot(b, node, lhs, rhs, ((args[2], args[3]),
                                               (args[4], args[5])))
        return
    if not isinstance(target, torch._ops.OpOverload):
        raise UnsupportedPrimitiveError(
            f"call {target!r} is not an ATen op; the DHLO bridge lowers "
            f"ATen graphs only")
    name = _packet(node)
    ov = target._overloadname

    if node in folds:
        x, _ = folds[node]
        lhs, rhs = b.env[x], b.env[args[1]]
        dn = (((lhs.rank - 1,), (0,)), ((), ()))
        b.env[node] = _dot(b, node, lhs, rhs, dn)
        return
    if name == "mm":
        b.env[node] = _dot(b, node, b.env[args[0]], b.env[args[1]],
                           (((1,), (0,)), ((), ())))
        return
    if name == "bmm":
        b.env[node] = _dot(b, node, b.env[args[0]], b.env[args[1]],
                           (((2,), (1,)), ((0,), (0,))))
        return
    if name in _IDENTITY:
        b.env[node] = b.env[args[0]]
        return
    if name in _EW_BINARY:
        a, c = args[0], args[1]
        alpha = kwargs.get("alpha", 1)
        if alpha != 1:
            raise UnsupportedPrimitiveError(f"{target} with alpha={alpha}")
        if name == "div" and kwargs.get("rounding_mode") is not None:
            raise UnsupportedPrimitiveError(
                f"{target} with rounding_mode={kwargs['rounding_mode']}")
        if name == "pow" and ov == "Tensor_Scalar" and isinstance(c, int):
            x = b.env[a]
            b.env[node] = b.emit1("integer_pow", node, [x], x.shape,
                                  _meta(node).dtype, _params={"y": int(c)})
            return
        b.env[node] = _binary(b, node, _EW_BINARY[name], [a, c])
        return
    if name in _EW_UNARY:
        b.env[node] = _unary(b, node, _EW_UNARY[name], args[0])
        return
    if name == "reciprocal":
        b.env[node] = _binary(b, node, "div", [1.0, args[0]])
        return
    if name == "clamp_min":
        b.env[node] = _binary(b, node, "max", [args[0], args[1]])
        return
    if name == "clamp_max":
        b.env[node] = _binary(b, node, "min", [args[0], args[1]])
        return
    if name == "where":
        b.env[node] = _where(b, node, args[0], args[1], args[2])
        return
    if name == "_to_copy":
        src = b.env[args[0]]
        dt = kwargs.get("dtype")
        b.env[node] = src if dt is None else _convert(b, src, dt, node)
        return
    if name in ("sum", "amax", "amin", "prod", "any", "all"):
        opcode = {"sum": "reduce_sum", "amax": "reduce_max",
                  "amin": "reduce_min", "prod": "reduce_prod",
                  "any": "reduce_or", "all": "reduce_and"}[name]
        dims = args[1] if len(args) > 1 else kwargs.get("dim")
        keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
        b.env[node] = _reduce(b, node, opcode, args[0], dims, keep,
                              kwargs.get("dtype"))
        return
    if name == "mean":
        dims = args[1] if len(args) > 1 else kwargs.get("dim")
        keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
        b.env[node] = _mean(b, node, args[0], dims, keep,
                            kwargs.get("dtype"))
        return
    if name in ("argmax", "argmin"):
        src = b.env[args[0]]
        dim = args[1] if len(args) > 1 else kwargs.get("dim")
        if dim is None or (kwargs.get("keepdim") or
                           (len(args) > 2 and args[2])):
            raise UnsupportedPrimitiveError(f"{target} without dim/keepdim")
        ax = int(dim) % src.rank
        kept = tuple(d for i, d in enumerate(src.shape) if i != ax)
        b.env[node] = b.emit1(name, node, [src], kept, _meta(node).dtype,
                              axes=(ax,))
        return
    if name in _VIEWS or name in ("squeeze",):
        b.env[node] = _reshape(b, node, args[0])
        return
    if name in _BROADCASTS:
        if not _folded_broadcast(node):
            b.env[node] = _broadcast_node(b, node)
        return
    if name == "permute":
        src = b.env[args[0]]
        perm = tuple(int(p) % src.rank for p in args[1])
        if perm == tuple(range(src.rank)):
            b.env[node] = src
            return
        b.env[node] = b.emit1("transpose", node, [src],
                              tuple(src.shape[i] for i in perm), src.dtype,
                              permutation=perm)
        return
    if name == "t":
        src = b.env[args[0]]
        b.env[node] = b.emit1("transpose", node, [src], src.shape[::-1],
                              src.dtype, permutation=(1, 0))
        return
    if name == "cat":
        b.env[node] = _concat(b, node, args[0],
                              args[1] if len(args) > 1 else kwargs.get("dim", 0))
        return
    if name in ("split_with_sizes", "split"):
        dim = args[2] if len(args) > 2 else kwargs.get("dim", 0)
        b.env[node] = _split(b, node, args[0], args[1], dim)
        return
    if name == "slice":
        b.env[node] = _slice(b, node, *args)
        return
    if name == "select" and ov == "int":
        src = b.env[args[0]]
        dim = int(args[1]) % src.rank
        idx = int(args[2]) % dim_value(src.shape[dim])
        if not isinstance(src.shape[dim], int) and int(args[2]) != 0:
            # index 0 is valid at every length of at least 1; any
            # other index could land in a bucket's padding on a short
            # request, where torch would raise
            raise UnsupportedPrimitiveError(
                f"{target}: indexing a dynamic axis at {int(args[2])} "
                f"(only index 0 is valid at every length)")
        sl = _slice(b, node, args[0], dim, idx, idx + 1)
        shape = tuple(d for i, d in enumerate(sl.shape) if i != dim)
        b.env[node] = b.emit1("reshape", node, [sl], shape, sl.dtype)
        return
    if name == "arange":
        if ov == "default":
            start, end, step = 0, args[0], 1
        elif ov == "start":
            start, end, step = args[0], args[1], 1
        else:
            start, end = args[0], args[1]
            step = args[2] if len(args) > 2 else 1
        b.env[node] = _iota(b, node, start, end, step)
        return
    if name == "scalar_tensor":
        b.env[node] = b.const(args[0], _meta(node).dtype)
        return
    if name in ("full",):
        b.env[node] = _full(b, node, args[1])
        return
    raise UnsupportedPrimitiveError(
        f"ATen op {target} has no DHLO lowering in the bridge; write the "
        f"function with supported ops or add a rule to fx_frontend.py")


def _walk(b: _Bridge, gm: torch.fx.GraphModule) -> List[DValue]:
    """Lower every node of ``gm`` (its placeholders already bound in
    ``b.env``) into ``b.graph``; returns the output values."""
    folds, skip = _matmul_folds(gm)
    fold_out = {out: mm for mm, (_, out) in folds.items()}
    scans, flips, flip_out = _reverse_scans(gm)
    b.reverse_scans |= scans
    skip |= flips
    fold_out.update(flip_out)
    outputs: List[DValue] = []
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            continue
        if node.op == "get_attr":
            attr = getattr(gm, node.target)
            # a GraphModule is a region body, lowered with its op
            b.env[node] = attr if isinstance(attr, torch.fx.GraphModule) \
                else b.graph.add_const(attr)
            continue
        if node.op == "output":
            flat, _ = torch.utils._pytree.tree_flatten(node.args[0])
            outputs = [b.env[n] for n in flat]
            continue
        _bridge_node(b, node, folds, skip, fold_out)
    return outputs


def _trace(fn: Callable, arg_specs, sym_shapes, device) -> torch.fx.GraphModule:
    """``make_fx`` of ``fn`` over fake examples on ``device``, with every
    kernel wrapper in its plain version: a fake CUDA tensor must never
    reach a kernel launch, and the traced plan is the plain one."""
    from torch._decomp import core_aten_decompositions

    from ..kernels.select import plain_versions

    examples = [torch.empty(tuple(dim_value(d) for d in sh),
                            dtype=as_torch(spec.dtype), device=device)
                for sh, spec in zip(sym_shapes, arg_specs)]
    # control flow is captured by dynamo inside torch's higher-order ops:
    # keep it at the representative sizes (after calls at other sizes it
    # would turn shapes dynamic and lift them as extra loop operands)
    with torch.no_grad(), plain_versions(), torch._dynamo.config.patch(
            automatic_dynamic_shapes=False):
        return make_fx(fn, tracing_mode="fake",
                       decomposition_table=core_aten_decompositions(),
                       _allow_non_fake_inputs=True)(*examples)


def bridge(fn: Callable, arg_specs: Sequence[ArgSpec], *, name: str = "graph",
           collect_hints: bool = True,
           bounds: Optional[Dict[str, int]] = None,
           device: Union[str, torch.device] = "cuda",
           ) -> Tuple[DGraph, List[ArgSpec]]:
    """Lower ``fn`` to a DHLO graph, collecting shape constraints (§4.2.1).

    ``bounds`` maps symbol names to their declared ``Dim(max=...)`` caps,
    recorded in the constraint store up front (the memory planner reads
    them).  ``device`` is where the example inputs of the trace live: the
    device of any tensors ``fn`` closes over.  Like ``disc_torch.compile``
    it defaults to the card and raises
    :class:`~repro_torch.errors.NoDeviceError` when there is none; pass
    ``device="cpu"`` to trace against CPU tensors on purpose.
    """
    from ..api.options import resolve_device

    device = resolve_device(device)
    b = _Bridge(name)
    sym_shapes: List[SymShape] = [
        tuple(b.symbol(s) if isinstance(s, str) else int(s)
              for s in spec.shape) for spec in arg_specs]
    gm = _trace(fn, arg_specs, sym_shapes, device)
    b.bounds = {nm: int(cap) for nm, cap in dict(bounds or {}).items()
                if cap is not None}
    for nm, cap in b.bounds.items():
        if nm in b.symbols:
            b.graph.store.note_dim_bound(b.symbols[nm], cap)
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    for spec, sh, node in zip(arg_specs, sym_shapes, placeholders):
        b.env[node] = b.graph.add_param(sh, as_torch(spec.dtype),
                                        name=spec.name)
    b.graph.set_outputs(_walk(b, gm))

    # constraint source #1: op semantics
    collect_semantic_constraints(b.graph)
    # constraint source #2: high-level-op structure hints
    if collect_hints:
        from .hints import collect_frontend_hints
        collect_frontend_hints(b.graph)
    return b.graph, list(arg_specs)
