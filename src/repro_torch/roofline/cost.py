"""Trip-count-aware cost walks over the port's two program forms, the
counterpart of the JAX package's ``roofline/hlo_cost.py``.

The reference walks optimized HLO text.  The port has no HLO; it has two
programs of its own, and one walk for each, sharing one table of ops:

* :func:`analyze_graph` walks an ATen FX graph traced with
  ``make_fx(tracing_mode="fake")``: the program the jit pipeline and the
  train step run, one launch a node.  Bytes are each launch's inputs plus
  its outputs (a gather or a slice reads only its window: twice its
  output, as the reference counts it); views and metadata ops are free.
  A ``torch.ops.higher_order.scan`` body is multiplied by its scanned
  length (nested scans multiply); a ``while_loop`` body is counted once
  and flagged in :attr:`Cost.while_loops`, since its trip count is not
  static; a ``cond`` counts its costlier branch.  ``_c10d_functional``
  collectives count their input bytes by kind (the kinds of
  ``dist/collectives.py``, reported under the reference's five HLO
  names; ``wait_tensor`` is free).  A recurrence op that runs a Python
  loop over its steps (the plain WKV and its backward,
  ``kernels/rwkv6/ref.py`` ``STEPWISE``) counts as that loop's own walk
  at the node's shapes: the loop traced at T = 2 and T = 3 and the walk
  extended over T, ``(3 - T)·walk(2) + (T - 2)·walk(3)``, exact since
  every step runs the same ops.
* :func:`analyze_lowered` walks a ``"dhlo"`` artifact's DHLO graph at one
  bucket's concrete sizes.  Bytes count at the fusion plan's cluster
  boundaries only (the values a cluster reads from outside it and the
  values it leaves live), the port's form of "fused internals are
  free"; a region body (``d.scan``, ``d.while``, ``d.cond``) runs op by
  op, so each of its ops is a boundary; a ``d.scan`` is multiplied by its
  trip count.

FLOPs follow the reference's conventions (``hlo_cost.py``): a contraction
(``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` / ``repro_torch::dot_general``,
DHLO ``dot_general``) counts 2·|out|·K with K the contracted extent; an
elementwise op |out|; a reduction |in|; data movement none.

Two facts bound what the walks see:

* a kernel wrapper (flash attention, the norms, the masked softmax, the
  WKV and SSD scans) is counted as its plain version's ops, because the
  trace records those (the dry run traces inside ``plain_versions()``,
  as the DHLO bridge does): a fused kernel moves fewer bytes than its
  plain version's launches do;
* the walks are per rank: a graph traced over DTensors on a mesh is the
  per-rank program (local shards and the collectives between them), and
  callers multiply by the chip count for global terms.
"""
from __future__ import annotations

import math
import operator
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional

import torch

__all__ = ["Cost", "COLLECTIVES", "HLO_NAMES", "analyze_graph",
           "analyze_lowered", "node_bytes", "cluster_costs"]

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: the port's collective kinds (``dist/collectives.py``) under the
#: reference's HLO names; broadcast, the port's one collective that moves
#: a single rank's buffer to the others, is reported as the reference's
#: point-to-point kind
HLO_NAMES = {"all_reduce": "all-reduce", "all_gather": "all-gather",
             "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
             "broadcast": "collective-permute"}


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = field(default_factory=lambda: {
        k: 0.0 for k in COLLECTIVES})
    coll_count: float = 0.0
    #: while-loop bodies counted once (their trip count is not static)
    while_loops: int = 0

    def __iadd__(self, other: "Cost"):
        self.flops += other.flops
        self.bytes += other.bytes
        for k in self.coll:
            self.coll[k] += other.coll[k]
        self.coll_count += other.coll_count
        self.while_loops += other.while_loops
        return self

    def scaled(self, m: float) -> "Cost":
        return Cost(self.flops * m, self.bytes * m,
                    {k: v * m for k, v in self.coll.items()},
                    self.coll_count * m, self.while_loops)

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll.values())


# ------------------------------------------------------------ op table --
# one table for both walks, by op name: the ATen overload packet's name
# for the FX walk, the DHLO opcode for the DHLO walk

#: contractions: 2·|out|·K
DOT_OPS = frozenset({"mm", "bmm", "addmm", "baddbmm", "dot_general",
                     "matmul", "addbmm", "mv", "dot", "convolution"})

#: reductions (and scans along an axis): |in|
REDUCE_OPS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax",
    "argmin", "var", "std", "var_mean", "logsumexp", "norm",
    "linalg_vector_norm", "any", "all", "cumsum", "cumprod", "sort",
    "topk", "_log_softmax", "_softmax", "nansum",
    "reduce_sum", "reduce_max", "reduce_min", "reduce_prod", "argmax",
    "reduce_and", "reduce_or", "cumlogsumexp",
})

#: data movement: no flops; a launch's bytes (free in the FX walk where
#: the op is a view, by its schema)
MOVE_OPS = frozenset({
    "clone", "copy", "copy_", "_to_copy", "to", "cat", "concatenate",
    "stack", "pad", "constant_pad_nd", "transpose", "permute", "reshape",
    "view", "expand", "broadcast_in_dim", "convert", "slice", "dslice",
    "dynamic_slice", "dynamic_update_slice", "select", "index",
    "index_select", "gather", "embedding", "scatter", "scatter_add",
    "index_put", "_unsafe_index_put", "index_add", "slice_scatter",
    "select_scatter", "flip", "rev", "roll", "repeat", "iota", "arange",
    "zeros", "zeros_like", "ones", "ones_like", "full", "full_like",
    "new_zeros", "new_ones", "new_full", "fill", "scalar_tensor",
    "_unsafe_view", "lift_fresh_copy", "alias", "tril", "triu",
    "stop_gradient", "split", "split_with_sizes", "unbind", "chunk",
    "narrow",
})

#: window reads: twice the output's bytes (the reference's slice rule)
WINDOW_OPS = frozenset({"slice", "dslice", "dynamic_slice", "select",
                        "index", "index_select", "gather", "embedding",
                        "narrow"})
#: in-place updates of a window: twice the update's bytes
UPDATE_OPS = frozenset({"dynamic_update_slice", "scatter", "scatter_add",
                        "index_put", "_unsafe_index_put", "index_add",
                        "slice_scatter", "select_scatter"})

#: allocation and metadata only: no launch
FREE_OPS = frozenset({"empty", "empty_like", "empty_strided",
                      "new_empty", "new_empty_strided", "sym_size",
                      "sym_stride", "sym_numel", "sym_storage_offset",
                      "detach", "lift_fresh", "_assert_async",
                      "_assert_scalar", "record_stream",
                      "_local_scalar_dense", "resize_"})

_DTYPE_BYTES: Dict[Any, int] = {}


def _itemsize(dtype) -> int:
    n = _DTYPE_BYTES.get(dtype)
    if n is None:
        n = _DTYPE_BYTES[dtype] = torch.empty((), dtype=dtype).element_size()
    return n


def _tensors(v) -> List[torch.Tensor]:
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, (list, tuple)):
        return [t for x in v for t in _tensors(x)]
    return []


def _numel(t) -> int:
    return int(math.prod(int(s) for s in t.shape))


def _nbytes(t) -> int:
    return _numel(t) * _itemsize(t.dtype)


def node_bytes(node) -> int:
    """Bytes of an FX node's value (its ``meta["val"]``), 0 if none."""
    return sum(_nbytes(t) for t in _tensors(node.meta.get("val")))


def _op_flops(name: str, out_elems: int, in_elems: int, k: int) -> float:
    if name in DOT_OPS:
        return 2.0 * out_elems * k
    if name in REDUCE_OPS:
        return float(in_elems)
    if name in MOVE_OPS or name in FREE_OPS:
        return 0.0
    return float(out_elems)


# ------------------------------------------------------------ FX walk --
def _is_view(target) -> bool:
    """A view (or an op that only relabels its input): an output that
    aliases an input without writing it."""
    schema = getattr(target, "_schema", None)
    if schema is None:
        return False
    for r in schema.returns:
        a = r.alias_info
        if a is not None and not a.is_write:
            return True
    return False


def _fx_contracted(name: str, node) -> int:
    args = node.args
    val = lambda a: a.meta.get("val") if hasattr(a, "meta") else None  # noqa
    if name in ("mm", "bmm", "matmul", "mv", "dot"):
        return int(val(args[0]).shape[-1])
    if name in ("addmm", "baddbmm", "addbmm"):
        return int(val(args[1]).shape[-1])
    if name == "dot_general":
        lhs, lc = val(args[0]), args[2]
        return int(math.prod(int(lhs.shape[i]) for i in lc))
    if name == "convolution":
        w = val(args[1])
        return int(math.prod(int(s) for s in w.shape[1:]))
    return 1


def _subgraph(gm, node_arg):
    return getattr(gm, node_arg.target)


def analyze_graph(gm) -> Cost:
    """Per-rank cost of an ATen FX graph (see the module docstring)."""
    total = Cost()
    hop = torch.ops.higher_order
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        t = node.target
        if t is operator.getitem:
            continue
        if t is getattr(hop, "scan", None):
            combine, _, xs = node.args[0], node.args[1], node.args[2]
            xs_vals = _tensors([x.meta.get("val") for x in xs])
            trips = int(xs_vals[0].shape[0]) if xs_vals else 1
            total += analyze_graph(_subgraph(gm, combine)).scaled(trips)
            continue
        if t is getattr(hop, "while_loop", None):
            cond_gm, body_gm = node.args[0], node.args[1]
            body = analyze_graph(_subgraph(gm, body_gm))
            body += analyze_graph(_subgraph(gm, cond_gm))
            body.while_loops += 1
            total += body
            continue
        if t is getattr(hop, "cond", None):
            branches = [analyze_graph(_subgraph(gm, b))
                        for b in node.args[1:3]]
            total += max(branches, key=lambda c: (c.flops, c.bytes))
            continue
        if not isinstance(t, torch._ops.OpOverload):
            continue
        steps = _stepwise_cost(node)
        if steps is not None:
            total += steps
            continue
        ns = t.namespace
        name = t._opname
        out_b = node_bytes(node)
        ins = []
        seen = set()
        for a in node.all_input_nodes:
            if a not in seen:
                seen.add(a)
                ins.append(a)
        in_b = sum(node_bytes(a) for a in ins)
        if ns == "_c10d_functional":
            hlo = _collective_kind(name)
            if hlo is None:        # wait_tensor and friends: free
                continue
            c = Cost()
            first = node.args[0] if node.args else None
            op_b = sum(node_bytes(a) for a in _fx_nodes(first)) or out_b
            c.coll[hlo] += op_b
            c.coll_count += 1
            c.bytes += out_b + op_b
            total += c
            continue
        if name in FREE_OPS or _is_view(t):
            continue
        outs = _tensors(node.meta.get("val"))
        out_elems = sum(_numel(x) for x in outs)
        first_in = _tensors(ins[0].meta.get("val")) if ins else []
        in_elems = _numel(first_in[0]) if first_in else 0
        k = _fx_contracted(name, node) if name in DOT_OPS else 1
        total.flops += _op_flops(name, out_elems, in_elems, k)
        if name in WINDOW_OPS:
            idx_b = sum(node_bytes(a) for a in ins[1:])
            total.bytes += 2 * out_b + idx_b
        elif name in UPDATE_OPS:
            upd = ins[-1] if len(ins) > 1 else None
            upd_b = node_bytes(upd) if upd is not None else out_b
            total.bytes += 2 * upd_b + sum(node_bytes(a) for a in ins[1:-1])
        else:
            total.bytes += in_b + out_b
    return total


def _stepwise_cost(node) -> Optional[Cost]:
    """The walk of a recurrence op's loop at ``node``'s shapes, extended
    over its T (see the module docstring); None for any other op."""
    from ..kernels.rwkv6.ref import STEPWISE

    entry = STEPWISE.get(node.target)
    if entry is None:
        return None
    fn, t_args = entry
    vals = [a.meta.get("val") if hasattr(a, "meta") else a
            for a in node.args]
    t = int(vals[t_args[0]].shape[2])
    total = _loop_walk(fn, t_args, vals, 2).scaled(3 - t)
    total += _loop_walk(fn, t_args, vals, 3).scaled(t - 2)
    return total


def _loop_walk(fn, t_args, vals: List[Any], steps: int) -> Cost:
    """The walk of ``fn`` traced at ``steps`` steps on fake inputs of
    ``vals``' shapes (axis 2, T, of the arguments ``t_args`` names set
    to ``steps``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    args = []
    with FakeTensorMode():
        for i, v in enumerate(vals):
            if isinstance(v, torch.Tensor):
                shape = list(v.shape)
                if i in t_args:
                    shape[2] = steps
                v = torch.empty(shape, dtype=v.dtype)
            args.append(v)
    return analyze_graph(make_fx(lambda *a: fn(*a),
                                 tracing_mode="fake")(*args))


def _fx_nodes(arg) -> List[Any]:
    if hasattr(arg, "meta"):
        return [arg]
    if isinstance(arg, (list, tuple)):
        return [n for a in arg for n in _fx_nodes(a)]
    return []


def _collective_kind(opname: str) -> Optional[str]:
    from ..dist.collectives import COLLECTIVE_KINDS

    kind = COLLECTIVE_KINDS.get(opname)
    return None if kind is None else HLO_NAMES[kind]


# ---------------------------------------------------------- DHLO walk --
class _Sizes:
    """Concrete extents of a lowered graph's dims at one bucket."""

    def __init__(self, lowered, sizes: Dict[str, int]) -> None:
        from ..core.codegen import _ShapeEnv

        missing = [n for n in lowered.sym_names if n not in sizes]
        if missing:
            raise KeyError(f"analyze_lowered: no size for the dims "
                           f"{missing} (declared: {list(lowered.sym_names)})")
        store = lowered.graph.store
        padded = {}
        for s in lowered.syms:
            c = store.canon_dim(s)
            if not isinstance(c, int):
                padded[c.uid] = int(sizes[s.name])
        self.env = _ShapeEnv(lowered.graph, padded, {}, "cpu")

    def shape(self, v) -> List[int]:
        return [self.env.padded_dim(d) for d in v.shape]

    def elems(self, v) -> int:
        return int(math.prod(self.shape(v)))

    def bytes(self, v) -> int:
        return self.elems(v) * _itemsize(v.dtype)


def _dhlo_op_cost(op, sz: _Sizes, boundary: bool) -> Cost:
    """One DHLO op: its flops, its region bodies, and (``boundary``: it
    runs as a launch of its own) its bytes."""
    c = Cost()
    name = op.opcode
    if name == "d.scan":
        trips = sz.env.padded_dim(op.attrs["length_dim"])
        return _region_cost(op.attrs["body_graph"], sz).scaled(trips)
    if name == "d.while":
        body = _region_cost(op.attrs["body_graph"], sz)
        body += _region_cost(op.attrs["cond_graph"], sz)
        body.while_loops += 1
        return body
    if name == "d.cond":
        branches = [_region_cost(g, sz) for g in op.attrs["branch_graphs"]]
        return max(branches, key=lambda b: (b.flops, b.bytes))
    out_elems = sum(sz.elems(o) for o in op.outputs)
    in_elems = sz.elems(op.inputs[0]) if op.inputs else 0
    k = 1
    if name == "dot_general":
        (lc, _), _ = op.attrs["dimension_numbers"]
        lshape = sz.shape(op.inputs[0])
        k = int(math.prod(lshape[i] for i in lc))
    c.flops += _op_flops(name, out_elems, in_elems, k)
    if boundary:
        c.bytes += _boundary_bytes(op.all_operands(), op.outputs, sz)
    return c


def _boundary_bytes(ins: Iterable[Any], outs: Iterable[Any],
                    sz: _Sizes) -> int:
    seen, total = set(), 0
    for v in ins:
        if v.literal is None and v.vid not in seen:
            seen.add(v.vid)
            total += sz.bytes(v)
    return total + sum(sz.bytes(o) for o in outs)


def _region_cost(graph, sz: _Sizes) -> Cost:
    """A region body: its ops run one by one, each a launch."""
    total = Cost()
    for op in graph.ops:
        total += _dhlo_op_cost(op, sz, boundary=True)
    return total


def cluster_costs(lowered, sizes: Dict[str, int]) -> List[Dict[str, Any]]:
    """Each cluster of a ``"dhlo"`` artifact's fusion plan at one
    bucket's ``sizes`` (``{dim name: extent}``), in plan order:
    ``{"cid", "kind", "template", "opcodes", "cost"}``."""
    from ..core.fusion import cluster_live_outs

    if lowered.graph is None or lowered.plan is None:
        raise ValueError("analyze_lowered walks a 'dhlo' artifact; this one "
                         f"is {lowered.pipeline!r}")
    graph = lowered.graph
    sz = _Sizes(lowered, sizes)
    users = graph.users()
    out_ids = {o.vid for o in graph.outputs}
    rows = []
    for cl in lowered.plan.clusters:
        c = Cost()
        member = {o.vid for op in cl.ops for o in op.outputs}
        ins = [v for op in cl.ops for v in op.all_operands()
               if v.vid not in member]
        for op in cl.ops:
            c += _dhlo_op_cost(op, sz, boundary=False)
        c.bytes += _boundary_bytes(
            ins, cluster_live_outs(graph, cl, users, out_ids), sz)
        rows.append({"cid": cl.cid, "kind": cl.kind,
                     "template": cl.template,
                     "opcodes": [op.opcode for op in cl.ops], "cost": c})
    return rows


def analyze_lowered(lowered, sizes: Dict[str, int]) -> Cost:
    """Per-rank cost of a ``"dhlo"`` artifact at one bucket's ``sizes``
    (``{dim name: extent}``, every declared dim): the sum of
    :func:`cluster_costs`."""
    total = Cost()
    for row in cluster_costs(lowered, sizes):
        total += row["cost"]
    return total
