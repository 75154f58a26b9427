"""Shape-class fusion planner — DISC §4.3.

    "A common fusion strategy is to allow memory bound ops with the same
     number of elements to be fused together.  However, the tensor shapes to
     process are not known at compile time for dynamic shape scenarios."

The planner never looks at concrete sizes.  Fusion legality between a
producer/consumer pair of *memory-intensive* ops is decided from the two
shape hints of the paper:

* **shape propagation** — the per-op-class transfer rules
  (``propagation.OP_TABLE``) let shape equality flow through elementwise
  chains, transposes, reshapes;
* **shape constraints** — tensor-size equality / dim equality from the
  :class:`ShapeConstraintStore`, including frontend-injected hints (e.g.
  ``split`` outputs), which enlarge fusion scope beyond what local
  propagation can prove.

Cluster kinds mirror the paper's codegen templates:

* ``loop``  — classical loop fusion with an elementwise root (the paper's
  **kLoop**): every member writes/reads values of one shape class, so the
  whole cluster lowers to a single flattened loop over the element domain;
* ``input`` — input fusion with a reduce op as the root (the paper's
  **kInput**): elementwise producers are recomputed inside the reduce's
  loop nest instead of materializing an intermediate;
* ``dot``   — a ``dot_general`` plus its elementwise *epilogue*
  (bias add / activation / residual), the **kDot** extension: the
  compute-intensive root still comes from the static-shape kernel library
  (§4.5) but its elementwise consumers are folded into the GEMM's output
  tiles instead of launching a separate memory-bound kernel;
* ``compute`` / ``opaque`` — unfused ops (library calls, gathers, ...).

Eligibility for the *backend fused-kernel templates* is also decided here,
at plan time: each cluster carries ``template`` — ``"kLoop"``,
``"kInput"``, ``"kDot"``, or ``None`` — so backends (``core/codegen.py``,
``api/backends.py``) dispatch on the plan instead of re-deriving
eligibility from private predicates.
"""
from __future__ import annotations

import itertools
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .dhlo import DGraph, DOp, DValue
from .propagation import CostClass, PropClass, op_info

__all__ = [
    "Cluster",
    "FusionPlan",
    "plan_fusion",
    "cluster_live_outs",
    "PALLAS_ELEMENTWISE_OPS",
    "REDUCE_ROOT_KINDS",
]


# opcodes whose emission is shape-oblivious on a flattened block — the
# eligibility set for the backend fused-kernel templates (§4.3).  Shared
# with ``core/codegen.py``; kept here because eligibility is a *plan*
# property, not a codegen one.  (The name is the JAX package's, whose
# fused kernels are Pallas; here they are the Hopper kernels.)
PALLAS_ELEMENTWISE_OPS = frozenset({
    "add", "sub", "mul", "div", "max", "min", "pow", "neg", "exp", "exp2",
    "expm1", "log", "log1p", "tanh", "logistic", "sqrt", "rsqrt", "abs",
    "sign", "floor", "ceil", "round", "erf", "sin", "cos", "square",
    "integer_pow", "select", "convert", "stop_gradient", "copy",
    "eq", "ne", "lt", "gt", "le", "ge", "and", "or", "not",
})

# reduce opcodes a kInput root may use, mapped to the fused-reduce kernel's
# combiner name
REDUCE_ROOT_KINDS = {"reduce_sum": "sum", "reduce_max": "max",
                     "reduce_min": "min", "reduce_prod": "prod"}


@dataclass
class Cluster:
    cid: int
    kind: str  # "loop" | "input" | "dot" | "compute" | "opaque"
    ops: List[DOp] = field(default_factory=list)
    # Fused-kernel template this cluster can execute as ("kLoop" | "kInput"
    # | "kDot"), or None when only per-op execution is possible.  Decided
    # once at plan time by ``plan_fusion``.
    template: Optional[str] = None

    @property
    def root(self) -> DOp:
        return self.ops[-1]

    def __repr__(self) -> str:  # pragma: no cover
        t = f" [{self.template}]" if self.template else ""
        return f"<Cluster {self.cid} {self.kind}{t}: {[o.opcode for o in self.ops]}>"


@dataclass
class FusionPlan:
    graph: DGraph
    clusters: List[Cluster]
    op_to_cluster: Dict[int, int]

    @property
    def n_kernels(self) -> int:
        """Number of launched kernels after fusion (paper Table 3 metric)."""
        return len(self.clusters)

    @property
    def n_memory_kernels(self) -> int:
        return sum(1 for c in self.clusters if c.kind in ("loop", "input"))

    def template_counts(self) -> Dict[str, int]:
        """How many clusters each fused-kernel template covers."""
        out: Dict[str, int] = {}
        for c in self.clusters:
            if c.template:
                out[c.template] = out.get(c.template, 0) + 1
        return out

    def stats(self) -> Dict[str, int]:
        mem_ops = sum(
            1 for op in self.graph.ops if op_info(op.opcode).cost is CostClass.MEMORY
        )
        return {
            "total_ops": len(self.graph.ops),
            "memory_ops": mem_ops,
            "kernels_after_fusion": self.n_kernels,
            "memory_kernels_after_fusion": self.n_memory_kernels,
            "largest_cluster": max((len(c.ops) for c in self.clusters), default=0),
            "fusable_clusters": sum(1 for c in self.clusters if c.template),
        }


# fusable propagation classes for loop fusion members
_LOOP_FUSABLE = {
    PropClass.ELEMENTWISE,
    PropClass.BROADCAST,
    PropClass.RESHAPE,
    PropClass.TRANSPOSE,
    PropClass.SLICE,
    PropClass.CONCAT,
    PropClass.IOTA,
    PropClass.UPDATE,
}


class _ClusterSet:
    """Union-find over op ids with per-cluster successor tracking for the
    cycle check (merging A→B is illegal if A reaches B via a third cluster)."""

    def __init__(self, graph: DGraph) -> None:
        self.graph = graph
        self.parent: Dict[int, int] = {op.oid: op.oid for op in graph.ops}
        self.members: Dict[int, List[DOp]] = {op.oid: [op] for op in graph.ops}
        # op-level edges
        self.succs: Dict[int, Set[int]] = defaultdict(set)
        producer = {}
        for op in graph.ops:
            for o in op.outputs:
                producer[o.vid] = op.oid
        for op in graph.ops:
            for v in op.all_operands():
                if v.vid in producer:
                    self.succs[producer[v.vid]].add(op.oid)

    def find(self, oid: int) -> int:
        p = self.parent[oid]
        if p != oid:
            p = self.find(p)
            self.parent[oid] = p
        return p

    def cluster_succs(self, root: int) -> Set[int]:
        out: Set[int] = set()
        for op in self.members[root]:
            for s in self.succs[op.oid]:
                rs = self.find(s)
                if rs != root:
                    out.add(rs)
        return out

    def would_cycle(self, a: int, b: int) -> bool:
        """True if merging clusters a,b creates a cycle: a path a→…→b (or
        b→…→a) through a third cluster."""
        for start, goal in ((a, b), (b, a)):
            stack = [s for s in self.cluster_succs(start) if s != goal]
            seen: Set[int] = set(stack)
            while stack:
                cur = stack.pop()
                if cur == goal:
                    return True
                for s in self.cluster_succs(cur):
                    if s not in seen and s != start:
                        seen.add(s)
                        stack.append(s)
        return False

    def merge(self, a: int, b: int) -> int:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return ra
        # keep topological order of members by op id (construction order)
        merged = sorted(self.members[ra] + self.members[rb], key=lambda o: o.oid)
        self.parent[rb] = ra
        self.members[ra] = merged
        del self.members[rb]
        return ra


def _is_tiny(graph: DGraph, v: DValue) -> bool:
    """Scalar/small constants broadcast implicitly inside a fused loop."""
    e = graph.store.size_expr(v.vid)
    return e is not None and e.is_static() and e.coeff <= 4096


def _broadcast_compatible(graph: DGraph, pshape, cshape) -> bool:
    """Producer shape feeds consumer via implicit broadcast (§4.3: "whether
    an implicit broadcast is necessary") — per-dim equal or producer dim 1."""
    if len(pshape) == 0:
        return True
    if len(pshape) != len(cshape):
        return False
    store = graph.store
    for dp, dc in zip(pshape, cshape):
        if isinstance(dp, int) and dp == 1:
            continue
        if not store.dims_equal(dp, dc):
            return False
    return True


# ------------------------------------------------------------ templates --

def cluster_live_outs(graph: DGraph, cluster: Cluster,
                      users: Optional[Dict[int, List[DOp]]] = None,
                      out_ids: Optional[Set[int]] = None) -> List[DValue]:
    """Values produced inside ``cluster`` that are observable outside it:
    graph outputs, or operands of ops in other clusters.  A fused cluster
    kernel must materialize exactly these (in this, deterministic, order)."""
    if users is None:
        users = graph.users()
    if out_ids is None:
        out_ids = {o.vid for o in graph.outputs}
    member = {op.oid for op in cluster.ops}
    live: List[DValue] = []
    for op in cluster.ops:
        for o in op.outputs:
            if o.vid in out_ids or any(
                    u.oid not in member for u in users.get(o.vid, ())):
                live.append(o)
    return live


def _same_class(store, shape, ref) -> bool:
    return len(shape) == len(ref) and store.shapes_equal(shape, ref)


def _block_operand_ok(graph: DGraph, v: DValue, ref) -> bool:
    """A value a fused-kernel body may touch as a block: scalar (closure
    captured), ref-class, or broadcastable into ref (the runner
    pre-broadcasts boundary operands, so inside the kernel everything is
    ref-shaped)."""
    if v.rank == 0:
        return True
    return (_same_class(graph.store, v.shape, ref)
            or _broadcast_compatible(graph, v.shape, ref))


def _hoistable_broadcast(op: DOp, produced: Set[int]) -> bool:
    """A ``broadcast_in_dim`` whose operands all come from outside the
    cluster: emitted outside the kernel (prologue), its output streams in
    as a boundary block."""
    return (op.opcode == "broadcast_in_dim"
            and not any(v.vid in produced for v in op.inputs))


def _plain_2d_matmul(dot: DOp) -> bool:
    dn = dot.attrs.get("dimension_numbers")
    if dn is None:
        return False
    (lc, rc), (lb, rb) = dn
    return (tuple(lc), tuple(rc), tuple(lb), tuple(rb)) == ((1,), (0,), (), ()) \
        and dot.inputs[0].rank == 2 and dot.inputs[1].rank == 2


def _classify_loop(graph: DGraph, cl: Cluster, users, out_ids) -> Optional[str]:
    """kLoop: ONE flattened masked kernel writing every live-out.  Every
    body op must be shape-oblivious elementwise over one shape class
    (scalars closure-captured, broadcast-compatible boundary operands
    pre-broadcast by the runner, boundary ``broadcast_in_dim`` ops hoisted
    to a prologue).  Multiple live-outs are fine — the kernel writes N
    output refs."""
    if len(cl.ops) < 2:
        return None
    store = graph.store
    produced = {o.vid for op in cl.ops for o in op.outputs}
    body = [op for op in cl.ops if op.opcode != "broadcast_in_dim"]
    if not body:
        return None
    # the block shape class: the maximal (non-broadcast) body output class
    ref = None
    for op in body:
        for v in op.outputs:
            if v.rank == 0:
                continue
            if ref is None or not _broadcast_compatible(graph, v.shape, ref):
                ref = v.shape
    if ref is None:
        return None
    for op in cl.ops:
        if op.opcode not in PALLAS_ELEMENTWISE_OPS:
            if not _hoistable_broadcast(op, produced):
                return None
            if not _broadcast_compatible(graph, op.outputs[0].shape, ref):
                return None
            continue
        for v in list(op.inputs) + list(op.outputs):
            if not _block_operand_ok(graph, v, ref):
                return None
    for v in cluster_live_outs(graph, cl, users, out_ids):
        p = graph.producer(v)
        if p is not None and p.opcode == "broadcast_in_dim":
            continue  # prologue value, materialized outside the kernel
        if v.rank == 0 or not _same_class(store, v.shape, ref):
            return None  # the kernel only stores full ref-class blocks
    return "kLoop"


def _classify_input(graph: DGraph, cl: Cluster, users, out_ids) -> Optional[str]:
    """kInput: shape-oblivious producers + ONE single-axis reduce root.
    Any reduce axis is allowed — the backend normalizes to a last-axis
    reduce with a symbolic transpose (elementwise producers commute with
    it).  Only the root may escape: the kernel materializes one result."""
    if len(cl.ops) < 2:
        return None
    root = cl.ops[-1]
    if root.opcode not in REDUCE_ROOT_KINDS:
        return None
    if len(tuple(root.attrs.get("axes", ()))) != 1:
        return None
    produced = {o.vid for op in cl.ops for o in op.outputs}
    ref = root.inputs[0].shape
    for op in cl.ops[:-1]:
        if op.opcode not in PALLAS_ELEMENTWISE_OPS:
            if not _hoistable_broadcast(op, produced):
                return None
            if not _broadcast_compatible(graph, op.outputs[0].shape, ref):
                return None
            continue
        for v in list(op.inputs) + list(op.outputs):
            if not _block_operand_ok(graph, v, ref):
                return None
    live = cluster_live_outs(graph, cl, users, out_ids)
    if [v.vid for v in live] != [root.outputs[0].vid]:
        return None
    return "kInput"


def _classify_dot(graph: DGraph, cl: Cluster, users, out_ids) -> Optional[str]:
    """kDot: one plain 2-D ``dot_general`` whose elementwise epilogue runs
    on the GEMM's output tiles.  Cluster members split into a *prologue*
    (ops not depending on the dot — e.g. a bias ``broadcast_in_dim`` —
    emitted outside the kernel) and the *epilogue* (everything downstream
    of the accumulator, which must be shape-oblivious elementwise over the
    dot's output class)."""
    dots = [op for op in cl.ops if op_info(op.opcode).cost is CostClass.COMPUTE]
    if len(dots) != 1 or dots[0].opcode != "dot_general":
        return None
    dot = dots[0]
    if not _plain_2d_matmul(dot):
        return None
    produced = {o.vid for op in cl.ops for o in op.outputs}
    if any(v.vid in produced for v in dot.inputs):
        return None  # dot operands must be cluster boundaries (no prologue into the MXU)
    store = graph.store
    ref = dot.outputs[0].shape
    dep = {dot.outputs[0].vid}
    for op in cl.ops:  # topological
        if op is dot:
            continue
        if any(v.vid in dep for v in op.inputs):
            # epilogue op: runs on (block_m, block_n) accumulator tiles
            # (broadcast-compatible operands are pre-broadcast to (M, N)
            # outside the kernel)
            if op.opcode not in PALLAS_ELEMENTWISE_OPS:
                return None
            for v in list(op.inputs) + list(op.outputs):
                if not _block_operand_ok(graph, v, ref):
                    return None
            dep.update(o.vid for o in op.outputs)
        else:
            # prologue op: materialized outside the kernel before launch
            if op.opcode not in PALLAS_ELEMENTWISE_OPS and \
                    op.opcode != "broadcast_in_dim":
                return None
    # kernel-stored live-outs must be full (M, N) tiles
    for v in cluster_live_outs(graph, cl, users, out_ids):
        if v.vid in dep and (v.rank == 0
                             or not _same_class(store, v.shape, ref)):
            return None
    return "kDot"


def _classify(graph: DGraph, cl: Cluster, users, out_ids) -> Optional[str]:
    if cl.kind == "loop":
        return _classify_loop(graph, cl, users, out_ids)
    if cl.kind == "input":
        return _classify_input(graph, cl, users, out_ids)
    if cl.kind == "dot":
        return _classify_dot(graph, cl, users, out_ids)
    return None


# ----------------------------------------------------------------- plan --

def plan_fusion(graph: DGraph) -> FusionPlan:
    store = graph.store
    cs = _ClusterSet(graph)
    kinds: Dict[int, str] = {}

    for op in graph.ops:
        info = op_info(op.opcode)
        if info.cost is CostClass.COMPUTE:
            kinds[op.oid] = "compute"
        elif info.cost is CostClass.SHAPE:
            kinds[op.oid] = "opaque"
        elif info.prop in _LOOP_FUSABLE:
            kinds[op.oid] = "loop"
        elif info.prop is PropClass.REDUCE:
            kinds[op.oid] = "input"
        else:
            kinds[op.oid] = "opaque"

    producer = {}
    for op in graph.ops:
        for o in op.outputs:
            producer[o.vid] = op

    def out_value(op: DOp) -> DValue:
        return op.outputs[0]

    def fusable_edge(p: DOp, c: DOp) -> bool:
        """Shape-hint legality of fusing producer p into consumer c."""
        kp, kc = kinds[cs.find(p.oid)], kinds[cs.find(c.oid)]
        if kp == "opaque" or kc == "opaque":
            return False
        if c.opcode == "dot_general" or kc == "compute":
            # nothing fuses into a dot's operands (the GEMM prologue stays
            # a cluster boundary); non-dot compute ops never fuse
            return False
        pv = out_value(p)
        if kp == "compute":
            # kDot seed: a dot_general absorbs an elementwise consumer
            # whose result shares the dot output's shape class (§4.3
            # epilogue fusion; template legality is re-checked at
            # classification time — e.g. batched dots stay per-op)
            if p.opcode != "dot_general" or kc != "loop":
                return False
            cv = out_value(c)
            return (store.sizes_equal(pv.vid, cv.vid)
                    or _broadcast_compatible(graph, pv.shape, cv.shape))
        if kp == "input":
            # a reduce is a cluster *root*: nothing fuses after it within
            # the cluster (paper: input fusion with reduce as the root)
            return False
        if "dot" in (kp, kc):
            # a dot cluster grows only by elementwise epilogue ops and
            # their loop-kind producers; reduces stay outside and two dots
            # never share a cluster
            if kp == "dot" and kc == "dot":
                return False
            if {kp, kc} - {"dot", "loop"}:
                return False
            cv = out_value(c)
            return (store.sizes_equal(pv.vid, cv.vid)
                    or _broadcast_compatible(graph, pv.shape, cv.shape)
                    or _is_tiny(graph, pv))
        if kc == "input":
            # kInput: producers fuse if they share the reduce's INPUT size
            red_in = c.inputs[0]
            return (store.sizes_equal(pv.vid, red_in.vid)
                    or _broadcast_compatible(graph, pv.shape, red_in.shape)
                    or _is_tiny(graph, pv))
        # kLoop: same element count (the paper's classic rule), proven via
        # constraints — or implicit broadcast into the consumer's shape
        cv = out_value(c)
        return (store.sizes_equal(pv.vid, cv.vid)
                or _broadcast_compatible(graph, pv.shape, cv.shape)
                or _is_tiny(graph, pv))

    for op in graph.ops:  # topological
        for v in op.inputs:
            p = producer.get(v.vid)
            if p is None:
                continue
            ra, rb = cs.find(p.oid), cs.find(op.oid)
            if ra == rb:
                continue
            if not fusable_edge(p, op):
                continue
            if cs.would_cycle(ra, rb):
                continue
            ka, kb = kinds[ra], kinds[rb]
            if "dot" in (ka, kb) or "compute" in (ka, kb):
                new_kind = "dot"
            elif "input" in (ka, kb):
                new_kind = "input"
            else:
                new_kind = "loop"
            root = cs.merge(ra, rb)
            kinds[root] = new_kind

    clusters: List[Cluster] = []
    op_to_cluster: Dict[int, int] = {}
    cid_iter = itertools.count()
    roots = sorted(cs.members.keys(), key=lambda r: cs.members[r][0].oid)
    for root in roots:
        cid = next(cid_iter)
        cl = Cluster(cid=cid, kind=kinds[root], ops=cs.members[root])
        clusters.append(cl)
        for m in cl.ops:
            op_to_cluster[m.oid] = cid
    clusters = _toposort_clusters(clusters)
    # template classification: backend fused-kernel eligibility is decided
    # here, on the plan, not inside codegen
    users = graph.users()
    out_ids = {o.vid for o in graph.outputs}
    for cl in clusters:
        cl.template = _classify(graph, cl, users, out_ids)
    return FusionPlan(graph=graph, clusters=clusters, op_to_cluster=op_to_cluster)


def _toposort_clusters(clusters: List[Cluster]) -> List[Cluster]:
    """Order clusters topologically (executors run them in list order).

    First-op order is NOT sufficient: a fused cluster executes *all* its
    ops at once, so a cluster whose earliest op traces before another
    cluster may still consume that cluster's output (e.g. an elementwise
    cluster reading a reduce it post-dominates).  The merge step's cycle
    check guarantees the cluster DAG is acyclic; ties break by cid for
    determinism."""
    import heapq

    producer_cluster: Dict[int, int] = {}
    for cl in clusters:
        for op in cl.ops:
            for o in op.outputs:
                producer_cluster[o.vid] = cl.cid
    by_cid = {cl.cid: cl for cl in clusters}
    indeg = {cl.cid: 0 for cl in clusters}
    succs: Dict[int, Set[int]] = defaultdict(set)
    for cl in clusters:
        for op in cl.ops:
            for v in op.all_operands():
                pc = producer_cluster.get(v.vid)
                if pc is not None and pc != cl.cid and cl.cid not in succs[pc]:
                    succs[pc].add(cl.cid)
                    indeg[cl.cid] += 1
    heap = [cid for cid, d in indeg.items() if d == 0]
    heapq.heapify(heap)
    ordered: List[Cluster] = []
    while heap:
        cid = heapq.heappop(heap)
        ordered.append(by_cid[cid])
        for s in sorted(succs[cid]):
            indeg[s] -= 1
            if indeg[s] == 0:
                heapq.heappush(heap, s)
    assert len(ordered) == len(clusters), "cluster DAG has a cycle"
    return ordered
