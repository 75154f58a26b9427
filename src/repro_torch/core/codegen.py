"""Code generation: DHLO graph → per-bucket executors — DISC §4.3.

Two executors are generated from one graph:

* :func:`build_exact_executor` — runs the graph at the call's exact
  concrete shapes.  Used by the static-fallback path (§4.4) and as the
  correctness oracle.
* :func:`build_padded_executor` — the dynamic-shape artifact: built once
  per *bucket signature*, it executes at padded shapes while taking the
  **actual lengths as runtime host ints** (``lens``).  Masking makes it
  exact for every shape ≤ bucket:

  - inputs are zero-padded by the generated dispatch, so padded regions
    start clean;
  - every *position-mixing* op (reduce, dot contraction, reverse cumsum,
    sort, arg-reduce) masks dynamic axes with the op's padding identity
    (``propagation.OP_TABLE.pad_identity``) right before mixing;
  - masks are canonical per symbolic dim: prefix masks ``iota < len`` for
    input symbols, Kronecker products for reshape-merged dims (matching the
    row-major garbage pattern of reshaped padded data), prefix masks for
    concat-sum / slice-affine dims;
  - ``concatenate`` along a dynamic axis is re-emitted as writes at the
    *actual* offsets, keeping valid data prefix-contiguous.

Each bucket's executor runs eagerly on the card: per-op torch for the
ops outside fused clusters, and one hand-written kernel launch per fused
cluster.  The lengths stay host ints and reach the kernels as runtime
arguments, so a new length inside a bucket launches the same compiled
kernels (the paper's "shape-adaptive" codegen).

Fused-cluster execution is organized around the :class:`ClusterKernel`
protocol: the fusion plan marks each cluster with the codegen *template*
it can execute as (``"kLoop"``, ``"kInput"``, ``"kDot"`` — see
``core/fusion.py``), and a backend supplies one kernel object per template
it implements.  The Hopper set (:func:`hopper_cluster_kernels`) covers:

* **kLoop**  — one generated Triton kernel over the element domain,
  writing every live-out of the cluster (multi-output clusters do not
  split);
* **kInput** — elementwise producers recomputed inside a masked
  single-axis reduce, any axis, f32 accumulation;
* **kDot**   — one CUDA C++ GEMM launch per plain 2-D dot, with the
  cluster's elementwise epilogue generated into it, M/N/K tails masked
  from the runtime lengths (``kernels/matmul``).

Clusters whose template a backend does not register run per op.  A
registered kernel that fails to build or launch raises; the cluster never
moves to the per-op path in its place.

Values are dropped by their last use **in the order the executor runs
them** (a fused cluster runs all its ops at once, in fusion-plan order),
so PyTorch's caching allocator recycles their storage for later ops.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from ..kernels.program import Program, Step
from .dhlo import DGraph, DOp, DValue
from .dtypes import as_torch, is_integer
from .emit import emit_op
from .fusion import REDUCE_ROOT_KINDS, Cluster, cluster_live_outs
from .propagation import op_info
from .symshape import SymDim

__all__ = [
    "build_exact_executor",
    "build_padded_executor",
    "dyn_symbols",
    "ClusterKernel",
    "hopper_cluster_kernels",
    "kdot_jobs",
    "REGION_OPS",
]

# DHLO region ops: bodies are nested DGraphs in attrs; the port's frontend
# does not produce them yet
REGION_OPS = frozenset({"d.while", "d.scan", "d.cond"})


def dyn_symbols(graph: DGraph) -> List[SymDim]:
    """Ordered list of *input* symbolic dims (canonical, deduped)."""
    seen: Dict[int, SymDim] = {}
    for p in graph.params:
        for d in p.shape:
            if isinstance(d, SymDim):
                c = graph.store.canon_dim(d)
                if isinstance(c, SymDim) and c.uid not in seen:
                    seen[c.uid] = c
    return list(seen.values())


class _ShapeEnv:
    """Evaluates symbolic dims for one call (padded ints + actual ints)."""

    def __init__(self, graph: DGraph, padded: Dict[int, int],
                 actual: Dict[int, Any], device,
                 static: Optional[Dict[Any, Any]] = None) -> None:
        self.graph = graph
        # per-executor memo of call-independent facts (a cluster's
        # live-outs, its kernel program): computed on the first call only
        self.static = {} if static is None else static
        self.store = graph.store
        self.exprs = getattr(graph, "dim_exprs", {})
        self.padded = dict(padded)   # canonical uid -> python int
        self.actual = dict(actual)   # canonical uid -> python int
        self.device = device
        self._masks: Dict[Tuple[int, int], Any] = {}

    def _canon(self, d):
        return self.store.canon_dim(d)

    def padded_dim(self, d) -> int:
        if isinstance(d, int):
            return d
        c = self._canon(d)
        if isinstance(c, int):
            return c
        if c.uid in self.padded:
            return self.padded[c.uid]
        expr = self.exprs.get(c.uid) or self.exprs.get(d.uid)
        if expr is None:
            # widened carry dims have no input binding and no derived
            # expr — they pad to their recorded cap
            cap = self.store.dim_bound(c)
            if cap is not None:
                return int(cap)
            raise KeyError(f"unbound dim {d!r}")
        return int(self._eval(expr, self.padded))

    def actual_dim(self, d):
        if isinstance(d, int):
            return d
        c = self._canon(d)
        if isinstance(c, int):
            return c
        if c.uid in self.actual:
            return self.actual[c.uid]
        expr = self.exprs.get(c.uid) or self.exprs.get(d.uid)
        if expr is None:
            cap = self.store.dim_bound(c)
            if cap is not None:
                return int(cap)  # conservative: full padded extent valid
            raise KeyError(f"unbound dim {d!r}")
        return self._eval(expr, self.actual)

    def _eval(self, expr, env):
        tag = expr[0]
        if tag == "mul":
            v = 1
            for x in expr[1]:
                v = v * (self._lookup(x, env))
            return v
        if tag == "sum":
            v = 0
            for x in expr[1]:
                v = v + self._lookup(x, env)
            return v
        if tag == "affine":
            _, base, a, b = expr
            return a * self._lookup(base, env) + b
        if tag == "div":
            _, base, k = expr
            return self._lookup(base, env) // k
        raise ValueError(f"bad dim expr {expr}")

    def _lookup(self, d, env):
        if isinstance(d, int):
            return d
        c = self._canon(d)
        if isinstance(c, int):
            return c
        if c.uid in env:
            return env[c.uid]
        expr = self.exprs.get(c.uid) or self.exprs.get(d.uid)
        if expr is None:
            raise KeyError(f"unbound dim {d!r}")
        return self._eval(expr, env)

    def prefix_length(self, d) -> Optional[int]:
        """The actual length of dynamic dim ``d`` when its valid entries
        are a prefix (the canonical mask of :meth:`mask_for_dim`), or None
        for a reshape-merged dim, whose mask is a Kronecker product."""
        c = self._canon(d)
        expr = self.exprs.get(c.uid)
        if expr is not None and expr[0] == "mul":
            return None
        return self.actual_dim(c)

    def is_dynamic(self, d) -> bool:
        if isinstance(d, int):
            return False
        c = self._canon(d)
        return isinstance(c, SymDim)

    def padded_shape(self, shape) -> Tuple[int, ...]:
        return tuple(self.padded_dim(d) for d in shape)

    def memo(self, key, make: Callable[[], Any]) -> Any:
        hit = self.static.get(key)
        if hit is None:
            hit = self.static[key] = make()
        return hit

    # ----------------------------------------------------------- masks --
    def mask_for_dim(self, d) -> Optional[torch.Tensor]:
        """Canonical validity mask (bool[padded]) for a dynamic dim."""
        if not self.is_dynamic(d):
            return None
        c = self._canon(d)
        psize = self.padded_dim(c)
        key = (c.uid, psize)
        if key in self._masks:
            return self._masks[key]
        expr = self.exprs.get(c.uid)
        if expr is not None and expr[0] == "mul":
            # reshape-merged dim: Kronecker product of factor masks matches
            # the row-major garbage pattern of reshaped padded data
            m = None
            for f in expr[1]:
                fp = self.padded_dim(f) if not isinstance(f, int) else f
                fm = self.mask_for_dim(f) if not isinstance(f, int) else None
                if fm is None:
                    fm = torch.ones((fp,), dtype=torch.bool,
                                    device=self.device)
                m = fm if m is None else (m[:, None] & fm[None, :]).reshape(-1)
            mask = m
        else:
            actual = self.actual_dim(c)
            mask = torch.arange(psize, device=self.device) < actual
        self._masks[key] = mask
        return mask

    def mask_axes(self, x: torch.Tensor, shape, axes, fill) -> torch.Tensor:
        """Apply canonical masks along ``axes`` of value with symbolic shape."""
        if is_integer(x.dtype) and math.isinf(fill):
            info = torch.iinfo(x.dtype)
            fill = info.min if fill < 0 else info.max
        fill_t = torch.tensor(fill, dtype=x.dtype, device=x.device)
        for ax in axes:
            m = self.mask_for_dim(shape[ax])
            if m is None:
                continue
            bshape = [1] * x.dim()
            bshape[ax] = m.shape[0]
            x = torch.where(m.reshape(bshape), x, fill_t)
        return x


def _emit_masked(op: DOp, inputs, out_shapes, env: _ShapeEnv):
    """emit_op + dynamic-axis masking for position-mixing ops."""
    code = op.opcode
    info = op_info(code)
    dev = env.device

    if code.startswith("reduce_") or code in ("argmax", "argmin"):
        axes = op.attrs.get("axes", ())
        src = op.inputs[0]
        dyn_axes = [a for a in axes if env.is_dynamic(src.shape[a])]
        if dyn_axes:
            fill = info.pad_identity if info.pad_identity is not None else 0.0
            x = env.mask_axes(inputs[0], src.shape, dyn_axes, fill)
            inputs = [x] + list(inputs[1:])
        return emit_op(op, inputs, out_shapes, dev)

    if code == "dot_general":
        (lc, _), _ = op.attrs["dimension_numbers"]
        lhs_v = op.inputs[0]
        dyn_lc = [a for a in lc if env.is_dynamic(lhs_v.shape[a])]
        if dyn_lc:
            lhs = env.mask_axes(inputs[0], lhs_v.shape, dyn_lc, 0.0)
            inputs = [lhs] + list(inputs[1:])
        return emit_op(op, inputs, out_shapes, dev)

    if code in ("cumsum", "cumprod", "cummax"):
        params = op.attrs.get("_params", {})
        axis = params.get("axis", 0)
        src = op.inputs[0]
        if params.get("reverse", False) and env.is_dynamic(src.shape[axis]):
            fill = {"cumsum": 0.0, "cumprod": 1.0, "cummax": -math.inf}[code]
            inputs = [env.mask_axes(inputs[0], src.shape, [axis], fill)]
        return emit_op(op, inputs, out_shapes, dev)

    if code == "sort":
        dim = op.attrs.get("_params", {}).get("dimension", -1)
        src = op.inputs[0]
        d = dim if dim >= 0 else src.rank + dim
        if env.is_dynamic(src.shape[d]):
            inputs = [env.mask_axes(inputs[0], src.shape, [d], math.inf)]
        return emit_op(op, inputs, out_shapes, dev)

    if code == "concatenate":
        axis = op.attrs["dimension"]
        out_v = op.outputs[0]
        if env.is_dynamic(out_v.shape[axis]) and len(op.inputs) > 1:
            # dynamic-axis concat: writes at actual offsets keep valid
            # data prefix-contiguous (canonical for the sum-derived dim)
            out = torch.zeros(out_shapes[0], dtype=as_torch(out_v.dtype),
                              device=dev)
            total = out.shape[axis]
            offset = 0
            for v, x in zip(op.inputs, inputs):
                n = x.shape[axis]
                start = min(offset, total - n)  # clamped, as in lax DUS
                out.narrow(axis, start, n).copy_(x)
                offset += env.actual_dim(v.shape[axis])
            return [out]
        return emit_op(op, inputs, out_shapes, dev)

    if code == "pad":
        cfg = op.attrs["padding_config"]
        src = op.inputs[0]
        for ax, (lo, hi, interior) in enumerate(cfg):
            if env.is_dynamic(src.shape[ax]) and (hi > 0 or interior > 0):
                raise NotImplementedError(
                    "hi/interior pad along a dynamic axis is not "
                    "bucket-paddable; pre-pad on the host instead")
        return emit_op(op, inputs, out_shapes, dev)

    return emit_op(op, inputs, out_shapes, dev)


# --------------------------------------------------- cluster kernels --

def _cluster_program(ops: Sequence[DOp], input_vids: Sequence[int],
                     in_dtypes: Sequence[Any],
                     scalar_consts: Mapping[int, Any],
                     out_vids: Sequence[int]) -> Program:
    """The cluster body as a kernel :class:`Program` (the counterpart of
    the JAX package's unrolled expression closure): ``input_vids`` name
    the kernel's tensor operands positionally, ``out_vids`` the values it
    stores.  Built at bucket-compile time — zero runtime interpretation
    on the card."""
    ref: Dict[int, Tuple[str, Any]] = {
        vid: ("in", i) for i, vid in enumerate(input_vids)}
    ref.update({vid: ("c", val) for vid, val in scalar_consts.items()})
    steps: List[Step] = []
    for op in ops:
        args = []
        for v in op.inputs:
            if v.vid in ref:
                args.append(ref[v.vid])
            elif v.literal is not None and v.rank == 0:
                args.append(("c", v.literal.item()))
            else:
                raise KeyError(f"unbound {v!r} in cluster body")
        (o,) = op.outputs
        param = None
        if op.opcode == "convert":
            param = as_torch(op.attrs["new_dtype"])
        elif op.opcode == "integer_pow":
            param = int(op.attrs.get("_params", {}).get("y", 2))
        steps.append(Step(op.opcode, tuple(args), as_torch(o.dtype), param))
        ref[o.vid] = ("t", len(steps) - 1)
    return Program(in_dtypes=tuple(as_torch(d) for d in in_dtypes),
                   steps=tuple(steps),
                   outs=tuple(ref[vid] for vid in out_vids))


def _cluster_io(ops: Sequence[DOp], read) -> Tuple[List[int], List[Any],
                                                   Dict[int, Any]]:
    """Boundary operands of a fused body: non-scalar values become kernel
    tensor operands (including non-scalar literals — they stream in as
    blocks, never re-materialized at full shape inside the body); rank-0
    *literals* are captured as Python numbers (they become constants in
    the generated source); a non-literal rank-0 value streams in as a
    broadcast operand."""
    produced = {o.vid for op in ops for o in op.outputs}
    tensor_ids: List[int] = []
    tensors: List[Any] = []
    scalars: Dict[int, Any] = {}
    for op in ops:
        for v in op.inputs:
            if v.vid in produced or v.vid in scalars or v.vid in tensor_ids:
                continue
            if v.rank == 0 and v.literal is not None:
                scalars[v.vid] = v.literal.item()
            else:
                tensor_ids.append(v.vid)
                tensors.append(read(v))
    return tensor_ids, tensors, scalars


def _hoist_broadcasts(cluster: Cluster, read, env: "_ShapeEnv"):
    """Emit the cluster's boundary ``broadcast_in_dim`` ops outside the
    kernel (classification guarantees their operands are boundaries) —
    as broadcast *views*, which the kernels read in place; returns the
    remaining body ops and the prologue values."""
    vals: Dict[int, Any] = {}
    body: List[DOp] = []
    for op in cluster.ops:
        if op.opcode == "broadcast_in_dim":
            outs = emit_op(op, [read(v) for v in op.inputs],
                           [env.padded_shape(o.shape) for o in op.outputs],
                           env.device)
            for o, val in zip(op.outputs, outs):
                vals[o.vid] = val
        else:
            body.append(op)
    return body, vals


def _to_blocks(tensors: Sequence[Any], padded_ref: Tuple[int, ...]):
    """Broadcast boundary operands to the kernel's block class: as views
    (stride 0 along broadcast dims), never copies."""
    return [t if tuple(t.shape) == tuple(padded_ref)
            else torch.broadcast_to(t, padded_ref) for t in tensors]


class ClusterKernel:
    """One fused-kernel template implementation for a backend.

    ``template`` names the fusion-plan template this kernel executes
    (``Cluster.template``); :meth:`run` executes one cluster and returns
    ``{vid: padded_tensor}`` for every value the cluster must materialize
    (its live-outs).  ``runs`` counts cluster executions through the
    kernel (executors run eagerly, so every call counts) — it lets tests
    and benchmarks prove a cluster actually executed through the fused
    path.  A kernel that fails raises: the cluster never moves to the
    per-op path behind the caller's back.
    """

    template: str = ""

    def __init__(self) -> None:
        self.runs = 0

    def run(self, graph: DGraph, cluster: Cluster, read, env: "_ShapeEnv",
            masked: bool) -> Dict[int, Any]:
        raise NotImplementedError


class HopperLoopKernel(ClusterKernel):
    """kLoop: one generated kernel over the element domain writing every
    live-out (``kernels/fused_elementwise``)."""

    template = "kLoop"

    def run(self, graph, cluster, read, env, masked):
        from ..kernels.fused_elementwise.ops import fused_elementwise

        body, pvals = _hoist_broadcasts(cluster, read, env)

        def rd(v):
            return pvals[v.vid] if v.vid in pvals else read(v)

        tensor_ids, tensors, scalars = _cluster_io(body, rd)
        live = env.memo(("live", cluster.cid),
                        lambda: cluster_live_outs(graph, cluster))
        kernel_outs = [v for v in live if v.vid not in pvals]
        result = {v.vid: pvals[v.vid] for v in live if v.vid in pvals}
        pref = env.padded_shape(kernel_outs[0].shape)
        tensors = _to_blocks(tensors, pref)
        in_dtypes = tuple(t.dtype for t in tensors)
        program = env.memo(("program", cluster.cid, in_dtypes),
                           lambda: _cluster_program(
                               body, tensor_ids, in_dtypes, scalars,
                               [v.vid for v in kernel_outs]))
        # pointwise garbage stays confined to the padded region (which is
        # NOT a flat prefix under multi-dim padding) — downstream mixing
        # ops apply their own canonical masks, so no in-kernel mask here
        n_valid = math.prod(pref)
        outs = fused_elementwise(program, tensors, n_valid, pref)
        result.update({v.vid: o for v, o in zip(kernel_outs, outs)})
        return result


class HopperInputKernel(ClusterKernel):
    """kInput: fused producers + masked single-axis reduce root
    (``kernels/fused_reduce``); any reduce axis, read in place."""

    template = "kInput"

    def run(self, graph, cluster, read, env, masked):
        from ..kernels.fused_reduce.ops import fused_reduce

        root = cluster.ops[-1]
        (axis,) = tuple(root.attrs["axes"])
        src = root.inputs[0]
        body, pvals = _hoist_broadcasts(cluster, read, env)

        def rd(v):
            return pvals[v.vid] if v.vid in pvals else read(v)

        tensor_ids, tensors, scalars = _cluster_io(body[:-1], rd)
        # the reduce source itself may be a boundary/prologue value (no
        # producer in the body): stream it in and reduce it as-is
        src_vid = src.vid
        if src_vid not in {o.vid for op in body[:-1] for o in op.outputs} \
                and src_vid not in tensor_ids:
            tensor_ids.append(src_vid)
            tensors.append(rd(src))
        shape = env.padded_shape(src.shape)
        tensors = _to_blocks(tensors, shape)
        in_dtypes = tuple(t.dtype for t in tensors)
        program = env.memo(("program", cluster.cid, in_dtypes),
                           lambda: _cluster_program(
                               body[:-1], tensor_ids, in_dtypes, scalars,
                               [src_vid]))
        red_dim = src.shape[axis]
        if masked and env.is_dynamic(red_dim):
            n_cols = env.actual_dim(red_dim)
        else:
            n_cols = env.padded_dim(red_dim)
        out_v = root.outputs[0]
        out = fused_reduce(program, tensors, n_cols,
                           REDUCE_ROOT_KINDS[root.opcode], axis=axis,
                           shape=shape, out_dtype=as_torch(out_v.dtype))
        return {out_v.vid: out.reshape(env.padded_shape(out_v.shape))}


class _DotParts:
    """A kDot cluster split for its kernel (call-independent, built once
    per executor): the dot; the *prologue* (ops not depending on the dot,
    e.g. a bias ``broadcast_in_dim``, emitted outside the kernel); the
    epilogue as a kernel :class:`Program` whose input 0 is the
    accumulator in the dot's dtype and whose other inputs are
    ``extras``; and the live-outs the kernel stores."""

    def __init__(self, graph: DGraph, cluster: Cluster) -> None:
        self.dot = next(op for op in cluster.ops
                        if op.opcode == "dot_general")
        acc_v = self.dot.outputs[0]
        self.dep = {acc_v.vid}
        self.prologue: List[DOp] = []
        epilogue: List[DOp] = []
        for op in cluster.ops:  # topological
            if op is self.dot:
                continue
            if any(v.vid in self.dep for v in op.inputs):
                epilogue.append(op)
                self.dep.update(o.vid for o in op.outputs)
            else:
                self.prologue.append(op)
        produced = {o.vid for op in epilogue for o in op.outputs}
        self.extras: List[DValue] = []
        scalars: Dict[int, Any] = {}
        for op in epilogue:
            for v in op.inputs:
                if v.vid in produced or v.vid == acc_v.vid or \
                        v.vid in scalars or \
                        any(v.vid == x.vid for x in self.extras):
                    continue
                if v.rank == 0 and v.literal is not None:
                    scalars[v.vid] = v.literal.item()
                else:
                    self.extras.append(v)
        self.live = cluster_live_outs(graph, cluster)
        self.kernel_outs = [v for v in self.live if v.vid in self.dep]
        self.program = _cluster_program(
            epilogue, [acc_v.vid] + [v.vid for v in self.extras],
            [acc_v.dtype] + [v.dtype for v in self.extras], scalars,
            [v.vid for v in self.kernel_outs])


def kdot_jobs(graph: DGraph, plan) -> List[Tuple[Program, torch.dtype]]:
    """``(epilogue program, operand dtype)`` of every kDot cluster in
    ``plan``: what the kDot kernel will build, known before the first
    call (``kernels.matmul.matmul.prebuild`` builds them at once)."""
    jobs = {}
    for cl in plan.clusters:
        if cl.template == "kDot":
            parts = _DotParts(graph, cl)
            dt = as_torch(parts.dot.inputs[0].dtype)
            jobs[(parts.program.key, dt)] = (parts.program, dt)
    return list(jobs.values())


class HopperDotKernel(ClusterKernel):
    """kDot: one GEMM launch with the elementwise epilogue fused into its
    store, M/N/K tails masked from the runtime lengths
    (``kernels/matmul``).  Prologue ops are emitted outside the kernel;
    epilogue operands are passed as (M, N) views, never copies."""

    template = "kDot"

    def run(self, graph, cluster, read, env, masked):
        from ..kernels.matmul.ops import matmul_fused

        parts = env.memo(("kdot", cluster.cid),
                         lambda: _DotParts(graph, cluster))
        vals: Dict[int, Any] = {}

        def rd(v):
            return vals[v.vid] if v.vid in vals else read(v)

        for op in parts.prologue:
            outs = emit_op(op, [rd(v) for v in op.inputs],
                           [env.padded_shape(o.shape) for o in op.outputs],
                           env.device)
            for o, val in zip(op.outputs, outs):
                vals[o.vid] = val

        lhs_v, rhs_v = parts.dot.inputs
        lhs, rhs = rd(lhs_v), rd(rhs_v)
        m_d, k_d = lhs_v.shape
        n_d = rhs_v.shape[1]

        def valid(d):
            if masked and env.is_dynamic(d):
                return env.prefix_length(d)
            return env.padded_dim(d)

        vm, vn, vk = valid(m_d), valid(n_d), valid(k_d)
        if vk is None:
            # a reshape-merged K: its valid entries are no prefix, so the
            # operands are masked here and the kernel contracts all of K
            lhs = env.mask_axes(lhs, lhs_v.shape, [1], 0.0)
            rhs = env.mask_axes(rhs, rhs_v.shape, [0], 0.0)
            vk = env.padded_dim(k_d)
        # a merged M or N keeps its padded garbage, as the per-op dot
        # does: consumers mask it with the dim's own canonical mask
        vm = env.padded_dim(m_d) if vm is None else vm
        vn = env.padded_dim(n_d) if vn is None else vn
        extras = _to_blocks([rd(v) for v in parts.extras],
                            env.padded_shape(parts.dot.outputs[0].shape))
        outs = matmul_fused(lhs, rhs, extras, parts.program,
                            valid_mnk=(vm, vn, vk),
                            out_dtypes=parts.program.out_dtypes)
        result = {v.vid: vals[v.vid] for v in parts.live
                  if v.vid not in parts.dep}
        result.update({v.vid: o for v, o in zip(parts.kernel_outs, outs)})
        return result


def hopper_cluster_kernels() -> Dict[str, ClusterKernel]:
    """Fresh instances of the Hopper cluster kernels, keyed by the
    fusion-plan template they execute (what ``backend="hopper"``
    registers)."""
    kernels = (HopperLoopKernel(), HopperInputKernel(), HopperDotKernel())
    return {k.template: k for k in kernels}


# ------------------------------------------------------------ executor --

class _Schedule:
    """The executor's run order and, per step, the values it frees.

    A step is a fused cluster (run through its kernel, or per op when the
    template has no kernel — the step boundary is the same) or,
    without kernels, one op in graph order.  A value is dropped right
    after the last step that reads it, in *this* order: the memory plan's
    frees are computed for graph order, which a fusion plan may reorder
    (a consumer's cluster can run before another producer's)."""

    def __init__(self, graph: DGraph, plan=None,
                 kernels: Optional[Mapping[str, ClusterKernel]] = None):
        if kernels and plan is not None:
            self.steps: List[Tuple[Optional[Cluster], List[DOp]]] = [
                (cl, list(cl.ops)) for cl in plan.clusters]
        else:
            self.steps = [(None, [op]) for op in graph.toposorted()]
        last: Dict[int, int] = {}
        for i, (_, ops) in enumerate(self.steps):
            for op in ops:
                for o in op.outputs:
                    last.setdefault(o.vid, i)
            for op in ops:
                for v in op.all_operands():
                    if v.vid in last:
                        last[v.vid] = max(last[v.vid], i)
        keep = {o.vid for o in graph.outputs}
        self.static: Dict[Any, Any] = {}
        self.frees: List[List[int]] = [[] for _ in self.steps]
        for vid, i in last.items():
            if vid not in keep:
                self.frees[i].append(vid)


class _Literals:
    """Device copies of a graph's literals, made once per executor.

    Rank-0 literals stay Python numbers (see ``core/emit.py``)."""

    def __init__(self, device) -> None:
        self.device = device
        self._cache: Dict[int, Any] = {}

    def get(self, v: DValue):
        hit = self._cache.get(v.vid)
        if hit is None:
            lit = v.literal
            if v.rank == 0:
                hit = lit.item()
            else:
                hit = lit.to(device=self.device, dtype=as_torch(v.dtype))
            self._cache[v.vid] = hit
        return hit


def _run_graph(graph: DGraph, arrays, env: _ShapeEnv, masked: bool,
               schedule: _Schedule, literals: _Literals,
               kernels: Optional[Mapping[str, ClusterKernel]] = None):
    vals: Dict[int, Any] = {}
    for p, a in zip(graph.params, arrays):
        vals[p.vid] = a

    def read(v: DValue):
        if v.vid in vals:
            return vals[v.vid]
        if v.literal is not None:
            return literals.get(v)
        raise KeyError(f"undefined value {v!r}")

    def run_op(op):
        ins = [read(v) for v in op.inputs] + [read(v) for v in op.shape_operands]
        if op.opcode in REGION_OPS:
            raise NotImplementedError(
                f"region op {op.opcode}: control flow is not ported yet")
        out_shapes = [env.padded_shape(o.shape) for o in op.outputs]
        if masked:
            outs = _emit_masked(op, ins, out_shapes, env)
        else:
            outs = emit_op(op, ins, out_shapes, env.device)
        for o, val in zip(op.outputs, outs):
            vals[o.vid] = val

    for (cluster, ops), dead in zip(schedule.steps, schedule.frees):
        kern = None
        if cluster is not None and cluster.template and kernels:
            kern = kernels.get(cluster.template)
        if kern is not None:
            vals.update(kern.run(graph, cluster, read, env, masked))
            kern.runs += 1
        else:
            for op in ops:
                run_op(op)
        for vid in dead:
            vals.pop(vid, None)
    return [read(o) for o in graph.outputs]


def build_exact_executor(graph: DGraph, plan=None,
                         kernels: Optional[Mapping[str, ClusterKernel]] = None,
                         device="cpu") -> Callable:
    """Executor running at exact concrete shapes (static-fallback path)."""
    schedule = _Schedule(graph, plan, kernels)
    literals = _Literals(torch.device(device))

    def run(*arrays):
        bindings: Dict[int, int] = {}
        for p, a in zip(graph.params, arrays):
            for d, size in zip(p.shape, a.shape):
                if isinstance(d, SymDim):
                    c = graph.store.canon_dim(d)
                    if isinstance(c, SymDim):
                        bindings[c.uid] = int(size)
        env = _ShapeEnv(graph, padded=bindings, actual=dict(bindings),
                        device=literals.device, static=schedule.static)
        return _run_graph(graph, arrays, env, False, schedule, literals,
                          kernels)

    return run


def build_padded_executor(graph: DGraph, padded_bindings: Dict[int, int],
                          sym_order: Sequence[SymDim], plan=None,
                          kernels: Optional[Mapping[str, ClusterKernel]] = None,
                          device="cpu") -> Callable:
    """Executor for one bucket signature: ``run(lens, *padded_arrays)``.

    ``padded_bindings`` maps canonical symbol uid -> padded size (static for
    this executor); ``lens`` carries the actual sizes as host ints in
    ``sym_order`` — the executor is exact for any actuals ≤ the bucket.
    ``kernels`` maps fusion-plan templates to :class:`ClusterKernel`
    implementations (the backend's registration): clusters whose template
    is covered execute through the fused kernels (§4.3 codegen), the rest
    op by op.
    """
    uids = [s.uid for s in sym_order]
    schedule = _Schedule(graph, plan, kernels)
    literals = _Literals(torch.device(device))

    def run(lens, *arrays):
        actual = {uid: int(lens[i]) for i, uid in enumerate(uids)}
        env = _ShapeEnv(graph, padded=padded_bindings, actual=actual,
                        device=literals.device, static=schedule.static)
        return _run_graph(graph, arrays, env, True, schedule, literals,
                          kernels)

    return run
