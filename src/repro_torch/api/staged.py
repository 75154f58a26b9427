"""The staged public pipeline: ``disc_torch.compile(fn) → lower() → compile()``.

Mirrors the JAX package's AOT staging for the whole DISC compiler:

* :func:`compile` returns a :class:`CompiledFunction` — callable
  immediately (lowering happens on demand, with spec inference from the
  first call when no specs were given), and stageable explicitly;
* :class:`Lowered` holds the inspectable compile-time artifacts (DHLO
  graph, fusion / placement / buffer plans, dynamic symbols) before any
  device code exists;
* :class:`Compiled` owns the generated host dispatcher plus the
  per-bucket compile cache, and exposes ``dispatch_source`` /
  ``cache_stats()`` / ``compile_counts()`` for introspection.

Two pipelines share this surface (selected by
``CompileOptions.pipeline``):

* ``"dhlo"`` — the paper's: ATen FX graph → DHLO bridge, shape
  constraints, fusion, placement, buffers, bucketed per-backend
  executors, generated host dispatch with output recovery.  On the card
  each bucket (and escalated exact) entry of a backend with
  ``Backend.graphs`` (``"eager"``, ``"hopper"``) is one CUDA graph of
  its executor, captured at its first call and replayed at every later
  one whatever the lengths in the bucket (the executor reads them on the
  card): the counterpart of the JAX package's AOT-compiled executable
  per bucket.  A graph holding a ``d.while`` or ``d.cond`` keeps host
  entries (their predicate reads cannot be captured), decided from the
  graph before any call, and ``"nimble_vm"`` is never captured.
* ``"jit"``  — bucketed dispatch over a plain PyTorch function *without*
  bridging it through DHLO: declared dynamic args are bucket-padded,
  ``None`` args (parameter and KV-cache trees) pass through, ``TreeSpec``
  pytrees are leaf-padded, and one entry is cached per bucket signature.
  On the card an entry is one CUDA graph, captured at its first call and
  replayed at every later one (:mod:`repro_torch.core.graphs`: the
  counterpart of the JAX package's ``jax.jit`` per bucket); on the CPU,
  and inside ``plain_versions()`` or ``eager_entries()``, it runs the
  function eagerly.  ``compile_counts()`` counts entries, so the
  O(#buckets) contract stays observable.  This is what the serving
  engine builds prefill and decode on.

Both pipelines share one host-dispatch emitter
(:func:`repro_torch.core.dispatcher.generate_dispatch`), parameterized by
a ``DispatchLens`` — so §4.4 static escalation (hot exact signatures get
an unpadded entry) and the tie guards behind promote-on-change work
identically under either.
"""
from __future__ import annotations

import hashlib
import inspect
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..core.bucketing import BucketPolicy
from ..core.cache import CompileCache
from ..core.codegen import dyn_symbols, host_control_flow
from ..core.dispatcher import dhlo_lens, generate_dispatch, jit_lens
from ..core.dtypes import dtype_key
from ..core.graphs import GraphEntry, GraphStats
from ..core.symshape import SymDim
from ..errors import CONTROL_EXCEPTIONS, CompileError, classify_transient
from ..frontends.fx_frontend import ArgSpec, TreeSpec, bridge
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .backends import get_backend
from .options import CompileOptions, Dim, normalize_specs, resolve_device

__all__ = ["compile", "CompiledFunction", "Lowered", "Compiled",
           "infer_specs"]


# ------------------------------------------------------------- inference --

def infer_specs(arrays: Sequence[Any]) -> List[ArgSpec]:
    """Infer ``ArgSpec``s from one call's concrete arguments.

    Every axis of size > 1 becomes a symbolic dim; axes sharing a size in
    this call share a symbol (so contractions stay well-typed when traced
    at representative sizes).  Size-1 axes stay static (broadcasting).
    The inferred profile is exact for any later call with the same
    equality structure; distinct dims that *happened* to coincide on the
    first call are tied — declare specs explicitly to untie them.
    """
    by_size: Dict[int, str] = {}
    specs: List[ArgSpec] = []
    for a in arrays:
        shape = []
        for size in a.shape:
            if size <= 1:
                shape.append(int(size))
            else:
                shape.append(by_size.setdefault(int(size), f"d{size}"))
        specs.append(ArgSpec(tuple(shape), a.dtype))
    return specs


#: literals up to this many bytes are fingerprinted by content; larger
#: ones (model weights) by identity — storage, view and version counter —
#: like the process-local function tokens of the JAX package's jit path:
#: hashing gigabytes of card memory on every lower() would dwarf it
_CONTENT_HASH_BYTES = 1 << 16


def _graph_const_token(graph) -> str:
    """Hash of a DHLO graph's literal payloads, in deterministic order.

    Recurses into region ops' nested body graphs (attrs holding a
    ``DGraph`` or a tuple of them): a constant inside a loop body is as
    cache-relevant as a top-level literal."""
    from ..core.dhlo import DGraph

    h = hashlib.sha1()
    seen = set()

    def walk(g) -> None:
        for op in g.ops:
            for v in list(op.inputs) + list(op.shape_operands):
                if v.literal is None or v.vid in seen:
                    continue
                seen.add(v.vid)
                t = v.literal
                h.update(dtype_key(t.dtype).encode())
                h.update(repr(tuple(t.shape)).encode())
                if t.numel() * t.element_size() <= _CONTENT_HASH_BYTES:
                    h.update(t.detach().cpu().contiguous().view(-1)
                             .view(torch.uint8).numpy().tobytes())
                else:
                    h.update(repr((t.untyped_storage().data_ptr(),
                                   t.storage_offset(), tuple(t.stride()),
                                   t._version, str(t.device))).encode())
            for av in op.attrs.values():
                bodies = av if isinstance(av, (tuple, list)) else (av,)
                for x in bodies:
                    if isinstance(x, DGraph):
                        walk(x)

    walk(graph)
    return h.hexdigest()[:16]


def _fn_token(fn: Callable) -> str:
    """An identity token for ``fn`` (code, closure, bound instance).

    Process-local: bound methods are distinguished by instance identity
    (two engines sharing one cache must never serve each other's
    closures), so tokens are not stable across processes — fine for an
    in-memory compile cache.
    """
    parts: List[str] = []
    base = getattr(fn, "__func__", fn)
    self_obj = getattr(fn, "__self__", None)
    if self_obj is not None:
        parts.append(type(self_obj).__qualname__)
        parts.append(str(id(self_obj)))
    code = getattr(base, "__code__", None)
    if code is None:
        parts.append(repr(base))
    else:
        parts.append(getattr(base, "__qualname__", ""))
        parts.append(hashlib.sha1(code.co_code).hexdigest())
        parts.append(repr(code.co_consts)[:2000])
        for cell in base.__closure__ or ():
            try:
                parts.append(repr(cell.cell_contents)[:200])
            except ValueError:  # empty cell
                parts.append("<empty>")
    return "\x00".join(parts)


# --------------------------------------------------------------- lowered --

@dataclass
class Lowered:
    """Compile-time artifacts of one function at one spec signature.

    For the ``"dhlo"`` pipeline all plan fields are populated; for the
    ``"jit"`` pipeline only ``specs`` / ``sym_names`` are (there is no
    DHLO graph: each bucket entry captures the function itself).
    """

    fn: Callable
    specs: Tuple[Any, ...]
    options: CompileOptions
    policy: BucketPolicy
    pipeline: str = "dhlo"
    graph: Any = None
    plan: Any = None              # FusionPlan
    placement: Any = None
    buffer_plan: Any = None
    syms: Tuple[SymDim, ...] = ()
    sym_names: Tuple[str, ...] = ()
    # SPMD ShardingPlan when lowered under CompileOptions(mesh=...);
    # ``policy`` is then the planner-tightened policy (sharded dynamic
    # dims' buckets are mesh-axis multiples)
    sharding_plan: Any = None

    def _spmd_token(self) -> str:
        """Same-pattern artifacts lowered for different meshes or
        profiles lay their entries out differently and must never share
        cache entries; the mesh's ranks and devices are part of the
        token."""
        if self.sharding_plan is None:
            return ""
        return self.sharding_plan.token()

    def fingerprint(self) -> str:
        if self.graph is not None:
            # DGraph.fingerprint() is deliberately shape-free AND
            # constant-free (the per-engine cache-key property).  As a
            # *shared*-cache key that is too weak: two graphs with the
            # same wiring but different literal payloads must not
            # collide, so the artifact fingerprint folds the constants in
            # (and the SPMD plan, when lowered under a mesh).
            return (self.graph.fingerprint() + "+"
                    + _graph_const_token(self.graph) + self._spmd_token())

        # the jit pipeline has no graph fingerprint; identify the artifact
        # by the *function* (code + closure + bound self) plus the spec
        # signature, so distinct functions sharing one CompileCache can
        # never hit each other's entries
        def _sig(s):
            if s is None:
                return None
            if isinstance(s, TreeSpec):
                return ("tree", s.axes)
            return (s.shape, dtype_key(s.dtype))

        sig = repr([_sig(s) for s in self.specs])
        h = hashlib.sha1((sig + "\x00" + _fn_token(self.fn)).encode())
        return (f"jit:{self.options.name}:{h.hexdigest()[:16]}"
                + self._spmd_token())

    def compile(self, options: Optional[CompileOptions] = None, *,
                on_tie_break: Optional[Callable] = None) -> "Compiled":
        """Build the dispatcher (bucket executors are built lazily, per
        bucket, through the backend registry).

        ``options`` may override backend / cache / escalation at this
        stage; the bucketing policy is part of the lowering contract
        (``Dim`` markers were folded into it) and stays fixed.
        ``on_tie_break`` handles a call that breaks a multi-site symbol
        tie (:class:`CompiledFunction` wires promote-on-change through
        it); without a handler such a call raises a contract error.
        """
        return Compiled(self, options or self.options,
                        on_tie_break=on_tie_break)

    def as_text(self) -> str:
        """Human-readable summary of the lowering (inspectable stage)."""
        lines = [f"Lowered({self.options.name!r}, "
                 f"pipeline={self.pipeline!r})"]
        lines.append(f"  fingerprint: {self.fingerprint()}")
        lines.append(f"  dynamic symbols: {list(self.sym_names)}")
        if self.graph is None:
            lines.append("  (no DHLO graph: the jit pipeline captures "
                         "the function per bucket)")
            return "\n".join(lines)
        lines.append(f"  params: {len(self.graph.params)}  "
                     f"ops: {len(self.graph.ops)}  "
                     f"outputs: {len(self.graph.outputs)}")
        lines.append(f"  fusion: {self.plan.stats()}")
        lines.append(f"  placement: {self.placement.report()}")
        lines.append(f"  constraints: {self.graph.store.stats()}")
        return "\n".join(lines)


def _lower(fn: Callable, specs: Sequence[ArgSpec], dims: Sequence[Dim],
           options: CompileOptions) -> Lowered:
    sp = (obs_trace.ACTIVE.begin("lower", cat="compile",
                                 artifact=options.name,
                                 pipeline=options.pipeline)
          if obs_trace.ACTIVE is not None else None)
    try:
        return _lower_impl(fn, specs, dims, options)
    finally:
        if sp is not None:
            sp.end()


def _lower_impl(fn: Callable, specs: Sequence[ArgSpec], dims: Sequence[Dim],
                options: CompileOptions) -> Lowered:
    from ..core.buffers import plan_buffers
    from ..core.fusion import plan_fusion
    from ..core.placer import place

    policy = options.policy_with_dims(dims)
    device = resolve_device(options.device)
    sharding_plan = None
    if options.mesh is not None:
        # SPMD planning happens at lower() time: per-arg layouts come
        # from the profile and the policy is tightened so every sharded
        # dynamic dim's bucket divides the mesh axes evenly
        # (ConstraintViolation here when the Dim contract cannot comply)
        from ..dist.profiles import get_profile
        from ..dist.spmd import plan_spmd
        if options.mesh.device_type != device.type:
            raise ValueError(
                f"CompileOptions(mesh=...) is a {options.mesh.device_type} "
                f"mesh, the artifact compiles for {device}")
        sharding_plan, policy = plan_spmd(
            specs, policy, options.mesh,
            get_profile(options.sharding_profile or "dp"))
    if options.pipeline == "jit":
        sym_names: List[str] = []
        for s in specs:
            if s is None:
                continue
            names = ([d for _, d in s.axes] if isinstance(s, TreeSpec)
                     else [d for d in s.shape if isinstance(d, str)])
            for d in names:
                if d not in sym_names:
                    sym_names.append(d)
        return Lowered(fn=fn, specs=tuple(specs), options=options,
                       policy=policy, pipeline="jit",
                       sym_names=tuple(sym_names),
                       sharding_plan=sharding_plan)
    if any(not isinstance(s, ArgSpec) for s in specs):
        raise ValueError(
            "the 'dhlo' pipeline needs an ArgSpec for every argument "
            "(None pass-through and TreeSpec pytree specs are only "
            "supported by CompileOptions(pipeline='jit'))")
    graph, _ = bridge(fn, list(specs), name=options.name,
                      bounds={d.name: d.max for d in dims
                              if d.max is not None},
                      device=device)
    plan = plan_fusion(graph)
    placement = place(graph, mesh=options.mesh)
    # bucket-generic symbolic memory plan, decided ONCE here — every
    # bucket entry realizes the same plan
    buffer_plan = plan_buffers(graph, policy,
                               symbolic=options.memory_planning,
                               donation=options.plan_donation)
    buffer_plan.lines_text = buffer_plan.render_lines(graph)
    graph.memory_plan = buffer_plan
    syms = tuple(dyn_symbols(graph))
    if sharding_plan is not None:
        # surface the plan-time divisibility facts in the constraint
        # store (report()["constraints"]["mesh_constraints"])
        for c in sharding_plan.constraints:
            graph.store.note_mesh_divisible(c.dim, c.axes, c.multiple_of)
    return Lowered(fn=fn, specs=tuple(specs), options=options,
                   policy=policy, graph=graph, plan=plan,
                   placement=placement, buffer_plan=buffer_plan, syms=syms,
                   sym_names=tuple(s.name for s in syms),
                   sharding_plan=sharding_plan)


# -------------------------------------------------------------- compiled --

class Compiled:
    """The executable artifact: generated host dispatch + compile cache.

    Both pipelines flow through the one emitter in
    :mod:`repro_torch.core.dispatcher`; all that differs is the
    ``DispatchLens`` (how sizes are observed, what gets padded, whether
    outputs are recovered) and the per-bucket / exact entry callbacks
    (backend registry vs the function itself).
    """

    def __init__(self, lowered: Lowered, options: CompileOptions,
                 on_tie_break: Optional[Callable] = None) -> None:
        self.lowered = lowered
        self.options = options
        self.device = resolve_device(options.device)
        self.backend = get_backend(options.backend)
        self._fingerprint = lowered.fingerprint()
        self.cache = options.cache if options.cache is not None else \
            CompileCache(self._fingerprint,
                         max_entries=options.max_cache_entries,
                         escalation_threshold=options.escalation_threshold)
        self._bucket_compiles = 0
        self._exact_compiles = 0
        self.graph_stats = GraphStats()
        # entries made by kind ("graphed" / "host"), and why the dhlo
        # entries stay on the host: the region ops that read the device
        # on the host, found in the graph before any call
        self.entries = {"graphed": 0, "host": 0}
        self.host_control_flow = sorted(set(host_control_flow(
            lowered.graph))) if lowered.graph is not None else []
        if lowered.pipeline == "dhlo":
            lens = dhlo_lens(lowered.graph, lowered.syms)
            # the arguments the dispatch passes unpadded: read in place
            self._static_args = [i for i, a in enumerate(lens.args)
                                 if not a.dynamic]
            compile_bucket = self._compile_bucket
            compile_exact = self._compile_exact
        else:
            lens = jit_lens(lowered.specs, lowered.sym_names,
                            name=options.name)
            compile_bucket = self._compile_jit_bucket
            compile_exact = self._compile_jit_exact
        # the generated dispatch reaches this artifact weakly: a cycle
        # through it would keep the cache's entries (a graph holds its
        # inputs: parameters, a KV cache) alive until a gc pass
        # collectives of each entry's first call, and of the latest
        # output gather (report()["sharding"]["collectives"])
        self._collectives: Dict[str, Any] = {"entries": {},
                                             "output_gather": {}}
        plan = lowered.sharding_plan
        self._dispatch, self.dispatch_source = generate_dispatch(
            lens, lowered.policy, self.cache, weak_method(compile_bucket),
            weak_method(compile_exact), fingerprint=self._fingerprint,
            escalation_threshold=options.escalation_threshold,
            on_tie_break=on_tie_break, memory_plan=lowered.buffer_plan,
            lens_device=self.device,
            first_call_compiles=lowered.pipeline == "dhlo",
            sharding=plan,
            gather=(weak_method(self._gather)
                    if plan is not None and lowered.pipeline == "dhlo"
                    else None))
        self._mstats = self._dispatch._mstats
        obs_metrics.register_collector("dispatch", self._obs_dispatch,
                                       name=options.name)
        obs_metrics.register_collector("memory", self._obs_memory,
                                       name=options.name)

    def _obs_dispatch(self) -> Dict[str, Any]:
        """Pull collector: ``disc_torch.observe()["dispatch"][name]``."""
        return self._mstats.cost_dict()

    def _obs_memory(self) -> Dict[str, Any]:
        """Pull collector: ``disc_torch.observe()["memory"][name]`` (the
        staging view of ``cost_report()``'s artifact)."""
        return dict(self._mstats.as_dict(),
                    planning=bool(self.options.memory_planning
                                  and self.lowered.pipeline == "dhlo"))

    # ------------------------------------------------------------ public --
    def __call__(self, *arrays):
        outs = self._dispatch(arrays)
        if self.lowered.pipeline == "jit":
            return outs
        return outs[0] if len(outs) == 1 else tuple(outs)

    @property
    def graph(self):
        return self.lowered.graph

    @property
    def plan(self):
        return self.lowered.plan

    @property
    def placement(self):
        return self.lowered.placement

    @property
    def buffer_plan(self):
        return self.lowered.buffer_plan

    @property
    def syms(self):
        return list(self.lowered.syms)

    @property
    def policy(self) -> BucketPolicy:
        return self.lowered.policy

    @property
    def n_compiles(self) -> int:
        return self._bucket_compiles + self._exact_compiles

    def cache_stats(self) -> Dict[str, float]:
        return self.cache.stats.as_dict()

    def cost_report(self) -> Dict[str, Any]:
        """Dynamic-shape cost accounting for this artifact: per-bucket
        hit histogram, padding-waste ratio (padded vs true bytes per
        launch), and the host-dispatch vs entry-call wall split."""
        return self._mstats.cost_dict()

    def compile_counts(self) -> Dict[str, int]:
        """Per-artifact compile counts (meaningful under shared caches)."""
        return {"bucket": self._bucket_compiles,
                "exact": self._exact_compiles,
                "total": self._bucket_compiles + self._exact_compiles}

    def graph_report(self) -> Dict[str, Any]:
        """The artifact's entries and their CUDA graphs: graphed and host
        entries (and the region ops that keep a dhlo artifact's on the
        host), captures, replays, bytes copied into the graphs' buffers
        and out of their outputs, the buffers' bytes, capture seconds
        and the bytes the cache's graph pool reserved."""
        st = self.graph_stats
        return {"graphed_entries": self.entries["graphed"],
                "host_entries": self.entries["host"],
                "host_control_flow": list(self.host_control_flow),
                "captures": st.captures, "replays": st.replays,
                "bytes_in": st.bytes_in, "bytes_out": st.bytes_out,
                "buffer_bytes": st.buffer_bytes,
                "capture_seconds": sum(st.capture_seconds),
                "pool_bytes": self.cache.graph_pool.reserved_bytes}

    def report(self) -> Dict[str, Any]:
        low = self.lowered
        if low.graph is None:
            rep = {"fingerprint": self._fingerprint, "pipeline": "jit",
                   "device": str(self.device), "cache": self.cache_stats(),
                   "compiles": self.compile_counts(),
                   "dynamic_symbols": list(low.sym_names),
                   "dispatch_cost": self.cost_report(),
                   "graphs": self.graph_report()}
            if low.sharding_plan is not None:
                rep["sharding"] = self.sharding_report()
            return rep
        templates = low.plan.template_counts()
        covered = sum(n for t, n in templates.items()
                      if t in self.backend.cluster_kernels)
        rep = {
            "fingerprint": self._fingerprint,
            "backend": self.backend.name,
            "device": str(self.device),
            "cache": self.cache_stats(),
            "compiles": self.compile_counts(),
            "dynamic_symbols": list(low.sym_names),
            "fusion": low.plan.stats(),
            "placement": low.placement.report(),
            "constraints": low.graph.store.stats(),
            # clusters eligible for a fused-kernel template (plan
            # property) vs covered by THIS backend's registrations
            "kernel_eligible_clusters": sum(templates.values()),
            "cluster_templates": templates,
            "backend_covered_clusters": covered,
            "dispatch_cost": self.cost_report(),
            "graphs": self.graph_report(),
        }
        if low.sharding_plan is not None:
            rep["sharding"] = self.sharding_report()
        return rep

    def sharding_report(self) -> Dict[str, Any]:
        """The plan's per-arg layouts and mesh constraints, and the
        collectives counted by kind and bytes: each entry's (its first
        call, which its CUDA graph replays) and the latest output
        gather's (dhlo)."""
        rep = self.lowered.sharding_plan.report()
        rep["collectives"] = {
            "entries": {k: dict(v) for k, v in
                        self._collectives["entries"].items()},
            "output_gather": dict(self._collectives["output_gather"])}
        return rep

    # ------------------------------------------------------------ SPMD --
    def _spmd(self, entry: Callable, label: str) -> Callable:
        """``entry`` run under the artifact's mesh (DTensor's implicit
        replication of the plain tensors made inside), its first call's
        collectives counted under ``label``."""
        plan = self.lowered.sharding_plan
        if plan is None:
            return entry
        return _SpmdEntry(entry, plan.mesh, self._collectives["entries"],
                          label)

    def _gather(self, outs: Sequence[Any]) -> List[Any]:
        """The dhlo entry's DTensor outputs as whole tensors, the
        collectives counted as the output gather."""
        from ..dist.collectives import CollectiveCounter
        from torch.distributed.tensor import DTensor

        with CollectiveCounter() as c:
            whole = [o.full_tensor() if isinstance(o, DTensor) else o
                     for o in outs]
        self._collectives["output_gather"] = c.counts
        return whole

    # ------------------------------------------------- device compilation --
    def _compile_bucket(self, key: Tuple[int, ...], args: tuple):
        low = self.lowered
        padded = {s.uid: int(k) for s, k in zip(low.syms, key)}
        if low.sharding_plan is not None:
            # the entry takes (lens, *args) laid out as the generated
            # dispatch lays them out
            params = inspect.signature(self.backend.build_bucket).parameters
            if "arg_shardings" not in params and not any(
                    p.kind is inspect.Parameter.VAR_KEYWORD
                    for p in params.values()):
                # failing loudly here beats a far-away layout mismatch
                # inside the entry
                raise ValueError(
                    f"backend {self.backend.name!r} cannot compile under "
                    f"CompileOptions(mesh=...): its build_bucket accepts "
                    f"no 'arg_shardings' keyword — add the parameter "
                    f"(see repro_torch.api.backends) or compile without a "
                    f"mesh")
            plan = low.sharding_plan
            shardings = (plan.lens_sharding(),
                         *(plan.arg_sharding(i)
                           for i in range(len(low.specs))))
            run = self.backend.build_bucket(low.graph, low.plan, low.syms,
                                            padded, self.device,
                                            arg_shardings=shardings)
        else:
            run = self.backend.build_bucket(low.graph, low.plan, low.syms,
                                            padded, self.device)
        # the entry takes (lens, *args): lens and the padded staging
        # buffers are copied into the graph's buffers, the arguments the
        # dispatch passes unpadded (static shapes) are read in place
        return self._first_call(self._dhlo_entry(run, "bucket", 1),
                                "bucket", args, f"bucket{tuple(key)}")

    def _compile_exact(self, args: tuple):
        # a fresh executor per escalated signature (each cache entry is
        # hit by exactly one exact shape)
        run = self.backend.build_exact(self.lowered.graph,
                                       self.lowered.plan, self.device)
        sig = tuple(tuple(getattr(a, "shape", ())) for a in args)
        return self._first_call(self._dhlo_entry(run, "exact", 0),
                                "exact", args, f"exact{sig}")

    def _first_call(self, entry: Callable, kind: str, args: tuple,
                    label: str):
        """A dhlo entry and the outputs of its first call on ``args``,
        which the dispatch makes part of its compile (the port's trace:
        the cluster kernels' first launches and the graph's capture).
        The entry counts once that call has succeeded: one that failed
        never reached the cache."""
        graphed = isinstance(entry, GraphEntry)
        entry = self._spmd(entry, label)
        outs = entry(*args)
        self._count(kind, "graphed" if graphed else "host")
        return entry, outs

    def _dhlo_entry(self, run: Callable, kind: str, first_arg: int):
        """``run`` as the backend's entry: a CUDA graph on the card, or
        the executor itself (a host entry) where the backend captures
        nothing or the graph holds ``d.while`` / ``d.cond``."""
        if not self.backend.graphs or self.host_control_flow:
            return run
        return self._graph_entry(
            run, kind, [first_arg + i for i in self._static_args])

    def _count(self, kind: str, where: str, n: int = 1) -> None:
        """``n`` more entries of ``kind`` ("bucket" / "exact") in the
        compile count, made ``where`` ("graphed" / "host")."""
        self.entries[where] += n
        if kind == "bucket":
            self._bucket_compiles += n
        else:
            self._exact_compiles += n

    def _graph_entry(self, fn: Callable, kind: str,
                     held: List[int]) -> GraphEntry:
        """An entry that is a CUDA graph of ``fn`` captured at its first
        call on the card, ``held`` the positions of the arguments read in
        place (every other tensor leaf is copied into the graph's own
        buffers).  A capture that fails takes the entry out of the cache
        and, where the cache held it, out of the compile count."""
        ref = weakref.ref(self)

        def dropped(entry):
            compiled = ref()
            if compiled is not None and compiled.cache.discard(entry):
                compiled._count(kind, "graphed", -1)

        return GraphEntry(fn, f"{self.options.name!r} {kind} entry",
                          self.graph_stats, self.cache.graph_pool, dropped,
                          held)

    # ----------------------------------------------------- jit pipeline --
    def _jit_entry(self, kind: str) -> GraphEntry:
        """An entry of the jit pipeline: a CUDA graph of the function.
        The pass-through (None-spec) arguments, the parameter and cache
        trees, are read in place; the graph copies every other leaf."""
        held = [i for i, s in enumerate(self.lowered.specs) if s is None]
        return self._graph_entry(self.lowered.fn, kind, held)

    def _compile_jit_bucket(self, key: Tuple[int, ...]):
        """One entry per bucket signature: the dispatch pads dynamic args
        to the bucket, and the entry's graph is captured on them."""
        self._count("bucket", "graphed")
        return self._spmd(self._jit_entry("bucket"), f"bucket{tuple(key)}")

    def _compile_jit_exact(self):
        """§4.4 for the jit pipeline: the escalated path calls the
        function at *unpadded* shapes.  One fresh entry per escalated
        signature, so the cache's LRU budget bounds them one by one."""
        self._count("exact", "graphed")
        return self._spmd(self._jit_entry("exact"),
                          f"exact{self._exact_compiles}")


class _SpmdEntry:
    """An entry run under its artifact's mesh (:func:`~repro_torch.dist.
    context.spmd_scope`); its first call's collectives are counted into
    ``counts[label]``."""

    def __init__(self, entry: Callable, mesh, counts: Dict[str, Any],
                 label: str) -> None:
        self.entry = entry
        self.mesh = mesh
        self._counts = counts
        self._label = label
        self._counted = False

    def __call__(self, *args):
        from ..dist.collectives import CollectiveCounter
        from ..dist.context import spmd_scope

        with spmd_scope(self.mesh):
            if self._counted:
                return self.entry(*args)
            with CollectiveCounter() as c:
                out = self.entry(*args)
            self._counts[self._label] = c.counts
            self._counted = True
            return out


def weak_method(method: Callable) -> Callable:
    """``method`` (a bound method) called through a weak reference to its
    instance."""
    ref = weakref.WeakMethod(method)

    def call(*args):
        return ref()(*args)

    call.__qualname__ = method.__qualname__
    return call


# ------------------------------------------------------ public entrypoint --

def _split_tied_specs(specs: Sequence[ArgSpec],
                      arrays: Sequence[Any]) -> Tuple[ArgSpec, ...]:
    """Refine an inferred spec profile against one call's observed sizes.

    Symbols whose sites no longer agree are split: each subgroup of sites
    that share a size in *this* call gets its own symbol (the subgroup
    containing the extraction site keeps the original name).  Sites that
    still coincide stay tied — the profile refines monotonically, one
    broken coincidence at a time, instead of over-constraining forever.
    """
    sizes: Dict[Tuple[int, int], int] = {}
    groups: Dict[str, List[Tuple[int, int]]] = {}
    for ai, spec in enumerate(specs):
        shape = tuple(arrays[ai].shape)
        for ax, d in enumerate(spec.shape):
            if isinstance(d, str):
                sizes[(ai, ax)] = int(shape[ax])
                groups.setdefault(d, []).append((ai, ax))

    used = set(groups)
    renames: Dict[Tuple[int, int], str] = {}
    for name, sites in groups.items():
        by_size: Dict[int, List[Tuple[int, int]]] = {}
        for site in sites:
            by_size.setdefault(sizes[site], []).append(site)
        if len(by_size) == 1:
            continue  # this tie survived the call
        keep = sizes[sites[0]]  # extraction-site subgroup keeps the name
        for size, subsites in by_size.items():
            if size == keep:
                continue
            new = f"{name}_{size}"
            while new in used:
                new += "_"
            used.add(new)
            for site in subsites:
                renames[site] = new

    return tuple(ArgSpec(tuple(renames.get((ai, ax), d)
                               for ax, d in enumerate(spec.shape)),
                         spec.dtype, spec.name)
                 for ai, spec in enumerate(specs))


class CompiledFunction:
    """What ``disc_torch.compile`` returns: callable now, stageable.

    * with specs: lowering + dispatcher generation happen eagerly (bucket
      executors still build per bucket on demand);
    * without specs: the first call infers them (:func:`infer_specs`), and
      the inferred profile *refines itself*: dims that merely coincided on
      the first call are re-lowered as independent dims the moment a later
      call breaks the coincidence (promote-on-change — disable with
      ``CompileOptions(promote_on_change=False)``).

    Attribute access falls through to the underlying :class:`Compiled`
    artifact (``plan``, ``report()``, ``n_compiles``, ...).
    """

    def __init__(self, fn: Callable,
                 specs: Optional[Sequence[Any]] = None,
                 options: Optional[CompileOptions] = None, **kw) -> None:
        if options is None:
            options = CompileOptions(**kw)
        elif kw:
            options = options.replace(**kw)
        resolve_device(options.device)  # no card: fail now, not mid-call
        self.fn = fn
        self.options = options
        self._specs, self._dims = normalize_specs(specs)
        self._inferred = False
        self._lowered: Optional[Lowered] = None
        self._compiled: Optional[Compiled] = None
        if self._specs is not None:
            self._ensure()

    # ------------------------------------------------------------ staging --
    def lower(self, specs: Optional[Sequence[Any]] = None) -> Lowered:
        """Stage 1: produce the inspectable compile-time artifacts."""
        if specs is not None:
            norm, dims = normalize_specs(specs)
            return _lower(self.fn, norm, dims, self.options)
        if self._specs is None:
            raise ValueError(
                "no specs declared and none inferred yet — pass specs to "
                "lower(), declare them in disc_torch.compile(fn, specs), or "
                "call the function once to infer them")
        if self._lowered is None:
            self._lowered = _lower(self.fn, self._specs, self._dims,
                                   self.options)
        return self._lowered

    def _ensure(self) -> Compiled:
        if self._compiled is None:
            handler = self._promote if (
                self._inferred and self.options.promote_on_change) else None
            self._compiled = self.lower().compile(on_tie_break=handler)
        return self._compiled

    def _promote(self, arrays):
        """Promote-on-change: a call broke a dim tie the first-call
        inference assumed, so split the tied symbols by the observed sizes
        and re-lower.  The compile cache carries over and the superseded
        entries are purged."""
        split = _split_tied_specs(self._specs, arrays)
        if split == self._specs:
            # a stale handle to a superseded artifact fired its guard, but
            # the live profile already accommodates this call
            return self._ensure()._dispatch(arrays)
        snapshot = (self._specs, self.options, self._lowered, self._compiled)
        prev = self._compiled
        self._specs = split
        self.options = self.options.replace(cache=prev.cache)
        self._lowered = None
        self._compiled = None
        try:
            compiled = self._ensure()
        except CONTROL_EXCEPTIONS:
            self._specs, self.options, self._lowered, self._compiled = \
                snapshot
            raise
        except Exception as e:
            self._specs, self.options, self._lowered, self._compiled = \
                snapshot
            raise CompileError(
                f"promote-on-change failed for {self.options.name!r}: a "
                f"call broke a dim tie inferred from the first call, but "
                f"re-lowering with independent dims "
                f"{[s.shape for s in split]} did not succeed — the "
                f"function itself may require the equality "
                f"({type(e).__name__}: {e})",
                transient=classify_transient(e)) from e
        prev.cache.stats.promotions += 1
        obs_metrics.record_event(
            "promote", artifact=self.options.name,
            symbols=list(compiled.lowered.sym_names))
        # the superseded artifact's entries are unreachable — free the
        # executors they pin
        prev.cache.drop_fingerprint(prev._fingerprint)
        return compiled._dispatch(arrays)

    # ------------------------------------------------------------ calling --
    def __call__(self, *arrays):
        if self._compiled is None:
            if self._specs is None:
                if self.options.pipeline == "jit":
                    # no declared dynamic dims: every arg passes through
                    self._specs = (None,) * len(arrays)
                else:
                    self._specs = tuple(infer_specs(arrays))
                    self._inferred = True
            self._ensure()
        return self._compiled(*arrays)

    def __getattr__(self, item):
        compiled = object.__getattribute__(self, "_compiled")
        if compiled is None:
            raise AttributeError(
                f"{item!r} is unavailable before compilation — call the "
                f"function once (or pass specs) first")
        return getattr(compiled, item)


def compile(fn: Optional[Callable] = None,
            specs: Optional[Sequence[Any]] = None,
            options: Optional[CompileOptions] = None,
            **kw) -> CompiledFunction:
    """Compile ``fn`` for dynamic shapes through the DISC pipeline.

    ``specs`` declares per-argument shapes with symbolic dims (strings or
    :class:`Dim` objects); omit it to infer from the first call.  All
    remaining keywords are :class:`CompileOptions` fields::

        f2 = disc_torch.compile(f, [(Dim("S", max=2048), 64), (64, 32)],
                                backend="hopper")          # on the card
        lowered = f2.lower()      # inspect DHLO graph + plans
        art = lowered.compile()   # generated dispatcher

    Usable as a decorator (``@disc_torch.compile`` or
    ``@disc_torch.compile(specs=..., backend=...)``).
    """
    if fn is None:  # decorator-with-arguments form
        return lambda f: CompiledFunction(f, specs, options, **kw)
    if not callable(fn):
        raise TypeError("disc_torch.compile: first argument must be callable")
    return CompiledFunction(fn, specs, options, **kw)
