"""One CUDA graph per bucket entry of the jit pipeline.

The JAX package compiles each bucket signature of its ``"jit"`` pipeline
with ``jax.jit``: a later call of that signature runs one executable and
nothing of the function's Python.  The port's counterpart is a
:class:`GraphEntry`, the entry the jit pipeline caches per bucket (and
per escalated exact) signature.  On the card it is one captured
``torch.cuda.CUDAGraph``:

* **Compile** is the entry's first call on the card.  The function runs
  once eagerly on the capture stream (building the ``nvcc`` libraries,
  cuBLAS's workspace for that stream and the plans' memos), and that run
  is the call's result.  Then the function is captured
  (``capture_error_mode="thread_local"``; a capture executes nothing, so
  the first call's in-place writes happen once), and every later call
  replays the graph.  A first call or capture that fails raises a
  :class:`~repro_torch.errors.CompileError` naming the entry and torch's
  error, and the entry leaves its cache: a function that synchronises in
  its body (``.item()``) fails so, as ``jax.jit`` refuses to concretise
  a traced value.  The error is transient (out of memory) only where the
  first call wrote no argument that is read in place, since a retry
  would apply that write twice.  There is no eager path on the card
  outside the two contexts below.
* **Inputs.**  Every tensor leaf of every argument is a graph input.  A
  *pass-through* argument (``None`` spec: the parameter and KV-cache
  trees) is read where it lies.  A later call must pass the very tensors
  captured: where a pass-through leaf is another tensor, that leaf
  joins the copied ones and the entry captures anew.  Every other
  tensor leaf is copied into a buffer the entry owns (counted in
  :class:`GraphStats`), so a call never writes into a tensor the caller
  passed before.  A non-tensor leaf that differs from the one captured
  raises.
* **Outputs** cannot change under a later call, as the reference's
  arrays cannot.  An output that is an input leaf comes back as the
  caller's leaf; a copied leaf that the function writes in place is
  copied back into the caller's tensor, as the eager function writes
  it.  Every other output is the first call's own tensor, or a fresh
  copy of the graph's output.
* **Launch counters** (:class:`~repro_torch.kernels.triton_build.
  LaunchCounter`) keep counting the launches the card executed: the
  first call counts its eager launches, the capture pass nothing, and
  every replay adds what the capture pass counted.
* **Spans and fault sites** (:mod:`repro_torch.obs`,
  :mod:`repro_torch.ft`) fire in the first call, the port's trace: the
  capture pass runs with no tracer and no injector installed, so it
  records nothing and no injected fault fires mid-capture, and a replay
  runs no Python.  An entry's ``kernel.cluster`` spans and sites come
  once per entry, as the JAX package's come once per ``jax.jit`` trace.

Inside :func:`~repro_torch.kernels.select.plain_versions` and
:func:`eager_entries`, and for arguments with no CUDA tensor (the CPU),
an entry runs its function eagerly, as the port did before graphs:
``plain_versions()`` because a replay would run the kernels it is there
to replace, ``eager_entries()`` to hold the graphs against the same
kernels launched one by one.
"""
from __future__ import annotations

import contextlib
import contextvars
import time
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Set)

import torch

from ..errors import CONTROL_EXCEPTIONS, CompileError, wrap_compile_error
from ..ft import faults
from ..kernels.select import in_plain_versions
from ..kernels.triton_build import launch_counts
from ..obs import trace as obs_trace

__all__ = ["GraphEntry", "GraphPool", "GraphStats", "CudaGraphs",
           "CUDA_GRAPHS", "eager_entries"]

_EAGER = contextvars.ContextVar("repro_torch_eager_entries", default=False)


@contextlib.contextmanager
def eager_entries() -> Iterator[None]:
    """Inside this context every jit entry on the card runs its function
    eagerly, launching the kernels one by one: the comparison the card
    tests and ``chip_smoke.py`` hold the graphs to.  Entries compiled
    inside it capture at their first call outside it."""
    token = _EAGER.set(True)
    try:
        yield
    finally:
        _EAGER.reset(token)


@contextlib.contextmanager
def _unobserved() -> Iterator[None]:
    """No tracer and no fault injector for the block: a capture pass
    re-runs the entry's Python, and its spans and sites fired in the
    first call already."""
    tracer, injector = obs_trace.ACTIVE, faults.ACTIVE
    obs_trace.ACTIVE = faults.ACTIVE = None
    try:
        yield
    finally:
        obs_trace.ACTIVE, faults.ACTIVE = tracer, injector


@dataclass
class GraphStats:
    """One artifact's graph entries: captures, replays, the bytes copied
    into the entries' buffers (and back into callers' leaves written in
    place) and out of the graphs' outputs, the bytes of those buffers,
    and each capture's seconds (its first call's eager run included)."""

    captures: int = 0
    replays: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    buffer_bytes: int = 0
    capture_seconds: List[float] = field(default_factory=list)


class GraphPool:
    """The memory pool that the graphs of one compile cache share (a
    serving engine's prefill and decode entries).

    Sharing is safe because the graphs replay one at a time on one
    stream, and no tensor a graph writes outlives its replay in the
    pool's free memory: a graph's outputs stay allocated while its entry
    lives (callers get copies, or their own input leaves), so a later
    capture reuses only memory freed inside earlier captures, which each
    replay writes before it reads.  ``reserved_bytes`` sums the card
    memory reserved while capturing."""

    def __init__(self) -> None:
        self._handle = None
        self.reserved_bytes = 0

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


class CudaGraphs:
    """What an entry asks of CUDA.  The CPU tests put a stand-in in the
    place of :data:`CUDA_GRAPHS`.

    Every first call and capture runs on one side stream per device, for
    the life of the process: cuBLAS keeps a workspace (32 MiB on Hopper)
    for each stream it has run on, so a stream per engine would leave one
    behind per engine.  The side stream waits for the current one before
    each use, so memory it frees is reused there only after the current
    stream's work on it."""

    def __init__(self) -> None:
        self._streams: Dict[int, Any] = {}

    def on_card(self, leaves: List[Any]) -> bool:
        return any(isinstance(x, torch.Tensor) and x.is_cuda
                   for x in leaves)

    def stream(self) -> "torch.cuda.Stream":
        index = torch.cuda.current_device()
        if index not in self._streams:
            self._streams[index] = torch.cuda.Stream()
        return self._streams[index]

    def warm_up(self, fn: Callable, args: tuple):
        """``fn(*args)`` run eagerly on the stream the capture will use,
        the current stream made to wait for it; returns its outputs."""
        stream = self.stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            out = fn(*args)
        torch.cuda.current_stream().wait_stream(stream)
        return out

    def capture(self, fn: Callable, args: tuple, pool: GraphPool):
        """``fn(*args)`` captured into a new graph in ``pool``; returns the
        graph and the outputs of the captured pass."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool.handle(), stream=self.stream(),
                              capture_error_mode="thread_local"):
            reserved = torch.cuda.memory_reserved()
            out = fn(*args)
            pool.reserved_bytes += torch.cuda.memory_reserved() - reserved
        return graph, out


#: the CUDA side of every entry
CUDA_GRAPHS = CudaGraphs()


def _flatten(x: Any, leaves: List[Any]):
    """Append the leaves of nested dicts, lists and tuples to ``leaves``
    (anything else is a leaf) and return their structure, as nested
    tuples that compare in C: a call of a serve entry flattens the whole
    parameter tree (~1000 leaves at 81 layers), where
    ``torch.utils._pytree`` costs several times as much."""
    t = type(x)
    if t is dict:
        return (t, tuple(x), tuple([_flatten(v, leaves)
                                    for v in x.values()]))
    if t is list or t is tuple:
        return (t, len(x), tuple([_flatten(v, leaves) for v in x]))
    leaves.append(x)
    return None


def _unflatten(spec, leaves: Iterator[Any]):
    """The structure ``spec`` of :func:`_flatten` rebuilt over ``leaves``."""
    if spec is None:
        return next(leaves)
    t, keys, kids = spec
    if t is dict:
        return {k: _unflatten(s, leaves) for k, s in zip(keys, kids)}
    return t([_unflatten(s, leaves) for s in kids])


def _same(x: torch.Tensor, y: torch.Tensor) -> bool:
    return x.data_ptr() == y.data_ptr() and x.stride() == y.stride()


def _is(x: Any, y: Any) -> bool:
    """``x`` is the tensor ``y``, as a view of the same memory."""
    return (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
            and x.shape == y.shape and x.dtype == y.dtype
            and x.device == y.device and _same(x, y))


def _dt_metas(leaves: List[Any]) -> Optional[tuple]:
    """Per leaf, a DTensor's (mesh, placements, shape, stride), or None
    for any other leaf; None where no leaf is a DTensor.  A graph over
    DTensors captures their local shards: its buffers are local tensors,
    and the function is called with DTensors rebuilt over them."""
    from torch.distributed.tensor import DTensor

    metas = [(x.device_mesh, tuple(x.placements), tuple(x.shape),
              x.stride()) if isinstance(x, DTensor) else None
             for x in leaves]
    return tuple(metas) if any(m is not None for m in metas) else None


def _local(x: Any) -> Any:
    from torch.distributed.tensor import DTensor

    # the shard itself (to_local() may return a new view object)
    return x._local_tensor if isinstance(x, DTensor) else x


def _rewrap(leaves: List[Any], metas: Optional[tuple]) -> List[Any]:
    """``leaves`` with each local shard whose meta :func:`_dt_metas`
    recorded wrapped back into its DTensor (sharing its storage)."""
    if metas is None:
        return leaves
    from torch.distributed.tensor import DTensor

    return [x if m is None else DTensor.from_local(
                x, m[0], m[1], run_check=False, shape=m[2], stride=m[3])
            for x, m in zip(leaves, metas)]


def _set_counts(counts: Dict[Any, int]) -> None:
    for counter, n in counts.items():
        counter.launches = n


class GraphEntry:
    """A bucket (or exact) entry of the jit pipeline: ``fn``'s graph on
    the card, ``fn`` itself elsewhere (see the module docstring).

    ``held`` are the positions of the pass-through arguments, read where
    they lie.  ``dropped(entry)`` is called when the first call or the
    capture fails: it takes the entry out of its compile cache.  It must
    not hold the cache strongly (the cache holds the entry, and the entry
    the graph's inputs)."""

    def __init__(self, fn: Callable, name: str, stats: GraphStats,
                 pool: GraphPool, dropped: Callable[["GraphEntry"], None],
                 held: Sequence[int] = ()):
        self.fn = fn
        self.name = name
        self.stats = stats
        self.pool = pool
        self._dropped = dropped
        self._held = frozenset(held)
        self._moved: Set[int] = set()   # pass-through leaves now copied
        self.graph = None

    def __call__(self, *args):
        if in_plain_versions() or _EAGER.get():
            return self.fn(*args)
        leaves: List[Any] = []
        spec = _flatten(args, leaves)
        metas = _dt_metas(leaves)
        if metas is not None:
            # DTensor leaves: the graph's inputs are their local shards
            leaves = [_local(x) for x in leaves]
        if not CUDA_GRAPHS.on_card(leaves):
            return self.fn(*args)
        if self.graph is not None:
            if spec != self._spec or metas != self._metas:
                raise ValueError(f"{self.name}: called with arguments of "
                                 f"another structure than the captured "
                                 f"call's")
            moved = []
            for i, (x, c) in enumerate(zip(leaves, self._in)):
                if not isinstance(c, torch.Tensor):
                    if x is not c and (type(x) is not type(c) or x != c):
                        raise ValueError(f"{self.name}: {x!r} where the "
                                         f"graph was captured with {c!r}")
                elif not self._copy[i] and not (x is c and _same(x, c)):
                    moved.append(i)
            if not moved:
                return self._replay(leaves)
            self._moved.update(moved)
            # the old graph lives through the new capture: the allocator
            # takes no capture into a pool whose graphs are all freed while
            # its memory (the old outputs) is still held
            old, self.graph = self.graph, None
            out = self._first_call(args, leaves, spec, metas)
            del old
            return out
        return self._first_call(args, leaves, spec, metas)

    def _copied(self, args: tuple) -> List[bool]:
        """Per leaf: True where the graph reads a buffer of its own."""
        copy: List[bool] = []
        for pos, a in enumerate(args):
            n: List[Any] = []
            _flatten(a, n)
            copy.extend([pos not in self._held] * len(n))
        return [c or i in self._moved for i, c in enumerate(copy)]

    def _fail(self, e: Exception, before: Dict[Any, int], what: str,
              transient: bool = True) -> CompileError:
        """The entry leaves its cache; returns ``e`` classified (a new
        error is chained to ``e`` by ``wrap_compile_error``, so the caller
        raises it without ``from e``, which would make a ``CompileError``
        ``e`` its own cause)."""
        _set_counts(before)
        self._dropped(self)
        err = wrap_compile_error(e, f"{what} of {self.name}")
        err.transient = err.transient and transient
        return err

    def _first_call(self, args: tuple, leaves: List[Any], spec, metas):
        """The function run eagerly (this call's result), then captured."""
        t0 = time.perf_counter()
        copy = self._copied(args)
        ins = [x.clone() if c and isinstance(x, torch.Tensor) else x
               for x, c in zip(leaves, copy)]
        copied = sum(x.nbytes for x, c in zip(ins, copy)
                     if c and isinstance(x, torch.Tensor))
        run_args = _unflatten(spec, iter(_rewrap(ins, metas)))
        versions = [x._version if isinstance(x, torch.Tensor) else None
                    for x in ins]
        before = launch_counts()

        def written() -> List[int]:
            return [i for i, v in enumerate(versions)
                    if v is not None and ins[i]._version != v]

        try:
            out = CUDA_GRAPHS.warm_up(self.fn, run_args)
        except CONTROL_EXCEPTIONS:
            _set_counts(before)
            raise
        except Exception as e:  # noqa: BLE001 — wrapped and re-raised
            # a retry would apply writes into arguments read in place
            # twice
            raise self._fail(e, before, "first call",
                             transient=all(copy[i] for i in written()))
        wrote = written()
        ran = launch_counts()
        try:
            with _unobserved():
                graph, captured = CUDA_GRAPHS.capture(self.fn, run_args,
                                                      self.pool)
        except CONTROL_EXCEPTIONS:
            _set_counts(before)
            raise
        except Exception as e:  # noqa: BLE001 — wrapped and re-raised
            # the first call's writes into arguments read in place are
            # done: a retry would apply them twice
            raise self._fail(e, before, "CUDA graph capture",
                             transient=all(copy[i] for i in wrote))
        after = launch_counts()
        _set_counts(ran)
        self._launches = {c: n - ran.get(c, 0) for c, n in after.items()
                          if n != ran.get(c, 0)}
        self._spec, self._in, self._copy = spec, ins, copy
        self._metas = metas
        self._written = [i for i in wrote if copy[i]]
        outs: List[Any] = []
        self._out_spec = _flatten(out, outs)
        self._out_metas = _dt_metas(outs)
        if self._out_metas is not None:
            outs = [_local(o) for o in outs]
        self._alias = [next((i for i, x in enumerate(ins) if _is(o, x)),
                            None) for o in outs]
        self._out = []
        _flatten(captured, self._out)
        self._out = [_local(o) for o in self._out]
        self.graph = graph
        self.stats.captures += 1
        self.stats.buffer_bytes += copied
        copied += self._copy_back(leaves)
        self.stats.bytes_in += copied
        self.stats.capture_seconds.append(time.perf_counter() - t0)
        return _unflatten(self._out_spec, iter(_rewrap(
            [o if a is None else leaves[a]
             for o, a in zip(outs, self._alias)], self._out_metas)))

    def _copy_back(self, leaves: List[Any]) -> int:
        """Copied leaves the function writes, written into the caller's
        tensors; returns the bytes."""
        for i in self._written:
            leaves[i].copy_(self._in[i])
        return sum(leaves[i].nbytes for i in self._written)

    def _replay(self, leaves: List[Any]):
        copied = 0
        for x, c, cp in zip(leaves, self._in, self._copy):
            if cp and isinstance(c, torch.Tensor):
                if not (isinstance(x, torch.Tensor) and x.shape == c.shape
                        and x.dtype == c.dtype and x.device == c.device):
                    raise ValueError(
                        f"{self.name}: a leaf of "
                        f"{getattr(x, 'shape', type(x))} where the graph "
                        f"was captured with {tuple(c.shape)} {c.dtype} on "
                        f"{c.device}")
                c.copy_(x)
                copied += c.nbytes
        self.graph.replay()
        for counter, n in self._launches.items():
            counter.launches += n
        copied += self._copy_back(leaves)
        outs = []
        out_bytes = 0
        for o, a in zip(self._out, self._alias):
            if a is not None:
                outs.append(leaves[a])
            elif isinstance(o, torch.Tensor):
                outs.append(o.clone())
                out_bytes += o.nbytes
            else:
                outs.append(o)
        self.stats.replays += 1
        self.stats.bytes_in += copied
        self.stats.bytes_out += out_bytes
        return _unflatten(self._out_spec, iter(_rewrap(outs,
                                                       self._out_metas)))
