"""Mesh context for distributed execution — a no-op by default.

Models and launchers are written mesh-aware (``maybe_shard`` on
activation boundaries, ``get_mesh()`` for the MoE's expert-parallel
branch).  Outside any ``use_mesh`` scope, or on a plain tensor, every
call here is the identity, so the same model code runs unsharded.

Under a mesh: ``use_mesh`` installs a ``DeviceMesh`` for the dynamic
extent of the ``with`` block; ``maybe_shard`` then redistributes a
DTensor to the spec *pruned to the axes the mesh has* (layer code names
the full production axis set ``("pod", "data", "model")``; a smaller
mesh ignores the rest).  :func:`spmd_scope` is what a compiled artifact
and the serving engine run their entries under: the mesh installed, and
plain tensors made inside the entry (masks, lengths, literals) taken as
replicated by DTensor's operators.
"""
from __future__ import annotations

import contextlib
import threading
import warnings
from typing import Any, Iterator, Optional

from .profiles import PartitionSpec

__all__ = ["use_mesh", "get_mesh", "maybe_shard", "spmd_scope",
           "scope_here", "check_mesh"]

_state = threading.local()


def check_mesh(mesh, where: str) -> None:
    """Raise ``TypeError`` unless ``mesh`` is a ``DeviceMesh`` with named
    dims."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or not mesh.mesh_dim_names:
        raise TypeError(
            f"{where}: mesh= takes a DeviceMesh with named dims "
            f"(repro_torch.launch.mesh.make_mesh), got {type(mesh).__name__}")


def get_mesh():
    """The innermost active mesh, or ``None`` outside any ``use_mesh``."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[Any]:
    """Install ``mesh`` as the ambient mesh for the duration of the
    block."""
    prev = get_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


@contextlib.contextmanager
def spmd_scope(mesh) -> Iterator[Any]:
    """``use_mesh(mesh)`` with DTensor's implicit replication of plain
    tensors (a no-op context when ``mesh`` is None)."""
    if mesh is None:
        yield None
        return
    from torch.distributed.tensor.experimental import implicit_replication
    with use_mesh(mesh), implicit_replication():
        yield mesh


def scope_here():
    """The ambient mesh and DTensor's implicit replication as they stand
    here: a factory of context managers that re-enter them later, on any
    thread (a rematerialised block's recompute runs on autograd's device
    thread, which does not see the mesh), each restoring that thread's
    own on exit."""
    mesh = get_mesh()
    if mesh is None:
        return contextlib.nullcontext
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    implicit = dispatcher._allow_implicit_replication

    @contextlib.contextmanager
    def again():
        prev = get_mesh(), dispatcher._allow_implicit_replication
        _state.mesh = mesh
        dispatcher._allow_implicit_replication = implicit
        try:
            yield
        finally:
            _state.mesh, dispatcher._allow_implicit_replication = prev

    return again


def prune_spec(spec: PartitionSpec, mesh) -> PartitionSpec:
    """Drop axis names the mesh does not have."""
    names = set(mesh.mesh_dim_names or ())
    pruned = []
    for entry in spec:
        if entry is None:
            pruned.append(None)
        elif isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in names)
            pruned.append(kept if kept else None)
        else:
            pruned.append(entry if entry in names else None)
    return PartitionSpec(*pruned)


def maybe_shard(x: Any, spec: Optional[PartitionSpec]) -> Any:
    """Redistribute the DTensor ``x`` to ``spec`` under the active mesh;
    the identity outside a mesh and on a plain tensor.

    A spec *longer than the array's rank* is truncated to the leading
    ``ndim`` entries with a warning.  A spec the shape does not divide
    evenly leaves ``x`` as it is: sharding is a layout hint, never a
    correctness requirement."""
    from torch.distributed.tensor import DTensor

    from .spmd import placements_for

    mesh = get_mesh()
    if mesh is None or spec is None or not isinstance(x, DTensor):
        return x
    if len(spec) > x.ndim:
        warnings.warn(
            f"maybe_shard: spec {spec} has {len(spec)} entries but the "
            f"array has rank {x.ndim}; truncating the spec to the leading "
            f"{x.ndim} entries", stacklevel=2)
        spec = PartitionSpec(*tuple(spec)[:x.ndim])
    if x.device_mesh is not mesh and x.device_mesh != mesh:
        return x
    try:
        placements = placements_for(prune_spec(spec, mesh), mesh,
                                    tuple(x.shape))
    except ValueError:
        return x
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)
