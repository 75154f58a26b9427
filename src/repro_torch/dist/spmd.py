"""SPMD planner: specs + bucket policy + mesh + profile → a sharding plan.

DISC's runtime flow (placement, buffer management, launch logic) is
*generated at compile time* (§4); this module extends that contract to
multi-device execution over a ``torch.distributed.device_mesh.DeviceMesh``.
:func:`plan_spmd` runs at ``lower()`` time and decides, once per
artifact:

* **per-argument shardings** — each declared spec (``ArgSpec`` /
  ``TreeSpec`` / pass-through ``None``) gets a :class:`PartitionSpec`
  from the :class:`~repro_torch.dist.profiles.ShardingProfile`: dynamic
  dims the profile owns land on their mesh axes, fully-static arguments
  get the profile's weight layout (fitted to the mesh), pass-through
  arguments stay untouched (persistent trees are sharded once by their
  owner, e.g. the serve engine's params).
* **mesh-divisibility bucket constraints** — a sharded dynamic dim's
  buckets must divide evenly across the owning mesh axes *for every
  bucket the policy can produce*.  The planner **tightens the
  BucketPolicy** (granule ← lcm(granule, axis size)) so divisibility is a
  plan-time theorem, not a per-call check.  Contracts that *cannot* be
  tightened — ``bucket="exact"`` dims, or a declared ``max`` the mesh
  axes do not divide — raise
  :class:`~repro_torch.core.constraints.ConstraintViolation` at
  ``lower()`` time.

The generated host dispatch consumes the plan: padded bucket buffers are
laid out as DTensors with their planned placements (each rank keeps its
own slice of the buffer every rank holds: no collective), lens vectors
stay replicated, and the §4.4 escalation branch re-fits the specs to the
exact (possibly non-divisible) shapes.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._pytree import tree_map

from ..core.bucketing import BucketPolicy
from ..core.constraints import ConstraintViolation
from .profiles import PartitionSpec, ShardingProfile

P = PartitionSpec

__all__ = ["MeshDimConstraint", "ShardingPlan", "NamedSharding",
           "plan_spmd", "fit_spec", "replicated", "placements_for",
           "shard_tensor", "mesh_shape", "mesh_token"]


# ---------------------------------------------------------------- mesh --
def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in mesh order."""
    return {a: int(s) for a, s in zip(mesh.mesh_dim_names, mesh.shape)}


def mesh_token(mesh) -> str:
    """Shape, axis names, ranks and device type of ``mesh``: two meshes
    of one shape over other ranks lay out other executables."""
    ranks = tuple(int(r) for r in mesh.mesh.flatten().tolist())
    dev = mesh.device_type
    if dev == "cuda":
        dev = f"cuda:{torch.cuda.current_device()}"
    return repr((tuple(mesh.mesh_dim_names), tuple(mesh.shape), ranks, dev))


def fit_spec(shape: Sequence[int], spec: PartitionSpec, mesh) -> P:
    """Fit a logical spec to a concrete shape on a concrete mesh.

    Axis names the mesh lacks are dropped (logical specs name the full
    production axis set); axis groups that do not evenly divide the
    dimension lose their outermost axis first (an explicit layout must
    divide evenly — e.g. batch=1 cells, odd vocabs)."""
    sizes = mesh_shape(mesh)
    out: List[Any] = []
    for i, entry in enumerate(spec):
        if i >= len(shape) or entry is None:
            out.append(None)
            continue
        axes = list(entry) if isinstance(entry, (tuple, list)) else [entry]
        axes = [a for a in axes if a in sizes]
        while axes:
            if shape[i] % math.prod(sizes[a] for a in axes) == 0:
                break
            axes.pop(0)  # drop outermost (e.g. "pod") first
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(tuple(axes))
    return P(*out)


def placements_for(spec: PartitionSpec, mesh,
                   shape: Optional[Sequence[int]] = None) -> tuple:
    """DTensor placements (one per mesh dim) of ``spec`` on ``mesh``.

    A tensor dim split over several mesh axes takes them major to minor
    in mesh order.  Raises ``ValueError`` where ``spec`` names an axis
    twice, orders a group against the mesh, or (``shape`` given) does
    not divide a dim evenly."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    sizes = mesh_shape(mesh)
    place: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        axes = tuple(a for a in axes if a in sizes)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} against the mesh "
                             f"order {tuple(names)}")
        if shape is not None and axes and \
                shape[d] % math.prod(sizes[a] for a in axes):
            raise ValueError(f"spec {spec}: dim {d} of {tuple(shape)} "
                             f"does not divide over {axes}")
        for j in idx:
            if not isinstance(place[j], Replicate):
                raise ValueError(f"spec {spec} names mesh axis "
                                 f"{names[j]!r} twice")
            place[j] = Shard(d)
    return tuple(place)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (its DTensor placements: :func:`placements_for`)."""

    mesh: Any
    spec: PartitionSpec

    def __repr__(self) -> str:
        return f"NamedSharding({mesh_shape(self.mesh)}, {self.spec})"


def replicated(mesh) -> NamedSharding:
    """The fully-replicated sharding (lens vectors, scalars)."""
    return NamedSharding(mesh, P())


def shard_tensor(x: Any, mesh, placements: tuple) -> Any:
    """``x`` as a DTensor with ``placements``.  A plain tensor is the
    same on every rank (every rank runs the same program on the same
    inputs), so each rank keeps its own slice, with no collective; a
    DTensor is redistributed (a collective where its layout differs)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(x, DTensor):
        if tuple(x.placements) == tuple(placements):
            return x
        return x.redistribute(mesh, placements)
    if not isinstance(x, torch.Tensor):
        return x
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


@dataclass(frozen=True)
class MeshDimConstraint:
    """One plan-time shape fact: every bucket of ``dim`` is a multiple of
    ``multiple_of`` (the product of the owning mesh axes' sizes)."""

    dim: str
    axes: Tuple[str, ...]
    multiple_of: int

    def as_dict(self) -> Dict[str, Any]:
        return {"dim": self.dim, "axes": list(self.axes),
                "multiple_of": self.multiple_of}


# per-argument plan entries
_ARRAY, _TREE = "array", "tree"


@dataclass
class ShardingPlan:
    """The emitted shardings for one artifact on one mesh."""

    mesh: Any
    profile: ShardingProfile
    # per argument: None | ("array", PartitionSpec) |
    #               ("tree", ((leaf_axis, mesh_axes | None), ...))
    arg_entries: Tuple[Optional[Tuple[str, Any]], ...]
    constraints: Tuple[MeshDimConstraint, ...] = ()
    _cache: Dict[Any, tuple] = field(default_factory=dict)

    # ------------------------------------------------------------- lookup --
    def _placements(self, spec: PartitionSpec,
                    shape: Optional[Sequence[int]] = None) -> tuple:
        key = (tuple(spec), None if shape is None else tuple(shape))
        hit = self._cache.get(key)
        if hit is None:
            hit = self._cache[key] = placements_for(spec, self.mesh, shape)
        return hit

    def arg_sharding(self, i: int) -> Optional[NamedSharding]:
        """The bucket-time sharding of array argument ``i`` (``None`` for
        pass-through and tree arguments)."""
        e = self.arg_entries[i]
        if e is None or e[0] != _ARRAY:
            return None
        return NamedSharding(self.mesh, e[1])

    def lens_sharding(self) -> NamedSharding:
        return replicated(self.mesh)

    def arg_put(self, i: int, static: bool = False
                ) -> Optional[Callable[[Any], Any]]:
        """``x -> DTensor`` laying array argument ``i`` out per the plan
        (``None`` for pass-through and tree arguments).  A ``static``
        argument (a weight the dispatch passes unpadded) keeps its last
        layout while the caller passes the same, unwritten tensor: a
        bucket's CUDA graph reads it in place, call after call."""
        e = self.arg_entries[i]
        if e is None or e[0] != _ARRAY:
            return None
        spec, mesh = e[1], self.mesh
        last: List[Any] = [None, None, None]   # weakref, version, DTensor

        def put(x):
            if static and last[0] is not None and last[0]() is x \
                    and last[1] == x._version:
                return last[2]
            out = shard_tensor(x, mesh, self._placements(spec))
            if static and isinstance(x, torch.Tensor):
                last[:] = [weakref.ref(x), x._version, out]
            return out

        return put

    # -------------------------------------------------------------- trees --
    def tree_sharder(self, i: int) -> Optional[Callable[[Any], Any]]:
        """A ``tree -> tree`` callable laying every tensor leaf of pytree
        argument ``i`` out per its leaf's fitted spec (``None`` when the
        argument is not a tree or shards nothing)."""
        e = self.arg_entries[i]
        if e is None or e[0] != _TREE:
            return None
        axes = [(ax, ma) for ax, ma in e[1] if ma]
        if not axes:
            return None
        mesh = self.mesh

        def put_leaf(x):
            shape = getattr(x, "shape", None)
            if shape is None:
                return x
            entries: List[Any] = [None] * len(shape)
            for ax, ma in axes:
                if ax < len(shape):
                    entries[ax] = ma
            spec = fit_spec(tuple(shape), P(*entries), mesh)
            return shard_tensor(x, mesh, self._placements(spec))

        return lambda tree: tree_map(put_leaf, tree)

    # --------------------------------------------------------- escalation --
    def put_exact(self, arrays: Sequence[Any]) -> List[Any]:
        """Lay a call's *exact* (unpadded, possibly non-divisible)
        arguments out for the §4.4 escalation path: each logical spec is
        re-fitted to the concrete shape, dropping axes that no longer
        divide evenly (``B = 7`` on 2 ranks: replicated)."""
        out = []
        for i, x in enumerate(arrays):
            e = self.arg_entries[i]
            if e is None:
                out.append(x)
            elif e[0] == _ARRAY:
                shape = tuple(getattr(x, "shape", ()))
                spec = fit_spec(shape, e[1], self.mesh)
                out.append(shard_tensor(x, self.mesh,
                                        self._placements(spec)))
            else:
                sharder = self.tree_sharder(i)
                out.append(sharder(x) if sharder is not None else x)
        return out

    # ------------------------------------------------------------- report --
    def report(self) -> Dict[str, Any]:
        per_arg: List[Any] = []
        for e in self.arg_entries:
            if e is None:
                per_arg.append(None)
            elif e[0] == _ARRAY:
                per_arg.append(str(e[1]))
            else:
                per_arg.append(
                    {"tree": {ax: list(ma) if ma else None
                              for ax, ma in e[1]}})
        return {
            "mesh": mesh_shape(self.mesh),
            "profile": self.profile.name,
            "per_arg": per_arg,
            "constraints": [c.as_dict() for c in self.constraints],
        }

    def token(self) -> str:
        """The plan and the mesh's ranks and devices, hashed: the SPMD
        part of an artifact's fingerprint."""
        h = hashlib.sha1((repr(self.report())
                          + mesh_token(self.mesh)).encode())
        return "+spmd:" + h.hexdigest()[:12]


def _tighten(policy: BucketPolicy, name: str, axes: Tuple[str, ...],
             m: int) -> BucketPolicy:
    """Tighten ``name``'s bucket rule so every bucket is a multiple of
    ``m`` — or prove it impossible (ConstraintViolation)."""
    kind, g = policy.rule(name)
    if kind == "exact":
        raise ConstraintViolation(
            f"dim {name!r} is sharded over mesh axes {axes} (size {m}) but "
            f"uses bucket='exact': exact buckets equal the runtime value "
            f"and cannot be proven divisible at plan time — use 'pow2' or "
            f"'multiple' bucketing, or a profile that does not shard "
            f"{name!r}")
    cap = policy.cap(name)
    if cap is not None and cap % m != 0:
        raise ConstraintViolation(
            f"dim {name!r} has max={cap}, not a multiple of its mesh axes "
            f"{axes} (size {m}): the cap-clamped bucket could not be "
            f"sharded evenly — declare a max divisible by {m}")
    g2 = math.lcm(g, m)
    if g2 == g:
        return policy
    replaced = False
    overrides: List[Tuple[str, Tuple[str, int]]] = []
    for n, rule in policy.overrides:
        if n == name:
            overrides.append((n, (kind, g2)))
            replaced = True
        else:
            overrides.append((n, rule))
    if not replaced:
        overrides.append((name, (kind, g2)))
    return dataclasses.replace(policy, overrides=tuple(overrides))


def plan_spmd(specs: Sequence[Any], policy: BucketPolicy, mesh,
              profile: ShardingProfile,
              ) -> Tuple[ShardingPlan, BucketPolicy]:
    """Plan the per-argument shardings for one lowering.

    ``specs`` are the normalized per-argument specs (``ArgSpec`` /
    ``TreeSpec`` / ``None``); returns the plan plus the **tightened**
    bucket policy (sharded dynamic dims' granules are raised to the lcm
    with the owning mesh-axis sizes, so every bucket divides evenly)."""
    from ..frontends.fx_frontend import ArgSpec, TreeSpec

    sizes = mesh_shape(mesh)

    def present_axes(dim_name: str) -> Tuple[str, ...]:
        axes = profile.axes_for_dim(dim_name) or ()
        return tuple(a for a in axes if a in sizes)

    constraints: List[MeshDimConstraint] = []
    seen: set = set()

    def note(dim_name: str) -> Tuple[str, ...]:
        nonlocal policy
        axes = present_axes(dim_name)
        if not axes:
            return ()
        m = math.prod(sizes[a] for a in axes)
        if m > 1 and dim_name not in seen:
            seen.add(dim_name)
            policy = _tighten(policy, dim_name, axes, m)
            constraints.append(
                MeshDimConstraint(dim=dim_name, axes=axes, multiple_of=m))
        return axes

    entries: List[Optional[Tuple[str, Any]]] = []
    for spec in specs:
        if spec is None:
            entries.append(None)
            continue
        if isinstance(spec, TreeSpec):
            entries.append((_TREE, tuple(
                (ax, note(d) or None) for ax, d in spec.axes)))
            continue
        assert isinstance(spec, ArgSpec)
        if any(isinstance(d, str) for d in spec.shape):
            parts: List[Any] = []
            for d in spec.shape:
                axes = note(d) if isinstance(d, str) else ()
                if not axes:
                    parts.append(None)
                elif len(axes) == 1:
                    parts.append(axes[0])
                else:
                    parts.append(axes)
            entries.append((_ARRAY, P(*parts)))
        else:
            # fully static: weight-like — profile layout, fitted now
            entries.append((_ARRAY, fit_spec(
                spec.shape, profile.leaf_spec(tuple(spec.shape)), mesh)))

    plan = ShardingPlan(mesh=mesh, profile=profile,
                        arg_entries=tuple(entries),
                        constraints=tuple(constraints))
    return plan, policy
