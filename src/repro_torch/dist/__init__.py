"""``repro_torch.dist`` — the SPMD subsystem.

* :mod:`repro_torch.dist.context`  — ambient-mesh context (``use_mesh`` /
  ``maybe_shard``; the identity outside a mesh and on a plain tensor).
* :mod:`repro_torch.dist.profiles` — named sharding layouts (``dp`` /
  ``fsdp`` / ``tp``) over the logical ``("pod", "data", "model")``
  axes, and the port's :class:`PartitionSpec`.
* :mod:`repro_torch.dist.spmd`     — the plan-time SPMD planner:
  per-argument shardings + mesh-divisibility bucket constraints,
  consumed by the generated dispatch (``CompileOptions(mesh=...,
  sharding_profile=...)``).
* :mod:`repro_torch.dist.collectives` — the collective counter behind
  ``report()["sharding"]["collectives"]``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dims, a sharded array a DTensor.
"""
from .context import get_mesh, maybe_shard, spmd_scope, use_mesh  # noqa: F401
from .profiles import (  # noqa: F401
    ALL_AXES, DP_AXES, PROFILES, P, PartitionSpec, ShardingProfile,
    get_profile, list_profiles,
)
from .spmd import (  # noqa: F401
    MeshDimConstraint, NamedSharding, ShardingPlan, fit_spec, plan_spmd,
    replicated,
)
from ..launch.mesh import make_mesh  # noqa: F401  (starts no group)

__all__ = [
    "use_mesh", "get_mesh", "maybe_shard", "spmd_scope",
    "ShardingProfile", "get_profile", "list_profiles", "PROFILES",
    "DP_AXES", "ALL_AXES", "PartitionSpec", "P",
    "ShardingPlan", "MeshDimConstraint", "NamedSharding", "plan_spmd",
    "fit_spec", "replicated", "make_mesh",
]
