"""Sharding profiles — named SPMD layouts over the logical mesh axes.

A :class:`ShardingProfile` answers the two questions any SPMD planner has
to answer for DISC artifacts:

* **which dynamic dims are sharded, and along which mesh axes** —
  ``dim_axes`` maps a symbolic-dim *name* (the strings in
  ``disc_torch.compile`` specs, e.g. ``"B"``) to the logical axes that
  partition it.  The planner (:mod:`repro_torch.dist.spmd`) intersects
  those with the axes the actual mesh defines, exactly like
  :func:`repro_torch.dist.context.maybe_shard` prunes activation specs.
* **how persistent pytrees (params, KV caches) are laid out** —
  ``param_mode`` selects between replication (pure data parallel),
  ZeRO-3 full sharding (every leaf folded onto the joint data-parallel
  axis group), and tensor parallelism (honor the model-provided logical
  spec tree from ``model.specs()`` / ``model.cache_specs()``).

The three built-ins, over the production axis set ``("pod", "data",
"model")``:

========  =========================  ======================================
profile   dynamic batch dim ``"B"``  params / caches
========  =========================  ======================================
``dp``    ``("pod", "data")``        replicated
``fsdp``  ``("pod", "data")``        every leaf ZeRO-3 sharded over the
                                     WHOLE mesh (all axes one
                                     data-parallel group, as in
                                     ``models/layers.py``'s ``_DP_ALL``)
``tp``    ``("pod", "data")``        model-provided logical specs (TP
                                     weights on ``"model"``); generic
                                     leaves column-parallel on ``"model"``
========  =========================  ======================================

A logical spec is a :class:`PartitionSpec`: per array dim ``None``, one
axis name, or a tuple of axis names (major to minor).  PyTorch has no
such type, so the port carries its own; it is a tuple, and a pytree leaf.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

from torch.utils._pytree import tree_map

__all__ = ["PartitionSpec", "P", "ShardingProfile", "get_profile",
           "list_profiles", "DP_AXES", "ALL_AXES", "PROFILES"]

#: the data-parallel axis group (gradient/batch partitioning)
DP_AXES: Tuple[str, ...] = ("pod", "data")
#: every logical production axis, in mesh order
ALL_AXES: Tuple[str, ...] = ("pod", "data", "model")

_PARAM_MODES = ("replicate", "fsdp", "tp")


class PartitionSpec(tuple):
    """A logical layout: one entry per array dim, each ``None`` (not
    partitioned), an axis name, or a tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self) -> str:
        return "PartitionSpec(" + ", ".join(repr(e) for e in self) + ")"

    __str__ = __repr__


P = PartitionSpec


def is_spec(x: Any) -> bool:
    return isinstance(x, PartitionSpec)


@dataclass(frozen=True)
class ShardingProfile:
    """One named SPMD layout (see the module docstring for the
    built-ins)."""

    name: str
    #: dynamic-dim name -> logical mesh axes sharding it
    dim_axes: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
        ("B", DP_AXES),)
    #: "replicate" | "fsdp" | "tp" — persistent-pytree layout
    param_mode: str = "replicate"
    description: str = ""

    def __post_init__(self):
        if self.param_mode not in _PARAM_MODES:
            raise ValueError(
                f"unknown param_mode {self.param_mode!r} "
                f"(expected one of {_PARAM_MODES})")

    def replace(self, **kw) -> "ShardingProfile":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------ dynamic dims --
    def axes_for_dim(self, dim_name: str) -> Optional[Tuple[str, ...]]:
        """Logical mesh axes sharding ``dim_name``, or ``None``."""
        for name, axes in self.dim_axes:
            if name == dim_name:
                return tuple(axes)
        return None

    # --------------------------------------------------- persistent trees --
    def leaf_spec(self, shape: Tuple[int, ...]) -> PartitionSpec:
        """Logical spec for one *static* array (a weight-like leaf); fit
        it to a concrete mesh with :func:`repro_torch.dist.spmd.fit_spec`,
        which drops axes that do not divide the dimension."""
        nd = len(shape)
        if nd == 0 or self.param_mode == "replicate":
            return P(*([None] * nd))
        if self.param_mode == "fsdp":
            # ZeRO-3: fold EVERY mesh axis onto one dim, the largest, so
            # the fold is most likely to divide evenly
            target = max(range(nd), key=lambda i: shape[i])
            return P(*[ALL_AXES if i == target else None
                       for i in range(nd)])
        # tp without a model-provided spec: column-parallel default
        return P(*([None] * (nd - 1) + ["model"]))

    def param_specs(self, tree: Any, logical: Any = None) -> Any:
        """A spec tree congruent to ``tree``: the model-provided
        ``logical`` tree under ``tp`` when given, else one spec per leaf
        from :meth:`leaf_spec`."""
        if self.param_mode == "tp" and logical is not None:
            return logical
        return tree_map(
            lambda x: self.leaf_spec(tuple(getattr(x, "shape", ()))), tree)

    def batch_axes(self) -> Tuple[str, ...]:
        """The mesh axes this profile shards the batch dim ``"B"`` on."""
        return self.axes_for_dim("B") or ()

    def batch_leaf_spec(self, ndim: int, batch_axis: int) -> PartitionSpec:
        """Spec for a batch-carrying leaf (KV-cache rows, activations):
        the batch axis is partitioned on the profile's batch axes."""
        axes = self.batch_axes()
        return P(*[(axes or None) if i == batch_axis else None
                   for i in range(ndim)])


PROFILES: Dict[str, ShardingProfile] = {
    "dp": ShardingProfile(
        name="dp", param_mode="replicate",
        description="pure data parallel: batch sharded, params replicated"),
    "fsdp": ShardingProfile(
        name="fsdp", param_mode="fsdp",
        description="ZeRO-3: batch sharded, params fully sharded over "
                    "the whole mesh (all axes one DP group), gathered "
                    "per use"),
    "tp": ShardingProfile(
        name="tp", param_mode="tp",
        description="tensor parallel: batch on DP axes, weights on "
                    "'model' per the model's logical specs"),
}


def get_profile(p: Union[str, ShardingProfile]) -> ShardingProfile:
    """Resolve a profile name (or pass a profile object through)."""
    if isinstance(p, ShardingProfile):
        return p
    try:
        return PROFILES[p]
    except KeyError:
        raise ValueError(
            f"unknown sharding profile {p!r} "
            f"(expected one of {sorted(PROFILES)} or a ShardingProfile)")


def list_profiles() -> Tuple[str, ...]:
    return tuple(sorted(PROFILES))
