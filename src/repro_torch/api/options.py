"""Public option objects for ``disc_torch.compile`` — one place for every knob.

:class:`CompileOptions` consolidates the knobs; :class:`Dim` makes symbolic
dimensions first-class values that carry their own bucketing contract
(``max``, ``multiple_of``) instead of smuggling it through a separately
constructed :class:`~repro_torch.core.bucketing.BucketPolicy`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple, Union

import torch

from ..core.bucketing import BucketPolicy, POW2
from ..core.cache import CompileCache
from ..errors import NoDeviceError
from ..frontends.fx_frontend import ArgSpec, TreeSpec

__all__ = ["Dim", "CompileOptions", "TreeSpec", "normalize_specs",
           "resolve_device"]


@dataclass(frozen=True)
class Dim:
    """A named symbolic dimension with an optional bucketing contract.

    ``Dim("S", max=4096, multiple_of=8)`` in a spec shape means: dimension
    ``S`` is dynamic, never exceeds 4096 (buckets are clamped there, larger
    runtime values are a contract violation), and buckets are sized in
    multiples of 8.

    ``bucket`` selects the bucketing rule for this symbol:

    * ``"pow2"``     — granule·2^k buckets (log-many; the default)
    * ``"multiple"`` — multiples of ``multiple_of`` (linear-many, less
      padding waste; good when shapes cluster)
    * ``"exact"``    — no bucketing: one compile per concrete size (the
      static-compiler baseline)
    """

    name: str
    max: Optional[int] = None
    multiple_of: Optional[int] = None
    bucket: str = "pow2"

    def __post_init__(self):
        if not self.name or not isinstance(self.name, str):
            raise ValueError(f"Dim needs a non-empty string name, got {self.name!r}")
        if self.bucket not in ("pow2", "multiple", "exact"):
            raise ValueError(f"unknown bucket rule {self.bucket!r}")
        if self.max is not None and self.max < 1:
            raise ValueError(f"Dim {self.name}: max must be >= 1")
        if self.multiple_of is not None and self.multiple_of < 1:
            raise ValueError(f"Dim {self.name}: multiple_of must be >= 1")

    def policy_override(self) -> Optional[Tuple[str, Tuple[str, int]]]:
        """The per-symbol :class:`BucketPolicy` override this Dim implies."""
        if self.bucket == "exact":
            return (self.name, ("exact", 1))
        if self.multiple_of is not None:
            kind = "multiple" if self.bucket == "multiple" else "pow2"
            return (self.name, (kind, self.multiple_of))
        if self.bucket == "multiple":
            return (self.name, ("multiple", 16))
        return None


DimLike = Union[int, str, Dim]
SpecLike = Union[ArgSpec, TreeSpec, Tuple[DimLike, ...], None]


@dataclass(frozen=True)
class CompileOptions:
    """Every ``disc_torch.compile`` knob, in one (immutable) place.

    * ``policy``               — default bucketing rule (per-``Dim``
      contracts are layered on top as overrides)
    * ``backend``              — registry name: ``"eager"``, ``"hopper"``,
      ``"nimble_vm"``,
      or anything registered via :func:`repro_torch.api.register_backend`
    * ``device``               — where the artifact runs: ``"cuda"`` (the
      default; compiling raises :class:`~repro_torch.errors.NoDeviceError`
      when no card is present) or ``"cpu"``, which runs every kernel's
      plain version and is meant for tests
    * ``escalation_threshold`` — §4.4 static/dynamic mix: exact signatures
      seen at least this many times get their own unpadded, unmasked
      specialization (``None`` disables)
    * ``promote_on_change``    — spec-inference refinement: when specs
      were inferred from the first call, dims that merely coincided there
      are re-lowered as independent dims the moment a later call breaks
      the coincidence (on by default; only meaningful without declared
      specs)
    * ``max_cache_entries``    — LRU budget of the compile cache
    * ``memory_planning``      — bucket-generic symbolic buffer reuse: the
      plan built at ``lower()`` time compares live ranges' byte sizes
      *symbolically* and shares slots across every bucket of the artifact.
      Off, the planner reports one slot per value; outputs are identical
      either way
    * ``plan_donation``        — let the plan mark dead-after-last-use
      parameters as donatable and realize in-place update ops as buffer
      donations
    * ``pipeline``             — ``"dhlo"`` runs the full DISC pipeline
      (bridge → constraints → fusion → bucketed codegen → generated
      dispatch); ``"jit"`` skips the DHLO bridge and buckets a plain
      PyTorch function directly: declared dynamic args are bucket-padded,
      ``None`` args (parameter / KV-cache trees) pass through, and each
      bucket entry on the card is one CUDA graph of the function: its
      first call runs eagerly and is captured, later calls replay it
      (``core/graphs.py``; pass-through args read in place, every other
      tensor leaf copied into the entry's own buffer;
      eager on the CPU and inside ``plain_versions()`` /
      ``eager_entries()``): the serving engine's prefill and decode
    * ``mesh``                 — a ``DeviceMesh`` with named dims
      (:func:`repro_torch.launch.mesh.make_mesh`): the artifact is
      lowered for SPMD execution over it.  The planner
      (:mod:`repro_torch.dist.spmd`) emits per-argument layouts from the
      ``sharding_profile`` and *tightens the bucket policy* so every
      sharded dynamic dim's bucket is a multiple of the owning mesh axes'
      size (a plan-time constraint, raised at ``lower()`` when the
      ``Dim`` contract cannot satisfy it); the generated dispatch then
      lays padded buckets out as DTensors and keeps lens vectors
      replicated
    * ``sharding_profile``     — a profile name (``"dp"`` / ``"fsdp"`` /
      ``"tp"``) or a :class:`~repro_torch.dist.profiles.ShardingProfile`;
      only meaningful with ``mesh`` (defaults to ``"dp"``)
    * ``cache``                — share a :class:`CompileCache` between
      several compiled artifacts (entries are keyed by per-artifact
      fingerprint and never collide)
    * ``name``                 — artifact name for diagnostics
    """

    policy: BucketPolicy = POW2
    backend: str = "eager"
    device: str = "cuda"
    escalation_threshold: Optional[int] = None
    promote_on_change: bool = True
    max_cache_entries: int = 256
    memory_planning: bool = True
    plan_donation: bool = True
    pipeline: str = "dhlo"
    mesh: Optional[Any] = None
    sharding_profile: Optional[Any] = None
    cache: Optional[CompileCache] = None
    name: str = "disc"

    def __post_init__(self):
        if self.pipeline not in ("dhlo", "jit"):
            raise ValueError(f"unknown pipeline {self.pipeline!r} "
                             f"(expected 'dhlo' or 'jit')")
        if self.sharding_profile is not None and self.mesh is None:
            raise ValueError(
                "CompileOptions(sharding_profile=...) needs a mesh: pass "
                "CompileOptions(mesh=..., sharding_profile=...)")
        if self.mesh is not None:
            from ..dist.context import check_mesh
            from ..dist.profiles import get_profile
            check_mesh(self.mesh, "CompileOptions")
            get_profile(self.sharding_profile or "dp")  # validate early

    def replace(self, **kw) -> "CompileOptions":
        return dataclasses.replace(self, **kw)

    def policy_with_dims(self, dims: Sequence[Dim]) -> BucketPolicy:
        """Layer per-``Dim`` contracts onto the base policy."""
        overrides = list(self.policy.overrides)
        caps = list(self.policy.caps)
        for d in dims:
            ov = d.policy_override()
            if ov is not None and ov[0] not in [n for n, _ in overrides]:
                overrides.append(ov)
            if d.max is not None and d.name not in [n for n, _ in caps]:
                caps.append((d.name, d.max))
        if overrides == list(self.policy.overrides) and caps == list(self.policy.caps):
            return self.policy
        return dataclasses.replace(self.policy, overrides=tuple(overrides),
                                   caps=tuple(caps))


def resolve_device(device: Any) -> torch.device:
    """The artifact's device; a CUDA device must exist — never a silent
    move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoDeviceError(
            f"disc_torch was asked to compile for {dev} (the default "
            f"device), but no CUDA device is present; pass device='cpu' "
            f"to run the plain kernel versions on the CPU on purpose")
    return dev


def normalize_specs(specs: Optional[Sequence[SpecLike]],
                    default_dtype=torch.float32,
                    ) -> Tuple[Optional[Tuple[Any, ...]], Tuple[Dim, ...]]:
    """Normalize user-facing specs into ``ArgSpec``s + the ``Dim``s found.

    Accepts per argument: an :class:`ArgSpec`, a bare shape tuple whose
    entries are ints / symbol-name strings / :class:`Dim` objects, a
    ``(shape, dtype[, name])`` tuple, a :class:`TreeSpec` (pytree whose
    leaves share bucketed axes — jit pipeline only), or ``None``
    (pass-through argument — jit pipeline only).  Returns
    ``(normalized, dims)``;
    ``normalized`` is ``None`` when ``specs`` is ``None`` (defer to
    first-call inference).
    """
    if specs is None:
        return None, ()
    dims: dict = {}
    explicit: set = set()  # names declared via a Dim object (vs bare string)

    def register(d: Union[str, Dim]) -> str:
        """Record one symbolic-dim occurrence; returns its name."""
        if isinstance(d, Dim):
            # only two *explicit* contracts can conflict — a bare string
            # occurrence of the same name just references this Dim
            if d.name in explicit and dims[d.name] != d:
                raise ValueError(
                    f"Dim {d.name!r} declared twice with different "
                    f"contracts: {dims[d.name]} vs {d}")
            dims[d.name] = d
            explicit.add(d.name)
            return d.name
        dims.setdefault(d, Dim(d))
        return d

    out = []
    for spec in specs:
        if spec is None:
            out.append(None)
            continue
        if isinstance(spec, TreeSpec):
            out.append(TreeSpec(tuple(
                (axis, register(d)) for axis, d in spec.axes)))
            continue
        if isinstance(spec, ArgSpec):
            shape, dtype, name = spec.shape, spec.dtype, spec.name
        elif isinstance(spec, tuple) and all(
                isinstance(d, (int, str, Dim)) for d in spec):
            shape, dtype, name = spec, default_dtype, ""
        elif isinstance(spec, tuple) and len(spec) in (2, 3) and isinstance(spec[0], (tuple, list)):
            shape = tuple(spec[0])
            dtype = spec[1]
            name = spec[2] if len(spec) == 3 else ""
        else:
            raise TypeError(
                f"cannot interpret spec {spec!r}: expected ArgSpec, shape "
                f"tuple, (shape, dtype[, name]), TreeSpec or None")
        norm_shape = []
        for d in shape:
            if isinstance(d, (Dim, str)):
                norm_shape.append(register(d))
            else:
                norm_shape.append(int(d))
        out.append(ArgSpec(tuple(norm_shape), dtype, name))
    return tuple(out), tuple(dims.values())
