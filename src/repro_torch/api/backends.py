"""Backend registry — one mechanism for selecting how buckets compile.

A :class:`Backend` bundles what a dispatcher needs:

* ``build_bucket``: produce the per-bucket-signature entry
  ``entry(lens, *padded_tensors) -> outputs`` for one padded binding;
* ``build_exact``: produce the exact-shape executor used by §4.4 static
  escalation;
* ``cluster_kernels``: the fused-kernel registrations — a mapping from
  fusion-plan template (``"kLoop"`` / ``"kInput"`` / ``"kDot"``, see
  ``Cluster.template`` in ``core/fusion.py``) to a
  :class:`~repro_torch.core.codegen.ClusterKernel` implementation.
  Clusters whose template a backend registers execute through that
  kernel; the rest run op by op.  Codegen never string-checks the backend
  name.

Built-ins:

* ``"eager"``  — every op emitted per op in torch (no cluster kernels);
  the counterpart of the JAX package's ``"xla"``
* ``"hopper"`` — kLoop, kInput and kDot clusters through the
  hand-written kernels (Triton: ``kernels/fused_elementwise``,
  ``kernels/fused_reduce``; CUDA C++: ``kernels/matmul``), the rest per
  op; the counterpart of ``"pallas"``

Each bucket's entry is the padded executor, run eagerly on the
artifact's device.  Third parties register their own with
``register_backend("mine", Backend(...))``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

from ..core.codegen import (ClusterKernel, build_exact_executor,
                            build_padded_executor, hopper_cluster_kernels)
from ..core.dhlo import DGraph
from ..core.symshape import SymDim

__all__ = ["Backend", "UnknownBackendError", "register_backend",
           "get_backend", "list_backends"]


class UnknownBackendError(ValueError):
    """Raised when ``options.backend`` names no registered backend."""


@dataclass(frozen=True)
class Backend:
    """A named strategy for turning a lowered graph into executables.

    ``build_bucket(graph, plan, syms, padded, device)`` returns the entry
    for one bucket signature; ``build_exact(graph, plan, device)`` returns
    the exact-shape executor for the static-escalation path;
    ``cluster_kernels`` maps fusion-plan templates to the
    :class:`~repro_torch.core.codegen.ClusterKernel` objects that execute
    them.
    """

    name: str
    build_bucket: Callable[..., Any]
    build_exact: Callable[..., Callable]
    description: str = ""
    cluster_kernels: Mapping[str, ClusterKernel] = field(default_factory=dict)


def _make_executor_backend(name: str, description: str,
                           cluster_kernels: Optional[
                               Mapping[str, ClusterKernel]] = None
                           ) -> Backend:
    """A backend whose bucket entries are padded executors running eagerly,
    clusters through its registered ``cluster_kernels``."""
    kernels = dict(cluster_kernels or {})

    def build_bucket(graph: DGraph, plan, syms: Sequence[SymDim],
                     padded: Dict[int, int], device):
        return build_padded_executor(graph, padded, syms, plan=plan,
                                     kernels=kernels, device=device)

    def build_exact(graph: DGraph, plan, device):
        return build_exact_executor(graph, plan=plan, kernels=kernels,
                                    device=device)

    return Backend(name=name, build_bucket=build_bucket,
                   build_exact=build_exact, description=description,
                   cluster_kernels=kernels)


_REGISTRY: Dict[str, Backend] = {}


def register_backend(name: str, backend: Backend, *,
                     overwrite: bool = False) -> Backend:
    """Register ``backend`` under ``name`` (``options.backend=name``)."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(
            f"backend {name!r} is already registered; pass overwrite=True "
            f"to replace it")
    _REGISTRY[name] = backend
    return backend


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnknownBackendError(
            f"unknown backend {name!r}; registered backends: "
            f"{sorted(_REGISTRY)}") from None


def list_backends() -> List[str]:
    return sorted(_REGISTRY)


register_backend("eager", _make_executor_backend(
    "eager", "DHLO emitted per op in torch"))
register_backend("hopper", _make_executor_backend(
    "hopper",
    "kLoop/kInput clusters through hand-written Triton kernels, kDot "
    "through a CUDA C++ GEMM with a generated epilogue, rest per op",
    cluster_kernels=hopper_cluster_kernels()))
