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
* ``"nimble_vm"`` — the interpreted baseline under the paper's name:
  ``"eager"``'s per-op executor (no cluster kernels), never captured, as
  the reference's ``_make_vm_backend`` runs uncompiled;
  :class:`~repro_torch.core.vm.NimbleVM` is the standalone interpreter
  that works out every shape again per call

Each bucket's entry is the padded executor on the artifact's device.
Where ``Backend.graphs`` is set (``"eager"``, ``"hopper"``: the
counterparts of the reference's ahead-of-time compiled ``"xla"`` and
``"pallas"``), the compiled function wraps each bucket entry, and each
escalated exact entry, in a CUDA graph on the card
(:class:`~repro_torch.core.graphs.GraphEntry`), unless the graph holds a
``d.while`` or ``d.cond``, whose host reads no capture can hold.  Third
parties register their own with ``register_backend("mine",
Backend(...))``.
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

    ``build_bucket(graph, plan, syms, padded, device, arg_shardings=None)``
    returns the entry for one bucket signature (under
    ``CompileOptions(mesh=...)`` it is given the ``(lens, *args)``
    layouts, and a backend whose ``build_bucket`` takes no
    ``arg_shardings`` cannot compile under a mesh); ``build_exact(graph, plan, device)`` returns
    the exact-shape executor for the static-escalation path;
    ``cluster_kernels`` maps fusion-plan templates to the
    :class:`~repro_torch.core.codegen.ClusterKernel` objects that execute
    them; ``graphs`` says whether the compiled function captures each
    entry into a CUDA graph on the card.
    """

    name: str
    build_bucket: Callable[..., Any]
    build_exact: Callable[..., Callable]
    description: str = ""
    cluster_kernels: Mapping[str, ClusterKernel] = field(default_factory=dict)
    graphs: bool = True


def _make_executor_backend(name: str, description: str,
                           cluster_kernels: Optional[
                               Mapping[str, ClusterKernel]] = None,
                           graphs: bool = True) -> Backend:
    """A backend whose bucket entries are padded executors, clusters
    through its registered ``cluster_kernels``, each entry a CUDA graph on
    the card where ``graphs`` is set."""
    kernels = dict(cluster_kernels or {})

    def build_bucket(graph: DGraph, plan, syms: Sequence[SymDim],
                     padded: Dict[int, int], device,
                     arg_shardings: Optional[Sequence[Any]] = None):
        # ``arg_shardings`` (SPMD dispatch): the (lens, *args) layouts
        # the generated host flow gives the entry.  The executor runs on
        # the DTensors it is given: per-op torch through DTensor's
        # operators, each cluster kernel on local shards under the
        # placements its wrapper declares (``kernels/sharded.py``)
        return build_padded_executor(graph, padded, syms, plan=plan,
                                     kernels=kernels, device=device)

    def build_exact(graph: DGraph, plan, device):
        return build_exact_executor(graph, plan=plan, kernels=kernels,
                                    device=device)

    return Backend(name=name, build_bucket=build_bucket,
                   build_exact=build_exact, description=description,
                   cluster_kernels=kernels, graphs=graphs)


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
register_backend("nimble_vm", _make_executor_backend(
    "nimble_vm", "interpreted per-op baseline (Nimble-style VM)",
    graphs=False))
