"""``repro_torch.api`` — the single public entry point to the DISC compiler
for PyTorch (aliased as the top-level ``disc_torch`` module)::

    import disc_torch

    f2 = disc_torch.compile(f, [(disc_torch.Dim("S", max=2048), 64),
                                (64, 32)], backend="hopper")
    lowered  = f2.lower()        # DHLO graph + fusion/placement/buffer plans
    compiled = lowered.compile() # generated dispatcher
    compiled.dispatch_source     # the generated host flow, as text
    compiled.cache_stats()       # O(#buckets) compile contract, observable

Artifacts run on the card (``device="cuda"``, the default) unless the
caller asks for ``device="cpu"``.  ``CompileOptions(pipeline="jit")``
buckets a plain PyTorch function without the DHLO bridge (``None`` specs
pass pytrees through, :class:`TreeSpec` pads their leaves);
:class:`ServeEngine` serves a model on it with continuous batching.  Backends (``eager``, ``hopper``,
``nimble_vm``, or your own via :func:`register_backend`) are selected by name through
``CompileOptions.backend``; ``nimble_vm`` and :class:`NimbleVM` are the
interpreted per-op baseline of the paper's §5.2.  :data:`observe` is the
observability plane (spans, counters, collectors; host time only) and
:mod:`faults` / :class:`FaultSpec` the seeded fault injection, as in the
JAX package's ``disc``.
"""
from ..core.bucketing import BucketPolicy, EXACT, POW2, pow2_bucket  # noqa: F401
from ..core.cache import CompileCache, CacheStats  # noqa: F401
from ..core.primitives import dot_general  # noqa: F401
from ..core.vm import NimbleVM  # noqa: F401
from ..errors import (  # noqa: F401
    CompileError,
    DeadlineExceeded,
    DiscError,
    LaunchError,
    NoDeviceError,
    PoolExhausted,
    RetryPolicy,
)
from ..dist import (  # noqa: F401
    ShardingProfile, get_mesh, get_profile, list_profiles, make_mesh,
    use_mesh,
)
from ..frontends.fx_frontend import ArgSpec, bridge  # noqa: F401
from ..ft import faults  # noqa: F401
from ..ft.faults import FaultInjector, FaultSpec  # noqa: F401
from ..obs import Observe, Tracer, observe  # noqa: F401
from .backends import (  # noqa: F401
    Backend,
    UnknownBackendError,
    get_backend,
    list_backends,
    register_backend,
)
from .options import CompileOptions, Dim, TreeSpec  # noqa: F401
from .staged import Compiled, CompiledFunction, Lowered, compile, infer_specs  # noqa: F401

__all__ = [
    # staged pipeline
    "compile", "CompiledFunction", "Lowered", "Compiled", "infer_specs",
    # options
    "CompileOptions", "Dim", "TreeSpec", "ArgSpec",
    # serving
    "ServeEngine", "ServeConfig",
    # backends
    "Backend", "register_backend", "get_backend", "list_backends",
    "UnknownBackendError",
    # bucketing / caching
    "BucketPolicy", "POW2", "EXACT", "pow2_bucket", "CompileCache",
    "CacheStats",
    # error taxonomy + fault injection (robustness plane)
    "DiscError", "CompileError", "LaunchError", "NoDeviceError",
    "PoolExhausted", "DeadlineExceeded", "RetryPolicy", "faults",
    "FaultSpec", "FaultInjector",
    # SPMD / distribution
    "ShardingProfile", "get_profile", "list_profiles", "make_mesh",
    "use_mesh", "get_mesh",
    # observability plane
    "observe", "Observe", "Tracer",
    # frontend + lax-level primitives, the interpreted baseline
    "bridge", "dot_general", "NimbleVM",
]


def __getattr__(name):
    # the serving engine is built on this package: importing it lazily
    # keeps ``import repro_torch.serve.engine`` free of an import cycle
    if name in ("ServeEngine", "ServeConfig"):
        from ..serve import engine

        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
