"""``disc_torch`` — the public name of the DISC compiler for PyTorch.

A thin alias for :mod:`repro_torch.api`; see that module for the full
surface.

    import disc_torch
    fast = disc_torch.compile(fn, [(disc_torch.Dim("S", max=2048), 64),
                                   (64, 32)], backend="hopper")
"""
import repro_torch.api as _api
from repro_torch.api import (  # noqa: F401
    ArgSpec,
    Backend,
    BucketPolicy,
    CacheStats,
    Compiled,
    CompiledFunction,
    CompileCache,
    CompileError,
    CompileOptions,
    DeadlineExceeded,
    Dim,
    DiscError,
    EXACT,
    FaultInjector,
    FaultSpec,
    LaunchError,
    Lowered,
    NimbleVM,
    NoDeviceError,
    Observe,
    POW2,
    PoolExhausted,
    RetryPolicy,
    ServeConfig,
    ServeEngine,
    ShardingProfile,
    Tracer,
    TreeSpec,
    UnknownBackendError,
    bridge,
    compile,
    dot_general,
    faults,
    get_backend,
    get_mesh,
    get_profile,
    infer_specs,
    list_backends,
    list_profiles,
    make_mesh,
    observe,
    pow2_bucket,
    register_backend,
    use_mesh,
)

__all__ = list(_api.__all__)
