"""Worlds of CPU ranks for the port's SPMD tests (``gloo``).

:func:`run_world` starts ``world`` processes on ``127.0.0.1`` (a free
port, a timeout per world so a hang fails instead of eating the suite's
limit), joins them into one ``gloo`` process group, and runs a list of
named cases in each rank, in order.  A case is a function of this module
``case_<name>(ctx) -> dict`` of numpy arrays or plain values; a case
that raises records its traceback and the next case runs.  Returns
``{case: [result of rank 0, rank 1, ...]}``.

The ranks import the port and numpy only: the JAX references are
computed by the calling test, in its own process.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import socket
import time
import traceback
from typing import Any, Dict, List, Sequence

import numpy as np

WORLD_TIMEOUT_S = 150.0


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclasses.dataclass
class Ctx:
    rank: int
    world: int

    def mesh(self, shape, axes):
        from repro_torch.launch.mesh import make_mesh
        return make_mesh(shape, axes, device_type="cpu")


def _to_host(x: Any) -> Any:
    import torch
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().numpy().copy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_main(rank: int, world: int, port: int, cases: Sequence[str],
               out_q) -> None:
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    ctx = Ctx(rank, world)
    results: Dict[str, Any] = {}
    try:
        for name in cases:
            torch.manual_seed(0)
            try:
                results[name] = _to_host(globals()[f"case_{name}"](ctx))
            except Exception:  # noqa: BLE001 — reported to the test
                results[name] = {"error": traceback.format_exc()}
            dist.barrier()
    finally:
        out_q.put((rank, results))
        dist.destroy_process_group()


def run_world(world: int, cases: Sequence[str],
              timeout: float = WORLD_TIMEOUT_S) -> Dict[str, List[Any]]:
    """Run ``cases`` in a ``gloo`` world of ``world`` CPU ranks; returns
    every rank's result per case."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, list(cases), out_q),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    got: Dict[int, Dict[str, Any]] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            try:
                rank, res = out_q.get(timeout=1.0)
                got[rank] = res
                continue
            except queue.Empty:
                pass
            dead = [r for r, p in enumerate(procs)
                    if p.exitcode is not None and r not in got]
            if dead:
                raise RuntimeError(f"rank(s) {dead} of a world of {world} "
                                   f"exited without results")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"a world of {world} ranks did not finish {list(cases)} "
                    f"within {timeout} s")
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    return {name: [got[r].get(name) for r in range(world)]
            for name in cases}


def check(results: Dict[str, List[Any]], name: str) -> List[Any]:
    """The ranks' results of case ``name``, failing the calling test
    with a rank's traceback where the case raised there."""
    per_rank = results[name]
    for r, res in enumerate(per_rank):
        if isinstance(res, dict) and "error" in res and len(res) == 1:
            raise AssertionError(f"case {name!r} raised on rank {r}:\n"
                                 f"{res['error']}")
    return per_rank


# ------------------------------------------------------------- inputs --
def weights(seed: int = 0):
    rng = np.random.RandomState(seed)
    return (rng.randn(16, 32).astype(np.float32),
            rng.randn(32, 8).astype(np.float32))


def xs(seed: int = 1, sizes=(5, 33)):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, 16).astype(np.float32) for b in sizes]


def _fn(w1, w2, x):
    """``jax.nn.relu(x @ w1) @ w2`` (a ``max`` against 0)."""
    import torch
    h = x @ w1
    return torch.where(h > 0, h, 0.0) @ w2


def _specs(**dim_kw):
    import disc_torch
    return [(16, 32), (32, 8), (disc_torch.Dim("B", max=64, **dim_kw), 16)]


def _granule1():
    import disc_torch
    return disc_torch.BucketPolicy(kind="pow2", granule=1)


def _mesh_2d(ctx: Ctx):
    shape = (2, 2) if ctx.world >= 4 else (ctx.world, 1)
    return ctx.mesh(shape, ("data", "model"))


# -------------------------------------------------------------- cases --
def _parity(ctx: Ctx, pipeline: str, backend: str) -> Dict[str, Any]:
    """``_fn`` on two buckets under each profile, both pipelines; the
    reports' collectives beside the outputs."""
    import torch
    import disc_torch

    mesh = _mesh_2d(ctx)
    w1, w2 = (torch.from_numpy(w) for w in weights())
    out: Dict[str, Any] = {}
    for profile in ("dp", "fsdp", "tp"):
        if pipeline == "jit":
            specs = [None, None, (disc_torch.Dim("B", max=64), 16)]
        else:
            specs = _specs()
        fn = disc_torch.compile(_fn, specs=specs,
                                options=disc_torch.CompileOptions(
                                    policy=_granule1(), mesh=mesh,
                                    sharding_profile=profile,
                                    pipeline=pipeline, backend=backend,
                                    device="cpu"))
        for i, x in enumerate(xs()):
            y = fn(w1, w2, torch.from_numpy(x))
            out[f"{profile}/{i}"] = y
        rep = fn.report()["sharding"]
        out[f"{profile}/collectives"] = rep["collectives"]
        out[f"{profile}/compiles"] = fn.compile_counts()
    return out


def case_dhlo_eager(ctx):
    return _parity(ctx, "dhlo", "eager")


def case_dhlo_hopper(ctx):
    return _parity(ctx, "dhlo", "hopper")


def case_jit(ctx):
    return _parity(ctx, "jit", "eager")


# --------------------------------------------------------------- serve --
def tiny_model(**over):
    """The reduced TinyLlama at 2 layers and vocab 128 (as the reference's
    ``_tiny_model``), weights from a seeded generator: the same on every
    rank."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model

    cfg = dataclasses.replace(get_config("tinyllama_11b").reduced(),
                              n_layers=2, vocab=128, **over)
    model = get_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0), "cpu")


def requests(vocab, plens, max_new=3):
    from repro_torch.data.pipeline import Request
    rng = np.random.RandomState(7)
    return [Request(rid=i, tokens=rng.randint(0, vocab, size=pl)
                    .astype(np.int32), max_new_tokens=max_new)
            for i, pl in enumerate(plens)]


def _serve(model, params, reqs, **kw):
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    eng = ServeEngine(model, params, ServeConfig(max_seq=64, device="cpu",
                                                 **kw))
    eng.submit(reqs)
    return eng, eng.run_until_done()


def _done(done):
    return {int(k): [int(t) for t in v] for k, v in done.items()}


def case_serve_dp(ctx):
    """Replicas over a data axis of the world's size (every rank one data
    shard of 2 slots), against the same engine without a mesh."""
    cfg, model, params = tiny_model()
    mesh = ctx.mesh((ctx.world,), ("data",))
    plens = [9, 5, 12, 7]
    _, base = _serve(model, params, requests(cfg.vocab, plens),
                     max_batch=2, replicas=ctx.world)
    eng, done = _serve(model, params, requests(cfg.vocab, plens),
                       max_batch=2, replicas=ctx.world, mesh=mesh,
                       sharding_profile="dp")
    rep = eng._prefill_fn.report()["sharding"]
    leaf = eng.cache["k"]
    return {"base": _done(base), "mesh": _done(done),
            "profile": rep["profile"], "constraints": rep["constraints"],
            "cache_placements": [str(p) for p in leaf.placements],
            "collectives": rep["collectives"]}


def case_serve_tp(ctx):
    """The tp profile on a (data, model) mesh: the cache follows the
    model's cache_specs, the params its specs."""
    cfg, model, params = tiny_model()
    shape = (2, 2) if ctx.world >= 4 else (1, ctx.world)
    mesh = ctx.mesh(shape, ("data", "model"))
    plens = [9, 5, 12]
    _, base = _serve(model, params, requests(cfg.vocab, plens),
                     max_batch=2, replicas=2)
    eng, done = _serve(model, params, requests(cfg.vocab, plens),
                       max_batch=2, replicas=2, mesh=mesh,
                       sharding_profile="tp")
    return {"base": _done(base), "mesh": _done(done),
            "cache_placements": [str(p) for p in eng.cache["k"].placements],
            "wq_placements": [str(p) for p in
                              eng.params["blocks"][0]["attn"]["wq"]
                              .placements]}


def case_serve_custom_profile(ctx):
    """A profile sharding "B" on "model" (no data axis at all): the
    engine's layout and divisibility guard follow its batch axes."""
    import disc_torch
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg, model, params = tiny_model()
    mesh = ctx.mesh((ctx.world,), ("model",))
    prof = disc_torch.get_profile("dp").replace(
        name="mp", dim_axes=(("B", ("model",)),))
    eng = ServeEngine(model, params, ServeConfig(
        max_batch=2, max_seq=64, replicas=ctx.world, mesh=mesh,
        sharding_profile=prof, device="cpu"))
    try:
        ServeEngine(model, params, ServeConfig(
            max_batch=1, max_seq=64, replicas=ctx.world + 1, mesh=mesh,
            sharding_profile=prof, device="cpu"))
        guard = ""
    except ValueError as e:
        guard = str(e)
    return {"dp_axes": list(eng._dp_axes),
            "cache_placements": [str(p) for p in eng.cache["k"].placements],
            "guard": guard}


def _fault_engine_kw(mesh, **kw):
    return dict(max_seq=64, device="cpu", mesh=mesh,
                sharding_profile="dp", **kw)


def _fault_requests(vocab, lens, max_new=5):
    rng = np.random.RandomState(11)
    from repro_torch.data.pipeline import Request
    return [Request(rid=i, tokens=rng.randint(0, vocab, size=ln)
                    .astype(np.int32), max_new_tokens=max_new)
            for i, ln in enumerate(lens)]


def case_faults_transient(ctx):
    """A transient fault at the first launch is retried under the mesh:
    the streams equal the fault-free run's."""
    from repro_torch.ft import faults
    from repro_torch.ft.faults import FaultSpec
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg, model, params = tiny_model()
    mesh = ctx.mesh((ctx.world,), ("data",))
    kw = _fault_engine_kw(mesh, max_batch=2, replicas=1)

    def run():
        eng = ServeEngine(model, params, ServeConfig(**kw))
        eng.submit(_fault_requests(cfg.vocab, [6, 9]))
        return eng, eng.run_until_done(max_steps=400)

    _, base = run()
    with faults.inject(FaultSpec("serve.launch", at=[0], transient=True)):
        eng, done = run()
    return {"base": _done(base), "done": _done(done),
            "retries": eng.stats["retries"], "failed": dict(eng.failed)}


def case_faults_drain(ctx):
    """A replica that misses its heartbeat is drained under the mesh;
    its requests complete on the survivor."""
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg, model, params = tiny_model()
    mesh = ctx.mesh((ctx.world,), ("data",))
    eng = ServeEngine(model, params, ServeConfig(**_fault_engine_kw(
        mesh, max_batch=1, replicas=ctx.world, heartbeat_deadline_s=5.0)))
    t = [1.0]
    eng._clock = lambda: t[0]
    for r in range(ctx.world):
        eng.heartbeat(r)
    eng.submit(_fault_requests(cfg.vocab, [6, 9]))
    for _ in range(2):
        eng.step()
    t[0] = 10.0
    eng.heartbeat(0)
    done = eng.run_until_done(max_steps=400)
    return {"drains": eng.stats["replica_drains"], "failed": dict(eng.failed),
            "done": _done(done)}


# ----------------------------------------------------------- planning --
def case_mesh_shapes(ctx):
    one = ctx.mesh((ctx.world,), ("data",))
    out = {"1d": dict(zip(one.mesh_dim_names, one.shape))}
    if ctx.world >= 4:
        two = ctx.mesh((2, 2), ("data", "model"))
        out["2d"] = dict(zip(two.mesh_dim_names, two.shape))
    return out


def case_maybe_shard(ctx):
    """An overlong spec is truncated with a warning and still shards."""
    import warnings

    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.dist import P, maybe_shard, use_mesh

    mesh = ctx.mesh((ctx.world,), ("data",))
    x = distribute_tensor(torch.ones(ctx.world, 4), mesh, [Replicate()],
                          src_data_rank=None)
    with use_mesh(mesh), warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        y = maybe_shard(x, P("data", None, "model"))
    plain = torch.ones(3, 4)
    with use_mesh(mesh):
        same = maybe_shard(plain, P("data", None)) is plain
    return {"warned": any("truncating" in str(w.message) for w in rec),
            "placements": [str(p) for p in y.placements], "y": y,
            "plain_identity": same,
            "outside_identity": maybe_shard(x, P("data", None)) is x}


def case_padded_sharded(ctx):
    """The generated dispatch lays the padded bucket out on the mesh."""
    import torch
    import disc_torch
    from repro_torch.dist import P

    seen = {}

    def f(x):
        seen["local"] = tuple(x.to_local().shape)
        seen["placements"] = [str(p) for p in x.placements]
        return x * 2.0

    mesh = ctx.mesh((ctx.world,), ("data",))
    fn = disc_torch.compile(f, specs=[(disc_torch.Dim("B", max=64), 4)],
                            options=disc_torch.CompileOptions(
                                pipeline="jit", policy=_granule1(),
                                mesh=mesh, sharding_profile="dp",
                                device="cpu"))
    out = fn(torch.ones(3, 4))
    return {"out": out, "put": "_put0(" in fn.dispatch_source,
            "spec": tuple(fn.lower().sharding_plan.arg_sharding(0).spec)
            == tuple(P("data", None)), **seen}


def case_legacy_backend(ctx):
    """A backend whose build_bucket predates the SPMD contract fails
    loudly at bucket-compile time."""
    import torch
    import disc_torch
    from repro_torch.api.backends import Backend, register_backend

    legacy = Backend(name="legacy",
                     build_bucket=lambda graph, plan, syms, padded, device:
                     None,
                     build_exact=lambda graph, plan, device: None)
    register_backend("legacy-spmd-test", legacy, overwrite=True)
    fn = disc_torch.compile(_fn, specs=_specs(),
                            options=disc_torch.CompileOptions(
                                mesh=_mesh_2d(ctx), sharding_profile="dp",
                                backend="legacy-spmd-test", device="cpu"))
    w1, w2 = (torch.from_numpy(w) for w in weights())
    try:
        fn(w1, w2, torch.from_numpy(xs()[0]))
    except Exception as e:  # noqa: BLE001 — returned to the test
        return {"type": type(e).__name__,
                "is_value_error": isinstance(e, ValueError),
                "msg": str(e)}
    return {"type": None, "msg": ""}


def case_escalation(ctx):
    """B = 7 over the world's ranks escalates to an exact entry, whose
    layout the plan re-fits (7 does not divide: replicated)."""
    import torch
    import disc_torch

    mesh = ctx.mesh((ctx.world,), ("data",))
    w1, w2 = (torch.from_numpy(w) for w in weights())
    x = torch.from_numpy(np.random.RandomState(3).randn(7, 16)
                         .astype(np.float32))
    fn = disc_torch.compile(_fn, specs=_specs(),
                            options=disc_torch.CompileOptions(
                                policy=_granule1(), mesh=mesh,
                                sharding_profile="dp",
                                escalation_threshold=2, device="cpu"))
    outs = [fn(w1, w2, x) for _ in range(3)]
    base = disc_torch.compile(_fn, specs=_specs(),
                              options=disc_torch.CompileOptions(
                                  policy=_granule1(), device="cpu"))
    return {"outs": outs, "base": base(w1, w2, x), "x": x,
            "compiles": fn.compile_counts(),
            "escalations": fn.cache_stats()["escalations"]}


def case_report(ctx):
    import disc_torch

    mesh = _mesh_2d(ctx)
    sh = disc_torch.compile(_fn, specs=_specs(),
                            options=disc_torch.CompileOptions(
                                policy=_granule1(), mesh=mesh,
                                sharding_profile="dp", device="cpu"))
    rep = sh.report()
    return {"sharding": {k: v for k, v in rep["sharding"].items()
                         if k != "collectives"},
            "mesh_constraints": rep["constraints"]["mesh_constraints"],
            "device_target": rep["placement"]["device_target"],
            "dp": int(dict(zip(mesh.mesh_dim_names, mesh.shape))["data"])}


def _count_run(options, calls):
    import torch
    import disc_torch

    w1, w2 = (torch.from_numpy(w) for w in weights())
    fn = disc_torch.compile(_fn, specs=_specs(), options=options)
    rng = np.random.RandomState(5)
    for b in calls:
        fn(w1, w2, torch.from_numpy(rng.randn(b, 16).astype(np.float32)))
    return fn.compile_counts()


def case_compile_counts(ctx):
    import disc_torch

    mesh = _mesh_2d(ctx)
    calls = [3, 5, 17, 33, 40, 33]
    out = {"base": _count_run(disc_torch.CompileOptions(device="cpu"), calls),
           "shard": _count_run(disc_torch.CompileOptions(
               mesh=mesh, sharding_profile="dp", device="cpu"), calls)}
    calls = [3, 5, 9, 33, 40, 33]
    out["g1_base"] = _count_run(disc_torch.CompileOptions(
        policy=_granule1(), device="cpu"), calls)
    out["g1_shard"] = _count_run(disc_torch.CompileOptions(
        policy=_granule1(), mesh=mesh, sharding_profile="dp",
        device="cpu"), calls)
    return out


# ------------------------------------------------- the TinyLlama stack --
def stack_fn(cfg, like):
    """Path 2's token-major TinyLlama stack, x (T, D) -> logits (T, V),
    its weights taken as arguments (flattened ``like``), then x."""
    import torch
    from torch.utils import _pytree
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as Tm

    _, spec = _pytree.tree_flatten(like)

    def fn(*args):
        params = _pytree.tree_unflatten(list(args[:-1]), spec)
        x = args[-1]
        pos = torch.arange(x.shape[0], dtype=torch.int32,
                           device=x.device)[None, :]
        for bp in params["blocks"]:
            h = L.norm_apply(cfg, bp["ln1"], x)
            a, _ = L.attn_apply(cfg, bp["attn"], h[None], positions=pos)
            x = x + a[0]
            x = x + L.mlp_apply(cfg, bp["ffn"],
                                L.norm_apply(cfg, bp["ln2"], x))
        return Tm.logits_from_hidden(cfg, params,
                                     L.norm_apply(cfg, params["ln_f"], x))

    return fn


def case_stack_tp(ctx):
    """The reduced TinyLlama stack on the dhlo pipeline under tp on a
    (data, model) mesh, the weights as arguments, two buckets."""
    import torch
    from torch.utils import _pytree
    import disc_torch
    from repro_torch.models.convert import params_to_numpy

    cfg, model, params = tiny_model()
    ws, _ = _pytree.tree_flatten(params)
    fn = stack_fn(cfg, params)
    specs = [(tuple(w.shape), w.dtype) for w in ws] + \
        [((disc_torch.Dim("T", max=64), cfg.d_model), torch.float32)]
    out = {"params": params_to_numpy(params, cfg)}
    for backend in ("hopper", "eager"):
        f = disc_torch.compile(fn, specs=specs,
                               options=disc_torch.CompileOptions(
                                   mesh=_mesh_2d(ctx), sharding_profile="tp",
                                   backend=backend, device="cpu"))
        for t in (5, 37):
            x = torch.from_numpy(np.random.RandomState(t).randn(
                t, cfg.d_model).astype(np.float32))
            out[f"{backend}/{t}"] = f(*ws, x)
        out[f"{backend}/collectives"] = \
            f.report()["sharding"]["collectives"]
    return out


# ----------------------------------------------------------------- MoE --
def moe_layer(seed: int = 0):
    """DBRX's reduced MoE layer (one layer's params) and its config."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    cfg = get_config("dbrx_132b").reduced()
    p = L.moe_init(torch.Generator().manual_seed(seed), cfg, "cpu")
    return cfg, p


def case_moe_ep(ctx):
    """moe_apply under a (data, model) mesh takes the expert-parallel
    branch: x data-sharded, experts split over "model"."""
    import torch
    from repro_torch.dist import spmd_scope
    from repro_torch.dist.spmd import shard_tensor
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.models import layers as L

    cfg, p = moe_layer()
    mesh = _mesh_2d(ctx)
    x = torch.from_numpy(np.random.RandomState(4).randn(
        4, 8, cfg.d_model).astype(np.float32))
    xd = shard_tensor(x, mesh, (Shard(0), Replicate()))
    with spmd_scope(mesh):
        y = L.moe_apply(cfg, p, xd)
        y_plain = L.moe_apply(cfg, p, x)
    # bucket invariance: the same rows padded to a longer bucket, lens
    # marking the valid tokens, give the same valid rows
    lens = torch.tensor([8, 5, 3, 8], dtype=torch.int32)
    xp = torch.zeros(4, 16, cfg.d_model)
    xp[:, :8] = x
    for r, n in enumerate(lens.tolist()):
        xp[r, n:] = 0.0
    xs8 = x.clone()
    for r, n in enumerate(lens.tolist()):
        xs8[r, n:] = 0.0
    with spmd_scope(mesh):
        a = L.moe_apply(cfg, p, shard_tensor(xs8, mesh,
                                             (Shard(0), Replicate())),
                        lens=lens)
        b = L.moe_apply(cfg, p, shard_tensor(xp, mesh,
                                             (Shard(0), Replicate())),
                        lens=lens)
    return {"x": x, "y": y, "y_plain": y_plain, "a": a, "b": b,
            "lens": lens, "placements": [str(q) for q in y.placements],
            "p": p}


# ---------------------------------------------------------- checkpoint --
def _ckpt_dir():
    return os.environ["DISC_TORCH_DIST_CKPT"]


def case_ckpt_save(ctx):
    """A tp-laid-out parameter tree saved from this world."""
    from repro_torch.checkpoint.checkpoint import save_checkpoint
    from repro_torch.dist.spmd import fit_spec, placements_for, shard_tensor
    from repro_torch.models.convert import params_to_numpy
    from torch.utils import _pytree

    cfg, model, params = tiny_model()
    mesh = _mesh_2d(ctx)

    def put(x, spec):
        spec = fit_spec(tuple(x.shape), spec, mesh)
        return shard_tensor(x, mesh, placements_for(spec, mesh))

    sharded = _pytree.tree_map(put, params, model.specs())
    save_checkpoint(_ckpt_dir(), 7, sharded, journal={"world": ctx.world})
    return {"params": params_to_numpy(params, cfg)}


def case_ckpt_restore(ctx):
    """The same tree restored on this world's mesh, laid out by dp-style
    shardings (rows over "data")."""
    import torch
    from repro_torch.checkpoint.checkpoint import restore_checkpoint
    from repro_torch.dist import NamedSharding, P
    from repro_torch.models.convert import params_to_numpy
    from torch.utils import _pytree

    cfg, model, params = tiny_model()
    like = _pytree.tree_map(torch.zeros_like, params)
    mesh = ctx.mesh((ctx.world,), ("data",))
    shardings = _pytree.tree_map(
        lambda x: NamedSharding(mesh, P(*(("data",) + (None,) * (x.dim() - 1)))),
        like)
    state, journal = restore_checkpoint(_ckpt_dir(), like,
                                        shardings=shardings)
    placements = sorted({str(tuple(x.placements))
                         for x in _pytree.tree_leaves(state)})
    whole = _pytree.tree_map(lambda x: x.full_tensor(), state)
    return {"params": params_to_numpy(whole, cfg), "journal": journal,
            "placements": placements}


def case_stack_tokens(ctx):
    """The reduced TinyLlama stack with its tokens ("T") sharded over
    "data", the weights replicated, on both backends."""
    import torch
    from torch.utils import _pytree
    import disc_torch

    cfg, model, params = tiny_model()
    ws, _ = _pytree.tree_flatten(params)
    fn = stack_fn(cfg, params)
    prof = disc_torch.get_profile("dp").replace(
        name="tokens", dim_axes=(("T", ("data",)),))
    specs = [(tuple(w.shape), w.dtype) for w in ws] + \
        [((disc_torch.Dim("T", max=64), cfg.d_model), torch.float32)]
    out = {}
    for backend in ("hopper", "eager"):
        f = disc_torch.compile(fn, specs=specs,
                               options=disc_torch.CompileOptions(
                                   mesh=_mesh_2d(ctx), sharding_profile=prof,
                                   backend=backend, device="cpu"))
        for t in (5, 37):
            x = torch.from_numpy(np.random.RandomState(t).randn(
                t, cfg.d_model).astype(np.float32))
            out[f"{backend}/{t}"] = f(*ws, x)
        out[f"{backend}/collectives"] = \
            f.report()["sharding"]["collectives"]
    return out


# ------------------------------------------------ kernels on local shards --
def case_kernels_local(ctx):
    """Each wrapper given DTensors on a (data, model) mesh, against its
    plain version on the whole tensors: kLoop, kInput over a sharded and
    an unsharded axis (sum and a masked max), kDot with M and N sharded
    and with K sharded (a Partial), flash attention with batch and heads
    sharded (KV heads dividing and not: GQA groups intact) and per-row
    lens / q_offset, RMSNorm and the masked softmax on sharded rows.
    Returns max|d| per case."""
    import torch
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.dist.spmd import shard_tensor
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import sdpa_ref
    from repro_torch.kernels.fused_elementwise.ops import fused_elementwise
    from repro_torch.kernels.fused_elementwise.ref import \
        fused_elementwise_ref
    from repro_torch.kernels.fused_reduce.ops import fused_reduce
    from repro_torch.kernels.fused_reduce.ref import fused_reduce_ref
    from repro_torch.kernels.matmul.ops import matmul_fused
    from repro_torch.kernels.matmul.ref import matmul_fused_ref
    from repro_torch.kernels.program import Program, Step
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.softmax.ops import masked_softmax
    from repro_torch.kernels.softmax.ref import masked_softmax_ref

    mesh = _mesh_2d(ctx)
    g = torch.Generator().manual_seed(3)
    f32 = torch.float32
    R = Replicate()

    def rnd(*shape):
        return torch.randn(shape, generator=g)

    def put(x, *place):
        return shard_tensor(x, mesh, tuple(place))

    def whole(y):
        return y.full_tensor() if hasattr(y, "full_tensor") else y

    out = {}
    mul = Program((f32, f32), (Step("mul", (("in", 0), ("in", 1)), f32),),
                  (("t", 0),))
    ident = Program((f32,), (), (("in", 0),))
    x, y = rnd(8, 16), rnd(8, 16)
    got = fused_elementwise(mul, [put(x, Shard(0), Shard(1)), y], 128,
                            (8, 16))[0]
    out["kloop"] = (whole(got) - fused_elementwise_ref(
        mul, [x, y], 128, (8, 16))[0]).abs().max().item()
    n = torch.tensor([11], dtype=torch.int32)
    for kind in ("sum", "max"):
        for axis, place in ((1, (Shard(0), Shard(1))), (1, (Shard(1), R)),
                            (0, (Shard(0), R))):
            got = fused_reduce(ident, [put(x, *place)], n, kind, axis=axis,
                               shape=(8, 16), out_dtype=f32)
            want = fused_reduce_ref(ident, [x], min(11, x.shape[axis]),
                                    kind, axis, (8, 16), f32)
            out[f"kinput {kind} axis {axis} {place}"] = \
                (whole(got) - want).abs().max().item()
    a, b, res = rnd(16, 32), rnd(32, 8), rnd(16, 8)
    valid = torch.tensor([13, 8, 29], dtype=torch.int32)
    add = Program((f32, f32), (Step("add", (("in", 0), ("in", 1)), f32),),
                  (("t", 0),))
    want = matmul_fused_ref(a, b, [res], add, (13, 8, 29), (f32,))[0]
    got = matmul_fused(put(a, Shard(0), R), put(b, R, Shard(1)), [res], add,
                       valid_mnk=valid, out_dtypes=(f32,))[0]
    out["kdot M, N"] = (whole(got) - want).abs().max().item()
    want = matmul_fused_ref(a, b, [], ident, (13, 8, 29), (f32,))[0]
    got = matmul_fused(put(a, Shard(0), Shard(1)), put(b, R, Shard(0)), [],
                       ident, valid_mnk=valid, out_dtypes=(f32,))[0]
    out["kdot K partial"] = (whole(got) - want).abs().max().item()
    out["kdot K partial placements"] = [str(p) for p in got.placements]
    # attention: q (B, H, S, D), k / v (B, Hkv, S, D)
    for hkv in (2, 4):
        q, k, v = rnd(2, 8, 12, 16), rnd(2, hkv, 12, 16), rnd(2, hkv, 12, 16)
        lens = torch.tensor([12, 7], dtype=torch.int32)
        qo = torch.tensor([0, 3], dtype=torch.int32)
        want = sdpa_ref(q, k, v, causal=True, lens=lens, q_offset=qo)
        # 4 ranks over the heads (GQA: 8 query heads, 2 or 4 KV heads)
        mesh4 = ctx.mesh((ctx.world,), ("model",))
        got = fa.flash_attention(
            shard_tensor(q, mesh4, (Shard(1),)), k, v, lens, causal=True,
            q_offset=qo)
        out[f"flash heads hkv={hkv}"] = (whole(got) - want).abs().max().item()
        # batch over "data", heads over "model"
        got = fa.flash_attention(put(q, Shard(0), Shard(1)),
                                 put(k, Shard(0), R), put(v, Shard(0), R),
                                 lens, causal=True, q_offset=qo)
        out[f"flash batch+heads hkv={hkv}"] = \
            (whole(got) - want).abs().max().item()
    h, w = rnd(8, 4, 32), rnd(32)
    got = rmsnorm(put(h, Shard(0), Shard(1)), w)
    out["rmsnorm"] = (whole(got) - rmsnorm_ref(h, w, 1e-6)).abs().max().item()
    got = masked_softmax(put(h, Shard(0), Shard(2)), 20)
    out["softmax"] = (whole(got) - masked_softmax_ref(
        h.reshape(-1, 32), 20).reshape(h.shape)).abs().max().item()
    return out
