"""Multi-pod dry run: trace every (architecture x input-shape x mesh) cell
on the production mesh and write its roofline terms and memory, the
counterpart of the JAX package's ``launch/dryrun.py``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama_11b \\
        --cell train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Results land in ``reports/dryrun_torch/<mesh>/<arch>__<cell>.json`` plus
stdout (the reference writes ``reports/dryrun/``).

The reference lowers and compiles each cell with XLA on 512 forced host
devices and reads the compiled HLO.  The port has no such compiler: it
*traces* each cell's per-rank program on the host's CPU and walks the
trace.

* The mesh is the production mesh (16x16 or 2x16x16) of CPU ranks on a
  ``fake`` process group of 256 or 512 ranks that this module starts for
  the run and ends after it (:func:`fake_group`): collectives are
  recorded, never run.
* The params, optimizer state, cache and batch are fake tensors (no
  memory behind them), laid out as DTensors per the model's ``specs()``
  / ``cache_specs()`` through ``dist/spmd.py`` ``fit_spec``, the batch on
  ``("pod", "data")``; the traced function takes each rank's local
  shards, wraps them (``DTensor.from_local``, no collective) and returns
  local shards, so the graph is rank 0's program: its ATen ops on local
  shards and the ``_c10d_functional`` collectives between them.
* A train cell traces ``make_train_step`` (loss, gradients, AdamW), a
  prefill cell ``model.forward``, a decode cell ``model.decode_step``
  (whisper's with ``enc_out``); an ``fsdp`` config is switched to ``tp``
  for inference cells, as in the reference.  Tracing runs inside
  ``plain_versions()``: each kernel wrapper records its plain version, as
  the DHLO bridge's trace does, and nothing launches.
* A stack of identical layers is traced at two depths and its walk
  extended to the config's depth (:func:`depth_plan`), the port's form
  of the reference's walk multiplying its layer scan by the trip count.
  RWKV-6's plain WKV is one traced op (and its backward one more) at any
  length, whose walk is its step loop's extended over the steps
  (``roofline/cost.py``).
* A train cell's step rematerialises per the config's ``remat``, as the
  reference's does (``models/common.py`` ``maybe_remat``): under
  ``"full"`` the trace holds each checkpointed block's recompute in the
  backward, and the liveness walk frees the block's activations after
  its forward.  A ``"dots"`` step traces as ``"none"``: under a trace,
  torch's selective checkpointing keeps every output (tagged for a
  compiler's partitioner) and recomputes none.  No config says
  ``"dots"``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import traceback
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils import _pytree

from ..configs import ARCH_IDS, get_config
from ..dist.profiles import PartitionSpec as P
from ..dist.profiles import is_spec
from ..models.registry import get_model
from ..obs.clock import CLOCK as _clock
from ..roofline.analysis import analyze_traced, liveness
from ..roofline.cost import Cost, analyze_graph
from .shapes import SHAPE_CELLS, ShapeCell, cells_for_arch, input_specs

__all__ = ["REPORT_DIR", "fake_group", "trace_cell", "depth_plan", "lower",
           "lower_cell", "main"]

REPORT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "reports"
              / "dryrun_torch")

def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


@contextlib.contextmanager
def fake_group(world_size: int) -> Iterator[None]:
    """A ``fake`` default process group of ``world_size`` ranks in this
    process (rank 0) for the block: it lays out and records collectives
    and runs none.  Raises if a group is already initialized."""
    import torch.distributed as dist
    # importing it registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError(
            f"the dry run starts its own fake process group of "
            f"{world_size} ranks, but a {dist.get_backend()!r} group is "
            f"already initialized in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _model_flops(cfg, cell) -> float:
    """MODEL_FLOPS = 6·N_active·D (train: fwd+bwd; inference: 2·N·D a
    token), the reference's."""
    n_act = cfg.n_active_params()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n_act * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_act * tokens
    return 2.0 * n_act * cell.global_batch  # decode: 1 token per row


# --------------------------------------------------------------- layout --
class _Layout:
    """Flat leaves of the traced function's arguments: each leaf's global
    fake tensor and its DTensor placements (None: a plain tensor, no
    mesh)."""

    def __init__(self, mesh) -> None:
        self.mesh = mesh
        self.leaves: List[torch.Tensor] = []
        self.placements: List[Optional[tuple]] = []

    def add(self, tree, spec_tree) -> Any:
        """Register ``tree``'s leaves under ``spec_tree`` (congruent, or a
        single spec for every leaf); returns the tree's spec (pytree)."""
        from ..dist.spmd import fit_spec, placements_for

        leaves, tdef = _pytree.tree_flatten(tree)
        if is_spec(spec_tree):
            specs = [spec_tree] * len(leaves)
        else:
            specs = _pytree.tree_flatten(spec_tree, is_leaf=is_spec)[0]
        if len(specs) != len(leaves):
            raise ValueError(f"spec tree has {len(specs)} leaves against "
                             f"the value tree's {len(leaves)}")
        for x, s in zip(leaves, specs):
            self.leaves.append(x)
            if self.mesh is None:
                self.placements.append(None)
            else:
                shape = tuple(x.shape)
                self.placements.append(placements_for(
                    fit_spec(shape, s, self.mesh), self.mesh, shape))
        return tdef

    def local(self, i: int, mode) -> torch.Tensor:
        """Leaf ``i``'s local shard on rank 0, a fake tensor of ``mode``."""
        x, pl = self.leaves[i], self.placements[i]
        shape = list(x.shape)
        if pl is not None:
            from torch.distributed.tensor import Shard
            for j, p in enumerate(pl):
                if isinstance(p, Shard):
                    shape[p.dim] //= self.mesh.size(j)
        with mode:
            return torch.empty(shape, dtype=x.dtype)

    def wrap(self, locals_: List[torch.Tensor]) -> List[torch.Tensor]:
        """The traced function's inputs as DTensors (no collective)."""
        if self.mesh is None:
            return list(locals_)
        from torch.distributed.tensor import DTensor
        return [DTensor.from_local(t, self.mesh, pl, run_check=False,
                                   shape=g.shape, stride=g.stride())
                for t, pl, g in zip(locals_, self.placements, self.leaves)]


@contextlib.contextmanager
def _strided_sizes_on_host() -> Iterator[None]:
    """DTensor computes a ``_StridedShard``'s local size (the layout a
    reshape of a dim sharded over two mesh axes takes) from a small index
    tensor it reads back with ``.tolist()``; under the trace's fake mode
    that tensor has no data (``aten._local_scalar_dense`` raises).  For
    the block, that helper runs with the dispatch modes off, on a real
    host tensor of a few elements."""
    from torch.distributed.tensor import placement_types as pt
    from torch.utils._python_dispatch import _disable_current_modes

    cls = getattr(pt, "_StridedShard", None)
    orig = getattr(cls, "local_shard_size_and_offset", None)
    if orig is None:
        yield
        return

    def on_host(*args, **kwargs):
        with _disable_current_modes():
            return orig(*args, **kwargs)

    cls.local_shard_size_and_offset = on_host
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = orig


def _batch_spec(name: str, ndim: int) -> P:
    dp = ("pod", "data")
    return P(dp) if name == "lens" else P(*((dp,) + (None,) * (ndim - 1)))


def _fake_params(model, mode):
    with mode:
        return model.init(torch.Generator().manual_seed(0), "cpu")


def _to_local(out) -> List[torch.Tensor]:
    from torch.distributed.tensor import DTensor
    return [o.to_local() if isinstance(o, DTensor) else o
            for o in _pytree.tree_leaves(out)
            if isinstance(o, torch.Tensor)]


def trace_cell(cfg, cell: ShapeCell, mesh, *, microbatches: int = 1):
    """Trace one cell's per-rank program: ``(gm, cfg)``, ``gm`` an ATen
    FX graph of rank 0's local ops and collectives, ``cfg`` the config
    traced (an ``fsdp`` one switched to ``tp`` for inference).  ``mesh``
    None traces the one-rank program on plain fake tensors (no DTensor).
    Touches no device, allocates no weight."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    from ..dist.context import spmd_scope
    from ..kernels.select import plain_as_kernels, plain_versions
    from ..optim.adamw import OptState
    from ..train.step import TrainConfig, TrainState, make_train_step

    if cell.kind != "train" and cfg.sharding_profile == "fsdp":
        # ZeRO-3 is a training layout: serving it would all-gather every
        # weight per token, so inference cells run TP (as the reference)
        cfg = dataclasses.replace(cfg, sharding_profile="tp")
    model = get_model(cfg)
    mode = FakeTensorMode()
    lay = _Layout(mesh)
    pspecs = model.specs()
    params = _fake_params(model, mode)
    batch = input_specs(cfg, cell, mode)
    if cell.kind == "train":
        tcfg = TrainConfig(microbatches=microbatches)
        with mode:
            f32 = lambda p: torch.empty(p.shape, dtype=torch.float32)  # noqa
            step = torch.empty((), dtype=torch.int32)
            mu = _pytree.tree_map(f32, params)
            nu = _pytree.tree_map(f32, params)
        parts = [(params, pspecs), (step, P()), (mu, pspecs), (nu, pspecs)]
        train_step = make_train_step(model, tcfg)

        def run(params, step, mu, nu, batch):
            state = TrainState(params=params,
                               opt=OptState(step=step, mu=mu, nu=nu),
                               residual=())
            return train_step(state, batch)
    elif cell.kind == "prefill":
        parts = [(params, pspecs)]

        def run(params, batch):
            return model.forward(params, batch)
    else:
        with mode:
            cache = model.init_cache(cell.global_batch, cell.seq_len, "cpu")
        parts = [(params, pspecs), (cache, model.cache_specs())]

        def run(params, cache, batch):
            kw = {}
            if "enc_out" in batch:
                kw["enc_out"] = batch["enc_out"]
            return model.decode_step(params, cache, batch["tokens"],
                                     batch["lens"], **kw)
    tdefs = [lay.add(tree, spec) for tree, spec in parts]
    bkeys = list(batch)
    for k in bkeys:
        lay.add(batch[k], _batch_spec(k, batch[k].dim()))
    sizes = [_pytree.tree_flatten(tree)[0] for tree, _ in parts]
    locals_ = [lay.local(i, mode) for i in range(len(lay.leaves))]

    def per_rank(*flat):
        xs = lay.wrap(list(flat))
        args, at = [], 0
        for tdef, leaves in zip(tdefs, sizes):
            args.append(_pytree.tree_unflatten(xs[at:at + len(leaves)],
                                               tdef))
            at += len(leaves)
        b = dict(zip(bkeys, xs[at:]))
        with spmd_scope(mesh), plain_versions(), plain_as_kernels():
            out = run(*args, b)
        return _to_local(out)

    with _strided_sizes_on_host():
        gm = make_fx(per_rank, tracing_mode="fake")(*locals_)
    return gm, cfg


def _compute_dtype(cfg) -> str:
    return "bf16" if cfg.dtype == "bf16" else "f32"


def depth_plan(cfg) -> List[Tuple[int, float]]:
    """``[(n_layers, weight)]``: the depths a cell is traced at and the
    weights whose weighted sum of their walks is the walk of the config's
    full depth.

    The reference's model is a ``scan`` over its stacked layers, so its
    walk multiplies the layer body by the trip count.  The port unrolls
    its layers, and a trace grows with the depth (S = 32768 attention is
    some 50 000 traced ops a layer), so a stack of identical layers is
    traced at depth 2 and 3, and the difference, one layer, is counted
    ``n_layers - 2`` times: ``(3 - L)·walk(2) + (L - 2)·walk(3)``.  (Not
    at depth 1: the first layer takes the embedding's layout, and
    DTensor may lay the head out otherwise behind it than behind a later
    layer; torch 2.11 gathers the logits there.)  Zamba2's stack repeats
    in groups of ``shared_attn_every`` Mamba layers and one shared
    attention block, the remainder going to the last group, so it is
    traced at ``k``, ``2k`` and ``k + 1`` layers (one group, two groups,
    one group with a layer more).  Whisper (an encoder and a decoder
    stack) and shorter stacks are traced whole."""
    n = cfg.n_layers
    if cfg.family == "hybrid":
        k = max(cfg.shared_attn_every, 1)
        if n <= 2 * k:
            return [(n, 1.0)]
        groups, rest = divmod(n, k)
        plan = [(k, float(1 - (groups - 1) - rest)),
                (2 * k, float(groups - 1))]
        if rest:
            plan.append((k + 1, float(rest)))
        return plan
    if cfg.family == "encdec" or n <= 3:
        return [(n, 1.0)]
    return [(2, float(3 - n)), (3, float(n - 2))]


def lower(cfg, cell: ShapeCell, mesh, *, arch: Optional[str] = None,
          mesh_name: Optional[str] = None, microbatches: int = 1,
          verbose: bool = False) -> Dict[str, Any]:
    """Trace one cell on ``mesh`` (None: one rank, no DTensor) at the
    depths of :func:`depth_plan` and return its result dict (see
    :func:`lower_cell`)."""
    chips = 1 if mesh is None else int(math.prod(mesh.shape))
    mesh_name = mesh_name or ("1" if mesh is None else
                              "x".join(str(s) for s in mesh.shape))
    arch = arch or cfg.name
    cost, mem = Cost(), {"argument": 0.0, "output": 0.0, "temp": 0.0}
    t_lower = t_walk = 0.0
    loops = 0
    plan = [(depth, cell.seq_len, w) for depth, w in depth_plan(cfg)]
    if mesh is not None:
        # torch 2.11's DTensor lays a program out otherwise the first
        # time it meets its ops' layouts at given shapes in a process
        # (TinyLlama's train_4k: the logits gathered, 47x the GEMM output
        # bytes of a later trace); one uncounted trace at the cell's
        # shapes first, so every counted trace is a steady one
        t0 = _clock()
        for seq in sorted({s for _, s, _ in plan}):
            trace_cell(dataclasses.replace(cfg, n_layers=1),
                       dataclasses.replace(cell, seq_len=seq), mesh,
                       microbatches=microbatches)
        t_lower += _clock() - t0
    for depth, seq, weight in plan:
        t0 = _clock()
        gm, run_cfg = trace_cell(dataclasses.replace(cfg, n_layers=depth),
                              dataclasses.replace(cell, seq_len=seq), mesh,
                              microbatches=microbatches)
        t1 = _clock()
        c = analyze_graph(gm)
        m = liveness(gm)
        del gm
        t_walk += _clock() - t1
        t_lower += t1 - t0
        loops = max(loops, c.while_loops)
        cost += c.scaled(weight)
        for k in mem:
            mem[k] += weight * m[k]
    cost.while_loops = loops
    if min(cost.flops, cost.bytes, cost.coll_bytes, *mem.values()) < 0:
        raise RuntimeError(
            f"the walks of the traced {[t[:2] for t in plan]} do not "
            f"extend to the full cell (flops {cost.flops:.3e}, bytes "
            f"{cost.bytes:.3e}, memory {mem}): a traced depth or length "
            f"is not a steady one")
    mem = {k: int(round(v)) for k, v in mem.items()}
    terms = analyze_traced(None, arch=arch, cell=cell.name,
                           mesh_name=mesh_name, chips=chips,
                           model_flops=_model_flops(
                               dataclasses.replace(run_cfg,
                                                   n_layers=cfg.n_layers),
                               cell),
                           compute_dtype=_compute_dtype(cfg), cost=cost,
                           memory=mem)
    result = terms.as_dict()
    result.update({
        "lower_seconds": round(t_lower, 2),
        "compile_seconds": round(t_walk, 2),
        "memory_analysis": {
            "argument_size_bytes": mem["argument"],
            "output_size_bytes": mem["output"],
            "temp_size_bytes": mem["temp"],
            "generated_code_size_bytes": None,
        },
        "status": "ok",
        "compute_dtype": terms.compute_dtype,
        "while_loops": cost.while_loops,
        "traced": [list(t) for t in plan],
    })
    if verbose:
        print(f"[dryrun] {arch} x {cell.name} on {mesh_name}: "
              f"trace={t_lower:.1f}s walk={t_walk:.1f}s "
              f"traced={[(d, s) for d, s, _ in plan]} "
              f"flops={terms.hlo_flops:.3e} bytes={terms.hlo_bytes:.3e} "
              f"coll={terms.coll_bytes:.3e} dominant={terms.dominant} "
              f"roofline_frac={terms.roofline_fraction:.3f}", flush=True)
        print(f"  memory_analysis: {result['memory_analysis']}", flush=True)
    return result


def lower_cell(arch_id: str, cell_name: str, *, multi_pod: bool,
               verbose: bool = True, microbatches: int = 1) -> Dict[str, Any]:
    """One cell on the production mesh (16x16, or 2x16x16 with
    ``multi_pod``), on a fake process group this call starts and ends.

    The result dict has the reference's keys, each counting in the port:

    * the :class:`~repro_torch.roofline.analysis.RooflineTerms` keys:
      ``hlo_flops`` / ``hlo_bytes`` / ``coll_bytes`` are the traced
      per-rank graph's walk times the chip count, ``coll_breakdown`` the
      collectives' operand bytes by the reference's HLO kind (and their
      per-rank ``count``), the terms on the H100's rates;
    * ``lower_seconds``: the trace; ``compile_seconds``: the walks (cost
      and liveness), since nothing is compiled;
    * ``memory_analysis``: ``argument_size_bytes`` the rank's local shards
      of the arguments, ``output_size_bytes`` its returned values,
      ``temp_size_bytes`` the peak of live intermediates in execution
      order; ``generated_code_size_bytes`` None (nothing is generated);
    * ``status``: ``"ok"``.

    Three keys are the port's own: ``compute_dtype`` (the peak the
    compute term divides by), ``while_loops`` (``while_loop`` bodies
    counted once; 0 in every cell of :func:`~.shapes.all_cells`) and
    ``traced`` (``[n_layers, seq_len, weight]`` of every counted trace,
    from :func:`depth_plan`: every count above, the memory included, is
    that weighted sum of the traces' walks)."""
    from .mesh import make_production_mesh

    cfg = get_config(arch_id)
    cell = SHAPE_CELLS[cell_name]
    shape_size = 512 if multi_pod else 256
    with fake_group(shape_size):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        return lower(cfg, cell, mesh, arch=arch_id,
                     mesh_name=_mesh_name(multi_pod),
                     microbatches=microbatches, verbose=verbose)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--cell", choices=list(SHAPE_CELLS))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    args = ap.parse_args(argv)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        cells = [(a, c) for a in ARCH_IDS for c in cells_for_arch(a)]
    else:
        if not (args.arch and args.cell):
            ap.error("--arch/--cell or --all")
        cells = [(args.arch, args.cell)]

    failures: List[Tuple[str, str, str, str]] = []
    for multi_pod in meshes:
        mesh_name = _mesh_name(multi_pod)
        outdir = REPORT_DIR / mesh_name
        outdir.mkdir(parents=True, exist_ok=True)
        for arch_id, cell_name in cells:
            out_path = outdir / f"{arch_id}__{cell_name}.json"
            try:
                result = lower_cell(arch_id, cell_name, multi_pod=multi_pod,
                                    microbatches=args.microbatches)
            except Exception as e:  # a failure here is a bug in the system
                traceback.print_exc()
                result = {"arch": arch_id, "cell": cell_name,
                          "mesh": mesh_name, "status": "FAIL",
                          "error": repr(e)}
                failures.append((mesh_name, arch_id, cell_name, repr(e)))
            out_path.write_text(json.dumps(result, indent=2))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nAll dry-run cells traced successfully.")


if __name__ == "__main__":
    main()
