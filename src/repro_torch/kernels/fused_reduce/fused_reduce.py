"""Fused reduce kernel for Hopper — DISC §4.3 kInput codegen.

Replaces the JAX package's ``kernels/fused_reduce/fused_reduce.py``
``fused_reduce_kernel`` (a Pallas TPU kernel): elementwise producers
recomputed inside a masked single-axis ``sum``/``max``/``min``/``prod``.

* What bounds it on an H100: bytes (a few flops per element read).  The
  design reads each operand byte once in 16-byte accesses, keeps enough
  loads in flight, and spreads the work over the 132 SMs.
* Layout (:func:`cluster_plan.reduce_plan`), without moving any operand
  in memory:

  - **rows × columns** (``"cols"``) where every operand is contiguous or
    broadcast along the reduced axis (a last-axis reduce): a tile of
    ``BR`` rows streams its columns in chunks of ``BC``, ``U`` chunks'
    loads issued before the first is combined, a per-row operand loaded
    once a row, a per-column one once a chunk;
  - **lanes** (``"lanes"``) where the reduced axis is strided but the
    kept innermost axis is contiguous: the lanes of a tile run along that
    kept axis (coalesced) and each accumulates down ``BK`` reduced
    indices at a time.

* Few tiles (a reduce to a few rows, down to one row of millions): the
  reduced axis is split over ``n_split`` programs a tile, each writing
  its partial to an f32 workspace; the program that takes the tile's
  last ticket (an integer atomic) combines the partials in a fixed order
  (16 splits' loads at a time, each group reduced as a tree, the groups
  in split order) and sets the ticket back to 0, so the tickets need no
  clearing launch.
  No float atomics, so the same inputs give the same bits every run.
* ``n_cols`` is the *valid* column count, read by the program from an
  ``int32`` in device memory and clamped there to ``[0, n_red]``: only
  that far is read, and a tile's last, partial chunk is the only masked
  one.  The plan comes from the padded shape, so one launch
  configuration serves every count, and a CUDA graph that captured the
  launch replays it at the count the tensor holds then.
  In the aligned class (a compile-time constant) offsets carry
  ``tl.multiple_of``, so Triton proves 16-byte loads though every size
  and stride is a runtime argument in ``do_not_specialize``.  Each
  kind keeps its identity (``n_cols = 0`` gives it); accumulation is
  f32 and the result is stored in the reduce's dtype.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple

import torch

from ..cluster_plan import ReducePlan, layouts, reduce_plan
from ..lengths import device_ints
from ..program import Program, triton_dtype, triton_lines
from ..triton_build import CLUSTER_OPTIONS, load_kernel, term_source
from .ops import UNALIGNED_LAUNCHES

__all__ = ["fused_reduce_kernel", "launch", "module_name", "INSTANCES"]

#: program key -> the (module, tile, warps, alignment class, operands'
#: 16-byte bases) instances it launched: Triton, which specialises on
#: nothing else (every length is in ``do_not_specialize``), builds at most
#: one kernel for each
INSTANCES: Dict[str, Set[Tuple]] = {}

_HEADER = '''import triton
import triton.language as tl
try:
    from triton.language.extra import libdevice
except ImportError:  # Triton < 3.0
    from triton.language.extra.cuda import libdevice


@triton.jit
def _mul(a, b):
    return a * b
'''

#: partials a combining program loads at once
SPLITS_AT_ONCE = 16

_IDENTITY = {"sum": "0.0", "max": "float('-inf')", "min": "float('inf')",
             "prod": "1.0"}
_COMBINE = {"sum": "{0} + {1}", "max": "tl.maximum({0}, {1})",
            "min": "tl.minimum({0}, {1})", "prod": "{0} * {1}"}
_FINISH = {"sum": "tl.sum({0}, axis={1})", "max": "tl.max({0}, axis={1})",
           "min": "tl.min({0}, axis={1})",
           "prod": "tl.reduce({0}, {1}, _mul)"}


def _varies(plan: ReducePlan, op) -> bool:
    """Whether an operand changes along the reduced axis; one that does
    not is loaded once, before the chunk loop."""
    return op.col != "zero" if plan.mode == "cols" else bool(op.red_stride)


def _load_chunk(plan: ReducePlan, u: int, mask: str) -> List[str]:
    """Loads of chunk ``u`` (the varying operands only)."""
    lines = []
    m = f", mask={mask}, other=0" if mask else ""
    for i, op in enumerate(plan.operands):
        if not _varies(plan, op):
            continue
        if plan.mode == "cols":
            col = f"cols{u}" if op.col == "unit" else \
                f"cols{u} * c{i}_stride"
            if op.terms:
                off = f"roff_{i}[:, None] + {col}[None, :]"
            else:
                off = f"{col}[None, :]"
        else:
            lane = {"unit": "lanes[None, :]", "zero": "0"}[op.col]
            off = f"ooff_{i} + koff{u}_{i}[:, None] + {lane}"
        lines.append(f"x{i}_{u} = tl.load(in_{i} + ({off}){m})")
    return lines


def _chunk_offsets(plan: ReducePlan, u: int, k: str) -> List[str]:
    if plan.mode == "cols":
        return [f"cols{u} = ({k} + {u}) * BC + ar"]
    lines = [f"ks{u} = ({k} + {u}) * BK + ar"]
    for i, op in enumerate(plan.operands):
        if op.red_stride:
            lines.append(f"koff{u}_{i} = ks{u} * k{i}_stride")
            if op.col == "unit" and plan.vec[i] > 1:
                lines.append("if ALIGNED:")
                lines.append(f"    koff{u}_{i} = tl.multiple_of("
                             f"koff{u}_{i}, {plan.vec[i]})")
    return lines


def _chunks(program: Program, plan: ReducePlan, kind: str, n: int, k: str,
            mask: str, ind: str) -> List[str]:
    """``n`` chunks from chunk index ``k``: every load first, then each
    chunk's values combined into ``acc`` in chunk order."""
    lines = []
    for u in range(n):
        lines += _chunk_offsets(plan, u, k)
    for u in range(n):
        lines += _load_chunk(plan, u, mask)
    ident = _IDENTITY[kind]
    for u in range(n):
        for i, op in enumerate(plan.operands):
            if not _varies(plan, op):
                # loaded before the loop: a local name here, so that its
                # conversion to f32 reassigns nothing the loop carries
                lines.append(f"x{i}_{u} = x{i}")
        loaded = [f"x{i}_{u}" for i in range(len(plan.operands))]
        body, (y,) = triton_lines(program, loaded, indent="")
        lines += body
        y = f"({y}).to(tl.float32)"
        if mask:
            cm = f"cols{u}[None, :] < n_cols" if plan.mode == "cols" \
                else f"ks{u}[:, None] < n_cols"
            y = f"tl.where({cm}, {y}, {ident})"
        lines.append(f"acc = {_COMBINE[kind].format('acc', y)}")
    return [ind + s for s in lines]


def _reduction(program: Program, plan: ReducePlan, kind: str, ind: str,
               lane_mask: str) -> List[str]:
    """The chunk loop over this program's share of the reduced axis."""
    U = plan.unroll
    return ([f"{ind}for j in range(0, n_full // {U}):",
             f"{ind}    k = k_lo + j * {U}"]
            + _chunks(program, plan, kind, U, "k", lane_mask, ind + "    ")
            + [f"{ind}for j in range((n_full // {U}) * {U}, n_full):",
               f"{ind}    k = k_lo + j"]
            + _chunks(program, plan, kind, 1, "k", lane_mask, ind + "    ")
            + [f"{ind}if k_lo + n_full < k_end:",
               f"{ind}    k = k_lo + n_full"]
            + _chunks(program, plan, kind, 1, "k",
                      " & ".join(filter(None, [
                          "(cols0[None, :] < n_cols)" if plan.mode == "cols"
                          else "(ks0[:, None] < n_cols)", lane_mask])),
                      ind + "    "))


def _source(program: Program, plan: ReducePlan, kind: str, out_dtype) -> str:
    n_in = len(program.in_dtypes)
    cols = plan.mode == "cols"
    args = [f"in_{i}" for i in range(n_in)] + ["out", "ws", "tickets",
                                                "n_cols_ptr", "n_rows",
                                                "n_lanes", "n_red",
                                                "n_split", "span"]
    for i, op in enumerate(plan.operands):
        for k in range(len(op.terms)):
            args += [f"r{i}_{k}_inner", f"r{i}_{k}_size", f"r{i}_{k}_stride"]
        if op.col == "strided":
            args.append(f"c{i}_stride")
        if not cols and op.red_stride:
            args.append(f"k{i}_stride")
    runtime = [a for a in args if a not in
               ("out", "ws", "tickets", "n_cols_ptr")
               and not a.startswith("in_")]
    ident = _IDENTITY[kind]
    A, B = ("BR", "BC") if cols else ("BK", "BL")
    lines = [_HEADER, "",
             f"@triton.jit(do_not_specialize={runtime!r})",
             f"def kinput({', '.join(args)}, {A}: tl.constexpr, "
             f"{B}: tl.constexpr, ALIGNED: tl.constexpr):",
             "    n_cols = tl.minimum(tl.maximum(tl.load(n_cols_ptr), 0), "
             "n_red)",
             "    pid = tl.program_id(0)",
             "    tile = pid // n_split",
             "    s = pid - tile * n_split",
             f"    ar = tl.arange(0, {'BC' if cols else 'BK'})"]
    if cols:
        lines += ["    rows = tile * BR + tl.arange(0, BR)",
                  "    omask = rows < n_rows",
                  "    idx = rows",
                  "    rows_ld = tl.minimum(rows, n_rows - 1)"]
        base = "rows_ld"
    else:
        lines += ["    n_lb = tl.cdiv(n_lanes, BL)",
                  "    o = tile // n_lb",
                  "    l0 = (tile - o * n_lb) * BL",
                  "    lanes = l0 + tl.arange(0, BL)",
                  "    omask = lanes < n_lanes",
                  "    idx = o * n_lanes + lanes"]
        base = "o"
    pre = "roff" if cols else "ooff"
    for i, op in enumerate(plan.operands):
        if not op.terms and not (not cols and op.red_stride):
            continue
        lines.append("    " + term_source(f"{pre}_{i}", base, len(op.terms),
                                          op.whole, f"r{i}_"))
        if op.col == "unit" and plan.vec[i] > 1:
            lines += ["    if ALIGNED:",
                      f"        {pre}_{i} = tl.multiple_of({pre}_{i}, "
                      f"{plan.vec[i]})"]
    for i, op in enumerate(plan.operands):
        if _varies(plan, op):
            continue
        if cols:  # one value a row
            lines.append(f"    x{i} = tl.load(in_{i} + roff_{i})[:, None]"
                         if op.terms else f"    x{i} = tl.load(in_{i})")
            continue
        off = " + ".join([f"ooff_{i}"] * bool(op.terms)
                         + ["lanes"] * (op.col == "unit"))
        if op.col == "unit":  # one value a lane
            lines.append(f"    x{i} = tl.load(in_{i} + ({off}), "
                         f"mask=omask, other=0)[None, :]")
        else:
            lines.append(f"    x{i} = tl.load(in_{i}"
                         f"{' + ' + off if off else ''})")
    chunk = "BC" if cols else "BK"
    lines += [f"    n_chunks = tl.cdiv(n_cols, {chunk})",
              "    k_lo = s * span",
              "    k_end = tl.minimum(k_lo + span, n_chunks)",
              f"    n_full = tl.maximum(tl.minimum(k_lo + span, "
              f"n_cols // {chunk}) - k_lo, 0)",
              f"    acc = tl.full(({A}, {B}), {ident}, tl.float32)"]
    if cols:
        lines += _reduction(program, plan, kind, "    ", "")
    else:
        lines += [f"    if l0 + BL <= n_lanes:"]
        lines += _reduction(program, plan, kind, "        ", "")
        lines += ["    else:"]
        lines += _reduction(program, plan, kind, "        ",
                            "omask[None, :]")
    axis = 1 if cols else 0
    dt = triton_dtype(out_dtype)
    n_out = "n_rows" if cols else "n_rows * n_lanes"
    lines += [f"    r = {_FINISH[kind].format('acc', axis)}",
              "    if n_split == 1:",
              f"        tl.store(out + idx, r.to({dt}), mask=omask)",
              "    else:",
              f"        tl.store(ws + s * ({n_out}) + idx, r, mask=omask)",
              "        tl.debug_barrier()",
              "        t = tl.atomic_add(tickets + tile, 1, sem='acq_rel', "
              "scope='gpu')",
              "        if t == n_split - 1:",
              f"            r = tl.full(({A if cols else B},), {ident}, "
              f"tl.float32)",
              f"            sj = tl.arange(0, {SPLITS_AT_ONCE})",
              f"            for j in range(0, n_split, {SPLITS_AT_ONCE}):",
              "                jm = (j + sj) < n_split",
              f"                y = tl.load(ws + (j + sj)[:, None] * ({n_out})"
              " + idx[None, :], mask=jm[:, None] & omask[None, :], "
              f"other={ident}, cache_modifier='.cg')",
              f"                y = {_FINISH[kind].format('y', 0)}",
              f"                r = {_COMBINE[kind].format('r', 'y')}",
              f"            tl.store(out + idx, r.to({dt}), mask=omask)",
              "            tl.store(tickets + tile, 0)"]
    return "\n".join(lines) + "\n"


def module_name(program: Program, plan: ReducePlan, kind: str,
                out_dtype) -> str:
    """One generated module per (program, kind, out dtype, operand
    structure, unroll), whatever the lengths."""
    return (f"kinput3_{program.key}_{kind}_"
            f"{str(out_dtype).split('.')[-1]}_{plan.structure}_u{plan.unroll}")


#: (device, stream) -> int32 tickets, zero between launches: the program
#: that takes a tile's last ticket sets it back to 0, and launches on one
#: stream run in order
_TICKETS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _tickets(dev: torch.device, n: int) -> torch.Tensor:
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                        device=dev)
    return t


def launch(program: Program, inputs: Sequence[torch.Tensor],
           n_cols: torch.Tensor, kind: str, out: torch.Tensor,
           plan: ReducePlan) -> torch.Tensor:
    """Launch the kInput kernel of ``program`` with ``plan`` into ``out``
    (CUDA); ``n_cols`` is the valid column count, an ``int32`` on the
    card that the kernel reads."""
    name = module_name(program, plan, kind, out.dtype)
    mod = load_kernel(name, lambda: _source(program, plan, kind, out.dtype))
    INSTANCES.setdefault(program.key, set()).add(
        (name, plan.block_a, plan.block_b, plan.unroll, plan.num_warps,
         plan.aligned, plan.bases))
    if not plan.aligned:
        UNALIGNED_LAUNCHES.launches += 1
    if not plan.tiles:
        return out
    dev = out.device
    # f32 partials, [split][out]; one unread word where nothing is split
    # (the same argument types, so the same compiled kernel)
    ws = torch.empty(plan.n_split * out.numel() if plan.n_split > 1 else 1,
                     dtype=torch.float32, device=dev)
    blocks = ({"BR": plan.block_a, "BC": plan.block_b} if plan.mode == "cols"
              else {"BK": plan.block_a, "BL": plan.block_b})
    mod.kinput[(plan.grid,)](*inputs, out, ws, _tickets(dev, plan.tiles),
                             n_cols, plan.n_rows, plan.n_lanes, plan.n_red,
                             plan.n_split, plan.span, *plan.args(),
                             **blocks, ALIGNED=plan.aligned,
                             num_warps=plan.num_warps, **CLUSTER_OPTIONS)
    return out


def fused_reduce_kernel(program: Program, inputs: Sequence[torch.Tensor],
                        n_valid_cols, kind: str, axis: int,
                        shape: Sequence[int], out_dtype) -> torch.Tensor:
    """Launch the kInput kernel (CUDA); ``n_valid_cols`` is an ``int32``
    tensor of one element on the card, which the kernel reads, or an int
    (put there first).  Returns the kept axes in order."""
    dev = inputs[0].device
    n_cols = n_valid_cols if isinstance(n_valid_cols, torch.Tensor) \
        else device_ints([n_valid_cols], dev)
    if n_cols.dtype != torch.int32 or n_cols.numel() != 1 or \
            n_cols.device != dev:
        raise ValueError(f"kInput: n_valid_cols must be one int32 on {dev},"
                         f" got {n_cols.dtype} {tuple(n_cols.shape)} on "
                         f"{n_cols.device}")
    shape = tuple(int(d) for d in shape)
    rank = len(shape)
    axis = axis % rank
    total = 1
    for d in shape:
        total *= d
    if total >= 2 ** 31:
        raise ValueError(f"kInput iteration space {shape} exceeds int32 "
                         f"indexing")
    plan = reduce_plan(shape, axis, layouts(inputs, shape))
    out = torch.empty([shape[a] for a in range(rank) if a != axis],
                      dtype=out_dtype, device=inputs[0].device)
    return launch(program, inputs, n_cols, kind, out, plan)
