"""Fused elementwise kernel for Hopper — DISC §4.3 kLoop codegen.

Replaces the JAX package's ``kernels/fused_elementwise/fused_elementwise.py``
``fused_elementwise_kernel`` (a Pallas TPU kernel).

One Triton kernel executes an entire kLoop fusion cluster and writes
every live-out of the cluster from the same launch.  The cluster's
expression is generated as Triton source from its
:class:`~repro_torch.kernels.program.Program` (the reference unrolls a
Python closure at trace time; Triton cannot take one) and cached by the
program's fingerprint and its operands' structure, so the identical
clusters of every layer share one compiled kernel.

* What bounds it on an H100: bytes.  Every output element costs a few
  flops against 4–12 bytes of traffic, far below the card's ~295
  flop/byte balance point, so the design moves each operand byte once,
  in 16-byte accesses, with no integer division per element.
* The iteration is rows × columns (:func:`cluster_plan.loop_plan`).  A
  program covers a tile of ``BR`` rows × ``BC`` columns: a per-row
  operand (an RMSNorm scale, a softmax sum) is loaded once a row of the
  tile, a per-column operand (a weight) once a tile as one contiguous
  vector, a dense one at its row offset plus the column.  Row offsets
  come from each operand's row terms, once a row.
* Tiles wholly inside the domain and inside ``n_valid`` take an
  unmasked body; in the aligned class (a compile-time constant) their
  offsets carry ``tl.multiple_of``, so Triton emits 16-byte loads and
  stores though every length is a runtime argument.  The rest take a
  masked body: the loads masked per row (``clamp(total − r·C, 0, C)``),
  positions at or beyond ``n_valid`` stored as exact zeros, as the
  reference does.
* Sizes, strides and ``n_valid`` are listed in ``do_not_specialize``: a
  new length inside a bucket, or a new bucket at the same width, reuses
  the compiled kernel.  Values are computed with ``triton_lines``'
  per-op roundings under ``triton_build.CLUSTER_OPTIONS`` (no FMA
  contraction, libdevice without flush-to-zero), so the kernel matches
  the plain version bit for bit, subnormal values included.
* The TPU's 8×128 tile versions and pad-to-1024 path are not carried
  over.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple

import torch

from ..cluster_plan import LoopPlan, layouts, loop_plan
from ..program import Program, triton_dtype, triton_lines
from ..triton_build import CLUSTER_OPTIONS, load_kernel, term_source
from .ops import UNALIGNED_LAUNCHES

__all__ = ["fused_elementwise_kernel", "launch", "module_name", "INSTANCES"]

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
'''


def _loads(plan: LoopPlan, masked: bool) -> List[str]:
    lines = []
    for i, op in enumerate(plan.operands):
        p = f"in_{i}"
        if op.col == "zero":
            if op.terms:
                m = ", mask=lim > 0, other=0" if masked else ""
                lines.append(f"x{i} = tl.load({p} + roff_{i}{m})[:, None]")
            else:
                lines.append(f"x{i} = tl.load({p})")
            continue
        col = "cols" if op.col == "unit" else f"cols * c{i}_stride"
        if op.terms:
            m = ", mask=m, other=0" if masked else ""
            lines.append(f"x{i} = tl.load({p} + (roff_{i}[:, None] + "
                         f"{col}[None, :]){m})")
        else:
            # a per-column operand read through the tile's own shape, so
            # that it takes the dense operands' register layout (a [BC]
            # load took its own, and a 16-bit store's layout then cost a
            # trip through shared memory)
            m = ", mask=tl.broadcast_to((cols < n_cols)[None, :], " \
                "(BR, BC)), other=0" if masked else ""
            lines.append(f"x{i} = tl.load(tl.broadcast_to({p} + "
                         f"{col}[None, :], (BR, BC)){m})")
    return lines


def _source(program: Program, plan: LoopPlan) -> str:
    n_in, n_out = len(program.in_dtypes), len(program.outs)
    args = [f"in_{i}" for i in range(n_in)] + \
        [f"out_{k}" for k in range(n_out)] + \
        ["n_rows", "n_cols", "n_valid", "total"]
    for i, op in enumerate(plan.operands):
        for k in range(len(op.terms)):
            args += [f"r{i}_{k}_inner", f"r{i}_{k}_size", f"r{i}_{k}_stride"]
        if op.col == "strided":
            args.append(f"c{i}_stride")
    runtime = [a for a in args if not a.startswith(("in_", "out_"))]
    lines = [_HEADER, "",
             f"@triton.jit(do_not_specialize={runtime!r})",
             f"def kloop({', '.join(args)}, BR: tl.constexpr, "
             f"BC: tl.constexpr, ALIGNED: tl.constexpr):",
             "    pid = tl.program_id(0)",
             "    n_cb = tl.cdiv(n_cols, BC)",
             "    rt = pid // n_cb",
             "    r0 = rt * BR",
             "    c0 = (pid - rt * n_cb) * BC",
             "    rows = r0 + tl.arange(0, BR)",
             "    cols = c0 + tl.arange(0, BC)",
             "    orow = rows * n_cols",
             "    if ALIGNED:",
             f"        orow = tl.multiple_of(orow, {plan.out_vec})"]
    for i, op in enumerate(plan.operands):
        if not op.terms:
            continue
        lines.append("    " + term_source(f"roff_{i}", "rows", len(op.terms),
                                          op.whole, f"r{i}_"))
        if op.col == "unit" and plan.vec[i] > 1:
            lines += ["    if ALIGNED:",
                      f"        roff_{i} = tl.multiple_of(roff_{i}, "
                      f"{plan.vec[i]})"]
    loaded = [f"x{i}" for i in range(n_in)]
    ind = "        "
    lines += ["    full = (r0 + BR <= n_rows) & (c0 + BC <= n_cols) & "
              "((r0 + BR - 1) * n_cols + c0 + BC <= n_valid)",
              "    if full:"]
    lines += [ind + s for s in _loads(plan, masked=False)]
    body, outs = triton_lines(program, loaded, indent=ind)
    lines += body
    for k, (name, dt) in enumerate(zip(outs, program.out_dtypes)):
        lines.append(f"{ind}tl.store(out_{k} + (orow[:, None] + "
                     f"cols[None, :]), tl.broadcast_to(({name})"
                     f".to({triton_dtype(dt)}), (BR, BC)))")
    lines += ["    else:",
              f"{ind}lim = tl.minimum(tl.maximum(total - orow, 0), n_cols)",
              f"{ind}keep_n = tl.minimum(tl.maximum(n_valid - orow, 0), "
              f"n_cols)",
              f"{ind}m = cols[None, :] < lim[:, None]",
              f"{ind}keep = cols[None, :] < keep_n[:, None]"]
    lines += [ind + s for s in _loads(plan, masked=True)]
    body, outs = triton_lines(program, loaded, indent=ind)
    lines += body
    for k, (name, dt) in enumerate(zip(outs, program.out_dtypes)):
        lines.append(f"{ind}tl.store(out_{k} + (orow[:, None] + "
                     f"cols[None, :]), tl.where(keep, {name}, 0)"
                     f".to({triton_dtype(dt)}), mask=m)")
    return "\n".join(lines) + "\n"


def module_name(program: Program, plan: LoopPlan) -> str:
    """One generated module per (program, operand structure), whatever
    the lengths."""
    return f"kloop2_{program.key}_{plan.structure}"


def launch(program: Program, inputs: Sequence[torch.Tensor], n_valid: int,
           shape: Sequence[int], plan: LoopPlan) -> List[torch.Tensor]:
    """Launch the kLoop kernel of ``program`` with ``plan`` (CUDA)."""
    name = module_name(program, plan)
    mod = load_kernel(name, lambda: _source(program, plan))
    INSTANCES.setdefault(program.key, set()).add(
        (name, plan.block_r, plan.block_c, plan.num_warps, plan.aligned,
         plan.bases))
    if not plan.aligned:
        UNALIGNED_LAUNCHES.launches += 1
    dev = inputs[0].device
    outs = [torch.empty(shape, dtype=dt, device=dev)
            for dt in program.out_dtypes]
    if plan.total:
        n_valid = min(max(int(n_valid), 0), plan.total)
        mod.kloop[(plan.grid,)](*inputs, *outs, plan.n_rows, plan.n_cols,
                                n_valid, plan.total, *plan.args(),
                                BR=plan.block_r, BC=plan.block_c,
                                ALIGNED=plan.aligned,
                                num_warps=plan.num_warps, **CLUSTER_OPTIONS)
    return outs


def fused_elementwise_kernel(program: Program, inputs: Sequence[torch.Tensor],
                             n_valid: int, shape: Sequence[int]
                             ) -> List[torch.Tensor]:
    """Launch the kLoop kernel for ``program`` over ``shape`` (CUDA)."""
    shape = tuple(int(d) for d in shape)
    dev = inputs[0].device
    for x in inputs:
        if x.device != dev:
            raise ValueError(f"kLoop operands on {x.device} and {dev}")
    plan = loop_plan(shape, layouts(inputs, shape),
                     tuple(dt.itemsize for dt in program.out_dtypes))
    if plan.total + plan.block_r * plan.n_cols >= 2 ** 31:
        raise ValueError(f"kLoop iteration space {shape} exceeds int32 "
                         f"indexing")
    return launch(program, inputs, n_valid, shape, plan)
