"""Fused reduce kernel for Hopper — DISC §4.3 kInput codegen.

Replaces the JAX package's ``kernels/fused_reduce/fused_reduce.py``
``fused_reduce_kernel`` (a Pallas TPU kernel): elementwise producers
recomputed inside a masked single-axis ``sum``/``max``/``min``/``prod``.

* Layout: rows = the kept axes, columns = the reduced axis.  A non-last
  reduce axis is not transposed in memory: each operand is read through
  its own row terms and column stride, so the permutation is free.
* Each program owns ``BLOCK_R`` rows and loops over the columns in
  ``BLOCK_C`` chunks with a running f32 accumulator — the reference loads
  whole rows into VMEM (4 MiB budget); a Hopper SM has 227 KB of shared
  memory and registers are scarcer, so rows of any length stream through
  a fixed (BLOCK_R, BLOCK_C) register tile.
* ``n_cols`` is the *valid* column count, a runtime argument: the loop
  stops there, so masked tail columns take the identity without being
  read.  Sizes and strides are runtime arguments in ``do_not_specialize``
  (no recompile per length or bucket).  The result is stored in the
  reduce's dtype after f32 accumulation.
* What bounds it on an H100: bytes (a few flops per element read).
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from ..program import Program, triton_dtype, triton_lines
from ..triton_build import index_terms, load_kernel, term_source, triton

__all__ = ["fused_reduce_kernel", "BLOCK_R", "BLOCK_C", "NUM_WARPS"]

BLOCK_R = 8
BLOCK_C = 256
NUM_WARPS = 4

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

_IDENTITY = {"sum": "0.0", "max": "float('-inf')", "min": "float('inf')",
             "prod": "1.0"}
_COMBINE = {"sum": "acc + y", "max": "tl.maximum(acc, y)",
            "min": "tl.minimum(acc, y)", "prod": "acc * y"}
_FINISH = {"sum": "tl.sum(acc, axis=1)", "max": "tl.max(acc, axis=1)",
           "min": "tl.min(acc, axis=1)", "prod": "tl.reduce(acc, 1, _mul)"}


def _structure(inputs, shape, perm):
    """Per operand: row terms over the kept axes and the column stride
    (``"unit"`` when 1, which vectorizes; ``0`` when broadcast)."""
    rows_shape = [shape[a] for a in perm[:-1]]
    n_rows = 1
    for d in rows_shape:
        n_rows *= d
    kinds, args = [], []
    for x in inputs:
        xp = x.expand(tuple(shape)).permute(perm)
        t = index_terms(xp.select(-1, 0), rows_shape) if rows_shape \
            else []
        cs = xp.stride(-1) if shape[perm[-1]] != 1 else 0
        col = "unit" if cs == 1 else ("zero" if cs == 0 else "strided")
        whole = bool(t) and t[0][0] * t[0][1] == n_rows
        kinds.append((len(t), whole, col))
        flat = [v for term in t for v in term]
        args.append(flat + ([cs] if col == "strided" else []))
    return tuple(kinds), args, n_rows


def _source(program: Program, kinds, kind: str, out_dtype) -> str:
    n_in = len(program.in_dtypes)
    args = [f"in_{i}" for i in range(n_in)] + ["out", "n_rows", "n_cols"]
    for i, (nt, _, col) in enumerate(kinds):
        for k in range(nt):
            args += [f"r{i}_{k}_inner", f"r{i}_{k}_size", f"r{i}_{k}_stride"]
        if col == "strided":
            args.append(f"c{i}_stride")
    runtime = [a for a in args if not a.startswith(("in_", "out"))]
    ident = _IDENTITY[kind]
    lines = [_HEADER, "",
             f"@triton.jit(do_not_specialize={runtime!r})",
             f"def kinput({', '.join(args)}, BLOCK_R: tl.constexpr, "
             f"BLOCK_C: tl.constexpr):",
             "    pid = tl.program_id(0)",
             "    rows = pid * BLOCK_R + tl.arange(0, BLOCK_R)",
             "    rmask = rows < n_rows"]
    for i, (nt, whole, _) in enumerate(kinds):
        lines.append("    " + term_source(f"roff_{i}", "rows", nt, whole,
                                          f"r{i}_"))
    lines += [f"    acc = tl.full((BLOCK_R, BLOCK_C), {ident}, tl.float32)",
              "    for c0 in range(0, n_cols, BLOCK_C):",
              "        cols = c0 + tl.arange(0, BLOCK_C)",
              "        m = rmask[:, None] & (cols < n_cols)[None, :]"]
    loaded = []
    for i, (_, _, col) in enumerate(kinds):
        coff = {"unit": "cols[None, :]", "zero": "cols[None, :] * 0",
                "strided": f"cols[None, :] * c{i}_stride"}[col]
        lines.append(f"        x{i} = tl.load(in_{i} + roff_{i}[:, None] + "
                     f"{coff}, mask=m, other=0)")
        loaded.append(f"x{i}")
    body, (y,) = triton_lines(program, loaded, indent="        ")
    lines += body
    lines += [f"        y = tl.where(m, ({y}).to(tl.float32), {ident})",
              f"        acc = {_COMBINE[kind]}",
              f"    r = {_FINISH[kind]}",
              f"    tl.store(out + rows, r.to({triton_dtype(out_dtype)}), "
              f"mask=rmask)"]
    return "\n".join(lines) + "\n"


def fused_reduce_kernel(program: Program, inputs: Sequence[torch.Tensor],
                        n_valid_cols: int, kind: str, axis: int,
                        shape: Sequence[int], out_dtype) -> torch.Tensor:
    """Launch the kInput kernel (CUDA); returns the kept axes in order."""
    shape = tuple(int(d) for d in shape)
    rank = len(shape)
    axis = axis % rank
    perm = [a for a in range(rank) if a != axis] + [axis]
    total = 1
    for d in shape:
        total *= d
    if total >= 2 ** 31:
        raise ValueError(f"kInput iteration space {shape} exceeds int32 "
                         f"indexing")
    dev = inputs[0].device
    kinds, per_in, n_rows = _structure(inputs, shape, perm)
    key = "".join(f"{nt}{int(w)}{c[0]}" for nt, w, c in kinds)
    mod = load_kernel(f"kinput_{program.key}_{kind}_{key}_"
                      f"{str(out_dtype).split('.')[-1]}_r{BLOCK_R}c{BLOCK_C}",
                      lambda: _source(program, kinds, kind, out_dtype))
    out = torch.empty([shape[a] for a in perm[:-1]], dtype=out_dtype,
                      device=dev)
    n_cols = min(int(n_valid_cols), shape[axis])
    flat: List[int] = [v for a in per_in for v in a]
    if n_rows:
        grid = (triton().cdiv(n_rows, BLOCK_R),)
        mod.kinput[grid](*inputs, out, n_rows, n_cols, *flat,
                         BLOCK_R=BLOCK_R, BLOCK_C=BLOCK_C,
                         num_warps=NUM_WARPS, enable_fp_fusion=False)
    return out
