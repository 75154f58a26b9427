"""Fused elementwise kernel for Hopper — DISC §4.3 kLoop codegen.

Replaces the JAX package's ``kernels/fused_elementwise/fused_elementwise.py``
``fused_elementwise_kernel`` (a Pallas TPU kernel).

One Triton kernel executes an entire kLoop fusion cluster over the
flattened element domain and writes every live-out of the cluster from the
same launch.  The cluster's expression is generated as Triton source from
its :class:`~repro_torch.kernels.program.Program` (the reference unrolls a
Python closure at trace time; Triton cannot take one) and cached by the
program's fingerprint, so the identical clusters of every layer share one
compiled kernel.

* ``n_valid`` and ``total`` are runtime arguments listed in
  ``do_not_specialize``, like every size and stride: a new length inside a
  bucket, or a new bucket, reuses the compiled kernel.  Positions at or
  beyond ``n_valid`` store exact zeros, as the reference does.
* Operands may be broadcast views (a per-row scale, a bias row): each is
  read in place through its own flat-index → offset terms
  (:func:`~repro_torch.kernels.triton_build.index_terms`); a dense
  operand is read at the flat index itself, which vectorizes.
* What bounds it on an H100: bytes.  Every output element costs a few
  flops against 4–12 bytes of traffic, far below the card's ~295 flop/byte
  balance point, so the kernel is written to move each operand byte once:
  1-D blocks of ``BLOCK`` elements, 4 warps (8 contiguous elements per
  thread, 16-byte accesses for f32 and bf16 pairs), no shared memory.
  The TPU's 8×128 tile versions and pad-to-1024 path are not carried over.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..program import Program, triton_dtype, triton_lines
from ..triton_build import index_terms, load_kernel, term_source, triton

__all__ = ["fused_elementwise_kernel", "BLOCK", "NUM_WARPS"]

BLOCK = 1024
NUM_WARPS = 4

_HEADER = '''import triton
import triton.language as tl
try:
    from triton.language.extra import libdevice
except ImportError:  # Triton < 3.0
    from triton.language.extra.cuda import libdevice
'''


def _structure(inputs, shape) -> Tuple[Tuple, List[List[Tuple[int, int, int]]]]:
    """Per operand: ``"flat"`` (dense, same shape) or its term count plus
    whether the first term spans the whole index range (no modulo)."""
    total = 1
    for d in shape:
        total *= d
    kinds, terms = [], []
    for x in inputs:
        t = index_terms(x, shape)
        if t == [(1, total, 1)]:
            kinds.append("flat")
            terms.append([])
        else:
            whole = bool(t) and t[0][0] * t[0][1] == total
            kinds.append((len(t), whole))
            terms.append(t)
    return tuple(kinds), terms


def _source(program: Program, kinds) -> str:
    n_in, n_out = len(program.in_dtypes), len(program.outs)
    args = [f"in_{i}" for i in range(n_in)] + \
        [f"out_{k}" for k in range(n_out)] + ["n_valid", "total"]
    for i, kind in enumerate(kinds):
        if kind != "flat":
            for k in range(kind[0]):
                args += [f"i{i}_{k}_inner", f"i{i}_{k}_size",
                         f"i{i}_{k}_stride"]
    runtime = [a for a in args if not a.startswith(("in_", "out_"))]
    lines = [_HEADER, "",
             f"@triton.jit(do_not_specialize={runtime!r})",
             f"def kloop({', '.join(args)}, BLOCK: tl.constexpr):",
             "    pid = tl.program_id(0)",
             "    idx = pid * BLOCK + tl.arange(0, BLOCK)",
             "    inb = idx < total"]
    loaded = []
    for i, kind in enumerate(kinds):
        if kind == "flat":
            off = "idx"
        else:
            off = f"off_{i}"
            lines.append("    " + term_source(off, "idx", kind[0], kind[1],
                                              f"i{i}_"))
        lines.append(f"    x{i} = tl.load(in_{i} + {off}, mask=inb, other=0)")
        loaded.append(f"x{i}")
    body, outs = triton_lines(program, loaded)
    lines += body
    lines.append("    keep = idx < n_valid")
    for k, (name, dt) in enumerate(zip(outs, program.out_dtypes)):
        lines.append(f"    tl.store(out_{k} + idx, tl.where(keep, {name}, 0)"
                     f".to({triton_dtype(dt)}), mask=inb)")
    return "\n".join(lines) + "\n"


def fused_elementwise_kernel(program: Program, inputs: Sequence[torch.Tensor],
                             n_valid: int, shape: Sequence[int]
                             ) -> List[torch.Tensor]:
    """Launch the kLoop kernel for ``program`` over ``shape`` (CUDA)."""
    shape = tuple(int(d) for d in shape)
    total = 1
    for d in shape:
        total *= d
    if total >= 2 ** 31:
        raise ValueError(f"kLoop iteration space {shape} exceeds int32 "
                         f"indexing")
    dev = inputs[0].device
    for x in inputs:
        if x.device != dev:
            raise ValueError(f"kLoop operands on {x.device} and {dev}")
    kinds, terms = _structure(inputs, shape)
    mod = load_kernel(f"kloop_{program.key}_{_key(kinds)}_b{BLOCK}",
                      lambda: _source(program, kinds))
    outs = [torch.empty(shape, dtype=dt, device=dev)
            for dt in program.out_dtypes]
    flat_args: List[int] = []
    for t in terms:
        for term in t:
            flat_args += list(term)
    if total:
        grid = (triton().cdiv(total, BLOCK),)
        mod.kloop[grid](*inputs, *outs, int(n_valid), total,
                                    *flat_args, BLOCK=BLOCK,
                                    num_warps=NUM_WARPS,
                                    enable_fp_fusion=False)
    return outs


def _key(kinds) -> str:
    return "".join("f" if k == "flat" else f"s{k[0]}{int(k[1])}"
                   for k in kinds)
