"""Plans of the cluster kernels (kLoop, kInput) as rows × columns.

Pure Python: nothing here imports Triton or touches a card, so the CPU
tests check every plan and emulate its reads.

A cluster's operands are tensors *broadcastable* to its iteration shape,
with any strides.  Both kernels see the iteration as **rows × columns**:

* the **columns** are the innermost merged run of dimensions over which
  every operand is contiguous (stride 1, ``"unit"``), broadcast (stride
  0, ``"zero"``) or strided by one constant (``"strided"``); for kInput
  they are the reduced axis;
* the **rows** are the rest.  Each operand's row offset is a sum of
  terms ``((r // inner) % size) * stride`` over the row index ``r``,
  computed once a row, never once an element.

A per-row operand (an RMSNorm scale, a softmax sum) is then a ``"zero"``
column with row terms, a per-column operand (a weight) a ``"unit"``
column without any, and a dense one a ``"unit"`` column whose row terms
give its row pitch.  A cluster that merges into one row (every operand
dense, or broadcast alike) is cut into rows of :data:`CUT_WIDTH`.

A plan also fixes the tile a program covers, its warps, and the
**alignment class**: whether every vector operand's base pointer and row
pitch, and the column count, are multiples of 16 bytes.  In the aligned
class the kernels mark their offsets with ``tl.multiple_of`` so that
Triton proves 16-byte accesses without specialising any length.  The
class, the tile and the warps are compile-time constants; every size,
stride and valid length stays a runtime argument, and no constant
depends on the number of rows (a new length, or a new bucket at the same
width, builds nothing).

Plans are memoised per (shape, strides, dtypes, pointer alignment), so a
call repeats no Python index work.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

__all__ = ["Term", "Operand", "LoopPlan", "ReducePlan", "merge_terms",
           "rows_by_columns", "layouts", "loop_plan", "reduce_plan",
           "split", "VEC_BYTES", "CUT_WIDTH", "SMS"]

#: (inner, size, stride): ((r // inner) % size) * stride
Term = Tuple[int, int, int]

#: bytes of one vector access (``LDG.128`` / ``STG.128``)
VEC_BYTES = 16
#: row width a cluster without rows is cut into (a power of two)
CUT_WIDTH = 2048
#: streaming multiprocessors of an H100 SXM
SMS = 132
#: bytes of the widest vector operand one tile reads: kLoop; kInput's
#: rows × columns; kInput's lanes (sizes from the sweeps of
#: ``tools/cluster_tune.py`` on an H100)
TILE_BYTES = 16384
ROWS_TILE_BYTES = 8192
LANES_TILE_BYTES = 32768
#: widest column block of a kLoop tile (elements)
LOOP_MAX_BC = 2048
#: widest column chunk of a kInput row tile (bytes of the widest operand)
REDUCE_CHUNK_BYTES = 8192
#: widest lane block of a kInput tile over a kept axis (elements)
REDUCE_MAX_BL = 256
#: kInput column chunks whose loads are issued before the first is used
UNROLL = 2
#: a kInput launch with fewer tiles than this splits its columns
FEW_TILES = 2 * SMS
#: ... into enough programs for this many
SPLIT_PROGRAMS = 4 * SMS
NUM_WARPS = 4


@dataclass(frozen=True)
class Operand:
    """How one operand is read over rows × columns (kInput over a kept
    axis: over outer rows × lanes, ``red_stride`` along the reduced
    axis)."""

    terms: Tuple[Term, ...]
    whole: bool         # the first term spans every row: no modulo
    col: str            # "unit" | "zero" | "strided"
    col_stride: int
    red_stride: int = 0

    @property
    def kind(self) -> str:
        return f"{len(self.terms)}{int(self.whole)}{self.col[0]}"

    def args(self, lanes: bool = False) -> List[int]:
        """Runtime arguments, in the order the kernels declare them."""
        out = [v for t in self.terms for v in t]
        if self.col == "strided":
            out.append(self.col_stride)
        if lanes and self.red_stride:
            out.append(self.red_stride)
        return out


def _pow2_divisor(n: int) -> int:
    return n & -n if n > 0 else 1


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _pow2_floor(n: int) -> int:
    return 1 << max(0, n.bit_length() - 1)


def merge_terms(dims: Sequence[Tuple[int, int]]) -> Tuple[Term, ...]:
    """Terms of the row-major index over ``dims`` = [(size, stride)],
    outermost first: broadcast dims give nothing; contiguous neighbours
    merge, so a dense block is the single term ``(1, n, pitch)``."""
    merged: List[List[int]] = []
    for n, st in dims:
        if n == 1:
            continue
        if merged and ((merged[-1][1] == 0 and st == 0)
                       or (st != 0 and merged[-1][1] == st * n)):
            merged[-1][0] *= n
            merged[-1][1] = st
        else:
            merged.append([n, st])
    terms: List[Term] = []
    inner = 1
    for n, st in reversed(merged):
        if st != 0:
            terms.append((inner, n, st))
        inner *= n
    return tuple(reversed(terms))


def _whole(terms: Tuple[Term, ...], n_rows: int) -> bool:
    return bool(terms) and terms[0][0] * terms[0][1] == n_rows


def rows_by_columns(shape: Sequence[int],
                    strides: Sequence[Sequence[int]]
                    ) -> Tuple[int, int, Tuple[Operand, ...]]:
    """``(n_rows, n_cols, operands)`` of the iteration ``shape`` over
    operands with the given (broadcast) strides.  Rows and columns cover
    the flat row-major index as ``r * n_cols + c``."""
    dims = [(int(n), [int(s[d]) for s in strides])
            for d, n in enumerate(shape) if n != 1]
    if not dims:
        return 1, 1, tuple(Operand((), False, "zero", 0) for _ in strides)
    n_c, cs = dims[-1][0], dims[-1][1]
    j = len(dims) - 1
    while j > 0 and all(st == c * n_c for st, c in zip(dims[j - 1][1], cs)):
        n_c *= dims[j - 1][0]
        j -= 1
    n_r = 1
    for n, _ in dims[:j]:
        n_r *= n
    ops = []
    for i, c in enumerate(cs):
        terms = merge_terms([(n, st[i]) for n, st in dims[:j]])
        col = "unit" if c == 1 else ("zero" if c == 0 else "strided")
        ops.append(Operand(terms, _whole(terms, n_r), col, c))
    return n_r, n_c, tuple(ops)


def _cut(n_cols: int, ops: Tuple[Operand, ...], width: int
         ) -> Tuple[int, int, Tuple[Operand, ...]]:
    """One row of ``n_cols`` as rows of ``width`` (the last one short)."""
    n_r = -(-n_cols // width)
    out = []
    for op in ops:
        terms = ((1, n_r, width * op.col_stride),) if op.col_stride else ()
        out.append(Operand(terms, bool(terms), op.col, op.col_stride))
    return n_r, width, tuple(out)


#: broadcast strides, element bytes, base pointer on 16 bytes
Layout = Tuple[Tuple[int, ...], int, bool]


def layouts(tensors: Sequence[torch.Tensor], shape: Sequence[int]
            ) -> Tuple[Layout, ...]:
    """Each operand's strides broadcast to ``shape``, element bytes and
    whether its base pointer is 16-byte aligned: the plans' key."""
    n = len(shape)
    out = []
    for x in tensors:
        xs, st = x.shape, x.stride()
        pad = n - len(xs)
        bst = tuple(0 if i < pad or xs[i - pad] == 1 else st[i - pad]
                    for i in range(n))
        out.append((bst, x.element_size(), x.data_ptr() % VEC_BYTES == 0))
    return tuple(out)


def _vector_aligned(op: Operand, esize: int, base_ok: bool,
                    extra: Sequence[int] = ()) -> bool:
    """A vector (unit-column) operand starts every row on 16 bytes."""
    vec = VEC_BYTES // esize if esize < VEC_BYTES else 1
    return base_ok and all(t[2] % vec == 0 for t in op.terms) and \
        all(s % vec == 0 for s in extra)


def _column_block(n: int, cap: int, least: int = 128) -> int:
    """A power-of-two block for a row of ``n``: the largest that divides
    it, up to ``cap`` (2560 = 5 × 512, 3584 = 7 × 512), where that is at
    least ``least``, so only an odd width masks its last block."""
    d = min(_pow2_divisor(n), cap)
    if d >= least or d >= n:
        return max(d, 1)
    return min(cap, _pow2_ceil(n))


# ------------------------------------------------------------- kLoop --

@dataclass(frozen=True)
class LoopPlan:
    """A kLoop launch: ``grid`` programs of ``block_r`` × ``block_c``."""

    n_rows: int
    n_cols: int
    total: int
    operands: Tuple[Operand, ...]
    vec: Tuple[int, ...]      # elements a 16-byte access, per operand
    out_vec: int              # ... of the outputs' widest multiple
    block_r: int
    block_c: int
    num_warps: int
    aligned: bool
    bases: Tuple[bool, ...]   # each operand's base on 16 bytes

    @property
    def grid(self) -> int:
        return -(-self.n_rows // self.block_r) * \
            -(-self.n_cols // self.block_c)

    @property
    def structure(self) -> str:
        return "".join(op.kind for op in self.operands)

    def args(self) -> List[int]:
        return [v for op in self.operands for v in op.args()]


@functools.lru_cache(maxsize=4096)
def loop_plan(shape: Tuple[int, ...], ins: Tuple[Layout, ...],
              out_sizes: Tuple[int, ...]) -> LoopPlan:
    """The kLoop plan over ``shape``; ``ins`` from :func:`layouts`,
    ``out_sizes`` the outputs' element bytes."""
    total = 1
    for d in shape:
        total *= int(d)
    n_r, n_c, ops = rows_by_columns(shape, [s for s, _, _ in ins])
    if n_r == 1 and n_c > CUT_WIDTH:
        n_r, n_c, ops = _cut(n_c, ops, CUT_WIDTH)
    bc = _column_block(n_c, LOOP_MAX_BC)
    widest = max([e for (_, e, _), op in zip(ins, ops) if op.col != "zero"]
                 + list(out_sizes) + [1])
    br = max(1, TILE_BYTES // (widest * bc))
    br = min(br, _pow2_floor(n_r))
    vec = tuple(max(1, VEC_BYTES // e) for _, e, _ in ins)
    out_vec = max([max(1, VEC_BYTES // e) for e in out_sizes] + [1])
    aligned = n_c % out_vec == 0 and bc >= out_vec and all(
        _vector_aligned(op, e, ok) and bc >= v
        for op, (_, e, ok), v in zip(ops, ins, vec) if op.col == "unit")
    return LoopPlan(n_r, n_c, total, ops, vec, out_vec, br, bc, NUM_WARPS,
                    aligned, tuple(ok for _, _, ok in ins))


# ------------------------------------------------------------ kInput --

@dataclass(frozen=True)
class ReducePlan:
    """A kInput launch.  ``mode`` ``"cols"``: rows × columns with the
    columns reduced (``block_a`` rows × ``block_b`` columns a chunk);
    ``"lanes"``: the reduced axis runs down a tile whose lanes lie along
    the kept, contiguous axis (``block_a`` reduced × ``block_b`` lanes).
    ``n_split`` programs share each tile's reduced range, ``span`` chunks
    each, their partials combined in split order."""

    mode: str
    n_rows: int               # rows ("cols"), outer rows ("lanes")
    n_lanes: int              # 1 in "cols"
    n_red: int                # the reduced axis' padded length
    operands: Tuple[Operand, ...]
    vec: Tuple[int, ...]
    block_a: int
    block_b: int
    unroll: int
    num_warps: int
    aligned: bool
    n_split: int
    span: int
    bases: Tuple[bool, ...]   # each operand's base on 16 bytes

    @property
    def tiles(self) -> int:
        if self.mode == "cols":
            return -(-self.n_rows // self.block_a)
        return self.n_rows * -(-self.n_lanes // self.block_b)

    @property
    def chunk(self) -> int:
        return self.block_a if self.mode == "lanes" else self.block_b

    @property
    def grid(self) -> int:
        return self.tiles * self.n_split

    @property
    def structure(self) -> str:
        return self.mode[0] + "".join(
            op.kind + ("s" if op.red_stride else "z") for op in self.operands)

    def args(self) -> List[int]:
        lanes = self.mode == "lanes"
        return [v for op in self.operands for v in op.args(lanes)]


def split(tiles: int, n_red: int, chunk: int) -> Tuple[int, int]:
    """(programs a tile, chunks each) over the padded reduced length."""
    chunks = -(-n_red // chunk) if n_red else 0
    n_split = 1
    if tiles < FEW_TILES and chunks >= 2 * UNROLL:
        n_split = min(-(-SPLIT_PROGRAMS // tiles), chunks // UNROLL)
    span = -(-chunks // n_split) if chunks else 1
    n_split = -(-chunks // span) if chunks else 1
    return n_split, span


@functools.lru_cache(maxsize=4096)
def reduce_plan(shape: Tuple[int, ...], axis: int, ins: Tuple[Layout, ...]
                ) -> ReducePlan:
    """The kInput plan reducing ``shape`` over ``axis``."""
    rank = len(shape)
    kept = [d for d in range(rank) if d != axis]
    n_red = int(shape[axis])
    red = [s[axis] if n_red != 1 else 0 for s, _, _ in ins]
    n_out = 1
    for d in kept:
        n_out *= int(shape[d])
    vec = tuple(max(1, VEC_BYTES // e) for _, e, _ in ins)
    widest = max([e for (_, e, _) in ins] + [1])
    kshape = [shape[d] for d in kept]
    kstrides = [[s[d] for d in kept] for s, _, _ in ins]
    n_o, n_l, lane_ops = rows_by_columns(kshape, kstrides) if kept \
        else (1, 1, ())
    cols_ok = all(s in (0, 1) for s in red)
    lanes_ok = (not cols_ok and n_l > 1
                and all(op.col != "strided" for op in lane_ops))
    if lanes_ok:
        ops = tuple(Operand(op.terms, op.whole, op.col, op.col_stride, r)
                    for op, r in zip(lane_ops, red))
        bl = _column_block(n_l, REDUCE_MAX_BL, least=32)
        bk = max(1, LANES_TILE_BYTES // (widest * bl))
        n_split, span = split(n_o * -(-n_l // bl), n_red, bk)
        aligned = all(_vector_aligned(op, e, ok, [op.red_stride])
                      and bl >= v
                      for op, (_, e, ok), v in zip(ops, ins, vec)
                      if op.col == "unit")
        return ReducePlan("lanes", n_o, n_l, n_red, ops, vec, bk, bl,
                          UNROLL, NUM_WARPS, aligned, n_split, span,
                          tuple(ok for _, _, ok in ins))
    ops = []
    for (s, _, _), r in zip(ins, red):
        terms = merge_terms([(shape[d], s[d]) for d in kept])
        col = "unit" if r == 1 else ("zero" if r == 0 else "strided")
        ops.append(Operand(terms, _whole(terms, n_out), col, r))
    ops = tuple(ops)
    bc = _column_block(n_red, max(1, REDUCE_CHUNK_BYTES // widest))
    br = max(1, ROWS_TILE_BYTES // (widest * bc))
    br = min(br, _pow2_floor(n_out))
    n_split, span = split(-(-n_out // br), n_red, bc)
    aligned = all(_vector_aligned(op, e, ok) and bc >= v
                  for op, (_, e, ok), v in zip(ops, ins, vec)
                  if op.col == "unit")
    return ReducePlan("cols", n_out, 1, n_red, ops, vec, br, bc, UNROLL,
                      NUM_WARPS, aligned, n_split, span,
                      tuple(ok for _, _, ok in ins))
