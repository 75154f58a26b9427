"""The cluster kernels' rows × columns plans (kLoop, kInput).

On the CPU: each plan (``kernels/cluster_plan.py``) at many shapes and
strides, its reads emulated with torch indexing from the plan's row
offsets and column kinds and held equal to ``torch.broadcast_to`` of each
operand; the few-rows split of a reduce and its fixed-order combine
against ``fused_reduce_ref``; the generated Triton source (parsed, every
size, stride and ``n_valid`` a runtime argument listed in
``do_not_specialize``); one module name for two lengths of one alignment
class; and JAX-parity cases for the structures the plans name (per-row ×
per-column broadcasts, a non-last-axis reduce of many rows, a one-row
reduce) through the JAX package's ``ops`` in interpret mode.

On the card (``python -m pytest -q tests/test_torch_cluster_tiles.py -k
on_card``; skipped without CUDA, no JAX needed): the kernels against
their plain versions, kLoop bit for bit with padded tails exactly zero,
kInput row by row within ``TOL_REDUCE_ROW`` of the row's sum of
magnitudes and the same bits on two runs.
"""
from __future__ import annotations

import ast

import numpy as np
import pytest
import torch

from repro_torch.kernels import cluster_plan as cp
from repro_torch.kernels.fused_elementwise import fused_elementwise as fe_k
from repro_torch.kernels.fused_elementwise import ops as ew_ops
from repro_torch.kernels.fused_elementwise.ref import fused_elementwise_ref
from repro_torch.kernels.fused_reduce import fused_reduce as fr_k
from repro_torch.kernels.fused_reduce import ops as red_ops
from repro_torch.kernels.fused_reduce.ref import (REDUCE_IDENTITY,
                                                  fused_reduce_ref)
from repro_torch.kernels.program import Program, Step

F32, BF16 = torch.float32, torch.bfloat16
TOL = dict(rtol=1e-5, atol=1e-5)
#: kInput vs plain, per row, relative to the row's sum of magnitudes
#: (chip_smoke.py's TOL_REDUCE_ROW): f32 summation order; bf16 one
#: rounding of the stored value
TOL_REDUCE_ROW = {F32: 1e-5, BF16: 8e-3}


def _p(n_in, steps, outs, in_dtypes=None):
    return Program(tuple(in_dtypes or (F32,) * n_in),
                   tuple(Step(*s) for s in steps), tuple(outs))


def _storage(x: torch.Tensor) -> torch.Tensor:
    """``x``'s whole storage as a 1-D tensor of its dtype."""
    return torch.empty(0, dtype=x.dtype).set_(x.untyped_storage())


def _row_offsets(op: cp.Operand, rows: torch.Tensor) -> torch.Tensor:
    """The operand's offset at each row: the sum of its terms, as the
    kernels' ``term_source`` computes it."""
    off = torch.zeros_like(rows)
    for inner, size, stride in op.terms:
        off = off + ((rows // inner) % size) * stride
    return off


def _operand(kind: str, shape, gen, dtype=F32) -> torch.Tensor:
    """An operand broadcastable to ``shape`` with the named layout."""
    s = tuple(shape)

    def rnd(*sh):
        return torch.randn(sh, generator=gen).to(dtype)

    if kind == "dense":
        return rnd(*s)
    if kind == "row":        # one value a row: (..., 1)
        return rnd(*s[:-1], 1)
    if kind == "col":        # one value a column: (last,)
        return rnd(s[-1])
    if kind == "scalar":
        return rnd(1)
    if kind == "transposed":  # a dense view with its last two axes swapped
        return rnd(*s[:-2], s[-1], s[-2]).transpose(-1, -2)
    if kind == "sliced":     # a column slice: base and rows off 16 bytes
        return rnd(*s[:-1], s[-1] + 1)[..., 1:]
    if kind == "every_other":  # every other column of a wider tensor
        return rnd(*s[:-1], 2 * s[-1])[..., ::2]
    if kind == "offset":     # a view one element into its storage
        return rnd(int(np.prod(s)) + 1)[1:].view(s)
    if kind == "mid":        # broadcast along a middle axis
        return rnd(*s[:-2], 1, s[-1])
    if kind == "subnormal":  # dense, every value below 2^-126
        return (torch.randn(s, generator=gen) * 1e-39).to(dtype)
    raise ValueError(kind)


# ------------------------------------------------------- kLoop plans --

LOOP_CASES = [
    # (shape, operand kinds)
    ((1, 37, 2048), ("row", "dense", "col")),      # RMSNorm-apply
    ((1, 4, 8, 64, 64), ("dense", "row")),          # softmax-div
    ((2, 5, 2047), ("dense", "row", "col")),        # odd width
    ((3, 2560), ("dense", "col")),
    ((2, 3584), ("dense", "row")),
    ((2, 5632), ("col", "row")),                    # per-row x per-column
    ((6, 7), ("dense", "scalar")),
    ((3, 4, 5), ("transposed", "dense")),
    ((4, 6), ("sliced", "col")),
    ((4, 6), ("every_other", "col")),
    ((5, 9), ("offset", "dense")),
    ((3, 4, 8), ("mid", "dense")),
    ((9000,), ("dense", "dense")),                 # cut into rows
    ((4096,), ("dense", "scalar")),
    ((1,), ("dense",)),
]


def _emulate_loop(plan: cp.LoopPlan, x: torch.Tensor, i: int) -> torch.Tensor:
    """Operand ``i`` read as the kernel reads it: the flat prefix of
    ``total`` elements, row by row."""
    op = plan.operands[i]
    rows = torch.arange(plan.n_rows)
    cols = torch.arange(plan.n_cols)
    off = _row_offsets(op, rows)[:, None] + cols[None, :] * op.col_stride
    return _storage(x)[x.storage_offset() + off.reshape(-1)[:plan.total]]


@pytest.mark.parametrize("shape,kinds", LOOP_CASES,
                         ids=[f"{s}-{'-'.join(k)}" for s, k in LOOP_CASES])
def test_loop_plan_reads_every_operand(shape, kinds):
    gen = torch.Generator().manual_seed(len(shape) * 7 + len(kinds))
    xs = [_operand(k, shape, gen) for k in kinds]
    plan = cp.loop_plan(tuple(shape), cp.layouts(xs, shape), (4,))
    assert plan.n_rows * plan.n_cols >= plan.total > \
        (plan.n_rows - 1) * plan.n_cols
    for i, x in enumerate(xs):
        want = torch.broadcast_to(x, shape).reshape(-1)
        assert torch.equal(_emulate_loop(plan, x, i), want), (i, plan)
    # the tile: powers of two, one block a row where the width allows
    assert plan.block_c & (plan.block_c - 1) == 0
    assert plan.block_r & (plan.block_r - 1) == 0
    assert plan.block_r <= max(1, plan.n_rows)
    assert plan.grid >= 1


@pytest.mark.parametrize("width,block", [(2048, 2048), (2560, 512),
                                         (3584, 512), (5632, 512),
                                         (64, 64), (2047, 2048), (96, 128)])
def test_loop_column_block_divides_the_row(width, block):
    xs = [torch.zeros(2, width), torch.zeros(2, 1)]
    plan = cp.loop_plan((2, width), cp.layouts(xs, (2, width)), (4,))
    assert plan.block_c == block
    assert plan.aligned == (width % 4 == 0)


@pytest.mark.parametrize("kind,aligned", [("dense", True), ("offset", False),
                                          ("sliced", False), ("row", True),
                                          ("col", True),
                                          ("every_other", True)])
def test_loop_alignment_class(kind, aligned):
    """The class asks 16 bytes of the operands read in vectors; a strided
    column is read an element at a time in either class."""
    gen = torch.Generator().manual_seed(3)
    shape = (8, 64)
    xs = [_operand(kind, shape, gen), torch.zeros(shape)]
    plan = cp.loop_plan(shape, cp.layouts(xs, shape), (4,))
    assert plan.aligned == aligned


def test_loop_bf16_tile_and_odd_width():
    xs = [torch.zeros(4, 2048, dtype=BF16), torch.zeros(2048, dtype=BF16)]
    plan = cp.loop_plan((4, 2048), cp.layouts(xs, (4, 2048)), (2,))
    assert plan.vec == (8, 8) and plan.out_vec == 8 and plan.aligned
    assert plan.block_r * plan.block_c * 2 == cp.TILE_BYTES
    # 4088 bytes a row: every row but the first starts off 16 bytes
    ys = [torch.zeros(4, 2044, dtype=BF16), torch.zeros(2044, dtype=BF16)]
    plan = cp.loop_plan((4, 2044), cp.layouts(ys, (4, 2044)), (2,))
    assert not plan.aligned


@pytest.mark.parametrize("n_valid_at", ["zero", "inside_row", "row_edge",
                                        "total"])
def test_loop_keep_mask_per_row(n_valid_at):
    """The kernel's per-row keep count ``clamp(n_valid − r·C, 0, C)`` is
    the flat prefix ``< n_valid``."""
    shape = (5, 3, 40)
    x = torch.zeros(shape)
    plan = cp.loop_plan(shape, cp.layouts([x], shape), (4,))
    n_valid = {"zero": 0, "inside_row": 2 * plan.n_cols + 17,
               "row_edge": 4 * plan.n_cols, "total": plan.total}[n_valid_at]
    rows = torch.arange(plan.n_rows)
    keep_n = (n_valid - rows * plan.n_cols).clamp(0, plan.n_cols)
    keep = torch.arange(plan.n_cols)[None, :] < keep_n[:, None]
    flat = torch.arange(plan.n_rows * plan.n_cols).reshape(keep.shape)
    assert torch.equal(keep, flat < n_valid)


# ------------------------------------------------------ kInput plans --

REDUCE_CASES = [
    # (shape, axis, operand kinds, mode)
    ((2048, 2048), 1, ("dense",), "cols"),            # the path's Σx²
    ((1, 64, 2048), 2, ("dense", "col"), "cols"),
    ((24, 300), 1, ("dense", "row"), "cols"),
    ((3, 40, 16), 1, ("dense", "dense"), "lanes"),     # a middle axis
    ((40, 5, 8), 0, ("dense", "mid"), "lanes"),        # axis 0
    ((5, 2048, 96), 1, ("dense",), "lanes"),
    ((64, 2048, 256), 1, ("dense", "col"), "lanes"),   # many rows
    ((1, 4194304), 1, ("dense",), "cols"),             # one row
    ((4194304,), 0, ("dense",), "cols"),
    ((6, 10), 1, ("transposed", "dense"), "cols"),     # strided columns
    ((7, 33), 1, ("offset", "dense"), "cols"),
]


def _emulate_reduce(plan: cp.ReducePlan, x: torch.Tensor, i: int
                    ) -> torch.Tensor:
    """Operand ``i`` as (outputs, reduced) from the plan's offsets."""
    op = plan.operands[i]
    k = torch.arange(plan.n_red)
    if plan.mode == "cols":
        rows = torch.arange(plan.n_rows)
        off = _row_offsets(op, rows)[:, None] + k[None, :] * op.col_stride
    else:
        o = torch.arange(plan.n_rows)[:, None, None]
        lane = torch.arange(plan.n_lanes)[None, :, None]
        off = (_row_offsets(op, o) + lane * op.col_stride
               + k[None, None, :] * op.red_stride)
        off = off.reshape(-1, plan.n_red)
    return _storage(x)[x.storage_offset() + off]


@pytest.mark.parametrize("shape,axis,kinds,mode", REDUCE_CASES,
                         ids=[f"{s}-ax{a}-{'-'.join(k)}"
                              for s, a, k, _ in REDUCE_CASES])
def test_reduce_plan_reads_every_operand(shape, axis, kinds, mode):
    gen = torch.Generator().manual_seed(len(shape) + axis)
    if int(np.prod(shape)) > 100_000:
        xs = [torch.zeros(shape) if k == "dense" else
              _operand(k, shape, gen) for k in kinds]
    else:
        xs = [_operand(k, shape, gen) for k in kinds]
    plan = cp.reduce_plan(tuple(shape), axis, cp.layouts(xs, shape))
    assert plan.mode == mode
    n_out = int(np.prod(shape)) // shape[axis]
    assert plan.n_rows * plan.n_lanes == n_out
    for i, x in enumerate(xs):
        want = torch.broadcast_to(x, shape).movedim(axis, -1) \
            .reshape(n_out, shape[axis])
        assert torch.equal(_emulate_reduce(plan, x, i), want), (i, plan)
    if mode == "lanes":  # the lanes run along a contiguous kept axis
        assert all(op.col in ("unit", "zero") for op in plan.operands)
    assert plan.grid == plan.tiles * plan.n_split


def _split_ranges(plan: cp.ReducePlan, n_cols: int):
    """Each split's columns, as the kernel walks them."""
    chunk = plan.chunk
    n_chunks = -(-n_cols // chunk)
    out = []
    for s in range(plan.n_split):
        k_lo = s * plan.span
        k_end = min(k_lo + plan.span, n_chunks)
        out.append((k_lo * chunk, min(k_end * chunk, n_cols)
                    if k_end > k_lo else k_lo * chunk))
    return out


@pytest.mark.parametrize("kind", ["sum", "max", "min", "prod"])
@pytest.mark.parametrize("shape,axis,n_cols", [
    ((1, 1 << 20), 1, 1 << 20), ((1, 1 << 20), 1, 1000003),
    ((2, 300000), 1, 0), ((3, 65536, 8), 1, 40000), ((1, 9000), 1, 8999)])
def test_reduce_split_combines_in_a_fixed_order(kind, shape, axis, n_cols):
    """The few-rows split covers the valid columns once, and its partials
    combined as the kernel combines them (groups of ``SPLITS_AT_ONCE``,
    the groups in split order) give the plain version's result."""
    gen = torch.Generator().manual_seed(11)
    x = torch.rand(shape, generator=gen) * 0.02 + 0.99
    plan = cp.reduce_plan(shape, axis, cp.layouts([x], shape))
    if shape[axis] > 4 * plan.chunk:
        assert plan.n_split > 1
    ranges = _split_ranges(plan, n_cols)
    covered = torch.zeros(shape[axis], dtype=torch.int32)
    for lo, hi in ranges:
        covered[lo:hi] += 1
    assert torch.equal(covered[:n_cols], torch.ones(n_cols,
                                                    dtype=torch.int32))
    assert not covered[n_cols:].any()
    y = x.movedim(axis, -1).reshape(-1, shape[axis]).double()
    ident = REDUCE_IDENTITY[kind]
    red = {"sum": lambda v, d: v.sum(d), "max": lambda v, d: v.amax(d),
           "min": lambda v, d: v.amin(d), "prod": lambda v, d: v.prod(d)}
    parts = torch.stack([red[kind](y[:, lo:hi], -1) if hi > lo else
                         torch.full((y.shape[0],), ident, dtype=y.dtype)
                         for lo, hi in ranges])
    r = torch.full((y.shape[0],), ident, dtype=torch.float64)
    for j in range(0, len(ranges), fr_k.SPLITS_AT_ONCE):
        part = red[kind](parts[j:j + fr_k.SPLITS_AT_ONCE], 0)
        r = {"sum": r + part, "prod": r * part,
             "max": torch.maximum(r, part),
             "min": torch.minimum(r, part)}[kind]
    prog = _p(1, [("abs", (("in", 0),), F32)], [("t", 0)])
    want = fused_reduce_ref(prog, [x], n_cols, kind, axis, shape, F32)
    torch.testing.assert_close(r.float().reshape(want.shape), want,
                               rtol=1e-5, atol=1e-6)


def test_reduce_plan_constants_do_not_follow_rows():
    """A new bucket of rows at the same width keeps the compile-time
    constants (tile, unroll, warps, class): only the split and grid,
    runtime values, move."""
    keys = set()
    for rows in (64, 256, 1024, 2048):
        x = torch.zeros(rows, 2048)
        p = cp.reduce_plan((rows, 2048), 1, cp.layouts([x], (rows, 2048)))
        keys.add((p.mode, p.block_a, p.block_b, p.unroll, p.num_warps,
                  p.aligned, p.structure))
    assert len(keys) == 1


# --------------------------------------------- generated source, names --

RMS_APPLY = _p(3, [("div", (("in", 0), ("c", 2048.0)), F32),
                   ("add", (("t", 0), ("c", 1e-6)), F32),
                   ("rsqrt", (("t", 1),), F32),
                   ("mul", (("in", 1), ("t", 2)), F32),
                   ("mul", (("t", 3), ("in", 2)), F32)], [("t", 4)])
SQUARE = _p(1, [("mul", (("in", 0), ("in", 0)), F32)], [("t", 0)])


def _jit_args(src: str, fn: str):
    """(runtime args, do_not_specialize list, constexpr args) of ``fn``."""
    tree = ast.parse(src)
    f = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
             and n.name == fn)
    dns = next(kw.value for d in f.decorator_list if isinstance(d, ast.Call)
               for kw in d.keywords if kw.arg == "do_not_specialize")
    listed = [ast.literal_eval(e) for e in dns.elts]
    const = [a.arg for a in f.args.args if a.annotation is not None]
    plain = [a.arg for a in f.args.args if a.annotation is None]
    return plain, listed, const


@pytest.mark.parametrize("case", ["rms_apply", "softmax_div", "strided",
                                  "scalar", "two_outputs"])
def test_kloop_source_takes_every_length_at_run_time(case):
    gen = torch.Generator().manual_seed(5)
    progs = {
        "rms_apply": (RMS_APPLY, (1, 37, 2048), ("row", "dense", "col")),
        "softmax_div": (_p(2, [("div", (("in", 0), ("in", 1)), F32)],
                           [("t", 0)]), (1, 4, 8, 64, 64), ("dense", "row")),
        "strided": (_p(2, [("add", (("in", 0), ("in", 1)), F32)],
                       [("t", 0)]), (3, 4, 5), ("transposed", "dense")),
        "scalar": (_p(2, [("mul", (("in", 0), ("in", 1)), F32)],
                      [("t", 0)]), (6, 7), ("dense", "scalar")),
        "two_outputs": (_p(2, [("mul", (("in", 0), ("in", 1)), F32),
                               ("exp", (("t", 0),), F32)],
                           [("t", 1), ("t", 0)]), (4, 6), ("dense", "col")),
    }
    prog, shape, kinds = progs[case]
    xs = [_operand(k, shape, gen) for k in kinds]
    plan = cp.loop_plan(shape, cp.layouts(xs, shape), (4,) * len(prog.outs))
    src = fe_k._source(prog, plan)
    plain, listed, const = _jit_args(src, "kloop")
    runtime = [a for a in plain if not a.startswith(("in_", "out_"))]
    assert sorted(listed) == sorted(runtime)
    assert {"n_rows", "n_cols", "n_valid", "total"} <= set(listed)
    assert const == ["BR", "BC", "ALIGNED"]
    assert len(runtime) == 4 + len(plan.args())


@pytest.mark.parametrize("shape,axis,kinds", [((2048, 2048), 1, ("dense",)),
                                              ((5, 64, 96), 1, ("dense",)),
                                              ((6, 10), 1, ("transposed",)),
                                              ((24, 30), 1, ("row",))])
@pytest.mark.parametrize("kind", ["sum", "prod"])
def test_kinput_source_takes_every_length_at_run_time(shape, axis, kinds,
                                                      kind):
    gen = torch.Generator().manual_seed(6)
    xs = [_operand(k, shape, gen) for k in kinds]
    plan = cp.reduce_plan(shape, axis, cp.layouts(xs, shape))
    src = fr_k._source(SQUARE, plan, kind, F32)
    plain, listed, const = _jit_args(src, "kinput")
    # the valid column count is no argument's value: the program loads
    # it from device memory and clamps it into the padded extent
    runtime = [a for a in plain if a not in ("out", "ws", "tickets",
                                             "n_cols_ptr")
               and not a.startswith("in_")]
    assert "n_cols_ptr" in plain and "n_cols" not in plain
    assert "tl.minimum(tl.maximum(tl.load(n_cols_ptr), 0), n_red)" in src
    assert sorted(listed) == sorted(runtime)
    assert {"n_rows", "n_lanes", "n_red", "n_split", "span"} <= set(listed)
    assert const[-1] == "ALIGNED" and len(const) == 3
    assert len(runtime) == 5 + len(plan.args())


@pytest.mark.parametrize("lengths", [(37, 2048), (1999, 1500), (64, 256)])
def test_two_lengths_one_class_one_module(lengths):
    """Two lengths of one alignment class: one module name and one set of
    compile-time constants (so one Triton specialisation)."""
    gen = torch.Generator().manual_seed(8)
    names, consts = set(), set()
    for s in lengths:
        shape = (1, s, 2048)
        xs = [_operand(k, shape, gen) for k in ("row", "dense", "col")]
        plan = cp.loop_plan(shape, cp.layouts(xs, shape), (4,))
        names.add(fe_k.module_name(RMS_APPLY, plan))
        consts.add((plan.block_r, plan.block_c, plan.num_warps,
                    plan.aligned))
        x = torch.zeros(s, 2048)
        rp = cp.reduce_plan((s, 2048), 1, cp.layouts([x], (s, 2048)))
        names.add(fr_k.module_name(SQUARE, rp, "sum", F32))
        consts.add((rp.block_a, rp.block_b, rp.unroll, rp.aligned))
    assert len(names) == 2 and len(consts) == 2


# ------------------------------------------------ JAX parity, new cases --

def _jax():
    import jax.numpy as jnp
    from repro.kernels.fused_elementwise.ops import fused_elementwise
    from repro.kernels.fused_reduce.ops import fused_reduce

    return jnp, fused_elementwise, fused_reduce


@pytest.mark.parametrize("shape,n_valid", [((3, 17, 40), 3 * 17 * 40),
                                           ((2, 5, 96), 500)])
def test_per_row_by_per_column_matches_reference(shape, n_valid):
    """(x * row) * col + bias: per-row and per-column operands beside a
    dense one, ``n_valid`` inside a row."""
    jnp, jax_ew, _ = _jax()
    rs = np.random.RandomState(shape[-1])
    x = rs.standard_normal(shape).astype(np.float32)
    row = rs.standard_normal(shape[:-1] + (1,)).astype(np.float32)
    col = rs.standard_normal(shape[-1:]).astype(np.float32)
    prog = _p(3, [("mul", (("in", 0), ("in", 1)), F32),
                  ("mul", (("t", 0), ("in", 2)), F32),
                  ("add", (("t", 1), ("c", 0.25)), F32)], [("t", 2)])
    full = [np.ascontiguousarray(np.broadcast_to(a, shape))
            for a in (x, row, col)]
    want = jax_ew(lambda a, b, c: a * b * c + 0.25,
                  [jnp.asarray(a) for a in full], n_valid, [jnp.float32])
    got = ew_ops.fused_elementwise(
        prog, [torch.from_numpy(a) for a in (x, row, col)], n_valid, shape)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    assert not got[0].reshape(-1)[n_valid:].any()


@pytest.mark.parametrize("kind", ["sum", "max", "min", "prod"])
@pytest.mark.parametrize("shape,axis,n_cols", [((64, 48, 16), 1, 40),
                                               ((1, 6000), 1, 5999),
                                               ((6000,), 0, 4096)])
def test_new_reduce_structures_match_reference(kind, shape, axis, n_cols):
    """A non-last-axis reduce of many rows, and a one-row reduce."""
    jnp, _, jax_red = _jax()
    rs = np.random.RandomState(n_cols)
    x = (rs.standard_normal(shape) * 0.01 + 1.0).astype(np.float32)
    prog = _p(1, [("mul", (("in", 0), ("c", 1.0)), F32)], [("t", 0)])
    want = jax_red(lambda a: a * 1.0, [jnp.asarray(x)], n_cols, kind,
                   axis=axis)
    got = red_ops.fused_reduce(prog, [torch.from_numpy(x)], n_cols, kind,
                               axis=axis, shape=shape, out_dtype=F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    assert red_ops.LAUNCHES.launches == 0


# ------------------------------------------------------------ on card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Triton kernels run on the "
                    "card only")
    return torch.device("cuda")


def _card_operand(kind, shape, gen, dtype):
    x = _operand(kind, shape, gen, F32)
    return x.to(dtype).to("cuda") if kind not in ("transposed", "sliced",
                                                 "offset") else \
        _relayout(kind, x.to(dtype))


def _relayout(kind, x):
    """The same view layout rebuilt on the card."""
    if kind == "transposed":
        return x.transpose(-1, -2).contiguous().cuda().transpose(-1, -2)
    if kind == "sliced":
        base = torch.zeros(*x.shape[:-1], 2 * x.shape[-1], dtype=x.dtype,
                           device="cuda")
        base[..., ::2] = x.cuda()
        return base[..., ::2]
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype, device="cuda")
    flat[1:] = x.reshape(-1).cuda()
    return flat[1:].view(x.shape)


KLOOP_CARD = {
    # name: (program builder, shape, operand kinds, n_valid or None)
    "rms_apply": (lambda dt: RMS_APPLY, (1, 131, 2048),
                  ("row", "dense", "col"), None),
    "per_row": (lambda dt: _p(2, [("div", (("in", 0), ("in", 1)), F32)],
                              [("t", 0)]), (1, 4, 8, 64, 64),
                ("dense", "row"), None),
    "per_column": (lambda dt: _p(2, [("sub", (("in", 0), ("in", 1)), F32)],
                                 [("t", 0)]), (37, 2560), ("dense", "col"),
                   None),
    "two_outputs": (lambda dt: _p(2, [("mul", (("in", 0), ("in", 1)), F32),
                                      ("tanh", (("t", 0),), F32)],
                                  [("t", 1), ("t", 0)]), (9, 3584),
                    ("dense", "row"), None),
    "unaligned_view": (lambda dt: _p(2, [("add", (("in", 0), ("in", 1)),
                                          F32)], [("t", 0)]), (17, 2048),
                       ("offset", "dense"), None),
    "odd_width": (lambda dt: _p(3, [("mul", (("in", 0), ("in", 1)), F32),
                                    ("add", (("t", 0), ("in", 2)), F32)],
                                [("t", 1)]), (2, 5, 2047),
                  ("dense", "row", "col"), None),
    "n_valid_in_a_row": (lambda dt: RMS_APPLY, (1, 64, 2048),
                         ("row", "dense", "col"), 37 * 2048 + 1000),
    "below_one_tile": (lambda dt: _p(2, [("mul", (("in", 0), ("in", 1)),
                                          F32)], [("t", 0)]), (3, 5),
                       ("dense", "dense"), 11),
    "dense_4m": (lambda dt: _p(2, [("max", (("in", 0), ("in", 1)), F32)],
                               [("t", 0)]), (4 << 20,), ("dense", "dense"),
                 (4 << 20) - 5),
    "strided": (lambda dt: _p(2, [("add", (("in", 0), ("in", 1)), F32)],
                              [("t", 0)]), (3, 64, 48),
                ("transposed", "dense"), None),
    # IEEE division of subnormal numerators: kept, not flushed to zero
    "subnormal_div": (lambda dt: _p(2, [("div", (("in", 0), ("in", 1)),
                                         F32)], [("t", 0)]), (16, 2048),
                      ("subnormal", "row"), None),
}


def _retype(program: Program, dt) -> Program:
    return Program(tuple(dt if d == F32 else d for d in program.in_dtypes),
                   tuple(Step(s.opcode, s.args,
                              dt if s.dtype == F32 else s.dtype, s.param)
                         for s in program.steps), program.outs)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(KLOOP_CARD))
def test_kloop_tiles_match_plain_on_card(cuda, case, dtype):
    make, shape, kinds, n_valid = KLOOP_CARD[case]
    prog = _retype(make(dtype), dtype)
    gen = torch.Generator().manual_seed(sorted(KLOOP_CARD).index(case))
    xs = [_card_operand(k, shape, gen, dtype) for k in kinds]
    total = int(np.prod(shape))
    n_valid = total if n_valid is None else n_valid
    before = ew_ops.LAUNCHES.launches
    got = ew_ops.fused_elementwise(prog, xs, n_valid, shape)
    assert ew_ops.LAUNCHES.launches == before + 1
    want = fused_elementwise_ref(prog, xs, n_valid, shape)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and tuple(g.shape) == tuple(shape)
        # bit for bit (a NaN where the plain version has one)
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
        assert not g.reshape(-1)[n_valid:].any()


def _row_tol_ok(prog, xs, n_cols, kind, axis, shape, got, want, dtype):
    d = torch.where(got == want, 0.0, (got.float() - want.float()).abs())
    if kind in ("max", "min"):
        return d.max().item() == 0
    if kind == "sum":
        mag_prog = Program(prog.in_dtypes, prog.steps + (
            Step("abs", (prog.outs[0],), prog.dtype_of(prog.outs[0])),),
            (("t", len(prog.steps)),))
        mag = fused_reduce_ref(mag_prog, xs, n_cols, "sum", axis, shape, F32)
    else:
        mag = want.float().abs()
    return bool((d <= TOL_REDUCE_ROW[dtype] * mag + 1e-30).all())


KINPUT_CARD = [
    # (shape, axis, n_cols or None for the padded size, operand kinds)
    ((2048, 2048), 1, None, ("dense",)),
    ((64, 2048), 1, 1999, ("dense",)),
    ((1, 4 << 20), 1, None, ("dense",)),
    ((1, 4 << 20), 1, (4 << 20) - 77, ("dense",)),
    ((64, 512, 256), 1, 500, ("dense",)),
    ((4096, 96), 0, 4000, ("dense",)),
    ((3, 40, 16), 1, 0, ("dense",)),
    ((300, 2047), 1, 2040, ("dense",)),
    ((6, 1000), 1, None, ("transposed",)),
    ((6, 1000), 1, 990, ("transposed", "dense")),    # strided columns
    ((256, 96), 1, None, ("dense", "row")),          # a per-row operand
    ((64, 32, 128), 1, 30, ("dense", "mid")),        # lanes, one per lane
]


#: products of millions of f32 terms part by more than the row tolerance
#: between any two summation orders: prod runs on rows up to 4096
KINPUT_CARD_CASES = [(c, k) for c in range(len(KINPUT_CARD))
                     for k in ("sum", "max", "min", "prod")
                     if k != "prod" or KINPUT_CARD[c][0][KINPUT_CARD[c][1]]
                     <= 4096]


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case,kind", KINPUT_CARD_CASES)
def test_kinput_tiles_match_plain_on_card(cuda, case, kind, dtype):
    shape, axis, n_cols, kinds = KINPUT_CARD[case]
    n_cols = shape[axis] if n_cols is None else n_cols
    gen = torch.Generator().manual_seed(case)
    n = len(kinds)
    if kind == "prod":   # products near 1 stay finite over 4 M terms
        xs = [(_card_operand(k, shape, gen, F32) * 1e-4 + 1.0).to(dtype)
              for k in kinds]
        step = ("mul", (("in", 0), ("in", 1) if n == 2 else ("c", 1.0)),
                F32)
    else:
        xs = [_card_operand(k, shape, gen, dtype) for k in kinds]
        if kind == "sum":    # x * y, or x²
            step = ("mul", (("in", 0), ("in", n - 1)), F32)
        elif n == 2:         # x - y
            step = ("sub", (("in", 0), ("in", 1)), F32)
        else:                # -x
            step = ("neg", (("in", 0),), F32)
    prog = _retype(_p(len(kinds), [step], [("t", 0)]), dtype)
    before = red_ops.LAUNCHES.launches
    got = red_ops.fused_reduce(prog, xs, n_cols, kind, axis=axis,
                               shape=shape, out_dtype=dtype)
    again = red_ops.fused_reduce(prog, xs, n_cols, kind, axis=axis,
                                 shape=shape, out_dtype=dtype)
    assert red_ops.LAUNCHES.launches == before + 2
    want = fused_reduce_ref(prog, xs, n_cols, kind, axis, shape, dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # no float atomics: the same bits
    assert got.dtype == dtype and got.shape == want.shape
    if n_cols == 0:
        assert bool((got.float() == REDUCE_IDENTITY[kind]).all())
    assert _row_tol_ok(prog, xs, n_cols, kind, axis, shape, got, want,
                       dtype)
