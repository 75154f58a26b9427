"""The port's GEMM kernels (kDot and the §4.5 library) against the JAX
package's.

On the CPU the wrappers run the kernels' plain versions; they are held
against the JAX package's ``kernels/matmul/ops.py`` (Pallas in interpret
mode) on the same numpy inputs, with the same epilogue written both ways:
a closure for the reference, a :class:`Program` for the port.  f32 is held
to ``rtol=atol=1e-5`` (both contract in f32, in another order).  bf16 is
compared in f32 against max|ref|: the accumulator and every epilogue op
round to bf16 (2^-8 relative) in both, so a last-bit difference in the f32
sum can move a result by about two bf16 roundings, 8e-3 of max|ref|.

The CUDA kernels themselves need the card: those cases skip here and run
there, where JAX is not installed (``python -m pytest -q
tests/test_torch_matmul.py -k on_card``); the JAX package is imported by
the CPU cases only.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch.core.library import pick
from repro_torch.kernels.matmul import ops
from repro_torch.kernels.matmul.matmul import (KDOT_TILES, LIBRARY_TILES,
                                               TILES, WGMMA_BK, WGMMA_TILES,
                                               _tma_operand, ffma_operands,
                                               gemm_plan,
                                               gemm_splits,
                                               identity_program,
                                               kernel_source, split_chunk,
                                               tma_ready)
from repro_torch.kernels.matmul.ref import matmul_fused_ref, matmul_ref
from repro_torch.kernels.program import Program, Step

F32, BF16 = torch.float32, torch.bfloat16
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 8e-3
SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def _jax():
    import jax
    import jax.numpy as jnp
    from repro.kernels.matmul import ops as ref_ops

    return jax, jnp, ref_ops


def _programs(dt):
    """name -> (program over (acc, *extras), the same epilogue as a JAX
    closure, the extras' shapes as functions of (M, N))."""
    def p(n_extra, steps, outs):
        return Program((dt,) * (1 + n_extra),
                       tuple(Step(*s) for s in steps), tuple(outs))

    def gelu(acc, b):
        jax = _jax()[0]
        return jax.nn.gelu(acc + b, approximate=True)

    def residual(acc, r):
        jnp = _jax()[1]
        a = jnp.tanh(acc + r)
        return a, a * acc

    def silu_h(acc, h):
        jax = _jax()[0]
        return jax.nn.silu(acc) * h

    return {
        # jax.nn.gelu(approximate=True): x * 0.5 * (1 + tanh(c (x + a x^3)))
        "bias_gelu": (p(1, [("add", (("in", 0), ("in", 1)), dt),
                            ("integer_pow", (("t", 0),), dt, 3),
                            ("mul", (("c", 0.044715), ("t", 1)), dt),
                            ("add", (("t", 0), ("t", 2)), dt),
                            ("mul", (("c", SQRT_2_OVER_PI), ("t", 3)), dt),
                            ("tanh", (("t", 4),), dt),
                            ("add", (("c", 1.0), ("t", 5)), dt),
                            ("mul", (("c", 0.5), ("t", 6)), dt),
                            ("mul", (("t", 0), ("t", 7)), dt)],
                      [("t", 8)]),
                      gelu, [lambda m, n: (1, n)]),
        "residual_two_outputs": (p(1, [("add", (("in", 0), ("in", 1)), dt),
                                       ("tanh", (("t", 0),), dt),
                                       ("mul", (("t", 1), ("in", 0)), dt)],
                                   [("t", 1), ("t", 2)]),
                                 residual, [lambda m, n: (m, n)]),
        "silu_h": (p(1, [("logistic", (("in", 0),), dt),
                         ("mul", (("in", 0), ("t", 0)), dt),
                         ("mul", (("t", 1), ("in", 1)), dt)],
                     [("t", 2)]),
                   silu_h, [lambda m, n: (m, n)]),
    }


def _operands(m, k, n, extra_shapes, seed, scale=1.0):
    rs = np.random.RandomState(seed)
    a = rs.standard_normal((m, k)).astype(np.float32)
    b = (rs.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32) * scale
    extras = [rs.standard_normal(f(m, n)).astype(np.float32)
              for f in extra_shapes]
    return a, b, extras


# (M, K, N) padded sizes with the valid (M, N, K) below them: ragged tails
# on every axis, and a case whose sizes are block multiples
SHAPES = [((40, 70, 24), (33, 19, 61)),
          ((16, 128, 136), (16, 130, 101)),
          ((128, 256, 128), (100, 128, 256))]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape,valid", SHAPES)
@pytest.mark.parametrize("name", ["bias_gelu", "residual_two_outputs",
                                  "silu_h"])
def test_fused_plain_matches_reference(name, shape, valid, dtype):
    jax, jnp, ref_ops = _jax()
    dt = F32 if dtype == "f32" else BF16
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    program, closure, extra_shapes = _programs(dt)[name]
    m, k, n = shape
    a, b, extras = _operands(m, k, n, extra_shapes, seed=m * n + k)
    want = ref_ops.matmul_fused(
        jnp.asarray(a, jdt), jnp.asarray(b, jdt),
        [jnp.broadcast_to(jnp.asarray(x, jdt), (m, n)) for x in extras],
        closure, valid_mnk=valid, out_dtypes=[jdt] * len(program.outs),
        acc_dtype=jdt)
    got = ops.matmul_fused(
        torch.from_numpy(a).to(dt), torch.from_numpy(b).to(dt),
        [torch.from_numpy(x).to(dt) for x in extras], program,
        valid_mnk=valid, out_dtypes=program.out_dtypes)
    assert len(got) == len(want) == len(program.outs)
    vm, vn, _ = valid
    for g, w in zip(got, want):
        assert tuple(g.shape) == (m, n) and g.dtype == dt
        g32 = g.float().numpy()
        w32 = np.asarray(w, np.float32)
        if dtype == "f32":
            np.testing.assert_allclose(g32, w32, **TOL)
        else:
            assert np.abs(g32 - w32).max() <= BF16_REL * np.abs(w32).max()
        assert not g32[vm:].any() and not g32[:, vn:].any()  # zero tails
    assert ops.EPILOGUE_LAUNCHES.launches == 0  # the CPU runs no kernel


def test_k_tail_masks_both_operands():
    """Garbage (even inf) past valid K in either operand never reaches the
    contraction: the reference masks only ``a`` and relies on host
    padding of ``b``; the port masks both."""
    program = identity_program(F32)
    rs = np.random.RandomState(3)
    a = torch.from_numpy(rs.standard_normal((9, 12)).astype(np.float32))
    b = torch.from_numpy(rs.standard_normal((12, 5)).astype(np.float32))
    a[:, 10:] = float("inf")
    b[10:, :] = float("nan")
    (got,) = ops.matmul_fused(a, b, [], program, valid_mnk=(9, 5, 10),
                              out_dtypes=[F32])
    want = a[:, :10] @ b[:10, :]
    torch.testing.assert_close(got, want, **TOL)


VERSION_SHAPES = {"square_big": (256, 128, 256), "balanced": (128, 128, 128),
                  "skinny_m": (8, 128, 128), "skinny_n": (128, 128, 8),
                  "deep_k": (128, 512, 128)}


@pytest.mark.parametrize("version", sorted(VERSION_SHAPES))
def test_library_plain_matches_reference(version):
    _, jnp, ref_ops = _jax()
    m, k, n = VERSION_SHAPES[version]
    a, b, _ = _operands(m, k, n, [], seed=k)
    want = ref_ops.matmul(jnp.asarray(a), jnp.asarray(b), version=version)
    got = ops.matmul(torch.from_numpy(a), torch.from_numpy(b),
                     version=version)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert ops.LAUNCHES.launches == 0


def test_selection_and_pick_names_equal_reference():
    _, _, ref_ops = _jax()
    from repro.core.library import pick as ref_pick

    assert ops.GEMM_LIBRARY == ref_ops.GEMM_LIBRARY
    sizes = (8, 24, 32, 64, 128, 256, 512, 1000, 1024, 2048, 5632)
    for m in sizes:
        for k in sizes:
            for n in sizes:
                want = ref_ops.select_gemm_version(m, k, n)
                assert ops.select_gemm_version(m, k, n) == want
                name = ref_pick(m, k, n).name
                assert pick(m, k, n).name == (
                    "vendor:torch_matmul" if name == "vendor:xla_dot"
                    else name)


def test_pick_runs_the_chosen_entry_on_cpu():
    rs = np.random.RandomState(0)
    for m, k, n in ((8, 128, 128), (37, 64, 48)):
        a = torch.from_numpy(rs.standard_normal((m, k)).astype(np.float32))
        b = torch.from_numpy(rs.standard_normal((k, n)).astype(np.float32))
        torch.testing.assert_close(pick(m, k, n)(a, b), a @ b, **TOL)


def test_generated_source_covers_every_epilogue_rule():
    """Every op the CUDA epilogue generator knows, in f32 and bf16,
    generates (the CUDA compiler runs on the card only)."""
    from repro_torch.kernels.program import _BINARY_C, _UNARY_C

    for dt in (F32, BF16):
        steps = [Step(op, (("in", 0),), dt) for op in sorted(_UNARY_C)]
        steps += [Step(op, (("in", 0), ("in", 1)), dt)
                  for op in sorted(_BINARY_C)
                  if op not in ("and", "or", "eq", "ne", "lt", "gt", "le",
                                "ge")]
        steps += [Step("abs", (("in", 0),), dt),
                  Step("logistic", (("in", 0),), dt),
                  Step("div", (("in", 0), ("c", 3.0)), dt),
                  Step("gt", (("in", 0), ("c", 0.0)), torch.bool),
                  Step("not", (("t", len(steps) + 3),), torch.bool),
                  Step("select", (("t", len(steps) + 4), ("in", 0),
                                  ("in", 1)), dt),
                  Step("convert", (("in", 0),), F32, F32),
                  Step("integer_pow", (("in", 1),), dt, -2)]
        program = Program((dt, dt), tuple(steps),
                          tuple(("t", j) for j in range(len(steps))))
        name, src = kernel_source(program, dt, LIBRARY_TILES)
        body = ("disc::launch_gemm<" if dt == F32
                else "disc::launch_gemm_wgmma<")
        # f32: a 16-byte and an element-by-element instance a tile
        assert src.count(body) == len(LIBRARY_TILES) * (2 if dt == F32
                                                        else 1)
        assert "__fdiv_rn" in src and "fmaf" not in src
        assert name.startswith(f"gemm_{program.key}_")


# ------------------------------------------- launch plan and layouts --

@pytest.mark.parametrize("m_tiles,n_tiles,vk,bk", [
    (16, 22, 2048, 64), (16, 8, 5632, 64), (1, 22, 2048, 64),
    (1, 8, 5632, 64), (2, 2, 5632, 64), (4, 1, 2048, 64), (1, 16, 2048, 64),
    (8, 2, 2048, 64), (4, 4, 5632, 32), (1, 1, 999, 8), (1, 1, 64, 64),
    (1, 1, 1, 64), (3, 5, 0, 64), (0, 7, 2048, 64), (66, 1, 4096, 64),
    (67, 1, 4096, 64), (1, 1, 100000, 16)])
@pytest.mark.parametrize("sms", [132, 264])
def test_gemm_splits_fill_the_card_and_cover_k(m_tiles, n_tiles, vk, bk,
                                               sms):
    """Tiles x splits never exceed the SMs' slots and about fill them; 1
    where the tiles already fill half; every range whole K steps, none
    empty, together exactly [0, vk)."""
    splits = gemm_splits(m_tiles, n_tiles, vk, bk, sms)
    tiles = m_tiles * n_tiles
    k_steps = -(-vk // bk)
    assert splits >= 1
    if 2 * tiles > sms or tiles == 0 or k_steps <= 1:
        assert splits == 1
    else:
        assert tiles * splits <= sms
        # at least half the splits the card has room for (whole K steps
        # per range cost the rest)
        assert 2 * splits >= min(sms // tiles, k_steps)
    chunk = split_chunk(vk, bk, splits)
    assert chunk % bk == 0 and chunk > 0
    ranges = [(z * chunk, min(vk, (z + 1) * chunk)) for z in range(splits)]
    if vk:
        assert all(lo < hi for lo, hi in ranges)
        assert ranges[0][0] == 0 and ranges[-1][1] == vk
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert splits * chunk >= vk


@pytest.mark.parametrize("dtype", [F32, BF16, torch.float16])
def test_path_kdots_take_no_split(dtype):
    """Path 2's kDots at T = 1999 fill the card with their tiles alone;
    its smallest bucket (T = 37 of 64) splits K."""
    for vn, vk in ((5632, 2048), (2048, 5632)):
        plan = gemm_plan(dtype, "kdot", 1999, vn, vk)
        assert plan.splits == 1 and plan.kchunk >= vk
        small = gemm_plan(dtype, "kdot", 37, vn, vk)
        assert small.splits > 1
        assert plan.body == ("ffma" if dtype == F32 else "wgmma")


@pytest.mark.parametrize("tile", sorted(WGMMA_TILES))
def test_wgmma_tile_table(tile):
    """Every 16-bit tile is one wgmma body can run: BM a whole number of
    64-row warpgroups, BN a multiple of 8 (and of the 64-wide TMA box)
    up to 256, the ring within the 227 KB a block may use."""
    bm, bn, stages = WGMMA_TILES[tile]
    assert bm % 64 == 0 and bm // 64 == 2
    assert bn % 8 == 0 and bn % 64 == 0 and 64 <= bn <= 256
    assert stages >= 2
    ring = stages * (bm + bn) * WGMMA_BK * 2
    # the ring holds the tile's f32 accumulators (rows padded by 8) for
    # the epilogue; with 1 KB of alignment slack and two mbarriers a
    # stage it fits the 227 KB (232448 bytes) a block may use
    assert ring >= bm * (bn + 8) * 4
    assert ring + 1024 + 16 * stages <= 232448
    assert set(WGMMA_TILES) == set(TILES) == set(KDOT_TILES + LIBRARY_TILES)


def _check_ffma_tile(shape):
    """``shape`` (BM, BN, BK, TM, TN, STAGES, MINB) is one the FFMA body
    can run: whole warps of 4 x 8 lanes, at most 1024 threads; the ring
    (and the f32 tile the epilogue walks, which reuses it) within the
    227 KB a block may use, and MINB blocks' shared memory within the
    SM's 228 KB; MINB blocks' registers within the SM's 65536, with a
    thread's share holding its accumulators, two fragment buffers and its
    staged A chunks; K steps of whole 16-byte chunks (BK a multiple of 4)
    that the A swizzle covers; every thread loading the same number of
    16-byte chunks; the epilogue's walk a whole number of rows."""
    bm, bn, bk, tm, tn, stages, minb = shape
    threads = (bm // tm) * (bn // tn)
    smem = max(stages * bk * (bm + bn) * 4, bm * bn * 4)
    regs = min(255, 65536 // (threads * minb) // 8 * 8)
    assert tm % 4 == 0 and tn % 4 == 0
    assert bm % (4 * tm) == 0 and bn % (8 * tn) == 0
    assert threads % 32 == 0 and threads <= 1024
    assert bk % 4 == 0 and bk in (8, 16, 32) and bm in (32, 64, 128, 256)
    assert stages >= 2 and minb >= 1
    assert stages * bk * (bm + bn) * 4 <= smem <= 232448
    assert minb * (smem + 1024) <= 233472
    a_chunks, b_chunks = bm * bk // 4, bk * bn // 4
    assert a_chunks % threads == 0 and b_chunks % threads == 0
    need = tm * tn + 2 * (tm + tn) + 4 * (a_chunks // threads)
    assert need < regs and regs * threads * minb <= 65536
    assert threads % bn == 0 and bm % (threads // bn) == 0


@pytest.mark.parametrize("tile", sorted(TILES))
def test_ffma_tile_table(tile):
    """Every f32 tile is one the FFMA body can run
    (:func:`_check_ffma_tile`)."""
    _check_ffma_tile(TILES[tile])


def test_tune_candidates_are_runnable_tiles():
    """Every tile the tuning module times is one the FFMA body can run,
    and each tile name's first candidate is the one :data:`TILES`
    keeps."""
    from repro_torch.kernels.matmul.tune import CANDIDATES, SHAPES

    assert set(CANDIDATES) == set(TILES)
    assert {tile for tile, *_ in SHAPES.values()} == set(TILES)
    for tile, shapes in CANDIDATES.items():
        assert shapes[0] == TILES[tile] and len(set(shapes)) == len(shapes)
        for shape in shapes:
            _check_ffma_tile(shape)


@pytest.mark.parametrize("tile", sorted(TILES))
@pytest.mark.parametrize("valid", [(1999, 5632, 2048), (1999, 2048, 5632),
                                   (37, 5632, 2048), (37, 2048, 5632),
                                   (1024, 256, 2048), (32, 2048, 2048),
                                   (512, 32, 2048), (256, 256, 5632),
                                   (77, 131, 45), (5, 7, 3)])
def test_gemm_plan_ffma_blocks_per_sm(tile, valid):
    """The f32 plan fills MINB blocks an SM: the splits are
    :func:`gemm_splits` over the tile's MINB x SMs slots, in K steps of
    the tile's BK, and cover K."""
    bm, bn, bk, _, _, _, minb = TILES[tile]
    vm, vn, vk = valid
    plan = gemm_plan(F32, tile, vm, vn, vk)
    assert plan.body == "ffma" and plan.tile == TILES[tile] and plan.bk == bk
    assert plan.splits == gemm_splits(-(-vm // bm), -(-vn // bn), vk, bk,
                                      minb * 132)
    assert plan.kchunk % bk == 0 and plan.splits * plan.kchunk >= vk
    assert gemm_plan(F32, tile, vm, vn, vk, sms=66).splits == gemm_splits(
        -(-vm // bm), -(-vn // bn), vk, bk, minb * 66)


def _ffma_case(kind):
    """(a, b, whether the 16-byte instance reads both in place)."""
    big = torch.from_numpy(np.random.RandomState(9).standard_normal(
        (300, 208)).astype(np.float32))
    b = big[:64, :40]
    cases = {
        "aligned": lambda: (big[:, :64], b, True),
        "row_slice": lambda: (big[4:, :64], b, True),       # 832-B rows
        "col_offset_4": lambda: (big[:, 4:68], b, True),    # 16 B in
        "offset_by_one": lambda: (big.view(-1)[1:1 + 300 * 64]
                                  .view(300, 64), b, False),
        "col_offset_1": lambda: (big[:, 1:65], b, False),
        "transposed_a": lambda: (big[:64, :50].T, big[:64, :40], False),
        "transposed_b": lambda: (big[:, :64], big[:40, :64].T, False),
        "odd_row_stride": lambda: (big.view(-1)[:300 * 65].view(300, 65)
                                   [:, :64], b, False),
        "odd_row_stride_b": lambda: (big[:, :64], big.view(-1)[:64 * 43]
                                     .view(64, 43)[:, :40], False),
        "one_row": lambda: (big.view(-1)[1:65].view(1, 64), b, False),
        "one_row_aligned": lambda: (big[:1, :64], b, True),
        "one_column_b": lambda: (big[:, :64], big[:64, 8:9], True),
    }
    return cases[kind]()


@pytest.mark.parametrize("kind", ["aligned", "row_slice", "col_offset_4",
                                  "offset_by_one", "col_offset_1",
                                  "transposed_a", "transposed_b",
                                  "odd_row_stride", "odd_row_stride_b",
                                  "one_row", "one_row_aligned",
                                  "one_column_b"])
def test_ffma_instance_choice(kind):
    """The f32 wrapper's choice, without a card: the 16-byte instance
    where both operands are K- / N-contiguous, 16-byte aligned, with
    rows a multiple of 4 floats apart; else the element-by-element one
    over the operands' own strides, with no copy.  An axis of extent 1
    is never stepped, so its stride is given as 0 (rows) or 1
    (columns)."""
    a, b, ready = _ffma_case(kind)
    vec, sa, sb = ffma_operands(a, b)
    assert vec == ready
    for t, s in ((a, sa), (b, sb)):
        rows, cols = t.shape
        assert s == (t.stride(0) if rows > 1 else 0,
                     t.stride(1) if cols > 1 else 1)
        if vec:
            assert s[1] == 1 and s[0] % 4 == 0 and t.data_ptr() % 16 == 0


def _rand(shape, dtype=BF16):
    rs = np.random.RandomState(sum(shape))
    return torch.from_numpy(rs.standard_normal(shape).astype(np.float32)
                            ).to(dtype)


def _view(kind):
    """(tensor, whether the wgmma body reads it in place)."""
    base = _rand((300, 208))
    cases = {
        "contiguous": lambda: (base, True),
        "row_slice": lambda: (base[8:], True),                # 416-B rows
        "col_slice_aligned": lambda: (base[:, 8:100], True),  # 16 B in
        "col_slice_misaligned": lambda: (base[:, 3:100], False),
        "transposed": lambda: (base.T, False),
        "odd_rows": lambda: (_rand((150, 45)), False),        # 90-B rows
        "stride_300_bytes": lambda: (_rand((150, 150))[:, :100], False),
        "one_row": lambda: (_rand((1, 45)), True),
        "one_column": lambda: (base[:, 8:9], True),
        "broadcast_rows": lambda: (_rand((1, 64)).expand(5, 64), False),
        "f16_contiguous": lambda: (_rand((7, 24), torch.float16), True),
    }
    return cases[kind]()


@pytest.mark.parametrize("kind", ["contiguous", "row_slice",
                                  "col_slice_aligned",
                                  "col_slice_misaligned", "transposed",
                                  "odd_rows", "stride_300_bytes", "one_row",
                                  "one_column", "broadcast_rows",
                                  "f16_contiguous"])
def test_layout_rule_and_operand_copy(kind):
    """Which layouts the wgmma body's TMA reads in place, and the copy it
    makes (and counts) of the others: same values, a layout it reads."""
    t, ready = _view(kind)
    assert tma_ready(t.shape, t.stride(), t.data_ptr(),
                     t.element_size()) == ready
    before = ops.OPERAND_COPIES.launches
    got, ld = _tma_operand(t)
    assert ops.OPERAND_COPIES.launches == before + (not ready)
    assert (got is t) == ready
    assert torch.equal(got, t)
    assert tma_ready(got.shape, (ld, 1), got.data_ptr(), got.element_size())
    assert ld * got.element_size() % 16 == 0 and ld >= got.shape[1]


@pytest.mark.parametrize("dtype", [F32, BF16, torch.float16])
@pytest.mark.parametrize("group", [KDOT_TILES, LIBRARY_TILES])
def test_kernel_source_instantiates_the_body_per_dtype(dtype, group):
    """16-bit operands instantiate the wgmma body at every tile of the
    library, f32 the FFMA body twice a tile (the 16-byte instance at case
    2t, the element-by-element one at 2t + 1); the mma.sync body is
    gone."""
    name, src = kernel_source(identity_program(dtype), dtype, group)
    for t, tile in enumerate(group):
        if dtype == F32:
            shape = ", ".join(map(str, TILES[tile]))
            cases = {2 * t: f"disc::launch_gemm<{shape}, true>",
                     2 * t + 1: f"disc::launch_gemm<{shape}, false>"}
        else:
            bm, bn, stages = WGMMA_TILES[tile]
            cases = {t: f"disc::launch_gemm_wgmma<{bm}, {bn}, {stages}>"}
        for case, want in cases.items():
            assert (f"case {case}: return (int){want}(A, B, g, epi, ws, s);"
                    in src)
    assert "launch_gemm_mma" not in src and "fmaf" not in src
    assert "g.splits = (int)dims[10]; g.kchunk = (int)dims[11];" in src
    assert name.endswith("-".join(group))


# ------------------------------------------------------------ on card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run on the card "
                    "only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


F16 = torch.float16
CARD_DTYPES = [F32, BF16, F16]


def _tol(dtype) -> float:
    return 1e-5 if dtype == F32 else BF16_REL


@pytest.mark.parametrize("dtype", CARD_DTYPES)
@pytest.mark.parametrize("name", ["bias_gelu", "residual_two_outputs",
                                  "silu_h"])
def test_kdot_kernel_matches_plain_on_card(cuda, name, dtype):
    """M, N, K multiples of no tile, valid extents below them."""
    from repro_torch.kernels.matmul.matmul import matmul_epilogue_kernel

    program, _, extra_shapes = _programs(dtype)[name]
    m, k, n = 300, 1000, 520
    valid = (291, 517, 999)
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    b = (torch.randn((k, n), generator=gen, device=cuda) / 32).to(dtype)
    extras = [torch.randn(f(m, n), generator=gen, device=cuda).to(dtype)
              for f in extra_shapes]
    before = ops.OPERAND_COPIES.launches
    got = matmul_epilogue_kernel(a, b, extras, program, valid,
                                 program.out_dtypes)
    want = matmul_fused_ref(a, b, extras, program, valid,
                            program.out_dtypes)
    torch.cuda.synchronize()
    assert ops.OPERAND_COPIES.launches == before  # read in place
    for g, w in zip(got, want):
        assert _rel(g, w) <= _tol(dtype)
        assert not g[valid[0]:].any() and not g[:, valid[1]:].any()


@pytest.mark.parametrize("dtype", CARD_DTYPES)
def test_broadcast_extras_on_card(cuda, dtype):
    """Extras read in place through stride-0 views: a row (1, N), a
    column (M, 1) and a scalar (1, 1)."""
    from repro_torch.kernels.matmul.matmul import matmul_epilogue_kernel

    program = Program((dtype,) * 4, (
        Step("add", (("in", 0), ("in", 1)), dtype),
        Step("mul", (("t", 0), ("in", 2)), dtype),
        Step("sub", (("t", 1), ("in", 3)), dtype)), (("t", 2),))
    m, k, n = 200, 384, 264
    valid = (190, 260, 384)
    gen = torch.Generator(device=cuda).manual_seed(4)
    a = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    b = (torch.randn((k, n), generator=gen, device=cuda) / 16).to(dtype)
    extras = [torch.randn(shape, generator=gen, device=cuda).to(dtype)
              for shape in ((1, n), (m, 1), (1, 1))]
    (got,) = matmul_epilogue_kernel(a, b, extras, program, valid, [dtype])
    (want,) = matmul_fused_ref(a, b, extras, program, valid, [dtype])
    torch.cuda.synchronize()
    assert _rel(got, want) <= _tol(dtype)
    assert not got[valid[0]:].any() and not got[:, valid[1]:].any()


@pytest.mark.parametrize("dtype", CARD_DTYPES)
@pytest.mark.parametrize("version", sorted(VERSION_SHAPES))
def test_library_kernel_matches_plain_on_card(cuda, version, dtype):
    m, k, n = VERSION_SHAPES[version]
    gen = torch.Generator(device=cuda).manual_seed(1)
    a = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    b = torch.randn((k, n), generator=gen, device=cuda).to(dtype)
    before = ops.LAUNCHES.launches
    got = ops.matmul(a, b, version=version)
    want = matmul_ref(a, b)
    torch.cuda.synchronize()
    assert ops.LAUNCHES.launches == before + 1
    assert got.dtype == dtype
    assert _rel(got, want) <= _tol(dtype)


@pytest.mark.parametrize("dtype", CARD_DTYPES)
def test_every_tile_masks_a_ragged_edge_on_card(cuda, dtype):
    from repro_torch.kernels.matmul.matmul import matmul_kernel

    gen = torch.Generator(device=cuda).manual_seed(2)
    a = torch.randn((77, 45), generator=gen, device=cuda).to(dtype)
    b = torch.randn((45, 131), generator=gen, device=cuda).to(dtype)
    for tile in LIBRARY_TILES:
        got = matmul_kernel(a, b, tile)
        if dtype == F32:
            torch.testing.assert_close(got, a @ b, **TOL)
        else:
            assert _rel(got, matmul_ref(a, b)) <= _tol(dtype)


@pytest.mark.parametrize("dtype", CARD_DTYPES)
def test_strided_operands_and_empty_k_on_card(cuda, dtype):
    """Transposed views and views with a 300-byte row stride: the FFMA
    body reads them through their strides, the wgmma body copies each
    once (counted).  A valid K of 0 leaves the epilogue over a zero
    accumulator; a valid M or N of 0 leaves all zeros (no tensor map is
    encoded, no operand copied)."""
    from repro_torch.kernels.matmul.matmul import matmul_epilogue_kernel

    gen = torch.Generator(device=cuda).manual_seed(3)
    m, n = 150, 90
    operands = {
        # A's K axis and B's N axis 150 elements apart: 300 bytes in bf16
        "transposed": (
            torch.randn((200, m), generator=gen, device=cuda).to(dtype).T,
            torch.randn((n, 200), generator=gen, device=cuda).to(dtype).T),
        # unit stride, rows 150 elements (300 bytes in bf16) apart
        "row_stride": (
            torch.randn((m, 150), generator=gen, device=cuda).to(dtype)
            [:, :100],
            torch.randn((100, 150), generator=gen, device=cuda).to(dtype)
            [:, :n]),
    }
    program = identity_program(dtype)
    for kind, (a, b) in operands.items():
        k = a.shape[1]
        for valid in ((147, 85, k - 7), (150, 90, 0), (0, 90, k),
                      (150, 0, k)):
            before = ops.OPERAND_COPIES.launches
            (got,) = matmul_epilogue_kernel(a, b, [], program, valid,
                                            [dtype])
            (want,) = matmul_fused_ref(a, b, [], program, valid, [dtype])
            torch.cuda.synchronize()
            copies = ops.OPERAND_COPIES.launches - before
            assert copies == (2 if dtype != F32 and min(valid) > 0 else 0)
            if min(valid):
                assert _rel(got, want) <= _tol(dtype)
            else:
                assert not got.any()
            assert not got[valid[0]:].any() and not got[:, valid[1]:].any()


@pytest.mark.parametrize("dtype", CARD_DTYPES)
def test_split_k_is_deterministic_on_card(cuda, dtype):
    """Path 2's smallest bucket (T = 37 of 64) splits K: the partials'
    fixed-order sum gives the same bits on every launch."""
    from repro_torch.kernels.matmul.matmul import matmul_epilogue_kernel

    program = _programs(dtype)["silu_h"][0]
    m, k, n = 64, 2048, 5632
    valid = (37, n, k)
    assert gemm_plan(dtype, "kdot", *valid).splits > 1
    gen = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    b = (torch.randn((k, n), generator=gen, device=cuda) / 32).to(dtype)
    h = torch.randn((m, n), generator=gen, device=cuda).to(dtype)
    (one,) = matmul_epilogue_kernel(a, b, [h], program, valid, [dtype])
    (two,) = matmul_epilogue_kernel(a, b, [h], program, valid, [dtype])
    (want,) = matmul_fused_ref(a, b, [h], program, valid, [dtype])
    torch.cuda.synchronize()
    assert torch.equal(one, two)
    assert _rel(one, want) <= _tol(dtype)
    assert not one[valid[0]:].any()


@pytest.mark.parametrize("dtype", CARD_DTYPES)
def test_more_tiles_than_sms_on_card(cuda, dtype):
    """More output tiles than SMs: the 16-bit body's blocks walk several
    tiles each and hand all but their last to the epilogue warps; ragged
    valid extents on every axis, one extra read in place."""
    from repro_torch.kernels.matmul.matmul import matmul_epilogue_kernel

    program = _programs(dtype)["silu_h"][0]
    m, k, n = 2176, 320, 4100
    valid = (2100, 4097, 317)
    gen = torch.Generator(device=cuda).manual_seed(6)
    a = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    b = (torch.randn((k, n), generator=gen, device=cuda) / 16).to(dtype)
    h = torch.randn((m, n), generator=gen, device=cuda).to(dtype)
    (got,) = matmul_epilogue_kernel(a, b, [h], program, valid, [dtype])
    (want,) = matmul_fused_ref(a, b, [h], program, valid, [dtype])
    torch.cuda.synchronize()
    assert _rel(got, want) <= _tol(dtype)
    assert not got[valid[0]:].any() and not got[:, valid[1]:].any()


FFMA_CARD_CASES = ["storage_offset_1", "row_stride_not_4",
                   "k_tail_below_bk", "interior_and_edge_blocks"]


def _ffma_card_operands(kind, dev):
    """(a, b, valid (M, N, K), whether the 16-byte instance runs)."""
    gen = torch.Generator(device=dev).manual_seed(10)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    if kind == "storage_offset_1":      # both start 4 bytes past 16
        m, k, n = 150, 200, 136
        a = rnd(m * k + 1)[1:].view(m, k)
        b = (rnd(k * n + 1) / 16)[1:].view(k, n)
        return a, b, (147, 130, 197), False
    if kind == "row_stride_not_4":      # rows 203 and 141 floats apart
        m, k, n = 150, 200, 136
        return rnd(m, k + 3)[:, :k], (rnd(k, n + 5) / 16)[:, :n], \
            (150, 136, 200), False
    if kind == "k_tail_below_bk":       # K = 7: one partial 16-byte chunk
        return rnd(140, 8)[:, :7], rnd(7, 136), (133, 136, 7), True
    # 128 x 128 (and 64 x 64) tiles inside (vm, vn), on its edge and past
    # it; a K tail of 997 % 16 = 5 (997 % 4 = 1)
    return rnd(700, 1000), (rnd(1000, 652) / 32)[:, :650], \
        (650, 600, 997), True


@pytest.mark.parametrize("tile", ["kdot", "balanced"])
@pytest.mark.parametrize("kind", FFMA_CARD_CASES)
def test_ffma_layouts_and_edges_on_card(cuda, kind, tile):
    """The f32 body on an operand at storage offset 1, on row strides
    that are no multiple of 4 (both on the element-by-element instance,
    counted, nothing copied), on K % 4 != 0 with K < BK, and on a grid
    of interior, edge and idle blocks (both on the 16-byte instance):
    the silu·h kDot and the empty epilogue against their plain versions
    at rtol = atol = 1e-5, tails exactly zero."""
    from repro_torch.kernels.matmul.matmul import matmul_epilogue_kernel

    a, b, valid, vec = _ffma_card_operands(kind, cuda)
    assert ffma_operands(a, b)[0] == vec
    m, n = a.shape[0], b.shape[1]
    h = torch.randn((m, n), generator=torch.Generator(device=cuda)
                    .manual_seed(11), device=cuda)
    for program, extras in ((_programs(F32)["silu_h"][0], [h]),
                            (identity_program(F32), [])):
        scalar = ops.FFMA_SCALAR_LAUNCHES.launches
        copies = ops.OPERAND_COPIES.launches
        (got,) = matmul_epilogue_kernel(a, b, extras, program, valid, [F32],
                                        tile=tile)
        (want,) = matmul_fused_ref(a, b, extras, program, valid, [F32])
        torch.cuda.synchronize()
        assert ops.FFMA_SCALAR_LAUNCHES.launches == scalar + (not vec)
        assert ops.OPERAND_COPIES.launches == copies
        torch.testing.assert_close(got, want, **TOL)
        assert not got[valid[0]:].any() and not got[:, valid[1]:].any()
    vm, vn, vk = valid
    torch.testing.assert_close(
        got[:vm, :vn], matmul_ref(a[:vm, :vk], b[:vk, :vn]), **TOL)
