"""The port's RMSNorm and LayerNorm kernels (CUDA C++): their plan, their
arithmetic, their wrappers' checks, and the kernels on the card.

* **Plan** (``row_norm.norm_plan``, CPU): at every width from 1 to 9000
  and the models' widths, for 2- and 4-byte types, rows that are and are
  not 16-byte readable, and decode and prefill row counts: 16-byte chunks
  only where the width allows them, the row's units covered exactly once
  (only the last chunk partial), chunks and values a thread within the
  register instances' limits (else the loop instance), rows a block x
  the group = the threads, a multiple of 32, and a grid that covers the
  rows or fills the card with groups that walk them; 4 decode rows get a
  grid sized to the rows.
* **Summation order** (CPU): a check of the order alone, not of the
  kernel, which runs only on the card.  The kernels' order of sums,
  emulated in f32 from the plan in PyTorch (each thread's chunks in
  order, the warp butterfly, the second level over a group's warps, the
  f32 1/D, the products in the plain version's order), stays within the
  tolerance of the plain versions, which the JAX package's Pallas kernels
  already hold (``tests/test_torch_attention.py``,
  ``tests/test_torch_rwkv.py``).  Tolerance: 1e-5 of max|ref| in f32,
  one bf16 rounding (8e-3) in bf16.  The card cases hold the kernel
  itself at the same widths.
* **Card cases** (``-k on_card``; they skip without CUDA): each kernel
  against its plain version on the same card inputs through
  ``plain_versions()``, at the models' widths, an odd one and those of
  the summation-order check (96; 4097 and 20000, the loop instance), on
  row
  views with a stride larger than D and on rows that are not 16-byte
  aligned, in f16 (RMSNorm) and with 16-bit weights, at 0, 1 and 20000
  rows (more rows than the grid holds groups, so the groups walk), and on
  rows too wide for registers (the loop instance); one launch a call.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import row_norm, select
from repro_torch.kernels.layernorm import ops as ln_ops
from repro_torch.kernels.layernorm.layernorm import layernorm_kernel
from repro_torch.kernels.layernorm.ref import layernorm_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_kernel

#: the models' widths: TinyLlama / DBRX / Zamba2 RMSNorm, RWKV-6 LayerNorm
MODEL_WIDTHS = (2048, 2560, 3584, 6144)
SMS = 132

# ------------------------------------------------------------ the plan --


def _check_plan(p, n_rows, d, elt, wide, layernorm=False):
    step = 16 // elt
    assert p.vec == (step if wide and d % step == 0 else 1)
    units = -(-d // p.vec)
    assert p.threads == p.rows * p.group and p.threads <= 512
    assert p.threads % 32 == 0
    assert p.group & (p.group - 1) == 0
    if p.loop:
        # a row wider than registers hold: a block of 512 a row
        assert (p.group, p.rows, p.threads) == (512, 1, 512)
        assert -(-units // 512) > row_norm.MAX_CHUNKS or \
            p.vec * -(-units // 512) > row_norm.MAX_ELEMS[layernorm]
        assert p.chunks * 512 >= units > (p.chunks - 1) * 512
        assert p.grid == max(1, min(n_rows, SMS * 4))
        assert p.walk == (p.grid < n_rows)
        return
    # the units covered exactly once: lane + j * G for j < chunks, only
    # the last chunk partial
    assert p.chunks * p.group >= units > (p.chunks - 1) * p.group
    owned = np.add.outer(np.arange(p.chunks) * p.group,
                         np.arange(p.group)).ravel()
    owned = owned[owned < units]
    assert np.array_equal(np.sort(owned), np.arange(units))
    assert 1 <= p.chunks <= row_norm.MAX_CHUNKS
    assert p.vec * p.chunks <= row_norm.MAX_ELEMS[layernorm]
    # the grid covers the rows, or stops at the card's share and the
    # groups walk: every group takes the same number of rows but the last
    blocks = max(1, -(-n_rows // p.rows))
    sm_threads = min(2048, max(512, 8 * p.group))
    cap = SMS * max(1, sm_threads // p.threads)
    assert p.grid <= min(blocks, cap)
    walk = -(-blocks // p.grid)
    assert p.grid * walk >= blocks and (p.grid - 1) * walk < blocks
    assert p.walk == (walk > 1) == (p.grid * p.rows < n_rows)


@pytest.mark.parametrize("layernorm", [False, True])
@pytest.mark.parametrize("n_rows", [1, 4, 2048, 20000])
@pytest.mark.parametrize("wide", [True, False])
@pytest.mark.parametrize("elt", [2, 4])
def test_norm_plan_covers_every_width(elt, wide, n_rows, layernorm):
    for d in list(range(1, 9001)) + list(MODEL_WIDTHS) + [16384, 20000]:
        _check_plan(row_norm.norm_plan(n_rows, d, elt, wide, SMS,
                                       layernorm=layernorm),
                    n_rows, d, elt, wide, layernorm)


@pytest.mark.parametrize("elt", [2, 4])
@pytest.mark.parametrize("d", MODEL_WIDTHS)
@pytest.mark.parametrize("layernorm", [False, True])
def test_norm_plan_at_model_widths(d, elt, layernorm):
    """Decode (4 rows): a grid sized to the rows, no group walks, two
    chunks a thread (more where 256 threads would not hold the row).  A
    2048-token prefill: the row at its exact width in 16-byte chunks, in
    registers, four chunks a thread (or more, at 256 threads), and a grid
    of 8 groups an SM whose groups walk the rows."""
    limit = min(8, row_norm.MAX_ELEMS[layernorm] * elt // 16)
    units = d * elt // 16

    def narrowest(p, target):   # no narrower group holds the row
        return p.chunks <= target and (
            p.group == 1 or -(-units // (p.group // 2)) > target)

    for n_rows, target in ((4, row_norm.DECODE_CHUNKS),
                           (2048, row_norm.PREFILL_CHUNKS)):
        p = row_norm.norm_plan(n_rows, d, elt, True, SMS,
                               layernorm=layernorm)
        assert p.vec == 16 // elt and not p.loop
        assert p.group <= row_norm.GROUP_CAP
        assert narrowest(p, min(target, limit)) or (
            p.group == row_norm.GROUP_CAP and p.chunks <= limit)
        if n_rows == 4:
            assert p.grid == -(-4 // p.rows) and not p.walk
        else:
            assert p.walk and p.grid * p.rows <= SMS * 8
    # more rows than the grid holds groups: each group walks
    many = row_norm.norm_plan(20000, d, elt, True, SMS, layernorm=layernorm)
    assert many.grid * many.rows < 20000


def test_norm_plan_exact_width():
    """RWKV-6's 2560 in bf16 is 320 units of 8, covered without a padded
    power-of-two block (the Triton kernel masked 4096)."""
    p = row_norm.norm_plan(2048, 2560, 2, True, SMS)
    assert p.vec == 8 and (p.chunks - 1) * p.group < 320 <= \
        p.chunks * p.group
    # not 16-byte readable: one column a chunk, no copy
    q = row_norm.norm_plan(2048, 2560, 2, False, SMS)
    assert q.vec == 1 and not q.loop


def test_launch_word_packs_the_plan():
    p = row_norm.norm_plan(2048, 2560, 2, True, SMS)
    word = row_norm.launch_word(p, 1, 0, 2)
    assert word & 3 == 1 and (word >> 2) & 3 == 0 and (word >> 4) & 3 == 2
    assert (word >> 6) & 1 == 1 and (word >> 7) & 1 == 0
    assert (word >> 8) & 15 == p.chunks
    assert 1 << ((word >> 12) & 15) == p.group
    assert (word >> 16) & 255 == p.rows
    assert (word >> 26) & 1 == p.walk == 1      # 2048 rows: groups walk
    assert row_norm.launch_word(row_norm.norm_plan(
        4, 2560, 2, True, SMS), 1, 0) >> 26 & 1 == 0
    loop = row_norm.norm_plan(3, 20000, 4, False, SMS)
    word = row_norm.launch_word(loop, 0, 0)
    assert loop.loop and (word >> 7) & 1 and (word >> 6) & 1 == 0
    assert 1 << ((word >> 12) & 15) == 512


# ----------------------------------------------------- the arithmetic --

def _group_sum(s: torch.Tensor) -> torch.Tensor:
    """The kernel's group_sum over the last axis (G lanes, f32): the warp
    butterfly, then for several warps the second butterfly over the
    warps' sums; lane 0's result."""
    g = s.shape[-1]
    lanes = torch.arange(g)
    for off in (16, 8, 4, 2, 1):
        if off < g:
            s = s + s[..., lanes ^ off]
    if g > 32:
        per_row = g // 32
        warps = s[..., ::32]                       # (R, per_row)
        v = warps[..., torch.arange(32) & (per_row - 1)]
        for off in (8, 4, 2, 1):
            if off < per_row:
                v = v + v[..., torch.arange(32) ^ off]
        return v[..., 0]
    return s[..., 0]


def _tree(vals):
    if len(vals) == 1:
        return vals[0]
    h = len(vals) // 2
    return _tree(vals[:h]) + _tree(vals[h:])


def _emulate(kind, x, w, b, eps, plan):
    """The kernel's arithmetic on the CPU for rows x (R, D) under
    ``plan``: thread i of a group holds units i, i + G, ... (VEC columns
    each), sums its values as a pairwise tree (the loop instance: a
    running sum over its passes), then the group reduces."""
    r_, d = x.shape
    g = plan.group
    units = -(-d // plan.vec)
    n_ch = -(-units // g)   # the loop instance: its loads a pass
    v = x.float()
    inv_d = torch.tensor(np.float32(1) / np.float32(d))

    def thread_sums(term):
        vals = []   # the thread's values in (chunk, column) order, 0 past D
        for j in range(n_ch):
            for e in range(plan.vec):
                cols = (torch.arange(g) + j * g) * plan.vec + e
                ok = cols < d
                t = torch.zeros((r_, g), dtype=torch.float32)
                t[:, ok] = term[:, cols[ok]]
                vals.append(t)
        if plan.loop:               # a running sum over the passes
            s = vals[0]
            for t in vals[1:]:
                s = s + t
        else:                       # a pairwise tree (csrc TreeSum)
            s = _tree(vals)
        return _group_sum(s)

    if kind == "layernorm":
        mu = (thread_sums(v) * inv_d)[:, None]
        c = v - mu
        var = thread_sums(c * c) * inv_d
        r = torch.rsqrt(var + np.float32(eps))[:, None]
        y = c * r * w.float() + b.float()
    else:
        ms = thread_sums(v * v) * inv_d
        r = torch.rsqrt(ms + np.float32(eps))[:, None]
        y = v * r * w.float()
    return y.to(x.dtype)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,rows", [(2560, 6), (2048, 3), (2561, 3),
                                    (96, 5), (20000, 2), (4097, 2)])
def test_kernel_arithmetic_matches_plain(kind, dtype, d, rows):
    """The kernels' summation order, emulated on the CPU (the kernel
    itself is held at these widths by test_norm_kernel_widths_on_card)."""
    rs = np.random.RandomState(d + rows)
    off = 3.0 if kind == "layernorm" else 0.0
    x = torch.from_numpy((rs.standard_normal((rows, d)) + off)
                         .astype(np.float32)).to(dtype)
    w = torch.from_numpy((1 + 0.1 * rs.standard_normal(d))
                         .astype(np.float32))
    b = torch.from_numpy((0.1 * rs.standard_normal(d)).astype(np.float32))
    elt = x.element_size()
    wide = d % (16 // elt) == 0
    for n_rows in (rows, 2048):     # the decode and the prefill plan
        plan = row_norm.norm_plan(n_rows, d, elt, wide, SMS,
                                  layernorm=kind == "layernorm")
        if kind == "layernorm":
            got = _emulate(kind, x, w, b, 1e-5, plan)
            want = layernorm_ref(x, w, b, 1e-5)
        else:
            got = _emulate(kind, x, w, None, 1e-6, plan)
            want = rmsnorm_ref(x, w, 1e-6)
        rel = ((got.float() - want.float()).abs().max()
               / want.float().abs().max()).item()
        assert rel <= (1e-5 if dtype == torch.float32 else 8e-3), \
            (n_rows, plan)


# ----------------------------------------------------- wrapper checks --

def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.ones(3, 8)
    with pytest.raises(ValueError, match="weight"):
        rmsnorm_kernel(x, torch.ones(7))
    with pytest.raises(TypeError):
        rmsnorm_kernel(x.to(torch.int32), torch.ones(8))
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_kernel(x, torch.ones(8))
    with pytest.raises(ValueError, match="scale"):
        layernorm_kernel(x, torch.ones(8), torch.ones(7))
    with pytest.raises(TypeError):
        layernorm_kernel(x.half(), torch.ones(8), torch.ones(8))
    with pytest.raises(ValueError, match="CUDA"):
        layernorm_kernel(x, torch.ones(8), torch.ones(8))


def test_weight_path_takes_whole_chunks_only_where_it_may():
    """An aligned f32 weight (and bias), as every model has, is read in
    whole chunks for 16-byte rows; anything else (a 16-bit weight or bias,
    an unaligned one, rows read a column a chunk) an element a load."""
    wide = row_norm.launch_word(row_norm.norm_plan(8, 64, 2, True, SMS),
                                1, 0)
    narrow = row_norm.launch_word(row_norm.norm_plan(8, 64, 2, False, SMS),
                                  1, 0)
    w32 = torch.ones(80)
    w16 = torch.ones(80, dtype=torch.bfloat16)
    assert w32.data_ptr() % 16 == 0 and w16.data_ptr() % 16 == 0
    path = row_norm._weight_path
    assert path(wide, (1, 0, 0), w32[:64], None) == 0
    assert path(wide, (1, 0, 0), w32[:64], w32[8:72]) == 0
    assert path(wide, (0, 0, 0), w32[:64], None) == 0     # f32 x
    assert path(wide, (1, 1, 0), w16[:64], None) == 1     # x's type
    assert path(wide, (1, 1, 1), w16[:64], w16[8:72]) == 1
    assert path(wide, (1, 0, 1), w32[:64], w16[:64]) == 1
    assert path(wide, (1, 2, 0), w16[:64], None) == 1     # f16 w, bf16 x
    assert path(wide, (1, 0, 0), w32[1:65], None) == 1    # unaligned
    assert path(wide, (1, 0, 0), w32[:64], w32[1:65]) == 1
    assert path(narrow, (1, 0, 0), w32[:64], None) == 1


def test_build_jobs_name_the_sources():
    for kind in ("rmsnorm", "layernorm"):
        name, source, dirs = row_norm.source_job(kind)
        assert name == kind and f"disc_{kind}" in source
        assert '#include "row_norm.cuh"' in source
        assert any((d / "row_norm.cuh").exists() for d in dirs)


# ------------------------------------------------------------ on card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA C++ kernels run on the "
                    "card only")
    return torch.device("cuda")


# kernel vs plain on the card, max|d|/max|ref|: f32 by summation order;
# 16-bit outputs by one rounding where the f32 results differ
CARD_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3, torch.float16: 8e-3}


def _card_inputs(gen, kind, shape, dtype, wdtype=torch.float32):
    off = 3.0 if kind == "layernorm" else 0.0
    x = (torch.randn(shape, generator=gen, device="cuda") + off).to(dtype)
    d = shape[-1]
    w = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(wdtype)
    b = (0.1 * torch.randn(d, generator=gen, device="cuda")).to(wdtype)
    return x, w, b


def _check(kind, x, w, b):
    ops = rms_ops if kind == "rmsnorm" else ln_ops
    args = (x, w) if kind == "rmsnorm" else (x, w, b)
    fn = ops.rmsnorm if kind == "rmsnorm" else ops.layernorm
    before = ops.LAUNCHES.launches
    got = fn(*args)
    assert ops.LAUNCHES.launches == before + 1
    with select.plain_versions():
        want = fn(*args)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == x.shape
    assert bool(torch.isfinite(got).all())
    if want.numel():
        rel = ((got.float() - want.float()).abs().max()
               / want.float().abs().max()).item()
        assert rel <= CARD_TOL[x.dtype], rel
    return got


KINDS_DTYPES = ([("rmsnorm", t) for t in (torch.float32, torch.bfloat16,
                                         torch.float16)]
                + [("layernorm", t) for t in (torch.float32,
                                              torch.bfloat16)])


@pytest.mark.parametrize("kind,dtype", KINDS_DTYPES)
@pytest.mark.parametrize("d", [2048, 2560, 3584, 6144, 2561, 96, 4097,
                               20000])
def test_norm_kernel_widths_on_card(cuda, kind, dtype, d):
    gen = torch.Generator(device=cuda).manual_seed(d)
    for rows in (4, 2048):      # the decode and the prefill plan
        _check(kind, *_card_inputs(gen, kind, (rows, d), dtype))


@pytest.mark.parametrize("kind,dtype", KINDS_DTYPES)
@pytest.mark.parametrize("view", ["row_stride", "unaligned", "strided_3d",
                                  "columns_strided"])
def test_norm_kernel_row_views_on_card(cuda, kind, dtype, view):
    """Rows read in place through a row stride larger than D (16-byte
    readable, or not: the one-column instance), and a last axis that is
    not unit-stride (copied first)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    d, rows = 2560, 300
    x, w, b = _card_inputs(gen, kind, (rows, d + 24), dtype)
    if view == "row_stride":
        x = x[:, :d]
    elif view == "unaligned":
        x = x[:, 1:d + 1]
        assert x.data_ptr() % 16
    elif view == "strided_3d":
        x = x.view(3, rows // 3, d + 24)[..., 8:d + 8]
    else:
        x = x[:, :d].t().contiguous().t()
        assert x.stride(-1) != 1
    _check(kind, x, w[:d], b[:d])


@pytest.mark.parametrize("kind,dtype", [("rmsnorm", torch.bfloat16),
                                        ("rmsnorm", torch.float16),
                                        ("layernorm", torch.bfloat16)])
def test_norm_kernel_16bit_weights_on_card(cuda, kind, dtype):
    """A scale and bias of x's type, read an element a load."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    for rows in (4, 2048):
        _check(kind, *_card_inputs(gen, kind, (rows, 2560), dtype, dtype))


@pytest.mark.parametrize("case", ["f32_x_bf16_w", "bf16_x_f16_w",
                                  "unaligned_w", "mixed_scale_bias"])
def test_norm_kernel_weight_paths_on_card(cuda, case):
    """Weights read an element a load (kWeightAny): a weight of another
    16-bit type than x, an unaligned weight, a bias of another type than
    the scale."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    for rows in (4, 2048):
        if case == "f32_x_bf16_w":
            _check("rmsnorm", *_card_inputs(gen, "rmsnorm", (rows, 2560),
                                            torch.float32, torch.bfloat16))
        elif case == "bf16_x_f16_w":
            _check("rmsnorm", *_card_inputs(gen, "rmsnorm", (rows, 2560),
                                            torch.bfloat16, torch.float16))
        elif case == "unaligned_w":
            for kind, dt in KINDS_DTYPES:
                x, w, b = _card_inputs(gen, kind, (rows, 2561), dt)
                _check(kind, x[:, :2560], w[1:], b[1:])
        else:
            x, w, b = _card_inputs(gen, "layernorm", (rows, 2560),
                                   torch.bfloat16)
            _check("layernorm", x, w, b.to(torch.bfloat16))


@pytest.mark.parametrize("kind,dtype", KINDS_DTYPES)
@pytest.mark.parametrize("rows", [0, 1, 20000])
def test_norm_kernel_row_counts_on_card(cuda, kind, dtype, rows):
    """0 rows (nothing launched, an empty output), 1 row, and 20000 rows:
    more rows than the grid holds groups, so each group walks several."""
    gen = torch.Generator(device=cuda).manual_seed(rows)
    d = 2048
    if rows == 20000:
        plan = row_norm.norm_plan(rows, d, torch.empty(
            (), dtype=dtype).element_size(), True, 132)
        assert plan.grid * plan.rows < rows
    _check(kind, *_card_inputs(gen, kind, (rows, d), dtype))


@pytest.mark.parametrize("kind,dtype", KINDS_DTYPES)
@pytest.mark.parametrize("d,aligned", [(20000, True), (4097, False)])
def test_norm_kernel_loop_instance_on_card(cuda, kind, dtype, d, aligned):
    """Rows wider than registers hold (the loop instance), 16-byte
    readable or a column a chunk."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x, w, b = _card_inputs(gen, kind, (7, d + 8), dtype)
    x = x[:, :d] if aligned else x[:, 1:d + 1]
    elt = x.element_size()
    wide = aligned and d % (16 // elt) == 0
    assert row_norm.norm_plan(7, d, elt, wide, 132,
                              layernorm=kind == "layernorm").loop
    _check(kind, x, w[:d], b[:d])
