"""The port's flash-attention and RMSNorm wrappers against the JAX package.

On the CPU the wrappers run their kernels' plain versions.  Those are held
against the JAX package's Pallas kernels in interpret mode
(``repro.kernels.flash_attention.ops``, ``repro.kernels.rmsnorm.ops``) and
against the reference's own attention functions (``models/layers.py``
``_sdpa`` / ``_sdpa_chunked``, with scalar and per-row ``q_offset``), on
the same numpy inputs.  Tolerances: f32 at 1e-5 relative (both sides sum
in f32, in another order; the attention cases add an absolute 1e-5 for
outputs near zero); bf16 as ``tests/test_kernels.py``'s ``TOL`` (2e-2).

The CUDA C++ and Triton kernels need the card: the ``on_card`` cases skip
here and run there, where JAX is not installed (``python -m pytest -q
tests/test_torch_attention.py -k on_card``); they hold each kernel
against its plain version on the same card inputs through
``plain_versions()``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import select
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models import layers as L

TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}


def _jax():
    import jax.numpy as jnp

    return jnp


def _qkv(b, h, hkv, sq, sk, d, seed):
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((b, h, sq, d)).astype(np.float32),
            rs.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rs.standard_normal((b, hkv, sk, d)).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


# ----------------------------------------------- plain vs Pallas (CPU) --

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hkv", [1, 2, 4])
@pytest.mark.parametrize("s", [128, 40])
def test_flash_attention_plain_matches_pallas(causal, hkv, s):
    from repro.kernels.flash_attention.ops import flash_attention

    jnp = _jax()
    q, k, v = _qkv(3, 4, hkv, s, s, 32, seed=s + hkv)
    lens = np.array([s, s // 3 + 1, 0], np.int32)  # ragged, one empty row
    want = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(lens), causal=causal)
    got = fa_ops.flash_attention(*_t(q, k, v), torch.from_numpy(lens),
                                 causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["f32"])
    assert not got[2].any()  # a row with no valid key gives 0
    assert fa_ops.LAUNCHES.launches == 0  # the CPU runs no kernel


@pytest.mark.parametrize("hkv", [1, 2, 4])
def test_flash_decode_plain_matches_pallas(hkv):
    from repro.kernels.flash_attention.ops import flash_decode

    jnp = _jax()
    q, k, v = _qkv(3, 4, hkv, 1, 128, 32, seed=hkv)
    lens = np.array([100, 1, 0], np.int32)
    want = flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(lens))
    got = fa_ops.flash_decode(*_t(q, k, v), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["f32"])


def test_flash_attention_plain_bf16_matches_pallas():
    import jax.numpy as jnp
    from repro.kernels.flash_attention.ops import flash_attention

    q, k, v = _qkv(2, 4, 2, 128, 128, 32, seed=5)
    lens = np.array([128, 77], np.int32)
    want = flash_attention(*[jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)],
                           jnp.asarray(lens), causal=True)
    got = fa_ops.flash_attention(*[x.to(torch.bfloat16) for x in _t(q, k, v)],
                                 torch.from_numpy(lens), causal=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL["bf16"])


# ---------------------------------- port _sdpa vs the reference's (CPU) --

SDPA_CASES = {
    # name: (sq, sk, causal, lens, q_offset)
    "self_causal": (32, 32, True, None, 0),
    "scalar_offset": (16, 64, True, None, 5),
    "row_offsets": (16, 64, True, None, [0, 20, 48]),
    "row_offsets_lens": (16, 64, True, [64, 40, 30], [0, 20, 48]),
    "decode_lens": (1, 64, False, [64, 1, 33], 0),
}


def _ref_args(lens, q_offset):
    jnp = _jax()
    jl = None if lens is None else jnp.asarray(np.array(lens, np.int32))
    jo = (jnp.asarray(np.array(q_offset, np.int32))
          if isinstance(q_offset, list) else q_offset)
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    to = (torch.tensor(q_offset, dtype=torch.int32)
          if isinstance(q_offset, list) else q_offset)
    return jl, jo, tl, to


@pytest.mark.parametrize("name", sorted(SDPA_CASES))
@pytest.mark.parametrize("chunked", [False, True])
def test_sdpa_matches_reference(name, chunked):
    """The port's ``_sdpa`` (and ``_sdpa_chunked``) take the reference's
    scalar or per-row ``q_offset`` and compute the same attention."""
    from repro.models import layers as RL

    jnp = _jax()
    sq, sk, causal, lens, q_offset = SDPA_CASES[name]
    q, k, v = _qkv(3, 8, 2, sq, sk, 16, seed=sq + sk)
    jl, jo, tl, to = _ref_args(lens, q_offset)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    if chunked:
        want = RL._sdpa_chunked(jq, jk, jv, causal=causal, lens=jl,
                                q_offset=jo)
        got = L._sdpa_chunked(*_t(q, k, v), causal=causal, lens=tl,
                              q_offset=to)
    else:
        want = RL._sdpa(jq, jk, jv, causal=causal, lens=jl, q_offset=jo)
        got = L._sdpa(*_t(q, k, v), causal=causal, lens=tl, q_offset=to)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["f32"])


def test_q_positions_vector_and_scalar():
    off = torch.tensor([0, 3, 10], dtype=torch.int32)
    assert L._q_positions(4, off, "cpu").tolist() == [
        [0, 1, 2, 3], [3, 4, 5, 6], [10, 11, 12, 13]]
    assert L._q_positions(3, 7, "cpu").tolist() == [[7, 8, 9]]
    assert [L._pick_chunk(s) for s in (2048, 96, 7)] == [1024, 32, 1]


# ------------------------------------------ RMSNorm vs Pallas (CPU) --

@pytest.mark.parametrize("shape", [(5, 7, 64), (3, 2048), (1, 100)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_plain_matches_pallas(shape, dtype):
    import jax.numpy as jnp
    from repro.kernels.rmsnorm.ops import rmsnorm

    rs = np.random.RandomState(len(shape))
    x = rs.standard_normal(shape).astype(np.float32)
    w = (1.0 + 0.1 * rs.standard_normal(shape[-1])).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = rmsnorm(jnp.asarray(x, jdt), jnp.asarray(w))
    got = rms_ops.rmsnorm(torch.from_numpy(x).to(tdt), torch.from_numpy(w))
    assert got.dtype == tdt and tuple(got.shape) == shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])
    assert rms_ops.LAUNCHES.launches == 0


def test_plain_versions_context_and_devices():
    """The wrappers take the plain version on the CPU and inside the
    context; a tensor on another device raises rather than falling back."""
    x = torch.ones(2, 8)
    assert not select.use_kernel(x, "op")
    with select.plain_versions():
        assert not select.use_kernel(x, "op")
    with pytest.raises(ValueError, match="no kernel"):
        select.use_kernel(torch.ones(2, device="meta"), "op")


# ------------------------------------------------------------ on card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA C++ and Triton kernels "
                    "run on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


# kernel vs plain on the card, max|d|/max|ref|: f32 differs by summation
# order; bf16 by one rounding of the output (2^-8) where sums differ
CARD_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_prefill_kernel_matches_plain_on_card(cuda, dtype, hd):
    gen = torch.Generator(device=cuda).manual_seed(0)
    b, h, hkv, sq, sk = 3, 8, 2, 200, 333
    q = torch.randn((b, sq, h, hd), generator=gen, device=cuda).to(dtype) \
        .transpose(1, 2)                    # the serve path's strided q
    k, v = (torch.randn((b, hkv, sk, hd), generator=gen,
                        device=cuda).to(dtype) for _ in range(2))
    off = torch.tensor([0, 70, 133], dtype=torch.int32, device=cuda)
    lens = torch.tensor([333, 150, 0], dtype=torch.int32, device=cuda)
    for causal, ln, qo in ((True, None, off), (True, lens, off),
                           (False, lens, 0)):
        before = fa_ops.LAUNCHES.launches
        got = fa_ops.flash_attention(q, k, v, ln, causal=causal, q_offset=qo)
        assert fa_ops.LAUNCHES.launches == before + 1
        with select.plain_versions():
            want = fa_ops.flash_attention(q, k, v, ln, causal=causal,
                                          q_offset=qo)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert _rel(got, want) <= CARD_TOL[dtype], (causal, ln is None)
        if ln is not None:
            assert not got[2].any()         # fully masked row: 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [8, 3, 12])
def test_flash_decode_kernel_matches_plain_on_card(cuda, dtype, group):
    gen = torch.Generator(device=cuda).manual_seed(1)
    b, hkv, sk, hd = 4, 4, 2048, 64
    q = torch.randn((b, 1, hkv * group, hd), generator=gen,
                    device=cuda).to(dtype).transpose(1, 2)
    k, v = (torch.randn((b, hkv, sk, hd), generator=gen,
                        device=cuda).to(dtype) for _ in range(2))
    lens = torch.tensor([38, 2016, 1, 731], dtype=torch.int32, device=cuda)
    got = fa_ops.flash_decode(q, k, v, lens)
    with select.plain_versions():
        want = fa_ops.flash_decode(q, k, v, lens)
    torch.cuda.synchronize()
    assert _rel(got, want) <= CARD_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2048, 2048), (4, 1, 2048), (3, 7, 96)])
def test_rmsnorm_kernel_matches_plain_on_card(cuda, dtype, shape):
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    w = 1.0 + 0.1 * torch.randn(shape[-1], generator=gen, device=cuda)
    before = rms_ops.LAUNCHES.launches
    got = rms_ops.rmsnorm(x, w)
    assert rms_ops.LAUNCHES.launches == before + 1
    with select.plain_versions():
        want = rms_ops.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert _rel(got, want) <= CARD_TOL[dtype]
