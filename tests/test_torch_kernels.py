"""The port's kLoop and kInput kernels against the JAX package's.

On the CPU the port's wrappers run their kernels' plain versions; they are
held against the JAX package's ``ops.fused_elementwise`` /
``ops.fused_reduce`` (Pallas in interpret mode) on the same numpy inputs,
at ``rtol=atol=1e-5`` in f32: both compute each op in f32 and differ only
in summation order.  The cases cover ``n_valid`` below the padded size,
multi-output clusters, broadcast operands, all four reduce kinds and a
non-last reduce axis.  The Triton kernels themselves need the card: those
cases skip here and run on the card, where JAX is not installed (``python
-m pytest -q tests/test_torch_kernels.py -k on_card``); the JAX package
is imported by the CPU cases only.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.fused_elementwise import ops as ew_ops
from repro_torch.kernels.fused_elementwise.ref import fused_elementwise_ref
from repro_torch.kernels.fused_reduce import ops as red_ops
from repro_torch.kernels.fused_reduce.ref import fused_reduce_ref
from repro_torch.kernels.program import Program, Step

F32 = torch.float32
TOL = dict(rtol=1e-5, atol=1e-5)


def _p(n_in, steps, outs, in_dtypes=None):
    return Program(tuple(in_dtypes or (F32,) * n_in),
                   tuple(Step(*s) for s in steps), tuple(outs))


def _jax():
    import jax.numpy as jnp
    from repro.kernels.fused_elementwise.ops import fused_elementwise
    from repro.kernels.fused_reduce.ops import fused_reduce

    return jnp, fused_elementwise, fused_reduce


class _JNP:
    """``jnp`` for the closures below, resolved when a CPU case runs."""

    def __getattr__(self, name):
        return getattr(_jax()[0], name)


jnp = _JNP()

# program, the same expression as a JAX closure, number of outputs
EW_CASES = {
    "mul_add_tanh_two_outputs": (
        _p(2, [("mul", (("in", 0), ("in", 1)), F32),
               ("add", (("t", 0), ("c", 0.5)), F32),
               ("tanh", (("t", 1),), F32)],
           [("t", 2), ("t", 0)]),
        lambda a, b: (jnp.tanh(a * b + 0.5), a * b), 2),
    "select_logistic_rsqrt": (
        _p(2, [("gt", (("in", 0), ("c", 0.0)), torch.bool),
               ("logistic", (("in", 1),), F32),
               ("abs", (("in", 0),), F32),
               ("add", (("t", 2), ("c", 1.0)), F32),
               ("rsqrt", (("t", 3),), F32),
               ("select", (("t", 0), ("t", 4), ("t", 1)), F32)],
           [("t", 5)]),
        lambda a, b: jnp.where(a > 0, 1 / (1 + jnp.exp(-b)),
                               1 / jnp.sqrt(jnp.abs(a) + 1.0)), 1),
    "div_exp_max_pow": (
        _p(2, [("exp", (("in", 0),), F32),
               ("div", (("t", 0), ("in", 1)), F32),
               ("max", (("t", 1), ("c", 0.25)), F32),
               ("integer_pow", (("t", 2),), F32, 3)],
           [("t", 3)]),
        lambda a, b: jnp.maximum(jnp.exp(a) / b, 0.25) ** 3, 1),
}


def _inputs(shape, n, seed):
    rs = np.random.RandomState(seed)
    xs = [rs.standard_normal(shape).astype(np.float32) for _ in range(n)]
    xs[-1] = np.abs(xs[-1]) + 0.5  # a safe divisor
    return xs


@pytest.mark.parametrize("name", sorted(EW_CASES))
@pytest.mark.parametrize("shape,n_valid", [((4, 300), 1000),
                                           ((2, 3, 1024), 6144),
                                           ((7, 64), 1)])
def test_fused_elementwise_plain_matches_reference(name, shape, n_valid):
    program, expr, n_out = EW_CASES[name]
    _, jax_ew, _ = _jax()
    xs = _inputs(shape, len(program.in_dtypes), seed=n_valid)
    want = jax_ew(expr, [jnp.asarray(x) for x in xs], n_valid,
                  [jnp.float32] * n_out)
    got = ew_ops.fused_elementwise(program, [torch.from_numpy(x) for x in xs],
                                   n_valid, shape)
    assert len(got) == n_out
    for g, w in zip(got, want):
        assert tuple(g.shape) == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        assert not g.reshape(-1)[n_valid:].any()  # padded tail: zeros
    assert ew_ops.LAUNCHES.launches == 0  # the CPU runs no kernel


def test_fused_elementwise_broadcast_operands():
    """A per-row scale and a per-column bias are read as broadcast views."""
    program = _p(3, [("mul", (("in", 0), ("in", 1)), F32),
                     ("add", (("t", 0), ("in", 2)), F32)], [("t", 1)])
    rs = np.random.RandomState(0)
    x = rs.standard_normal((1, 37, 64)).astype(np.float32)
    row = rs.standard_normal((1, 37, 1)).astype(np.float32)
    col = rs.standard_normal((64,)).astype(np.float32)
    full = [np.broadcast_to(a, x.shape) for a in (x, row, col)]
    _, jax_ew, _ = _jax()
    want = jax_ew(lambda a, b, c: a * b + c,
                  [jnp.asarray(np.ascontiguousarray(a)) for a in full],
                  x.size, [jnp.float32])
    got = ew_ops.fused_elementwise(
        program, [torch.from_numpy(a) for a in (x, row, col)], x.size,
        x.shape)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)


RED_EXPR = {
    "sum": (_p(2, [("mul", (("in", 0), ("in", 1)), F32)], [("t", 0)]),
            lambda a, b: a * b),
    "max": (_p(2, [("sub", (("in", 0), ("in", 1)), F32)], [("t", 0)]),
            lambda a, b: a - b),
    "min": (_p(2, [("add", (("in", 0), ("in", 1)), F32)], [("t", 0)]),
            lambda a, b: a + b),
    "prod": (_p(2, [("mul", (("in", 0), ("c", 0.01)), F32),
                    ("add", (("t", 0), ("c", 1.0)), F32)], [("t", 1)]),
             lambda a, b: a * 0.01 + 1.0),
}


@pytest.mark.parametrize("kind", sorted(RED_EXPR))
@pytest.mark.parametrize("shape,axis,n_cols", [((24, 300), 1, 250),
                                               ((3, 16, 40), 2, 40),
                                               ((3, 40, 16), 1, 33),
                                               ((40, 5, 8), 0, 29)])
def test_fused_reduce_plain_matches_reference(kind, shape, axis, n_cols):
    program, expr = RED_EXPR[kind]
    _, _, jax_red = _jax()
    xs = _inputs(shape, 2, seed=n_cols)
    want = jax_red(expr, [jnp.asarray(x) for x in xs], n_cols, kind,
                   axis=axis)
    got = red_ops.fused_reduce(program, [torch.from_numpy(x) for x in xs],
                               n_cols, kind, axis=axis, shape=shape,
                               out_dtype=F32)
    kept = tuple(d for i, d in enumerate(shape) if i != axis)
    assert tuple(got.shape) == kept
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert red_ops.LAUNCHES.launches == 0


@pytest.mark.parametrize("kind", sorted(RED_EXPR))
def test_fused_reduce_plain_takes_the_count_from_a_tensor(kind):
    """The valid column count as the bucket executor hands it over, an
    int32 tensor written in place between calls: equal to the reference
    at each count, the padded shape fixed."""
    program, expr = RED_EXPR[kind]
    jnp, _, jax_red = _jax()
    shape, axis = (24, 300), 1
    xs = _inputs(shape, 2, seed=9)
    n_cols = torch.zeros(1, dtype=torch.int32)
    for n in (250, 300, 1, 0, 17):
        n_cols.fill_(n)
        want = jax_red(expr, [jnp.asarray(x) for x in xs], n, kind,
                       axis=axis)
        got = red_ops.fused_reduce(program, [torch.from_numpy(x)
                                             for x in xs], n_cols, kind,
                                   axis=axis, shape=shape, out_dtype=F32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------ on card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Triton kernels run on the "
                    "card only")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kloop_kernel_matches_plain_on_card(cuda, dtype):
    from repro_torch.kernels.fused_elementwise.fused_elementwise import \
        fused_elementwise_kernel

    program, _, _ = EW_CASES["select_logistic_rsqrt"]
    program = Program((dtype, dtype), tuple(
        Step(s.opcode, s.args, dtype if s.dtype == F32 else s.dtype)
        for s in program.steps), program.outs)
    shape = (1, 131, 2048)
    gen = torch.Generator(device=cuda).manual_seed(0)
    xs = [torch.randn(shape, generator=gen, device=cuda).to(dtype),
          torch.randn((1, 131, 1), generator=gen, device=cuda).to(dtype)]
    n_valid = 100 * 2048 + 7
    got = fused_elementwise_kernel(program, xs, n_valid, shape)
    want = fused_elementwise_ref(program, xs, n_valid, shape)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    assert not got[0].reshape(-1)[n_valid:].any()


@pytest.mark.parametrize("kind", sorted(RED_EXPR))
def test_kinput_kernel_matches_plain_on_card(cuda, kind):
    from repro_torch.kernels.fused_reduce.fused_reduce import \
        fused_reduce_kernel

    program, _ = RED_EXPR[kind]
    shape, axis, n_cols = (5, 2048, 96), 1, 2000
    gen = torch.Generator(device=cuda).manual_seed(1)
    xs = [torch.randn(shape, generator=gen, device=cuda) for _ in range(2)]
    got = fused_reduce_kernel(program, xs, n_cols, kind, axis, shape, F32)
    want = fused_reduce_ref(program, xs, n_cols, kind, axis, shape, F32)
    torch.cuda.synchronize()
    # f32 sums and products of 2000 terms in another order: a few 1e-5
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", sorted(RED_EXPR))
@pytest.mark.parametrize("shape,axis", [((5, 2048, 96), 1),
                                        ((64, 2048), 1), ((1, 1 << 18), 1)])
def test_captured_kinput_replays_new_counts_on_card(cuda, kind, shape,
                                                    axis):
    """One CUDA graph of the kernel, captured at the padded shape and
    replayed after the count it reads was written anew: each replay
    equals the plain version at that count (the split shape's partials
    combined by the last program, whose ticket it clears itself)."""
    from repro_torch.kernels.fused_reduce.fused_reduce import \
        fused_reduce_kernel

    program, _ = RED_EXPR[kind]
    gen = torch.Generator(device=cuda).manual_seed(2)
    xs = [torch.randn(shape, generator=gen, device=cuda) for _ in range(2)]
    n_cols = torch.full((1,), shape[axis], dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # builds the kernel, outside a capture
        fused_reduce_kernel(program, xs, n_cols, kind, axis, shape, F32)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fused_reduce_kernel(program, xs, n_cols, kind, axis, shape,
                                  F32)
    for n in (shape[axis] - 48, 1, 0, shape[axis], 77):
        n_cols.fill_(n)
        graph.replay()
        want = fused_reduce_ref(program, xs, n, kind, axis, shape, F32)
        torch.cuda.synchronize()
        # f32 sums and products of up to 262144 terms in another order
        torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-3)
