"""The port's FX frontend against the JAX package's jaxpr frontend.

The port's TinyLlama stack (narrow widths, 2 layers) must bridge to the
same dynamic symbols, the same fused-cluster template sequence and the
same kernel count after fusion as the JAX package's stack does: kInput×1
then kLoop×7 in f32, kLoop×7 in bf16 (the norm's f32 cast keeps the first
reduce out of a kInput cluster).  The remaining cases pin the ATen→DHLO
mapping rules the parity rests on.
"""
from __future__ import annotations

import jax.numpy as jnp
import pytest
import torch

import disc
import disc_torch
from _torch_parity import build_pair
from repro_torch.frontends.fx_frontend import (ArgSpec,
                                                UnsupportedPrimitiveError,
                                                bridge)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
EXPECTED = {"f32": ["kInput"] + ["kLoop"] * 7, "bf16": ["kLoop"] * 7}


def _templates(plan):
    return [c.template for c in plan.clusters if c.template]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_tinyllama_stack_plans_like_reference(dtype):
    rcfg, ref_fn, pcfg, port_fn = build_pair(dtype)
    jdt, tdt = DTYPES[dtype]
    ref = disc.compile(ref_fn, [((1, disc.Dim("S", max=2048), rcfg.d_model),
                                 jdt)], backend="pallas").lower()
    port = disc_torch.compile(
        port_fn, [((1, disc_torch.Dim("S", max=2048), pcfg.d_model), tdt)],
        backend="hopper", device="cpu").lower()
    assert list(port.sym_names) == list(ref.sym_names) == ["S"]
    assert _templates(port.plan) == _templates(ref.plan) == EXPECTED[dtype]
    rs, ps = ref.plan.stats(), port.plan.stats()
    assert ps["kernels_after_fusion"] == rs["kernels_after_fusion"]
    assert ps["fusable_clusters"] == rs["fusable_clusters"]
    assert port.plan.template_counts() == ref.plan.template_counts()


def _ops(graph):
    return [op.opcode for op in graph.ops]


def test_rank3_matmul_is_one_dot_general():
    w = torch.randn(64, 32)
    g, _ = bridge(lambda x: x @ w, [ArgSpec((1, "S", 64))], device="cpu")
    assert _ops(g) == ["dot_general"]
    (op,) = g.ops
    assert op.attrs["dimension_numbers"] == (((2,), (0,)), ((), ()))
    assert op.outputs[0].shape[1] is g.params[0].shape[1]


def test_unsqueeze_chain_is_one_broadcast():
    def f(x):
        return x[:, None, None, :] * 2.0

    g, _ = bridge(f, [ArgSpec(("B", "S"))], device="cpu")
    assert _ops(g) == ["broadcast_in_dim", "mul"]
    assert g.ops[0].attrs["broadcast_dimensions"] == (0, 3)


def test_lower_rank_operand_lifts_like_jnp():
    scale = torch.ones(64)

    def f(x):
        return x * scale + 1.0

    g, _ = bridge(f, [ArgSpec(("S", 64))], device="cpu")
    assert _ops(g) == ["broadcast_in_dim", "mul", "add"]
    lit = g.ops[2].inputs[1]
    assert lit.rank == 0 and lit.dtype == torch.float32  # weakly typed
    assert lit.literal.item() == 1.0


def test_mean_is_sum_then_div_and_keepdim_broadcasts():
    g, _ = bridge(lambda x: x.mean(-1, keepdim=True), [ArgSpec(("S", 64))],
                  device="cpu")
    assert _ops(g) == ["reduce_sum", "broadcast_in_dim", "div"]
    assert g.ops[2].inputs[1].literal.item() == 64


def test_reshape_merge_records_derived_dim():
    g, _ = bridge(lambda x: (x * 2.0).reshape(-1, 8), [ArgSpec(("B", "S", 8))],
                  device="cpu")
    out = g.outputs[0].shape[0]
    assert g.dim_exprs[out.uid][0] == "mul"


def test_dynamic_concat_records_sum_dim():
    g, _ = bridge(lambda x, y: torch.cat([x, y], dim=0),
                  [ArgSpec(("S", 4)), ArgSpec(("T", 4))], device="cpu")
    out = g.outputs[0].shape[0]
    assert g.dim_exprs[out.uid][0] == "sum"


def test_chunk_becomes_slices_with_equal_shape_hint():
    def f(x):
        a, b = torch.chunk(x, 2, dim=-1)
        return a * b

    g, _ = bridge(f, [ArgSpec(("S", 32))], device="cpu")
    assert _ops(g) == ["slice", "slice", "mul"]
    s1, s2 = g.ops[0].outputs[0], g.ops[1].outputs[0]
    assert g.store.sizes_equal(s1.vid, s2.vid)


def test_mixed_dtypes_get_explicit_converts():
    g, _ = bridge(lambda x, y: x + y, [ArgSpec(("S",), torch.bfloat16),
                                       ArgSpec(("S",), torch.float32)],
                  device="cpu")
    assert _ops(g) == ["convert", "add"]
    assert g.ops[1].outputs[0].dtype == torch.float32


def test_gather_is_unsupported_and_named():
    table = torch.randn(100, 8)
    with pytest.raises(UnsupportedPrimitiveError, match="embedding|index"):
        bridge(lambda ids: table[ids], [ArgSpec(("S",), torch.int64)],
               device="cpu")


def test_dot_general_primitive_keeps_batch_dims():
    def f(q, k):
        return disc_torch.dot_general(q, k, (((3,), (3,)), ((0, 1), (0, 1))))

    g, _ = bridge(f, [ArgSpec((1, 2, "S", 16)), ArgSpec((1, 2, "T", 16))],
                  device="cpu")
    assert _ops(g) == ["dot_general"]
    shape = g.outputs[0].shape
    assert shape[:2] == (1, 2)
    assert [d.name for d in shape[2:]] == ["S", "T"]
