"""The port's framework-free IR against the JAX package's, graph for graph.

Each test builds the same DHLO graph by hand in both packages (as
``tests/test_core_ir.py`` and ``tests/test_memory_planning.py`` build
theirs) and requires identical fusion plans, placement, buffer-plan lines,
bucket keys and shape-free ``fingerprint()``s.
"""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

import repro.core.bucketing as RB
import repro.core.buffers as RBuf
import repro.core.dhlo as RD
import repro.core.fusion as RF
import repro.core.placer as RP
import repro.core.propagation as RPr
import repro.core.symshape as RS
import repro_torch.core.bucketing as PB
import repro_torch.core.buffers as PBuf
import repro_torch.core.dhlo as PD
import repro_torch.core.fusion as PF
import repro_torch.core.placer as PP
import repro_torch.core.propagation as PPr
import repro_torch.core.symshape as PS

REF = types.SimpleNamespace(
    DGraph=RD.DGraph, sym=RS.fresh_symdim, f32=np.float32, i32=np.int32,
    const=lambda g, v, dt: g.add_const(np.asarray(v, dtype=dt)),
    plan=RF.plan_fusion, place=RP.place, buffers=RBuf.plan_buffers,
    collect=RPr.collect_semantic_constraints, bucketing=RB)
PORT = types.SimpleNamespace(
    DGraph=PD.DGraph, sym=PS.fresh_symdim, f32=torch.float32,
    i32=torch.int32,
    const=lambda g, v, dt: g.add_const(torch.tensor(v), dtype=dt),
    plan=PF.plan_fusion, place=PP.place, buffers=PBuf.plan_buffers,
    collect=PPr.collect_semantic_constraints, bucketing=PB)


def _norm_mlp(P):
    """RMSNorm + a 2-D dot with a bias/activation epilogue + residual."""
    g = P.DGraph("norm_mlp")
    S = P.sym("S", rep=37)
    x = g.add_param((S, 64), P.f32)
    w = g.add_param((64, 32), P.f32)
    b = g.add_param((32,), P.f32)
    scale = g.add_param((64,), P.f32)
    sq = g.add_op("mul", [x, x], [(S, 64)], [P.f32]).outputs[0]
    ss = g.add_op("reduce_sum", [sq], [(S,)], [P.f32],
                  attrs={"axes": (1,)}).outputs[0]
    ssb = g.add_op("broadcast_in_dim", [ss], [(S, 1)], [P.f32],
                   attrs={"broadcast_dimensions": (0,)}).outputs[0]
    ms = g.add_op("div", [ssb, P.const(g, 64.0, P.f32)], [(S, 1)],
                  [P.f32]).outputs[0]
    eps = g.add_op("add", [ms, P.const(g, 1e-6, P.f32)], [(S, 1)],
                   [P.f32]).outputs[0]
    r = g.add_op("rsqrt", [eps], [(S, 1)], [P.f32]).outputs[0]
    h = g.add_op("mul", [x, r], [(S, 64)], [P.f32]).outputs[0]
    sb = g.add_op("broadcast_in_dim", [scale], [(1, 64)], [P.f32],
                  attrs={"broadcast_dimensions": (1,)}).outputs[0]
    h = g.add_op("mul", [h, sb], [(S, 64)], [P.f32]).outputs[0]
    y = g.add_op("dot_general", [h, w], [(S, 32)], [P.f32],
                 attrs={"dimension_numbers": (((1,), (0,)), ((), ()))}
                 ).outputs[0]
    bb = g.add_op("broadcast_in_dim", [b], [(1, 32)], [P.f32],
                  attrs={"broadcast_dimensions": (1,)}).outputs[0]
    y = g.add_op("add", [y, bb], [(S, 32)], [P.f32]).outputs[0]
    y = g.add_op("tanh", [y], [(S, 32)], [P.f32]).outputs[0]
    m = g.add_op("reduce_max", [y], [(32,)], [P.f32],
                 attrs={"axes": (0,)}).outputs[0]
    g.set_outputs([y, m])
    P.collect(g)
    return g, [S]


def _reshape_concat(P):
    """Reshape merges, a dynamic-axis concat, a slice and a transpose."""
    g = P.DGraph("reshape_concat")
    B, S = P.sym("B", rep=37), P.sym("S", rep=41)
    x = g.add_param((B, S, 8), P.f32)
    y = g.add_param((B, S, 8), P.f32)
    BS = P.sym("B*S", rep=37 * 41)
    g.dim_exprs = {BS.uid: ("mul", (B, S))}
    e = g.add_op("exp", [x], [(B, S, 8)], [P.f32]).outputs[0]
    a = g.add_op("add", [e, y], [(B, S, 8)], [P.f32]).outputs[0]
    f = g.add_op("reshape", [a], [(BS, 8)], [P.f32]).outputs[0]
    t = g.add_op("transpose", [f], [(8, BS)], [P.f32],
                 attrs={"permutation": (1, 0)}).outputs[0]
    S2 = P.sym("S+S", rep=82)
    g.dim_exprs[S2.uid] = ("sum", (S, S))
    c = g.add_op("concatenate", [a, y], [(B, S2, 8)], [P.f32],
                 attrs={"dimension": 1}).outputs[0]
    s = g.add_op("slice", [c], [(B, S2, 4)], [P.f32],
                 attrs={"start_indices": (0, 0, 0), "limit_indices":
                        (37, 82, 4), "strides": (1, 1, 1)}).outputs[0]
    n = g.add_op("neg", [s], [(B, S2, 4)], [P.f32]).outputs[0]
    g.set_outputs([t, n])
    P.collect(g)
    return g, [B, S]


def _dus_chain(P):
    """An in-place update whose dying operand donates its slot, plus
    integer shape math feeding the update's start index (host-placed)."""
    g = P.DGraph("dus_chain")
    S = P.sym("S", rep=37)
    buf = g.add_param((S, 16), P.f32)
    upd = g.add_param((4, 16), P.f32)
    i = g.add_param((), P.i32)
    j = g.add_op("add", [i, P.const(g, 1, P.i32)], [()], [P.i32]).outputs[0]
    t = g.add_op("tanh", [buf], [(S, 16)], [P.f32]).outputs[0]
    d = g.add_op("dynamic_update_slice", [t, upd], [(S, 16)], [P.f32],
                 shape_operands=[j, P.const(g, 0, P.i32)]).outputs[0]
    o = g.add_op("mul", [d, d], [(S, 16)], [P.f32]).outputs[0]
    g.set_outputs([o])
    P.collect(g)
    return g, [S]


BUILDERS = {"norm_mlp": _norm_mlp, "reshape_concat": _reshape_concat,
            "dus_chain": _dus_chain}


def _plan_view(plan):
    return [(c.kind, c.template, [op.opcode for op in c.ops])
            for c in plan.clusters]


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_fingerprint_and_fusion_plan_match(name):
    (rg, _), (pg, _) = BUILDERS[name](REF), BUILDERS[name](PORT)
    assert pg.fingerprint() == rg.fingerprint()
    rp, pp = REF.plan(rg), PORT.plan(pg)
    assert _plan_view(pp) == _plan_view(rp)
    assert pp.stats() == rp.stats()
    assert pp.template_counts() == rp.template_counts()
    assert PORT.place(pg).report() == REF.place(rg).report()
    assert pg.store.stats() == rg.store.stats()


@pytest.mark.parametrize("name", sorted(BUILDERS))
@pytest.mark.parametrize("symbolic", [True, False])
def test_buffer_plan_lines_match(name, symbolic):
    (rg, rs), (pg, ps) = BUILDERS[name](REF), BUILDERS[name](PORT)
    rpol = REF.bucketing.BucketPolicy(caps=(("S", 128),))
    ppol = PORT.bucketing.BucketPolicy(caps=(("S", 128),))
    rplan = REF.buffers(rg, rpol, symbolic=symbolic)
    pplan = PORT.buffers(pg, ppol, symbolic=symbolic)
    assert pplan.render_lines(pg) == rplan.render_lines(rg)
    assert pplan.symbolic_peak() == rplan.symbolic_peak()
    assert pplan.symbolic_peak_no_reuse() == rplan.symbolic_peak_no_reuse()
    assert pplan.donatable_args == rplan.donatable_args
    assert pplan.reuse_counts == rplan.reuse_counts
    for n in (1, 37, 128):
        rb = rplan.concrete_peaks(rg, {d.uid: n for d in rs})
        pb = pplan.concrete_peaks(pg, {d.uid: n for d in ps})
        assert pb == rb


@pytest.mark.parametrize("policy", [
    dict(kind="pow2", granule=16),
    dict(kind="pow2", granule=8, overrides=(("S", ("multiple", 32)),)),
    dict(kind="multiple", granule=64, caps=(("S", 1000),)),
    dict(kind="exact"),
])
def test_bucket_keys_match(policy):
    rpol = REF.bucketing.BucketPolicy(**policy)
    ppol = PORT.bucketing.BucketPolicy(**policy)
    def key(pol, n):
        try:
            return pol.bucket("S", n)
        except ValueError as e:  # beyond a declared cap
            return str(e)

    for n in list(range(1, 70)) + [127, 128, 129, 999, 1000, 2047]:
        assert key(ppol, n) == key(rpol, n)
    assert ppol.emit_bucket_expr("S", "s_0") == \
        rpol.emit_bucket_expr("S", "s_0")
