"""The port's per-op emission table against the JAX package's, op by op.

Every opcode with an emission rule runs through ``repro.core.emit.emit_op``
(jax on the CPU) and ``repro_torch.core.emit.emit_op`` (torch on the CPU)
on the same numpy inputs.  f32 results agree to ``rtol=1e-5``: the two
libraries' transcendental functions differ by an ulp or two; everything
else is exact.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from jax import lax

import repro.core.dhlo as RD
import repro.core.emit as RE
import repro_torch.core.dhlo as PD
import repro_torch.core.emit as PE
from repro_torch.core.dtypes import as_torch

F, I, B = np.float32, np.int32, np.bool_


def _any(shape, rs):
    return rs.standard_normal(shape).astype(F)


def _pos(shape, rs):
    return (np.abs(rs.standard_normal(shape)) + 0.1).astype(F)


def _unit(shape, rs):
    return rs.uniform(-0.9, 0.9, shape).astype(F)


def _ints(shape, rs):
    return rs.randint(1, 50, shape).astype(I)


def _bools(shape, rs):
    return rs.rand(*shape) > 0.5


# name: (opcode, [(input maker, shape)], out shape, out dtype, attrs)
S = (3, 5)
CASES = {}
for code in ("neg", "sign", "floor", "ceil", "round", "exp", "exp2",
             "expm1", "log1p", "tanh", "logistic", "cbrt", "abs", "erf",
             "erfc", "sin", "cos", "tan", "atan", "sinh", "cosh", "square",
             "stop_gradient", "copy"):
    CASES[code] = (code, [(_any, S)], S, F, {})
for code in ("log", "sqrt", "rsqrt"):
    CASES[code] = (code, [(_pos, S)], S, F, {})
for code in ("erf_inv", "asin", "acos"):
    CASES[code] = (code, [(_unit, S)], S, F, {})
CASES["is_finite"] = ("is_finite", [(_any, S)], S, B, {})
CASES["not"] = ("not", [(_bools, S)], S, B, {})
for code in ("add", "sub", "mul", "div", "max", "min", "atan2",
             "nextafter"):
    CASES[code] = (code, [(_any, S), (_pos, S)], S, F, {})
# lax.rem is C fmod; the reference re-emits it as jnp.remainder, which
# differs for negative dividends — compare where the two agree
CASES["rem"] = ("rem", [(_pos, S), (_pos, S)], S, F, {})
CASES["pow"] = ("pow", [(_pos, S), (_any, S)], S, F, {})
for code in ("eq", "ne", "lt", "gt", "le", "ge"):
    CASES[code] = (code, [(_any, S), (_any, S)], S, B, {})
for code in ("and", "or", "xor", "shift_left", "shift_right_arithmetic"):
    CASES[f"{code}_int"] = (code, [(_ints, S), (_ints, S)], S, I, {})
CASES["and_bool"] = ("and", [(_bools, S), (_bools, S)], S, B, {})
CASES["implicit_broadcast"] = ("mul", [(_any, (3, 5)), (_any, (3, 1))], S,
                               F, {})
for code in ("reduce_sum", "reduce_max", "reduce_min", "reduce_prod"):
    CASES[f"{code}_1"] = (code, [(_any, (3, 5, 4))], (3, 4), F,
                          {"axes": (1,)})
    CASES[f"{code}_02"] = (code, [(_any, (3, 5, 4))], (5,), F,
                           {"axes": (0, 2)})
CASES["reduce_and"] = ("reduce_and", [(_bools, (3, 5))], (3,), B,
                       {"axes": (1,)})
CASES["reduce_or"] = ("reduce_or", [(_bools, (3, 5))], (5,), B,
                      {"axes": (0,)})
CASES["integer_pow"] = ("integer_pow", [(_any, S)], S, F,
                        {"_params": {"y": 3}})
CASES["select"] = ("select", [(_bools, S), (_any, S), (_any, S)], S, F, {})
CASES["clamp"] = ("clamp", [(lambda s, rs: np.full(s, -0.5, F), S),
                            (_any, S), (lambda s, rs: np.full(s, 0.5, F), S)],
                  S, F, {})
CASES["broadcast_in_dim"] = ("broadcast_in_dim", [(_any, (5,))], (3, 5), F,
                             {"broadcast_dimensions": (1,)})
CASES["reshape"] = ("reshape", [(_any, (3, 4, 5))], (12, 5), F, {})
CASES["transpose"] = ("transpose", [(_any, (3, 4, 5))], (5, 3, 4), F,
                      {"permutation": (2, 0, 1)})
CASES["rev"] = ("rev", [(_any, (3, 4))], (3, 4), F,
                {"_params": {"dimensions": (1,)}})
CASES["argmax"] = ("argmax", [(_any, (3, 5))], (3,), I, {"axes": (1,)})
CASES["argmin"] = ("argmin", [(_any, (3, 5))], (5,), I, {"axes": (0,)})
CASES["dot_general"] = ("dot_general", [(_any, (2, 3, 4)), (_any, (2, 4, 5))],
                        (2, 3, 5), F,
                        {"dimension_numbers": (((2,), (1,)), ((0,), (0,)))})
CASES["slice"] = ("slice", [(_any, (6, 7))], (2, 2), F,
                  {"start_indices": (1, 0), "limit_indices": (5, 7),
                   "strides": (2, 3)})
CASES["concatenate"] = ("concatenate", [(_any, (2, 3)), (_any, (4, 3))],
                        (6, 3), F, {"dimension": 0})
CASES["iota"] = ("iota", [], (3, 4), I, {"dimension": 1})
CASES["sort"] = ("sort", [(_any, (3, 6))], (3, 6), F,
                 {"_params": {"dimension": 1}})


def _reference_prim(code):
    return {"cumsum": lax.cumsum_p, "cumprod": lax.cumprod_p,
            "cummax": lax.cummax_p}.get(code)


for code in ("cumsum", "cumprod", "cummax"):
    for rev in (False, True):
        CASES[f"{code}_{rev}"] = (code, [(_any, (3, 5))], (3, 5), F,
                                  {"_params": {"axis": 1, "reverse": rev}})


def _run(name):
    code, ins, out_shape, out_dt, attrs = CASES[name]
    rs = np.random.RandomState(sum(map(ord, name)))
    arrays = [make(shape, rs) for make, shape in ins]

    rg = RD.DGraph()
    r_in = [rg.add_param(a.shape, a.dtype) for a in arrays]
    r_attrs = dict(attrs)
    if _reference_prim(code) is not None:
        r_attrs["_prim"] = _reference_prim(code)
    rop = rg.add_op(code, r_in, [out_shape], [out_dt], attrs=r_attrs)
    want = np.asarray(RE.emit_op(rop, [np.asarray(a) for a in arrays],
                                 [out_shape])[0])

    pg = PD.DGraph()
    p_in = [pg.add_param(a.shape, as_torch(a.dtype)) for a in arrays]
    pop = pg.add_op(code, p_in, [out_shape], [as_torch(out_dt)],
                    attrs=dict(attrs))
    got = PE.emit_op(pop, [torch.from_numpy(np.array(a)) for a in arrays],
                     [out_shape])[0]
    return want, got


@pytest.mark.parametrize("name", sorted(CASES))
def test_emit_matches_reference(name):
    want, got = _run(name)
    assert tuple(got.shape) == want.shape
    assert got.dtype == as_torch(want.dtype)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_convert_pad_and_dynamic_slices():
    x = np.random.RandomState(0).standard_normal((4, 5)).astype(F)
    cases = [
        ("convert", [x], (4, 5), {"new_dtype": (np.int32, torch.int32)}, []),
        ("pad", [x, np.asarray(0.5, F)], (5, 10),
         {"padding_config": ((1, 0, 0), (-1, 2, 1))}, []),
        ("dslice", [x], (2, 3), {}, [np.asarray(3, I), np.asarray(1, I)]),
        ("dynamic_update_slice", [x, np.ones((2, 2), F)], (4, 5), {},
         [np.asarray(1, I), np.asarray(4, I)]),
    ]
    for code, ins, out_shape, attrs, starts in cases:
        rg, pg = RD.DGraph(), PD.DGraph()
        r_attrs = {k: v[0] if isinstance(v, tuple) and k == "new_dtype"
                   else v for k, v in attrs.items()}
        p_attrs = {k: v[1] if isinstance(v, tuple) and k == "new_dtype"
                   else v for k, v in attrs.items()}
        out_dt = np.int32 if code == "convert" else F
        rop = rg.add_op(code, [rg.add_param(a.shape, a.dtype) for a in ins],
                        [out_shape], [out_dt],
                        shape_operands=[rg.add_param((), I) for _ in starts],
                        attrs=r_attrs)
        pop = pg.add_op(code, [pg.add_param(a.shape, as_torch(a.dtype))
                               for a in ins], [out_shape],
                        [as_torch(out_dt)],
                        shape_operands=[pg.add_param((), torch.int32)
                                        for _ in starts], attrs=p_attrs)
        want = np.asarray(RE.emit_op(rop, list(ins) + starts,
                                     [out_shape])[0])
        got = PE.emit_op(pop, [torch.from_numpy(np.array(a))
                               for a in list(ins) + starts], [out_shape])[0]
        np.testing.assert_array_equal(got.numpy(), want, err_msg=code)


def test_every_rule_is_covered():
    covered = {c[0] for c in CASES.values()} | {
        "convert", "pad", "dslice", "dynamic_update_slice"}
    assert PE.HAS_RULE - covered <= {"shift_right_logical"}
    assert PE.HAS_RULE == RE.HAS_RULE
