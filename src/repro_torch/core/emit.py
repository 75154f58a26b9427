"""Per-op PyTorch emission rules — the device-side per-op table.

Each DHLO opcode maps to a rule ``(op, inputs, out_shapes) -> outputs`` that
re-derives any shape-bearing parameters from the op's *symbolic* output
shapes evaluated at the current concrete sizes — the DHLO property that the
computation is re-emittable at any runtime shape.  Rules are eager torch
calls on the inputs' device: this table is the ``"eager"`` backend, and the
per-op path every cluster without a registered kernel takes.

Operands are tensors, except rank-0 *literals*, which arrive as Python
numbers: eager PyTorch computes ``t * 0.5`` in the op's math type with the
scalar unrounded, and passing the number keeps that (a 0-dim tensor of the
value's weak dtype would round it first).  Every rule's result is cast to
the DHLO output dtype, so integer sums or scalar promotions never leak a
dtype the graph did not declare.
"""
from __future__ import annotations

import operator
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .dhlo import DOp
from .dtypes import as_torch, is_floating
from .primitives import einsum_dot

__all__ = ["emit_op", "HAS_RULE", "UNARY", "BINARY"]


def _not(x):
    return torch.logical_not(x) if x.dtype == torch.bool \
        else torch.bitwise_not(x)


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


UNARY: Dict[str, Callable] = {
    "neg": operator.neg, "sign": torch.sign, "floor": torch.floor,
    "ceil": torch.ceil, "round": torch.round, "exp": torch.exp,
    "exp2": torch.exp2, "expm1": torch.expm1, "log": torch.log,
    "log1p": torch.log1p, "tanh": torch.tanh, "logistic": torch.sigmoid,
    "sqrt": torch.sqrt, "rsqrt": torch.rsqrt, "cbrt": _cbrt,
    "abs": torch.abs, "erf": torch.erf, "erfc": torch.erfc,
    "erf_inv": torch.erfinv, "sin": torch.sin, "cos": torch.cos,
    "tan": torch.tan, "asin": torch.asin, "acos": torch.acos,
    "atan": torch.atan, "sinh": torch.sinh, "cosh": torch.cosh,
    "not": _not, "is_finite": torch.isfinite,
    "stop_gradient": lambda x: x, "copy": lambda x: x,
    "square": lambda x: x * x,
}


def _div(a, b):
    # lax.div: true division on floats, truncation toward zero on ints
    dt = a.dtype if isinstance(a, torch.Tensor) else b.dtype
    if is_floating(dt):
        return a / b
    return torch.div(a, b, rounding_mode="trunc")


def _max(a, b):
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    return torch.clamp_min(a, b) if not isinstance(b, torch.Tensor) \
        else torch.maximum(a, b)


def _min(a, b):
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    return torch.clamp_max(a, b) if not isinstance(b, torch.Tensor) \
        else torch.minimum(a, b)


BINARY: Dict[str, Callable] = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul,
    "div": _div, "rem": torch.fmod, "pow": operator.pow,
    "max": _max, "min": _min, "atan2": torch.atan2,
    "and": operator.and_, "or": operator.or_, "xor": operator.xor,
    "eq": operator.eq, "ne": operator.ne, "lt": operator.lt,
    "gt": operator.gt, "le": operator.le, "ge": operator.ge,
    "nextafter": torch.nextafter,
    "shift_left": operator.lshift, "shift_right_logical": operator.rshift,
    "shift_right_arithmetic": operator.rshift,
}


def _reduce_prod(x, axis):
    for a in sorted(axis, reverse=True):
        x = torch.prod(x, dim=a)
    return x


_REDUCE = {
    "reduce_sum": lambda x, axis: torch.sum(x, dim=axis),
    "reduce_max": lambda x, axis: torch.amax(x, dim=axis),
    "reduce_min": lambda x, axis: torch.amin(x, dim=axis),
    "reduce_prod": _reduce_prod,
    "reduce_and": lambda x, axis: torch.all(x, dim=axis),
    "reduce_or": lambda x, axis: torch.any(x, dim=axis),
}


def _tensor_operands(op: DOp, inputs: Sequence[Any], device) -> List[Any]:
    """Operands with at least one tensor among them: an op whose operands
    are all literals gets its first one as a 0-dim tensor on ``device``."""
    if any(isinstance(x, torch.Tensor) for x in inputs) or not inputs:
        return list(inputs)
    first = torch.tensor(inputs[0], dtype=as_torch(op.inputs[0].dtype),
                         device=device)
    return [first] + list(inputs[1:])


def _broadcast_in_dim(x, shape, bdims):
    view = [1] * len(shape)
    for i, d in enumerate(bdims):
        view[d] = x.shape[i]
    return x.reshape(view).expand(tuple(shape))


def _pad(x, value, cfg):
    if all(interior == 0 for _, _, interior in cfg):
        widths: List[int] = []
        for lo, hi, _ in reversed(cfg):
            widths += [lo, hi]
        return torch.nn.functional.pad(x, widths, value=value)
    shape = [d + lo + hi + max(d - 1, 0) * it
             for d, (lo, hi, it) in zip(x.shape, cfg)]
    lo_shape = [d + max(lo, 0) + max(hi, 0) + max(d - 1, 0) * it
                for d, (lo, hi, it) in zip(x.shape, cfg)]
    out = torch.full(lo_shape, value, dtype=x.dtype, device=x.device)
    idx = tuple(slice(max(lo, 0), max(lo, 0) + (d - 1) * (it + 1) + 1, it + 1)
                for d, (lo, hi, it) in zip(x.shape, cfg))
    out[idx] = x
    crop = tuple(slice(max(-lo, 0), max(-lo, 0) + n)
                 for n, (lo, _, _) in zip(shape, cfg))
    return out[crop]


def _cumulative(code, x, axis, reverse):
    if reverse:
        x = torch.flip(x, (axis,))
    if code == "cumsum":
        y = torch.cumsum(x, dim=axis)
    elif code == "cumprod":
        y = torch.cumprod(x, dim=axis)
    else:
        y = torch.cummax(x, dim=axis).values
    return torch.flip(y, (axis,)) if reverse else y


def _starts(idx) -> List[int]:
    return [int(i) for i in idx]


def _emit(op: DOp, inputs: Sequence[Any], out_shapes, device) -> List[Any]:
    code = op.opcode
    if code in UNARY:
        (x,) = _tensor_operands(op, inputs, device)
        return [UNARY[code](x)]
    if code in BINARY:
        a, b = _tensor_operands(op, inputs, device)
        return [BINARY[code](a, b)]
    if code in _REDUCE:
        axes = tuple(op.attrs.get("axes", ()))
        return [_REDUCE[code](inputs[0], axes)]
    if code == "integer_pow":
        y = op.attrs.get("_params", {}).get("y", 2)
        return [inputs[0] ** y]
    if code == "select":
        pred, *cases = _tensor_operands(op, inputs, device)
        if len(cases) == 2:
            return [torch.where(pred, cases[1], cases[0])]
        out = cases[0]
        for i, c in enumerate(cases[1:], start=1):
            out = torch.where(pred == i, c, out)
        return [out]
    if code == "clamp":
        lo, x, hi = _tensor_operands(op, inputs, device)  # lax.clamp order
        return [_min(_max(x, lo), hi)]
    if code == "convert":
        x = inputs[0]
        dt = as_torch(op.attrs["new_dtype"])
        if not isinstance(x, torch.Tensor):
            return [torch.tensor(x, dtype=dt, device=device)]
        return [x.to(dt)]
    if code == "broadcast_in_dim":
        bdims = op.attrs["broadcast_dimensions"]
        x = inputs[0]
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(x, dtype=as_torch(op.outputs[0].dtype),
                             device=device)
        return [_broadcast_in_dim(x, out_shapes[0], bdims)]
    if code == "reshape":
        return [torch.reshape(inputs[0], tuple(out_shapes[0]))]
    if code == "transpose":
        return [inputs[0].permute(tuple(op.attrs["permutation"]))]
    if code == "rev":
        dims = op.attrs.get("_params", {}).get("dimensions", ())
        return [torch.flip(inputs[0], tuple(dims))]
    if code in ("argmax", "argmin"):
        axes = op.attrs.get("axes", (0,))
        fn = torch.argmax if code == "argmax" else torch.argmin
        return [fn(inputs[0], dim=axes[0])]
    if code in ("cumsum", "cumprod", "cummax"):
        params = op.attrs.get("_params", {})
        return [_cumulative(code, inputs[0], params.get("axis", 0),
                            params.get("reverse", False))]
    if code == "dot_general":
        return [einsum_dot(inputs[0], inputs[1],
                           op.attrs["dimension_numbers"])]
    if code == "dslice":
        x = inputs[0]
        starts = _starts(inputs[1:])
        idx = []
        for ax, (s, n) in enumerate(zip(starts, out_shapes[0])):
            s = min(max(s, 0), x.shape[ax] - n)  # lax clamps start indices
            idx.append(slice(s, s + n))
        return [x[tuple(idx)]]
    if code == "dynamic_update_slice":
        x, upd = inputs[0], inputs[1]
        out = x.clone()
        idx = []
        for ax, s in enumerate(_starts(inputs[2:])):
            s = min(max(s, 0), x.shape[ax] - upd.shape[ax])
            idx.append(slice(s, s + upd.shape[ax]))
        out[tuple(idx)] = upd
        return [out]
    if code == "slice":
        starts = op.attrs["start_indices"]
        strides = op.attrs.get("strides") or (1,) * len(starts)
        idx = tuple(slice(s, s + o * st, st) for s, o, st in
                    zip(starts, out_shapes[0], strides))
        return [inputs[0][idx]]
    if code == "concatenate":
        return [torch.cat(list(inputs), dim=op.attrs["dimension"])]
    if code == "pad":
        cfg = op.attrs["padding_config"]
        value = inputs[1]
        if isinstance(value, torch.Tensor):
            value = value.item()
        return [_pad(inputs[0], value, cfg)]
    if code == "iota":
        dt = as_torch(op.outputs[0].dtype)
        shape = tuple(out_shapes[0])
        dim = op.attrs.get("dimension", 0)
        r = torch.arange(shape[dim], dtype=dt, device=device)
        view = [1] * len(shape)
        view[dim] = shape[dim]
        return [r.reshape(view).expand(shape)]
    if code == "sort":
        dim = op.attrs.get("_params", {}).get("dimension", -1)
        return [torch.sort(inputs[0], dim=dim).values]
    if code in ("d.while", "d.scan", "d.cond"):
        raise NotImplementedError(
            f"region op {code} carries nested DGraph bodies; it runs "
            f"through codegen.emit_region_op, not emit_op")
    raise NotImplementedError(f"no emission rule for {code}")


def emit_op(op: DOp, inputs: Sequence[Any],
            out_shapes: Sequence[Tuple[int, ...]],
            device: Optional[torch.device] = None) -> List[torch.Tensor]:
    """Execute one DHLO op eagerly at concrete shapes ``out_shapes``."""
    outs = _emit(op, inputs, out_shapes, device)
    res = []
    for o, val in zip(op.outputs, outs):
        dt = as_torch(o.dtype)
        res.append(val if val.dtype == dt else val.to(dt))
    return res


HAS_RULE = (set(UNARY) | set(BINARY) | set(_REDUCE) |
            {"integer_pow", "select", "clamp", "convert", "broadcast_in_dim",
             "reshape", "transpose", "rev", "argmax", "argmin", "cumsum",
             "cumprod", "cummax", "dot_general", "dslice",
             "dynamic_update_slice", "slice", "concatenate", "pad", "iota",
             "sort"})
