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

No rule reads a device value on the host or copies a host value to the
device, so a padded executor built from these rules can be captured into
a CUDA graph: a scalar operand becomes a tensor by a fill
(:func:`scalar_tensor`), and a tensor start index of ``dslice`` /
``dynamic_update_slice`` or a tensor padding value of ``pad`` is used on
the device where it lies.
"""
from __future__ import annotations

import operator
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .dhlo import DOp
from .dtypes import as_torch, is_floating
from .primitives import einsum_dot

__all__ = ["emit_op", "scalar_tensor", "HAS_RULE", "UNARY", "BINARY"]


def scalar_tensor(value, dtype: torch.dtype, device) -> torch.Tensor:
    """A 0-d tensor of ``value`` made on ``device`` by a fill: never a
    copy from host memory, which a CUDA graph capture refuses."""
    try:
        return torch.full((), value, dtype=dtype, device=device)
    except RuntimeError:  # out of range: rounded on the host, as
        value = torch.tensor(value, dtype=dtype).item()  # torch.tensor does
        return torch.full((), value, dtype=dtype, device=device)


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
    first = scalar_tensor(inputs[0], as_torch(op.inputs[0].dtype), device)
    return [first] + list(inputs[1:])


def _broadcast_in_dim(x, shape, bdims):
    view = [1] * len(shape)
    for i, d in enumerate(bdims):
        view[d] = x.shape[i]
    return x.reshape(view).expand(tuple(shape))


def _pad(x, value, cfg):
    if isinstance(value, torch.Tensor):
        # a padding value on the device: pad with zeros, then fill the
        # padding through a mask padded the same way
        inside = _pad(torch.ones_like(x, dtype=torch.bool), False, cfg)
        return torch.where(inside, _pad(x, 0, cfg), value.to(x.dtype))
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


def _start(start, dim: int, n: int) -> int:
    """A host start index as ``lax`` takes it: a negative one counts from
    the end, then it is clamped so that the window fits."""
    s = int(start)
    s = s + dim if s < 0 else s
    return min(max(s, 0), dim - n)


def _window(x: torch.Tensor, ax: int, start, n: int) -> torch.Tensor:
    """The ``n`` indices from ``start`` along ``ax`` of ``x``, the start
    taken as ``lax`` takes it (:func:`_start`): a host int directly, a
    tensor start on the device, where the window is then gathered."""
    dim = x.shape[ax]
    if not isinstance(start, torch.Tensor):
        s = _start(start, dim, n)
        return torch.arange(s, s + n, device=x.device)
    s = start.reshape(()).to(torch.int64)
    s = torch.where(s < 0, s + dim, s).clamp(0, dim - n)
    return s + torch.arange(n, device=x.device)


def _dslice(x, starts, sizes):
    for ax, (s, n) in enumerate(zip(starts, sizes)):
        if isinstance(s, torch.Tensor):
            x = torch.index_select(x, ax, _window(x, ax, s, n))
        else:
            x = x.narrow(ax, _start(s, x.shape[ax], n), n)
    return x


def _dynamic_update_slice(x, upd, starts):
    # index_put over the broadcast grid of the clamped windows
    grids = []
    for ax, s in enumerate(starts):
        view = [1] * x.dim()
        view[ax] = upd.shape[ax]
        grids.append(_window(x, ax, s, upd.shape[ax]).reshape(view))
    return x.index_put(tuple(grids), upd.to(x.dtype))


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
            return [scalar_tensor(x, dt, device)]
        return [x.to(dt)]
    if code == "broadcast_in_dim":
        bdims = op.attrs["broadcast_dimensions"]
        x = inputs[0]
        if not isinstance(x, torch.Tensor):
            x = scalar_tensor(x, as_torch(op.outputs[0].dtype), device)
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
        return [_dslice(inputs[0], inputs[1:], out_shapes[0])]
    if code == "dynamic_update_slice":
        return [_dynamic_update_slice(inputs[0], inputs[1], inputs[2:])]
    if code == "slice":
        starts = op.attrs["start_indices"]
        strides = op.attrs.get("strides") or (1,) * len(starts)
        idx = tuple(slice(s, s + o * st, st) for s, o, st in
                    zip(starts, out_shapes[0], strides))
        return [inputs[0][idx]]
    if code == "concatenate":
        return [torch.cat(list(inputs), dim=op.attrs["dimension"])]
    if code == "pad":
        return [_pad(inputs[0], inputs[1], op.attrs["padding_config"])]
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
