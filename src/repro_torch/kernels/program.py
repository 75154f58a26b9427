"""Cluster programs: the elementwise expression a fused kernel body runs.

The JAX package hands its Pallas kernels the fused cluster as a Python
closure that Pallas unrolls at trace time.  A Triton kernel cannot take a
closure, so the port hands its kernels a :class:`Program` instead — the
cluster's body ops as data — from which

* :func:`eval_program` computes the plain PyTorch version, op by op with
  the eager emission rules (the kernels' ``ref.py`` and the CPU path), and
* :func:`triton_lines` generates the kernel body as Triton source.

Both follow the eager numerics of each op: every value is computed in its
math type (f32 for f16/bf16/f32 values) and rounded to its own dtype
before its consumers read it, so a fused kernel and the per-op path
differ only by the order of nothing — each op is the same rounded op.
"""
from __future__ import annotations

import functools
import hashlib
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import torch

from ..core.dtypes import as_torch

__all__ = ["Arg", "Step", "Program", "eval_program", "triton_lines",
           "triton_dtype"]

#: an operand of a step: ("in", i) kernel input i, ("t", j) the result of
#: step j, ("c", value) a literal Python number
Arg = Tuple[str, Any]


@dataclass(frozen=True)
class Step:
    opcode: str
    args: Tuple[Arg, ...]
    dtype: torch.dtype
    # opcode parameters: new_dtype for convert, y for integer_pow
    param: Any = None


@dataclass(frozen=True)
class Program:
    """A straight-line elementwise program over ``len(in_dtypes)`` inputs.

    ``outs`` name the values the kernel stores (step results or inputs).
    """

    in_dtypes: Tuple[torch.dtype, ...]
    steps: Tuple[Step, ...]
    outs: Tuple[Arg, ...]

    @property
    def out_dtypes(self) -> Tuple[torch.dtype, ...]:
        return tuple(self.dtype_of(a) for a in self.outs)

    def dtype_of(self, a: Arg) -> torch.dtype:
        kind, x = a
        if kind == "in":
            return self.in_dtypes[x]
        if kind == "t":
            return self.steps[x].dtype
        raise ValueError(f"literal {a!r} has no dtype of its own")

    @functools.cached_property
    def key(self) -> str:
        """Stable fingerprint: identical clusters of 22 layers share one
        compiled kernel."""
        return hashlib.sha1(repr(self).encode()).hexdigest()[:16]


# ----------------------------------------------------------- plain eval --

def eval_program(program: Program, inputs: Sequence[torch.Tensor]
                 ) -> List[torch.Tensor]:
    """Run ``program`` eagerly on ``inputs`` (broadcastable tensors)."""
    from ..core.emit import BINARY, UNARY

    vals: List[Any] = []

    def rd(a: Arg):
        kind, x = a
        if kind == "in":
            return inputs[x]
        if kind == "t":
            return vals[x]
        return x

    for st in program.steps:
        ins = [rd(a) for a in st.args]
        code = st.opcode
        if code in UNARY:
            y = UNARY[code](ins[0])
        elif code in BINARY:
            a, b = ins
            if not isinstance(a, torch.Tensor) and \
                    not isinstance(b, torch.Tensor):
                a = torch.tensor(a, dtype=st.dtype)
            y = BINARY[code](a, b)
        elif code == "select":
            pred, on_false, on_true = ins
            y = torch.where(pred, on_true, on_false)
        elif code == "convert":
            y = ins[0].to(st.param)
        elif code == "integer_pow":
            y = ins[0] ** st.param
        else:
            raise NotImplementedError(f"no plain rule for {code}")
        if not isinstance(y, torch.Tensor):
            y = torch.tensor(y)
        vals.append(y if y.dtype == st.dtype else y.to(st.dtype))
    return [rd(a) for a in program.outs]


# -------------------------------------------------------- triton source --

_TL = {
    torch.float32: "tl.float32", torch.float16: "tl.float16",
    torch.bfloat16: "tl.bfloat16", torch.float64: "tl.float64",
    torch.int32: "tl.int32", torch.int64: "tl.int64", torch.int16: "tl.int16",
    torch.int8: "tl.int8", torch.uint8: "tl.uint8", torch.bool: "tl.int1",
}

_LOW_FLOATS = (torch.float16, torch.bfloat16)


def triton_dtype(dt) -> str:
    return _TL[as_torch(dt)]


def _math_dtype(dt: torch.dtype) -> torch.dtype:
    """The type a value is computed in (eager's opmath type)."""
    return torch.float32 if dt in _LOW_FLOATS else dt


_UNARY_TL = {
    "neg": "-({0})", "exp": "libdevice.exp({0})", "exp2": "libdevice.exp2({0})",
    "expm1": "libdevice.expm1({0})", "log": "libdevice.log({0})",
    "log1p": "libdevice.log1p({0})", "tanh": "libdevice.tanh({0})",
    "logistic": ("libdevice.div_rn(tl.zeros_like({0}) + 1.0, "
                 "1.0 + libdevice.exp(-({0})))"),
    "sqrt": "libdevice.sqrt({0})", "rsqrt": "libdevice.rsqrt({0})",
    "abs": "tl.abs({0})", "floor": "libdevice.floor({0})",
    "ceil": "libdevice.ceil({0})", "round": "libdevice.rint({0})",
    "erf": "libdevice.erf({0})", "sin": "libdevice.sin({0})",
    "cos": "libdevice.cos({0})", "square": "(({0}) * ({0}))",
    "sign": "tl.where(({0}) > 0, 1, tl.where(({0}) < 0, -1, 0))",
    "stop_gradient": "({0})", "copy": "({0})",
}

_BINARY_TL = {
    "add": "({0} + {1})", "sub": "({0} - {1})", "mul": "({0} * {1})",
    "div": "({0} // {1})", "div_rn": "libdevice.div_rn({0}, {1})",
    "max": "tl.maximum({0}, {1})",
    "min": "tl.minimum({0}, {1})", "pow": "libdevice.pow({0}, {1})",
    "eq": "({0} == {1})", "ne": "({0} != {1})", "lt": "({0} < {1})",
    "gt": "({0} > {1})", "le": "({0} <= {1})", "ge": "({0} >= {1})",
    "and": "({0} & {1})", "or": "({0} | {1})",
}


def _literal(x: Any) -> str:
    if isinstance(x, bool):
        return "1" if x else "0"
    if isinstance(x, float):
        if x != x:
            return "float('nan')"
        if x in (float("inf"), float("-inf")):
            return f"float('{x}')"
    return repr(x)


def triton_lines(program: Program, loaded: Sequence[str],
                 indent: str = "    ") -> Tuple[List[str], List[str]]:
    """Source lines computing ``program`` from already-loaded input blocks.

    ``loaded[i]`` names input ``i`` as loaded (its storage dtype).  Returns
    ``(lines, outs)``: ``outs[k]`` names output ``k`` in its math type.
    """
    lines: List[str] = []
    names: Dict[Arg, str] = {}

    def ref(a: Arg, want: torch.dtype) -> str:
        kind, x = a
        if kind == "c":
            return _literal(x)
        if kind == "in":
            dt = program.in_dtypes[x]
            name = loaded[x]
        else:
            dt = program.steps[x].dtype
            name = names[a]
        if want is not None and _math_dtype(dt) != _math_dtype(want):
            return f"{name}.to({triton_dtype(_math_dtype(want))})"
        return name

    for i in range(len(program.in_dtypes)):
        dt = program.in_dtypes[i]
        if dt in _LOW_FLOATS:
            lines.append(f"{indent}{loaded[i]} = {loaded[i]}.to(tl.float32)")

    for j, st in enumerate(program.steps):
        code = st.opcode
        name = f"t{j}"
        math = _math_dtype(st.dtype)
        if code in _UNARY_TL:
            expr = _UNARY_TL[code].format(ref(st.args[0], st.dtype))
        elif code == "not":
            a = ref(st.args[0], None)
            expr = f"({a} == 0)" if st.dtype is torch.bool else f"(~{a})"
        elif code in _BINARY_TL:
            if code in ("eq", "ne", "lt", "gt", "le", "ge", "and", "or"):
                # predicates compute in their operands' type
                operand = next((program.dtype_of(a) for a in st.args
                                if a[0] != "c"), st.dtype)
            else:
                operand = st.dtype
            a, b = (ref(x, operand) for x in st.args)
            if code == "div" and operand.is_floating_point:
                code = "div_rn"  # IEEE division, as eager computes it
            if code in ("pow", "div_rn"):  # libdevice takes tensors only
                if st.args[0][0] == "c":
                    a = f"(tl.zeros_like({b}) + {a})"
                if st.args[1][0] == "c":
                    b = f"(tl.zeros_like({a}) + {b})"
            expr = _BINARY_TL[code].format(a, b)
        elif code == "select":
            pred = ref(st.args[0], None)
            expr = (f"tl.where({pred} != 0, {ref(st.args[2], st.dtype)}, "
                    f"{ref(st.args[1], st.dtype)})")
        elif code == "convert":
            src = st.args[0]
            expr = ref(src, None) if src[0] != "c" else _literal(src[1])
            if st.dtype is torch.bool:
                expr = f"({expr} != 0)"
        elif code == "integer_pow":
            x = ref(st.args[0], st.dtype)
            y = int(st.param)
            if y == 0:
                expr = f"tl.full({x}.shape, 1, {triton_dtype(math)})"
            else:
                prod = " * ".join([f"({x})"] * abs(y))
                expr = f"({prod})" if y > 0 else f"(1.0 / ({prod}))"
        else:
            raise NotImplementedError(f"no Triton rule for {code}")
        if st.dtype is torch.bool:
            lines.append(f"{indent}{name} = {expr}")
        else:
            lines.append(f"{indent}{name} = ({expr}).to({triton_dtype(math)})")
            if st.dtype in _LOW_FLOATS:
                # round to the value's own dtype, as the eager op does
                lines.append(f"{indent}{name} = {name}.to("
                             f"{triton_dtype(st.dtype)}).to(tl.float32)")
        names[("t", j)] = name

    outs = []
    for a in program.outs:
        kind, x = a
        outs.append(loaded[x] if kind == "in" else names[a])
    return lines, outs
