"""Cluster programs: the elementwise expression a fused kernel body runs.

The JAX package hands its Pallas kernels the fused cluster as a Python
closure that Pallas unrolls at trace time.  A Triton kernel cannot take a
closure, so the port hands its kernels a :class:`Program` instead — the
cluster's body ops as data — from which

* :func:`eval_program` computes the plain PyTorch version, op by op with
  the eager emission rules (the kernels' ``ref.py`` and the CPU path),
* :func:`triton_lines` generates the kernel body as Triton source (kLoop,
  kInput), and
* :func:`cuda_lines` generates it as CUDA C++ (the kDot epilogue).

All follow the eager numerics of each op: every value is computed in its
math type (f32 for f16/bf16/f32 values) and rounded to its own dtype
before its consumers read it, so a fused kernel and the per-op path
differ only by the order of nothing — each op is the same rounded op.
Division is IEEE (``div_rn``), and nothing is contracted into a fused
multiply-add.
"""
from __future__ import annotations

import functools
import hashlib
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import torch

from ..core.dtypes import as_torch

__all__ = ["Arg", "Step", "Program", "eval_program", "triton_lines",
           "triton_dtype", "cuda_lines", "cuda_type", "cuda_load",
           "cuda_store"]

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


# ---------------------------------------------------------- CUDA source --

_C_STORAGE = {
    torch.float32: "float", torch.bfloat16: "__nv_bfloat16",
    torch.float16: "__half", torch.float64: "double", torch.int32: "int",
    torch.int64: "long long", torch.int16: "short", torch.int8: "signed char",
    torch.uint8: "unsigned char", torch.bool: "bool",
}

_C_ROUND = {torch.bfloat16: "disc::round_bf16",
            torch.float16: "disc::round_f16"}
_C_TO_LOW = {torch.bfloat16: "__float2bfloat16_rn",
             torch.float16: "__float2half_rn"}

# "{f}" is the single-precision suffix of the math function ("" in double)
_UNARY_C = {
    "neg": "(-({0}))", "exp": "exp{f}({0})", "exp2": "exp2{f}({0})",
    "expm1": "expm1{f}({0})", "log": "log{f}({0})",
    "log1p": "log1p{f}({0})", "tanh": "tanh{f}({0})",
    "sqrt": "sqrt{f}({0})", "rsqrt": "rsqrt{f}({0})",
    "floor": "floor{f}({0})", "ceil": "ceil{f}({0})",
    "round": "rint{f}({0})", "erf": "erf{f}({0})", "sin": "sin{f}({0})",
    "cos": "cos{f}({0})", "square": "(({0}) * ({0}))",
    "sign": "((({0}) > 0) - (({0}) < 0))",
    "stop_gradient": "({0})", "copy": "({0})",
}

_BINARY_C = {
    "add": "({0} + {1})", "sub": "({0} - {1})", "mul": "({0} * {1})",
    "max": "disc::disc_max({0}, {1})", "min": "disc::disc_min({0}, {1})",
    "pow": "pow{f}({0}, {1})",
    "eq": "({0} == {1})", "ne": "({0} != {1})", "lt": "({0} < {1})",
    "gt": "({0} > {1})", "le": "({0} <= {1})", "ge": "({0} >= {1})",
    "and": "({0} & {1})", "or": "({0} | {1})",
}


def cuda_type(dt) -> str:
    """The C++ storage type of ``dt`` (``cuda_bf16.h`` / ``cuda_fp16.h``
    types for the low floats)."""
    return _C_STORAGE[as_torch(dt)]


def cuda_load(dt, expr: str) -> str:
    """``expr`` (a value stored as ``dt``) in its math type."""
    return f"disc::to_f32({expr})" if as_torch(dt) in _LOW_FLOATS else expr


def cuda_store(dt, expr: str) -> str:
    """A math-type ``expr`` converted to ``dt``'s storage type."""
    dt = as_torch(dt)
    if dt in _C_TO_LOW:
        return f"{_C_TO_LOW[dt]}({expr})"
    if dt is torch.bool:
        return f"(({expr}) != 0)"
    return f"static_cast<{cuda_type(dt)}>({expr})"


def _c_literal(x: Any, dt: torch.dtype) -> str:
    """A Python number as a C++ constant of math type ``dt`` (a float
    literal is rounded to ``dt`` once, as eager rounds a scalar operand)."""
    if dt is torch.bool:
        return "true" if x else "false"
    ctype = cuda_type(_math_dtype(dt))
    if isinstance(x, float):
        if x != x:
            v = "NAN"
        elif x in (float("inf"), float("-inf")):
            v = "INFINITY" if x > 0 else "(-INFINITY)"
        else:
            v = repr(x)
    else:
        v = repr(int(x))
    return f"(({ctype})({v}))"


def cuda_lines(program: Program, loaded: Sequence[str],
               indent: str = "    ") -> Tuple[List[str], List[str]]:
    """C++ statements computing ``program`` from inputs already in their
    math types (``loaded[i]`` names input ``i``; low floats as ``float``).
    Returns ``(lines, outs)``: ``outs[k]`` names output ``k`` in its math
    type.  The statements use ``gemm.cuh``'s ``disc::`` helpers."""
    lines: List[str] = []
    names: Dict[Arg, str] = {}

    def ref(a: Arg, want) -> str:
        kind, x = a
        if kind == "c":
            return _c_literal(x, want if want is not None else
                              (torch.float32 if isinstance(x, float)
                               else torch.int64))
        if kind == "in":
            dt, name = program.in_dtypes[x], loaded[x]
        else:
            dt, name = program.steps[x].dtype, names[a]
        if want is not None and _math_dtype(dt) != _math_dtype(want):
            if want is torch.bool:
                return f"(({name}) != 0)"
            return f"static_cast<{cuda_type(_math_dtype(want))}>({name})"
        return name

    for j, st in enumerate(program.steps):
        code = st.opcode
        math = _math_dtype(st.dtype)
        f = "" if math is torch.float64 else "f"
        if code in _UNARY_C:
            expr = _UNARY_C[code].format(ref(st.args[0], st.dtype), f=f)
        elif code == "abs":
            x = ref(st.args[0], st.dtype)
            expr = f"fabs{f}({x})" if math.is_floating_point else \
                f"(({x}) < 0 ? -({x}) : ({x}))"
        elif code == "logistic":
            x = ref(st.args[0], st.dtype)
            div = "__fdiv_rn" if f else "__ddiv_rn"
            one = _c_literal(1.0, math)
            expr = f"{div}({one}, {one} + exp{f}(-({x})))"
        elif code == "not":
            a = ref(st.args[0], None)
            expr = f"(!({a}))" if st.dtype is torch.bool else f"(~({a}))"
        elif code in _BINARY_C or code == "div":
            if code in ("eq", "ne", "lt", "gt", "le", "ge", "and", "or"):
                # predicates compute in their operands' type
                operand = next((program.dtype_of(a) for a in st.args
                                if a[0] != "c"), st.dtype)
            else:
                operand = st.dtype
            a, b = (ref(x, operand) for x in st.args)
            if code == "div":
                if operand.is_floating_point:
                    div = "__ddiv_rn" if operand is torch.float64 \
                        else "__fdiv_rn"
                    expr = f"{div}({a}, {b})"  # IEEE, as eager divides
                else:
                    expr = f"({a} / {b})"  # truncating, as lax.div
            else:
                expr = _BINARY_C[code].format(
                    a, b, f="" if _math_dtype(operand) is torch.float64
                    else "f")
        elif code == "select":
            pred = ref(st.args[0], None)
            expr = (f"(({pred}) ? {ref(st.args[2], st.dtype)} : "
                    f"{ref(st.args[1], st.dtype)})")
        elif code == "convert":
            src = st.args[0]
            expr = ref(src, None) if src[0] != "c" else \
                _c_literal(src[1], st.dtype)
            if st.dtype is torch.bool:
                expr = f"(({expr}) != 0)"
        elif code == "integer_pow":
            x = ref(st.args[0], st.dtype)
            y = int(st.param)
            if y == 0:
                expr = _c_literal(1, math)
            else:
                prod = " * ".join([f"({x})"] * abs(y))
                if y > 0:
                    expr = f"({prod})"
                else:
                    div = "__ddiv_rn" if math is torch.float64 \
                        else "__fdiv_rn"
                    expr = f"{div}({_c_literal(1.0, math)}, ({prod}))"
        else:
            raise NotImplementedError(f"no CUDA rule for {code}")
        name = f"t{j}"
        if st.dtype is torch.bool:
            lines.append(f"{indent}const bool {name} = {expr};")
        else:
            ctype = cuda_type(math)
            value = f"static_cast<{ctype}>({expr})"
            if st.dtype in _C_ROUND:
                # round to the value's own dtype, as the eager op does
                value = f"{_C_ROUND[st.dtype]}({value})"
            lines.append(f"{indent}const {ctype} {name} = {value};")
        names[("t", j)] = name

    outs = []
    for a in program.outs:
        kind, x = a
        outs.append(loaded[x] if kind == "in" else names[a])
    return lines, outs
