"""DHLO-style graph IR — DISC §4.1.

The paper's key IR move: ops whose HLO definition bakes shape information
into *compile-time constant attributes* (slice indices, pad amounts,
broadcast sizes, reshape targets) are re-expressed with **tensor operands**
so one compiled artifact can serve any runtime shape.  We mirror that here:

* every :class:`DOp` separates ``inputs`` (data operands) from
  ``shape_operands`` (DHLO's attr-replacing tensor operands — e.g.
  ``dslice`` start indices);
* dimension sizes in :class:`DValue` shapes may be symbolic
  (:class:`~repro.core.symshape.SymDim`) — rank is always static, matching
  DISC's "dynamic shapes with static rank" scoping;
* a graph owns a :class:`~repro.core.constraints.ShapeConstraintStore`
  populated while the graph is built (op-semantic constraints) and by the
  frontend bridge (high-level-op hints).

The *pattern fingerprint* (:meth:`DGraph.fingerprint`) deliberately excludes
concrete dimension values — DISC's insight that "we do not need to consider
shape information to check whether two fusion patterns are the same for code
generation".  The compile cache keys on it plus a bucket signature.
"""
from __future__ import annotations

import hashlib
import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from .constraints import ShapeConstraintStore
from .dtypes import dtype_key, dtype_name
from .symshape import Dim, SymDim, SymShape, shape_is_static, shape_value

__all__ = ["DValue", "DOp", "DGraph"]

_val_ids = itertools.count()
_op_ids = itertools.count()


@dataclass
class DValue:
    """An SSA value (tensor) in the graph."""

    shape: SymShape
    dtype: Any
    name: str = ""
    vid: int = field(default_factory=lambda: next(_val_ids))
    # literal payload for constants (a tensor), else None.  A rank-0
    # literal made from a Python number keeps the number's full precision
    # (a float64/int64/bool tensor) while ``dtype`` is the weak type it
    # takes next to its tensor operand, as in eager PyTorch.
    literal: Optional[torch.Tensor] = None

    @property
    def rank(self) -> int:
        return len(self.shape)

    def concrete_shape(self) -> Tuple[int, ...]:
        return shape_value(self.shape)

    def is_static(self) -> bool:
        return shape_is_static(self.shape)

    def __hash__(self) -> int:
        return hash(self.vid)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, DValue) and other.vid == self.vid

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        dt = dtype_name(self.dtype) if self.dtype is not None else "?"
        return f"%{self.vid}{':' + self.name if self.name else ''}<{list(self.shape)};{dt}>"


@dataclass
class DOp:
    """A DHLO op.  ``shape_operands`` replace HLO's constant shape attrs."""

    opcode: str
    inputs: List[DValue]
    outputs: List[DValue]
    shape_operands: List[DValue] = field(default_factory=list)
    attrs: Dict[str, Any] = field(default_factory=dict)
    oid: int = field(default_factory=lambda: next(_op_ids))

    def all_operands(self) -> List[DValue]:
        return self.inputs + self.shape_operands

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        outs = ", ".join(map(repr, self.outputs))
        ins = ", ".join(map(repr, self.inputs))
        sh = ("; shape_ops=" + ", ".join(map(repr, self.shape_operands))) if self.shape_operands else ""
        return f"{outs} = {self.opcode}({ins}{sh})"


class DGraph:
    """A DHLO computation graph (hub IR for all frontends — §4.4)."""

    def __init__(self, name: str = "graph") -> None:
        self.name = name
        self.params: List[DValue] = []
        self.ops: List[DOp] = []
        self.outputs: List[DValue] = []
        self.store = ShapeConstraintStore()
        self._producer: Dict[int, DOp] = {}

    # ------------------------------------------------------------ build --
    def add_param(self, shape: SymShape, dtype, name: str = "") -> DValue:
        v = DValue(shape=tuple(shape), dtype=dtype, name=name or f"arg{len(self.params)}")
        self.params.append(v)
        self.store.note_value_size(v.vid, v.shape)
        return v

    def add_const(self, array, name: str = "", dtype=None) -> DValue:
        array = torch.as_tensor(array)
        v = DValue(shape=tuple(array.shape), dtype=dtype or array.dtype,
                   name=name, literal=array)
        self.store.note_value_size(v.vid, v.shape)
        return v

    def add_op(
        self,
        opcode: str,
        inputs: Sequence[DValue],
        out_shapes: Sequence[SymShape],
        out_dtypes: Sequence[Any],
        shape_operands: Sequence[DValue] = (),
        attrs: Optional[Dict[str, Any]] = None,
    ) -> DOp:
        outs = [DValue(shape=tuple(s), dtype=dt) for s, dt in zip(out_shapes, out_dtypes)]
        op = DOp(
            opcode=opcode,
            inputs=list(inputs),
            outputs=outs,
            shape_operands=list(shape_operands),
            attrs=dict(attrs or {}),
        )
        self.ops.append(op)
        for o in outs:
            self._producer[o.vid] = op
            self.store.note_value_size(o.vid, o.shape)
        return op

    def set_outputs(self, outs: Sequence[DValue]) -> None:
        self.outputs = list(outs)

    # ----------------------------------------------------------- queries --
    def producer(self, v: DValue) -> Optional[DOp]:
        return self._producer.get(v.vid)

    def users(self) -> Dict[int, List[DOp]]:
        table: Dict[int, List[DOp]] = {}
        for op in self.ops:
            for v in op.all_operands():
                table.setdefault(v.vid, []).append(op)
        return table

    def values(self) -> List[DValue]:
        seen: Dict[int, DValue] = {}
        for p in self.params:
            seen[p.vid] = p
        for op in self.ops:
            for v in op.all_operands():
                seen.setdefault(v.vid, v)
            for v in op.outputs:
                seen.setdefault(v.vid, v)
        return list(seen.values())

    def toposorted(self) -> List[DOp]:
        # ops are appended in construction order which is already topological
        return list(self.ops)

    # -------------------------------------------------------- fingerprint --
    def fingerprint(self) -> str:
        """Shape-free structural hash of the computation pattern.

        Two graphs with the same ops/wiring but different concrete dims have
        the same fingerprint — the DISC cache-key property.
        """
        h = hashlib.sha256()
        idx: Dict[int, int] = {}

        def vkey(v: DValue) -> Tuple:
            if v.vid not in idx:
                idx[v.vid] = len(idx)
            # rank and dtype are structure; dim values are NOT
            return (idx[v.vid], v.rank, dtype_key(v.dtype))

        def akey(v) -> str:
            # region ops carry nested DGraphs in attrs: fold their own
            # (shape-free) fingerprints in, never their repr — object
            # identity must not leak into the cache key
            if isinstance(v, DGraph):
                return f"<region:{v.fingerprint()}>"
            if isinstance(v, (tuple, list)) and any(
                    isinstance(x, DGraph) for x in v):
                return "(" + ",".join(akey(x) for x in v) + ")"
            return repr(v)

        for p in self.params:
            h.update(repr(("param", vkey(p))).encode())
        for op in self.ops:
            attrs = tuple(sorted((k, akey(v)) for k, v in op.attrs.items()))
            h.update(
                repr(
                    (
                        op.opcode,
                        tuple(vkey(v) for v in op.inputs),
                        tuple(vkey(v) for v in op.shape_operands),
                        tuple(vkey(v) for v in op.outputs),
                        attrs,
                    )
                ).encode()
            )
        for o in self.outputs:
            h.update(repr(("out", vkey(o))).encode())
        return h.hexdigest()[:16]

    # ------------------------------------------------------------- debug --
    def pretty(self) -> str:
        lines = [f"DGraph {self.name} ({len(self.ops)} ops)"]
        for p in self.params:
            lines.append(f"  param {p!r}")
        for op in self.ops:
            lines.append(f"  {op!r}")
        lines.append("  return " + ", ".join(map(repr, self.outputs)))
        return "\n".join(lines)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"<DGraph {self.name}: {len(self.ops)} ops, {len(self.params)} params>"
