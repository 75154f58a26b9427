"""Host/device placement of shape calculation vs tensor compute — DISC §4.2.1.

    "DISC separates shape computation and data processing during
     compilation ... The placer component places shape calculation logic on
     host side and tensor computation kernels on device side."

Placement rule (as in the paper / Nimble): the backward closure of values
feeding **shape operands** (dslice starts, etc.) that is cheap integer math
is *shape calculation* → host; everything else is tensor compute → device.
The generated dispatcher evaluates host-placed shape math on the host;
device ops run in the per-bucket executor on the card.

The device side of the split is **host/mesh** when the artifact compiles
under ``CompileOptions(mesh=...)``: shape calculation still runs on the
host (it is *replicated* control flow — every participant computes the
same bucket key), while tensor compute is SPMD-partitioned over the mesh
per the sharding plan.  The placement records the mesh so ``report()``
shows where device ops actually land.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set

from .dhlo import DGraph, DOp
from .dtypes import is_integer, itemsize
from .propagation import CostClass, op_info

__all__ = ["Placement", "place"]

_HOST_BYTES_LIMIT = 1024  # shape math is tiny by definition


@dataclass
class Placement:
    host_ops: List[DOp]
    device_ops: List[DOp]
    host_value_ids: Set[int]
    # the SPMD mesh device ops are partitioned over (None = one device)
    mesh: Optional[Any] = None

    @property
    def device_target(self) -> str:
        """Where tensor compute lands: ``"device"`` or ``"mesh(...)"``."""
        if self.mesh is None:
            return "device"
        shape = "x".join(f"{a}={s}"
                         for a, s in _axes(self.mesh).items())
        return f"mesh({shape})"

    def report(self) -> Dict[str, Any]:
        rep: Dict[str, Any] = {"host_ops": len(self.host_ops),
                               "device_ops": len(self.device_ops),
                               "device_target": self.device_target}
        if self.mesh is not None:
            rep["mesh_axes"] = _axes(self.mesh)
        return rep


def _axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``."""
    return {a: int(s) for a, s in zip(mesh.mesh_dim_names, mesh.shape)}


def _is_small_int(v) -> bool:
    if not is_integer(v.dtype):
        return False
    n = 1
    for d in v.shape:
        if not isinstance(d, int):
            return False
        n *= d
    return n * itemsize(v.dtype) <= _HOST_BYTES_LIMIT


def place(graph: DGraph, mesh: Optional[Any] = None) -> Placement:
    producer: Dict[int, DOp] = {}
    for op in graph.ops:
        for o in op.outputs:
            producer[o.vid] = op

    # roots: values used as shape operands + outputs of SHAPE-cost ops
    roots: List[DOp] = []
    for op in graph.ops:
        for v in op.shape_operands:
            p = producer.get(v.vid)
            if p is not None:
                roots.append(p)
        if op_info(op.opcode).cost is CostClass.SHAPE:
            roots.append(op)

    host: Set[int] = set()
    stack = list(roots)
    while stack:
        op = stack.pop()
        if op.oid in host:
            continue
        # only small integer computations move to host
        if not all(_is_small_int(o) for o in op.outputs):
            continue
        if op_info(op.opcode).cost is CostClass.COMPUTE:
            continue
        host.add(op.oid)
        for v in op.inputs:
            p = producer.get(v.vid)
            if p is not None:
                stack.append(p)

    host_ops = [op for op in graph.ops if op.oid in host]
    device_ops = [op for op in graph.ops if op.oid not in host]
    host_vals = {o.vid for op in host_ops for o in op.outputs}
    return Placement(host_ops=host_ops, device_ops=device_ops,
                     host_value_ids=host_vals, mesh=mesh)
